"""The index path (FASTA → `.kin` + `.kin.json`) on one device, batch
indexing, and index verification."""

from .batch import BatchResult, index_batch
from .indexer import create_fasta_index
from .reader import read_fasta_index

__all__ = ["BatchResult", "create_fasta_index", "index_batch", "read_fasta_index"]
