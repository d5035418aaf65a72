"""The index path (FASTA → `.kin` + `.kin.json`) on one device, sharded over
a mesh, or across the processes of a multi-host job; batch indexing, and
index verification."""

from .batch import BatchResult, index_batch
from .indexer import create_fasta_index
from .multihost import create_fasta_index_multihost
from .reader import read_fasta_index
from .sharded import create_fasta_index_sharded

__all__ = ["BatchResult", "create_fasta_index", "create_fasta_index_multihost",
           "create_fasta_index_sharded", "index_batch", "read_fasta_index"]
