"""The index path (FASTA → `.kin` + `.kin.json`) on one device."""

from .indexer import create_fasta_index

__all__ = ["create_fasta_index"]
