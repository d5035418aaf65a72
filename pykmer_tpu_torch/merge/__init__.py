"""The N×N merge of `.kin` indexes into a `.kma` matrix."""

from .merger import merge, pair_counts_stream

__all__ = ["merge", "pair_counts_stream"]
