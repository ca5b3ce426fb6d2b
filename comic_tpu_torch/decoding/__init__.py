"""Caption decoding: greedy and beam search."""

from .search import (
    DecodeOutput,
    beam_search,
    beam_search_from_memory,
    greedy_or_sample,
    greedy_or_sample_from_memory,
)

__all__ = [
    "DecodeOutput",
    "beam_search",
    "beam_search_from_memory",
    "greedy_or_sample",
    "greedy_or_sample_from_memory",
]
