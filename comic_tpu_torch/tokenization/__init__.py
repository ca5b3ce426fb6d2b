from .radix import RadixCodec, base_arr_to_int, number_to_base
from .text import ids_to_captions
from .vocab import EOS, GO, PAD, UNK, Vocabulary

__all__ = [
    "RadixCodec",
    "base_arr_to_int",
    "number_to_base",
    "Vocabulary",
    "PAD",
    "UNK",
    "GO",
    "EOS",
    "ids_to_captions",
]
