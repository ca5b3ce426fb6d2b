from .radix import RadixCodec, base_arr_to_int, number_to_base
from .text import (caption_strings_to_batched_ids, encode_caption_tokens,
                   ids_to_captions)
from .vocab import (EOS, GO, PAD, UNK, Vocabulary, build_char_vocab,
                    build_vocab)

__all__ = [
    "RadixCodec",
    "base_arr_to_int",
    "number_to_base",
    "Vocabulary",
    "build_vocab",
    "build_char_vocab",
    "PAD",
    "UNK",
    "GO",
    "EOS",
    "ids_to_captions",
    "encode_caption_tokens",
    "caption_strings_to_batched_ids",
]
