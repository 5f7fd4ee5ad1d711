"""Text frontend: normalization, segmentation, G2P, tokenization."""

from .frontend import batch_to_bucket, pad_to_bucket, pick_bucket, segment_text, text_to_ids
from .g2p import text_to_phonemes, word_to_phonemes
from .normalize import normalize_text, number_to_words, ordinal_to_words, year_to_words
from .segment import split_into_sentences
from .symbols import BOS_ID, EOS_ID, PAD_ID, SYMBOLS, WORD_SEP_ID, decode, encode, n_symbols

__all__ = [
    "batch_to_bucket",
    "pad_to_bucket",
    "pick_bucket",
    "segment_text",
    "text_to_ids",
    "text_to_phonemes",
    "word_to_phonemes",
    "normalize_text",
    "number_to_words",
    "ordinal_to_words",
    "year_to_words",
    "split_into_sentences",
    "BOS_ID",
    "EOS_ID",
    "PAD_ID",
    "SYMBOLS",
    "WORD_SEP_ID",
    "decode",
    "encode",
    "n_symbols",
]
