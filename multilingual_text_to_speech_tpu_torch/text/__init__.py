"""Text frontend: symbol tables, cleaning and phonemization."""

from multilingual_text_to_speech_tpu_torch.text.cleaners import clean_text
from multilingual_text_to_speech_tpu_torch.text.phonemize import (
    build_phoneme_dicts,
    phonemize_word,
    to_phoneme,
)
from multilingual_text_to_speech_tpu_torch.text.symbols import (
    EOS_ID,
    PAD_ID,
    UNK_ID,
    SymbolTable,
)

__all__ = ["SymbolTable", "clean_text", "PAD_ID", "EOS_ID", "UNK_ID",
           "phonemize_word", "to_phoneme", "build_phoneme_dicts"]
