"""IPA phonemization with punctuation-preserving word-by-word translation.

A copy of the JAX package's ``text/phonemize.py``.  The phonemizer/epitran
backends are optional host-side dependencies (they shell out to espeak);
when neither is installed, ``phonemize_word`` raises so corpora can still be
built grapheme-only (``use_phonemes=False``).  The language is always
passed to the backend.
"""

from __future__ import annotations

import string
from typing import Dict, Iterable, List, Optional, Tuple

from multilingual_text_to_speech_tpu_torch.text.cleaners import (
    remove_punctuation,
)

try:  # pragma: no cover - optional dependency
    from phonemizer.phonemize import phonemize as _espeak_phonemize
    from phonemizer.separator import Separator as _Separator

    _HAS_PHONEMIZER = True
except Exception:  # pragma: no cover
    _HAS_PHONEMIZER = False

try:  # pragma: no cover - optional dependency
    import epitran as _epitran

    _HAS_EPITRAN = True
except Exception:  # pragma: no cover
    _HAS_EPITRAN = False


def phonemize_word(text: str, language: str) -> str:
    """Translate text to IPA via espeak, falling back to epitran
    (reference: utils/text.py:88-96)."""
    if _HAS_PHONEMIZER:
        try:
            seps = _Separator(word=" ", phone="")
            out = _espeak_phonemize(
                text, separator=seps, backend="espeak", language=language
            )
            return out.replace("\n", " ")
        except RuntimeError:
            pass
    if _HAS_EPITRAN:
        epi = _epitran.Epitran(language)
        return epi.transliterate(text, normpunc=True)
    raise RuntimeError(
        "No phonemization backend available: install `phonemizer` (espeak) "
        "or `epitran`, or build the corpus with phonemes=False."
    )


def build_phoneme_dicts(
    text_lang_pairs: Iterable[Tuple[str, str]],
    hp,
    progress=None,
) -> Dict[str, Dict[str, str]]:
    """Build per-language word->IPA caches over a corpus
    (reference: utils/text.py:20-32)."""
    pairs = list(text_lang_pairs)
    dictionaries: Dict[str, Dict[str, str]] = {}
    for i, (text, lang) in enumerate(pairs):
        lang_dict = dictionaries.setdefault(lang, {})
        for word in remove_punctuation(text, hp).split():
            if word not in lang_dict:
                # the phonemizer output carries a trailing separator space
                lang_dict[word] = phonemize_word(word, lang)[:-1]
        if progress is not None:
            progress((i + 1) / len(pairs))
    return dictionaries


def to_phoneme(
    text: str,
    ignore_punctuation: bool,
    language: str,
    hp,
    phoneme_dictionary: Optional[Dict[str, str]] = None,
) -> str:
    """Phonemize an utterance, re-inserting punctuation to match the input.

    The espeak backend mangles punctuation, so words are phonemized
    individually (optionally via a prebuilt cache) and the original
    punctuation marks are woven back in at their source positions
    (reference: utils/text.py:35-85).
    """
    clear_text = remove_punctuation(text, hp)
    if ignore_punctuation:
        return phonemize_word(clear_text, language)[:-1]

    clear_words = clear_text.split()
    phoneme_dictionary = phoneme_dictionary or {}
    phonemes: List[str] = [
        phoneme_dictionary[w]
        if w in phoneme_dictionary
        else phonemize_word(w, language)[:-1]
        for w in clear_words
    ]

    # Weave the punctuation of the raw text back into the phoneme stream.
    in_word = False
    punctuation_seen = False
    out = ""
    clear_offset = 0
    word_idx = 0
    for idx, char in enumerate(text):
        if idx - clear_offset < len(clear_text) and char == clear_text[idx - clear_offset]:
            # non-punctuation character
            if not in_word:
                if char in string.whitespace:
                    punctuation_seen = False
                    continue
                in_word = True
                out += (" " if idx != 0 and not punctuation_seen else "") + phonemes[word_idx]
                word_idx += 1
            else:
                if char in string.whitespace:
                    in_word = False
            punctuation_seen = False
        else:
            # punctuation character
            clear_offset += 1
            if in_word and char in hp.punctuations_in:
                continue
            out += (" " if not in_word and not punctuation_seen else "") + char
            punctuation_seen = True
    return out
