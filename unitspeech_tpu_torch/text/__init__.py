"""Text frontend: graphemes -> IPA phonemes -> interleaved symbol IDs
(counterpart of unitspeech_tpu/text/__init__.py; reference
text/__init__.py:11-26 and util.py:154-172):

    lowercase -> espeak IPA (en-us / ro) -> symbol-ID lookup -> blank token
    between every ID.

Phonemization is a host string operation. espeak-ng is optional: the
binary is found on PATH through shutil.which; without it
`get_phonemizer(fallback=True)` routes to the pure-Python rule G2Ps
(text/g2p.py, text/g2p_ro.py), and pre-phonemized IPA always goes
through `phonemes_to_sequence`.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from typing import List, Sequence

from unitspeech_tpu_torch.ops.masking import intersperse
from unitspeech_tpu_torch.text.symbols import BLANK_ID, symbols

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}
_whitespace_re = re.compile(r"\s+")

SUPPORTED_LANGUAGES = ("en-us", "ro")


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text)


# the `phonemizer` package's Punctuation._DEFAULT_MARKS, the set the
# reference preserves (preserve_punctuation=True); each has a symbol ID
PUNCTUATION_MARKS = ';:,.!?¡¿—…"«»“”'
_marks_re = re.compile(rf"(\s*[{re.escape(PUNCTUATION_MARKS)}]+\s*)+")
# espeak's "(en)"-style language-switch flags (language_switch="remove-flags")
_lang_flag_re = re.compile(r"\([a-z]{2,5}(?:-[a-z0-9-]+)?\)")
_stress_re = re.compile(r"[ˈˌ]")


class EspeakPhonemizer:
    """Grapheme -> IPA through the espeak-ng CLI with the reference's
    phonemizer flags: punctuation preserved in place, stress kept,
    language-switch flags removed."""

    def __init__(self, language: str = "en-us", with_stress: bool = True,
                 preserve_punctuation: bool = True):
        if language not in SUPPORTED_LANGUAGES:
            raise ValueError(f"Language {language} not supported.")
        self.language = language
        self.with_stress = with_stress
        self.preserve_punctuation = preserve_punctuation
        self._binary = shutil.which("espeak-ng") or shutil.which("espeak")
        if self._binary is None:
            raise RuntimeError(
                "espeak-ng not found on PATH; install it or pass pre-phonemized "
                "IPA text to phonemes_to_sequence().")

    def _espeak_ipa(self, text: str) -> str:
        """One espeak call: raw IPA for a punctuation-free chunk."""
        proc = subprocess.run([self._binary, "-q", "--ipa", "-v", self.language, "--", text],
                              capture_output=True, text=True, check=True)
        ph = proc.stdout.replace("\n", " ")
        # espeak ties multi-character phones with U+0361, which the symbol
        # table lacks: drop them, as the phonemizer package does
        ph = ph.replace("͡", "").replace("‍", "")
        ph = _lang_flag_re.sub("", ph)
        if not self.with_stress:
            ph = _stress_re.sub("", ph)
        return ph.strip()

    def phonemize(self, texts: Sequence[str], strip: bool = True) -> List[str]:
        return [phonemize_chunks(self._espeak_ipa, t, self.preserve_punctuation, strip=strip)
                for t in texts]


def phonemize_chunks(ipa_fn, text: str, preserve_punctuation: bool = True,
                     strip: bool = True) -> str:
    """Apply a chunk IPA function with punctuation preserved in place: the
    marks keep their surrounding whitespace and the text between them is
    phonemized chunk by chunk (the phonemizer package's preserve/restore
    contract). Shared by the espeak backend and the rule G2Ps."""
    if not preserve_punctuation:
        ph = ipa_fn(text)
    else:
        parts: List[str] = []
        pos = 0
        for m in _marks_re.finditer(text):
            chunk = text[pos:m.start()]
            if chunk.strip():
                parts.append(ipa_fn(chunk))
            parts.append(m.group())
            pos = m.end()
        tail = text[pos:]
        if tail.strip():
            parts.append(ipa_fn(tail))
        ph = "".join(parts)
    return ph.strip() if strip else ph


def get_phonemizer(language: str, fallback: bool = False):
    """An espeak-backed phonemizer. Without the binary: None (callers then
    need IPA input), or with fallback=True the rule G2P of the language
    (Romanian for "ro*", else English), or None when it has no rule set.
    An unsupported language raises ValueError unless fallback is set."""
    try:
        return EspeakPhonemizer(language)
    except (RuntimeError, ValueError) as espeak_err:
        if isinstance(espeak_err, ValueError) and not fallback:
            raise
        if not fallback:
            return None
        import logging

        from unitspeech_tpu_torch.text.g2p import RuleG2P
        from unitspeech_tpu_torch.text.g2p_ro import RomanianG2P

        log = logging.getLogger(__name__)
        try:
            g2p = RomanianG2P(language) if language.startswith("ro") else RuleG2P(language)
        except ValueError as e:  # no rule set for this language
            log.warning("espeak-ng not found and no G2P fallback: %s", e)
            return None
        log.warning("espeak-ng not found: falling back to the built-in rule G2P "
                    "(text/g2p%s.py), a best-effort phonemization; install espeak-ng "
                    "for the reference's output", "_ro" if language.startswith("ro") else "")
        return g2p


def phonemize(text: str, phonemizer) -> str:
    """Reference text/__init__.py:11-16."""
    ph = phonemizer.phonemize([lowercase(text)], strip=True)[0]
    return collapse_whitespace(ph)


def cleaned_text_to_sequence(cleaned_text: str) -> List[int]:
    """IPA string -> symbol IDs; unknown symbols are skipped (the reference
    raises KeyError)."""
    return [_symbol_to_id[s] for s in cleaned_text if s in _symbol_to_id]


def phonemes_to_sequence(cleaned_text: str, add_blank: bool = True) -> List[int]:
    """IPA string -> interleaved ID sequence ready for the text encoder."""
    seq = cleaned_text_to_sequence(cleaned_text)
    return intersperse(seq, BLANK_ID) if add_blank else seq


def text_to_sequence(text: str, phonemizer, add_blank: bool = True) -> List[int]:
    """Graphemes -> IDs (reference inference.py:117-122)."""
    return phonemes_to_sequence(phonemize(text, phonemizer), add_blank=add_blank)


def sequence_to_text(seq: Sequence[int]) -> str:
    return "".join(_id_to_symbol.get(i, "") for i in seq)


_sentence_split_re = re.compile(r"(?<=[.!?…])\s+")


def split_sentences(text: str, max_words: int = 60) -> List[str]:
    """Split raw text into chunks for long-text synthesis: after
    sentence-final punctuation; a chunk ending in a 1-2 letter word and a
    period ("U.", "Mr.") merges into the text after it; a sentence longer
    than `max_words` splits again at a clause comma near the budget, else
    at the budget. Chunk boundaries change the prosody at the joins only."""

    def _ends_with_abbrev(chunk: str) -> bool:
        last = chunk.rsplit(None, 1)[-1]
        return last.endswith(".") and len(last.rstrip(".")) <= 2

    parts = [p.strip() for p in _sentence_split_re.split(text.strip()) if p.strip()]
    merged: List[str] = []
    for p in parts:
        if merged and _ends_with_abbrev(merged[-1]):
            merged[-1] += " " + p
        else:
            merged.append(p)
    out: List[str] = []
    for p in merged:
        words = p.split()
        while len(words) > max_words:
            cut = max_words
            for k in range(max_words, max_words // 2, -1):
                if words[k - 1].endswith((",", ";", ":")):
                    cut = k
                    break
            out.append(" ".join(words[:cut]))
            words = words[cut:]
        if words:
            out.append(" ".join(words))
    return out or ([text.strip()] if text.strip() else [])
