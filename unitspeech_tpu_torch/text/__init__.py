"""Text frontend, IPA path (counterpart of unitspeech_tpu/text/__init__.py
`cleaned_text_to_sequence` and `phonemes_to_sequence`; reference
text/__init__.py:19-26): pre-phonemized IPA -> symbol IDs -> blank token
between every ID. The espeak wrapper and the rule-based G2P belong to a
later slice, so this slice takes IPA input.
"""

from __future__ import annotations

from typing import List

from unitspeech_tpu_torch.ops.masking import intersperse
from unitspeech_tpu_torch.text.symbols import BLANK_ID, symbols

_symbol_to_id = {s: i for i, s in enumerate(symbols)}


def cleaned_text_to_sequence(cleaned_text: str) -> List[int]:
    """IPA string -> symbol IDs; unknown symbols are skipped (the reference
    raises KeyError)."""
    return [_symbol_to_id[s] for s in cleaned_text if s in _symbol_to_id]


def phonemes_to_sequence(cleaned_text: str, add_blank: bool = True) -> List[int]:
    """IPA string -> interleaved ID sequence ready for the text encoder."""
    seq = cleaned_text_to_sequence(cleaned_text)
    return intersperse(seq, BLANK_ID) if add_blank else seq
