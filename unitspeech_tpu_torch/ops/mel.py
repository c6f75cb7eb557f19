"""Mel normalization (counterpart of unitspeech_tpu/ops/mel.py; reference
data.py:89-92, inference.py:140). The STFT frontend belongs to a later
slice."""

from __future__ import annotations


def denormalize_mel(mel, mel_min, mel_max):
    """[-1, 1] per-channel normalized mel (..., n_mels) -> log-mel."""
    return (mel + 1.0) / 2.0 * (mel_max - mel_min) + mel_min
