"""PCM wav reading and writing without soundfile or librosa (counterpart
of unitspeech_tpu/data/dataset.py load_wav / write_wav), and the host
resampling every SSL frontend's input goes through."""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """A 16- or 32-bit PCM wav -> (float32 samples in [-1, 1], sample rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    return data, sr


def write_wav(path: str, data: np.ndarray, sr: int):
    """float [-1, 1] -> 16-bit PCM mono."""
    pcm = (np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def resample_to(wav: np.ndarray, sr: int, target: int) -> np.ndarray:
    """wav at sr -> f32 at target (scipy resample_poly on the host, in
    float64, as the JAX CLI)."""
    if sr == target:
        return np.asarray(wav, np.float32)
    from scipy.signal import resample_poly

    return resample_poly(np.asarray(wav, np.float64), target, sr).astype(np.float32)
