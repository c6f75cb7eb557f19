"""ITU-T P.56 active speech level and sv56-style gain normalization
(counterpart of unitspeech_tpu/ops/sv56.py; reference sv56.py:39-92).

Host-side numpy/scipy, run once per written wav:
  1. envelope = two cascaded one-pole smoothers of |x| (0.03 s);
  2. for 15 thresholds 2^-14 .. 2^0, count samples where the envelope
     exceeds the threshold, with a 0.2 s hangover;
  3. active level where A_j - 20 log10(c_j) crosses 15.9 dB, interpolated;
  4. gain = 10^((target - level) / 20).
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

MARGIN_DB = 15.9
TIME_CONSTANT_S = 0.03
HANGOVER_S = 0.2
N_THRESHOLDS = 15


def _activity_counts(x: np.ndarray, sr: int):
    g = np.exp(-1.0 / (sr * TIME_CONSTANT_S))
    p = lfilter([1.0 - g], [1.0, -g], np.abs(x))
    q = lfilter([1.0 - g], [1.0, -g], p)
    hangover = int(np.ceil(HANGOVER_S * sr))
    thresholds = 2.0 ** (np.arange(1, N_THRESHOLDS + 1) - 15.0)
    t_idx = np.arange(len(x))
    counts = np.zeros(N_THRESHOLDS, np.int64)
    for j, c in enumerate(thresholds):
        exceed = q >= c
        if not exceed.any():
            continue
        last = np.maximum.accumulate(np.where(exceed, t_idx, -hangover - 1))
        counts[j] = int((t_idx - last <= hangover).sum())
    return float(np.sum(x.astype(np.float64) ** 2)), counts, thresholds


def active_speech_level(x: np.ndarray, sr: int):
    """(active level in dBov, activity factor) of a waveform in [-1, 1]."""
    sq, counts, thresholds = _activity_counts(np.asarray(x, np.float64), sr)
    n = len(x)
    if n == 0 or sq <= 0:
        return -100.0, 0.0
    long_term = 10.0 * np.log10(sq / n + 1e-20)
    a_db = np.full(N_THRESHOLDS, -100.0)
    nz = counts > 0
    a_db[nz] = 10.0 * np.log10(sq / counts[nz] + 1e-20)
    delta = a_db - 20.0 * np.log10(thresholds)
    active, activity = long_term, 1.0
    for j in range(N_THRESHOLDS - 1, -1, -1):
        if counts[j] == 0:
            continue
        if delta[j] >= MARGIN_DB:
            if j == N_THRESHOLDS - 1 or counts[j + 1] == 0:
                active = a_db[j]
            else:
                d1, d2 = delta[j], delta[j + 1]
                if abs(d1 - d2) < 1e-9:
                    active = a_db[j]
                else:
                    w = (d1 - MARGIN_DB) / (d1 - d2)
                    active = a_db[j] + w * (a_db[j + 1] - a_db[j])
            activity = 10.0 ** ((long_term - active) / 10.0)
            break
    return float(active), float(activity)


def normalize(x: np.ndarray, sr: int, target_dbov: float = -26.0) -> np.ndarray:
    """Scale to `target_dbov` active level and clip to [-1, 1]."""
    level, _ = active_speech_level(x, sr)
    g = float(10.0 ** ((target_dbov - level) / 20.0))
    return np.clip(np.asarray(x, np.float64) * g, -1.0, 1.0).astype(np.float32)
