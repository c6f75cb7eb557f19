"""Unit <-> mel frame-rate alignment (counterpart of
unitspeech_tpu/ops/units.py; reference util.py:69-102), host-side numpy:
50 Hz unit runs are expanded to samples (duration * sr // 50 each),
regrouped into hop-sized groups by each group's mode, then run-length
encoded again. It runs once per reference utterance, before the
fine-tune."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def dedup_consecutive(units: np.ndarray):
    """(T,) -> (unique_units, run_lengths), as torch.unique_consecutive
    with return_counts=True."""
    units = np.asarray(units)
    if len(units) == 0:
        return units, np.zeros((0,), np.int64)
    change = np.flatnonzero(np.diff(units)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(units)]])
    return units[starts], (ends - starts).astype(np.int64)


def process_unit(units: np.ndarray, durations: np.ndarray, sampling_rate: int,
                 hop_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """(units (N,), durations (N,) at 50 Hz) -> (units (M,), durations (M,))
    at the mel frame rate, truncated to a whole number of hops. Each hop's
    unit is its mode, ties going to the smallest unit (torch.mode's
    tie-break)."""
    units = np.asarray(units, np.int64)
    durations = np.asarray(durations, np.int64) * (sampling_rate // 50)
    expanded = np.repeat(units, durations)
    new_length = len(expanded) // hop_length * hop_length
    if new_length == 0:
        return np.zeros((0,), np.int64), np.zeros((0,), np.int64)
    groups = expanded[:new_length].reshape(-1, hop_length)
    # the mode of each sorted row is its longest run; argmax picks the first
    # (smallest) of equally long runs
    s = np.sort(groups, axis=1)
    change = s[:, 1:] != s[:, :-1]
    run_id = np.concatenate([np.zeros((s.shape[0], 1), np.int64),
                             np.cumsum(change, axis=1)], axis=1)
    modes = np.empty(s.shape[0], np.int64)
    for i in range(s.shape[0]):
        best_run = np.argmax(np.bincount(run_id[i]))
        modes[i] = s[i, np.searchsorted(run_id[i], best_run)]
    out_units, out_durations = dedup_consecutive(modes)
    return out_units.astype(np.int64), out_durations.astype(np.int64)
