"""Duration calibration for speculative and bucket-switch serving
(counterpart of unitspeech_tpu/infer/calibration.py; the port keeps its own
copy of this numpy module).

The exact serving path syncs the predicted output length to the host before
it picks a frame bucket (the reference does the same at
unitspeech.py:427-429). Speculative serving guesses the bucket up front
instead, and the guess must be tight: the 50-step sampler runs at the padded
length. This module is that guess: a host-side duration surrogate. The
duration predictor is deterministic given the tokens, so a per-token-id mean
duration table (learned online from the durations the exact path already
brings to the host) estimates a request's total frames without touching the
device. A residual-ratio quantile (actual / estimate over served requests)
sets the safety margin, so the guessed bucket covers ~P95 of requests;
overflows fall back to the exact bucket, reusing the encoder outputs. The
observed totals also give the bucket-switch window its length distribution
(infer/bucket_cost.py).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


@dataclass
class DurationCalibrator:
    """Online per-token-id duration model + residual-quantile margin.

    observe_durations() feeds per-token frame counts (w_ceil rows);
    observe_total() feeds (tokens, actual_total) pairs — cheap, used on
    every request to track the estimate's residual distribution.
    """

    n_vocab: int
    min_samples: int = 8          # requests seen before speculating
    quantile: float = 0.95        # residual coverage target
    max_margin: float = 1.5       # cap on the residual margin
    max_residuals: int = 512      # sliding window for residuals/totals
    _dur_sum: np.ndarray = field(default=None, repr=False)
    _dur_cnt: np.ndarray = field(default=None, repr=False)
    _residuals: list = field(default_factory=list, repr=False)
    _totals: list = field(default_factory=list, repr=False)
    _n_seen: int = 0

    def __post_init__(self):
        if self._dur_sum is None:
            self._dur_sum = np.zeros((self.n_vocab,), np.float64)
        if self._dur_cnt is None:
            self._dur_cnt = np.zeros((self.n_vocab,), np.float64)

    # -- observation ---------------------------------------------------------

    def observe_durations(self, token_ids: Sequence[int], durations: Sequence[float]):
        """Per-token durations from one request (w_ceil row, frames/token)."""
        tok = np.asarray(token_ids, np.int64)
        dur = np.asarray(durations, np.float64)[: tok.shape[0]]
        np.add.at(self._dur_sum, tok, dur)
        np.add.at(self._dur_cnt, tok, 1.0)

    def observe_total(self, token_ids: Sequence[int], actual_frames: float):
        """Track the surrogate's residual on a served request."""
        est = self.estimate(token_ids)
        if est is not None and est > 0:
            r = float(actual_frames) / est
            self._residuals.append(r)
            if len(self._residuals) > self.max_residuals:
                self._residuals = self._residuals[-self.max_residuals :]
        self._totals.append(float(actual_frames))
        if len(self._totals) > self.max_residuals:
            self._totals = self._totals[-self.max_residuals :]
        self._n_seen += 1

    def total_quantile(self, q: float) -> Optional[float]:
        """Quantile of observed request lengths (frames, pre-length_scale)."""
        if not self._totals:
            return None
        return float(np.quantile(self._totals, q))

    def observed_totals(self) -> list:
        """The raw observed request lengths (frames, pre-length_scale) —
        consumed by the cost-model bucket-window policy (infer/bucket_cost)."""
        return list(self._totals)

    # -- estimation ----------------------------------------------------------

    @property
    def global_mean(self) -> Optional[float]:
        n = self._dur_cnt.sum()
        return float(self._dur_sum.sum() / n) if n > 0 else None

    def estimate(self, token_ids: Sequence[int]) -> Optional[float]:
        """Expected total frames for this token sequence, or None if the
        table has no data yet."""
        g = self.global_mean
        if g is None:
            return None
        tok = np.asarray(token_ids, np.int64)
        cnt = self._dur_cnt[tok]
        mean = np.where(cnt > 0, self._dur_sum[tok] / np.maximum(cnt, 1), g)
        return float(mean.sum())

    @property
    def margin(self) -> float:
        """Residual quantile: multiply the estimate by this to cover
        ~`quantile` of requests."""
        if len(self._residuals) < 4:
            return self.max_margin
        q = float(np.quantile(self._residuals, self.quantile))
        return float(np.clip(q * 1.02, 1.0, self.max_margin))

    @property
    def ready(self) -> bool:
        return self._n_seen >= self.min_samples and self.global_mean is not None

    def guess_frames(self, token_ids: Sequence[int]) -> Optional[int]:
        """Speculative total-frame guess (estimate x residual margin), or
        None when not enough data has been observed to speculate safely."""
        if not self.ready:
            return None
        est = self.estimate(token_ids)
        if est is None or est <= 0:
            return None
        return int(np.ceil(est * self.margin))

    # -- persistence ---------------------------------------------------------

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(
                {
                    "n_vocab": self.n_vocab,
                    "min_samples": self.min_samples,
                    "quantile": self.quantile,
                    "max_margin": self.max_margin,
                    "max_residuals": self.max_residuals,
                    "dur_sum": self._dur_sum.tolist(),
                    "dur_cnt": self._dur_cnt.tolist(),
                    "residuals": self._residuals,
                    "totals": self._totals,
                    "n_seen": self._n_seen,
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "DurationCalibrator":
        with open(path) as f:
            d = json.load(f)
        cal = cls(
            n_vocab=d["n_vocab"], min_samples=d["min_samples"],
            quantile=d["quantile"], max_margin=d["max_margin"],
            max_residuals=int(d.get("max_residuals", 512)),
        )
        cal._dur_sum = np.asarray(d["dur_sum"], np.float64)
        cal._dur_cnt = np.asarray(d["dur_cnt"], np.float64)
        cal._residuals = list(d["residuals"])
        cal._totals = list(d.get("totals", []))
        cal._n_seen = int(d["n_seen"])
        return cal
