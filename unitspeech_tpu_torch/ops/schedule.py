"""Reverse-DDPM schedule, closed form (counterpart of
unitspeech_tpu/ops/schedule.py `make_reverse_schedule`; reference
unitspeech.py:235-296, 360-370).

Host-side numpy float64, folded into three per-step scalars:

    x_{i+1} = (c_x[i] * x_i + c_score[i] * score_i + c_noise[i] * eps) * mask
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np


@dataclass(frozen=True)
class ReverseSchedule:
    """Per-step coefficients in sampler order (step 0 = t closest to 1),
    each (n_timesteps,) float32."""

    n_timesteps: int
    t_cont: np.ndarray
    c_x: np.ndarray
    c_score: np.ndarray
    c_noise: np.ndarray


@lru_cache(maxsize=64)
def make_reverse_schedule(
    n_timesteps: int, beta_min: float = 0.05, beta_max: float = 20.0, eta: float = 1.0
) -> ReverseSchedule:
    n = n_timesteps
    j = np.arange(n, dtype=np.float64)
    t = (j + 0.5) / n
    lam = beta_min * t + 0.5 * (beta_max - beta_min) * t ** 2
    ac = np.exp(-lam)
    ac_prev = np.concatenate([[1.0], ac[:-1]])
    beta = 1.0 - ac / ac_prev
    pv = beta * (1.0 - ac_prev) / (1.0 - ac)
    sigma2 = (eta ** 2) * pv

    sqrt_om_ac = np.sqrt(1.0 - ac)
    c_x = np.sqrt(ac_prev / ac)
    c_score = np.sqrt(ac_prev) * np.sqrt(1.0 / ac - 1.0) * sqrt_om_ac - np.sqrt(
        np.clip(1.0 - ac_prev - sigma2, 0.0, None)
    ) * sqrt_om_ac
    c_noise = eta * np.sqrt(pv)
    c_noise[0] = 0.0  # the final step adds no noise

    rev = slice(None, None, -1)
    return ReverseSchedule(
        n_timesteps=n,
        t_cont=t[rev].astype(np.float32).copy(),
        c_x=c_x[rev].astype(np.float32).copy(),
        c_score=c_score[rev].astype(np.float32).copy(),
        c_noise=c_noise[rev].astype(np.float32).copy(),
    )
