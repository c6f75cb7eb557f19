"""Diffusion noise schedules, closed form (counterpart of
unitspeech_tpu/ops/schedule.py; reference unitspeech.py:204-209, 235-296,
360-384).

The forward process q(x_t | x_0) for the fine-tune's loss
(`forward_diffusion_coefficients`, on tensors), and the reverse-DDPM
schedule, host-side numpy float64 folded into three per-step scalars:

    x_{i+1} = (c_x[i] * x_i + c_score[i] * score_i + c_noise[i] * eps) * mask

and the DPM-Solver++(2M) probability-flow schedule of the `dpm2` sampler
(`make_ode_schedule`), seven per-step scalars on a uniform log-SNR grid.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch


def get_noise(t, beta_min: float, beta_max: float, cumulative: bool = False):
    """beta(t), or Lambda(t) = int_0^t beta(s) ds with cumulative, for the
    linear schedule (reference unitspeech.py:204-209)."""
    if cumulative:
        return beta_min * t + 0.5 * (beta_max - beta_min) * (t ** 2)
    return beta_min + (beta_max - beta_min) * t


def forward_diffusion_coefficients(t: torch.Tensor, beta_min: float, beta_max: float):
    """(mean_coef, std) of q(x_t | x_0), each shaped like t: mean = x0 *
    exp(-Lambda(t) / 2), var = 1 - exp(-Lambda(t)) (reference
    unitspeech.py:376-384)."""
    cum = get_noise(t, beta_min, beta_max, cumulative=True)
    return torch.exp(-0.5 * cum), torch.sqrt(1.0 - torch.exp(-cum))


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


@dataclass(frozen=True)
class OdeSchedule:
    """Per-step coefficients of the DPM-Solver++(2M) probability-flow
    sampler (deterministic, no noise), each (n_timesteps,) float32; step i
    advances t_{i-1} -> t_i:

      t_eval:  the time the estimator is evaluated at (t_{i-1})
      a:       sigma_i / sigma_{i-1}
      b:       alpha_i * (1 - exp(-h_i))
      c1, c2:  D_i = c1 * x0(x_{i-1}) + c2 * x0_prev (the first step's
               c1 = 1, c2 = 0: a DDIM step)
      inv_alpha, sigma2: of t_{i-1}, for x0 = (x + sigma^2 * score) / alpha
    """

    n_timesteps: int
    t_eval: np.ndarray
    a: np.ndarray
    b: np.ndarray
    c1: np.ndarray
    c2: np.ndarray
    inv_alpha: np.ndarray
    sigma2: np.ndarray

    def stacked(self) -> np.ndarray:
        """(N, 7) float32: t_eval, a, b, c1, c2, inv_alpha, sigma2."""
        return np.stack([self.t_eval, self.a, self.b, self.c1, self.c2, self.inv_alpha,
                         self.sigma2], axis=1)


def _lambda_of_t(t, beta_min, beta_max):
    """Half the log-SNR, log(alpha_t / sigma_t), of the linear schedule."""
    lam_cum = beta_min * t + 0.5 * (beta_max - beta_min) * t ** 2
    alpha2 = np.exp(-lam_cum)
    return 0.5 * (np.log(alpha2) - np.log(1.0 - alpha2))


@lru_cache(maxsize=64)
def make_ode_schedule(n_timesteps: int, beta_min: float = 0.05, beta_max: float = 20.0,
                      t_start: float = 1.0, t_end: float = 0.01) -> OdeSchedule:
    """DPM-Solver++(2M) coefficients on a uniform log-SNR grid from t_start
    down to t_end (0.01: the 50-step DDPM grid's finest midpoint), host-side
    float64; t(lambda) is a bisection on the monotone lambda(t)."""
    n = n_timesteps
    lams = np.linspace(_lambda_of_t(np.float64(t_start), beta_min, beta_max),
                       _lambda_of_t(np.float64(t_end), beta_min, beta_max), n + 1)

    def t_of_lambda(lam):
        lo, hi = t_end * 1e-3, 1.0
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if _lambda_of_t(mid, beta_min, beta_max) > lam:
                lo = mid
            else:
                hi = mid
        return 0.5 * (lo + hi)

    ts = np.array([t_start] + [t_of_lambda(v) for v in lams[1:-1]] + [t_end])
    lam_cum = beta_min * ts + 0.5 * (beta_max - beta_min) * ts ** 2
    alpha = np.exp(-0.5 * lam_cum)
    sigma = np.sqrt(1.0 - alpha ** 2)
    h = lams[1:] - lams[:-1]
    c1, c2 = np.ones(n), np.zeros(n)
    if n > 1:
        r = h[:-1] / h[1:]
        c1[1:] = 1.0 + 1.0 / (2.0 * r)
        c2[1:] = -1.0 / (2.0 * r)
    f32 = lambda v: np.asarray(v, np.float64).astype(np.float32)  # noqa: E731
    return OdeSchedule(n_timesteps=n, t_eval=f32(ts[:-1]), a=f32(sigma[1:] / sigma[:-1]),
                       b=f32(alpha[1:] * (1.0 - np.exp(-h))), c1=f32(c1), c2=f32(c2),
                       inv_alpha=f32(1.0 / alpha[:-1]), sigma2=f32(sigma[:-1] ** 2))
