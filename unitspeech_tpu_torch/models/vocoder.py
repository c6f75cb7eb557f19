"""BigVGAN generator, plain PyTorch (counterpart of
unitspeech_tpu/models/vocoder.py `BigVGAN` with use_pallas=False;
reference vocoder/models.py:121-201): mel (B, T, num_mels) ->
wav (B, T * prod(upsample_rates)).

Weight norm is folded into plain kernels, as in the JAX package. The
anti-aliased snake activation is 2x kaiser-sinc upsample -> snake-beta ->
2x kaiser-sinc downsample with replicate padding at the edges (reference
alias_free_torch/act.py:8-27). Internally the generator runs in torch's
(B, C, T) layout; parameters keep flax's layout and names.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unitspeech_tpu_torch.models.layers import Conv1d, ConvTranspose1d


@lru_cache(maxsize=16)
def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass prototype summing to 1 (reference
    filter.py:28-57)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    time = (np.arange(-half_size, half_size) + 0.5) if even else (np.arange(kernel_size) - half_size)
    if cutoff == 0:
        return np.zeros(kernel_size, dtype=np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


def _filter(x, k):
    filt = torch.from_numpy(kaiser_sinc_filter1d(0.25, 0.3, k)).to(x.device, x.dtype)
    return filt.view(1, 1, k).expand(x.shape[1], 1, k)


def upsample1d(x, ratio: int = 2):
    """Anti-aliased 2x upsample of (B, C, T) (reference resample.py:10-35)."""
    k = int(6 * ratio // 2) * 2
    pad = k // ratio - 1
    pad_left = pad * ratio + (k - ratio) // 2
    pad_right = pad * ratio + (k - ratio + 1) // 2
    x = F.pad(x, (pad, pad), mode="replicate")
    y = ratio * F.conv_transpose1d(x, _filter(x, k), stride=ratio, groups=x.shape[1])
    return y[..., pad_left:y.shape[-1] - pad_right]


def downsample1d(x, ratio: int = 2):
    """Anti-aliased 2x downsample of (B, C, T) (reference resample.py:38-48)."""
    k = int(6 * ratio // 2) * 2
    pad_left, pad_right = k // 2 - int(k % 2 == 0), k // 2
    x = F.pad(x, (pad_left, pad_right), mode="replicate")
    return F.conv1d(x, _filter(x, k), stride=ratio, groups=x.shape[1])


class SnakeBeta(nn.Module):
    """x + 1/(beta + 1e-9) sin^2(alpha x), log-scale alpha/beta."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(channels))
        self.beta = nn.Parameter(torch.empty(channels))

    def forward(self, x):
        alpha = torch.exp(self.alpha.to(x.dtype))[None, :, None]
        beta = torch.exp(self.beta.to(x.dtype))[None, :, None]
        return x + (1.0 / (beta + 1e-9)) * torch.sin(x * alpha) ** 2


class AntiAliasedActivation(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.act = SnakeBeta(channels)

    def forward(self, x):
        return downsample1d(self.act(upsample1d(x)))


class AMPBlock1(nn.Module):
    """3x (aa-act -> dilated conv -> aa-act -> conv) with residuals
    (reference models.py:18-76)."""

    def __init__(self, channels: int, kernel_size: int, dilation):
        super().__init__()
        self.k, self.dilation = kernel_size, tuple(dilation)
        for i in range(len(self.dilation)):
            self.add_module(f"act1_{i}", AntiAliasedActivation(channels))
            self.add_module(f"conv1_{i}", Conv1d(channels, channels, kernel_size))
            self.add_module(f"act2_{i}", AntiAliasedActivation(channels))
            self.add_module(f"conv2_{i}", Conv1d(channels, channels, kernel_size))

    def forward(self, x):
        for i, d in enumerate(self.dilation):
            xt = getattr(self, f"act1_{i}")(x)
            xt = getattr(self, f"conv1_{i}").ncw(xt, (self.k * d - d) // 2, d)
            xt = getattr(self, f"act2_{i}")(xt)
            xt = getattr(self, f"conv2_{i}").ncw(xt, (self.k - 1) // 2, 1)
            x = xt + x
        return x


class BigVGAN(nn.Module):
    def __init__(self, num_mels=80, upsample_rates=(8, 8, 2, 2),
                 upsample_kernel_sizes=(16, 16, 4, 4), upsample_initial_channel=512,
                 resblock_kernel_sizes=(3, 7, 11), resblock_dilation_sizes=((1, 3, 5),) * 3,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n_up, self.num_kernels = len(upsample_rates), len(resblock_kernel_sizes)
        self.conv_pre = Conv1d(num_mels, upsample_initial_channel, 7)
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            cin, ch = ch, upsample_initial_channel // (2 ** (i + 1))
            # torch ConvTranspose1d(k, u, padding=(k-u)//2): T -> T*u
            self.add_module(f"up_{i}", ConvTranspose1d(cin, ch, k, u, (k - 1) - (k - u) // 2))
            for j, (rk, rd) in enumerate(zip(resblock_kernel_sizes, resblock_dilation_sizes)):
                self.add_module(f"resblock_{i}_{j}", AMPBlock1(ch, rk, rd))
        self.act_post = SnakeBeta(ch)
        self.conv_post = Conv1d(ch, 1, 7)

    def forward(self, mel):
        x = self.conv_pre.ncw(mel.to(self.dtype).transpose(1, 2), 3)
        for i in range(self.n_up):
            x = getattr(self, f"up_{i}").ncw(x)
            xs = None
            for j in range(self.num_kernels):
                y = getattr(self, f"resblock_{i}_{j}")(x)
                xs = y if xs is None else xs + y
            x = xs / self.num_kernels
        x = downsample1d(self.act_post(upsample1d(x)))
        x = self.conv_post.ncw(x, 3)
        return torch.tanh(x)[:, 0, :].to(torch.float32)

    @classmethod
    def from_config(cls, cfg, dtype=torch.float32):
        if cfg.resblock != "1" or cfg.activation != "snakebeta" or not cfg.snake_logscale:
            raise NotImplementedError("the port has the resblock-1 / log-scale snakebeta "
                                      "generator only")
        return cls(cfg.num_mels, tuple(cfg.upsample_rates), tuple(cfg.upsample_kernel_sizes),
                   cfg.upsample_initial_channel, tuple(cfg.resblock_kernel_sizes),
                   tuple(tuple(d) for d in cfg.resblock_dilation_sizes), dtype=dtype)
