"""BigVGAN's anti-aliased snake activation (kernels K5 and K6; counterpart of
unitspeech_tpu/ops/pallas_kernels.py `fused_aa_snake_conv` and
`fused_aa_snake`, and of the resampling in unitspeech_tpu/models/vocoder.py).

The activation is 2x kaiser-sinc upsample -> snake / snakebeta -> 2x
kaiser-sinc downsample with replicate padding at the edges (reference
alias_free_torch/act.py:8-27); K5 fuses the dilated conv1d that follows it
in an AMP block, with its bias and an optional residual. Tensors are in the
port's vocoder layout (B, C, T); conv kernels keep flax's (k, Cin, Cout).

The plain versions are the XLA twin, and the kernels match them at every
sample, edges included. The Pallas kernels are exact only in the interior
(extended-LTI edges) and are not followed there. CUDA source:
csrc/aa_snake.cu, which states what bounds the kernels and how they are
laid out.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from unitspeech_tpu_torch.ops import _cuda

RATIO, KSIZE = 2, 12  # the 2x resampling filters of BigVGAN's activations


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
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, dtype=np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


def _prototype() -> np.ndarray:
    return kaiser_sinc_filter1d(0.5 / RATIO, 0.6 / RATIO, KSIZE)


def _filter(x, k):
    filt = torch.from_numpy(_prototype()).to(x.device, x.dtype)
    return filt.view(1, 1, k).expand(x.shape[1], 1, k)


def upsample1d(x, ratio: int = RATIO):
    """Anti-aliased 2x upsample of (B, C, T) (reference resample.py:10-35)."""
    k = int(6 * ratio // 2) * 2
    pad = k // ratio - 1
    pad_left = pad * ratio + (k - ratio) // 2
    pad_right = pad * ratio + (k - ratio + 1) // 2
    x = F.pad(x, (pad, pad), mode="replicate")
    y = ratio * F.conv_transpose1d(x, _filter(x, k), stride=ratio, groups=x.shape[1])
    return y[..., pad_left:y.shape[-1] - pad_right]


def downsample1d(x, ratio: int = RATIO):
    """Anti-aliased 2x downsample of (B, C, T) (reference resample.py:38-48)."""
    k = int(6 * ratio // 2) * 2
    pad_left, pad_right = k // 2 - int(k % 2 == 0), k // 2
    x = F.pad(x, (pad_left, pad_right), mode="replicate")
    return F.conv1d(x, _filter(x, k), stride=ratio, groups=x.shape[1])


@lru_cache(maxsize=1)
def phase_filters():
    """The resampling filters as the kernels apply them, derived from the
    padding rules of upsample1d / downsample1d:

      y2[2u + p] = sum_k f_p[k] x[clamp(u + off_p + k)]   (f_p carries the 2x gain)
      y[t]       = sum_i g[i]   z[clamp(2t + dn_off + i)]

    Returns (f0, f1, g, off0, off1, dn_off): numpy f32 taps and int offsets,
    in the convention of the JAX `_phase_filters()`."""
    filt = _prototype().astype(np.float64)
    k = KSIZE
    pad = k // RATIO - 1
    pad_left = pad * RATIO + (k - RATIO) // 2
    # conv_transpose: y2[m] = r * sum_i xp[i] filt[m + pad_left - r i], xp[i] = x[i - pad]
    phases, offs = [], []
    for p in range(RATIO):
        taps = {}
        for j in range(-k, k + 1):  # x index u + j for output 2u + p
            idx = p + pad_left - RATIO * (j + pad)
            if 0 <= idx < k:
                taps[j] = RATIO * filt[idx]
        lo = min(taps)
        offs.append(lo)
        phases.append(np.array([taps[lo + i] for i in range(len(taps))], np.float32))
    dn_off = -(k // 2 - int(k % 2 == 0))
    return phases[0], phases[1], _prototype().copy(), offs[0], offs[1], dn_off


def snake(x, alpha, beta, logscale: bool = True):
    """x + 1/(beta + 1e-9) sin^2(alpha x) per channel of (B, C, T), in x's
    dtype; Snake is snakebeta with beta = alpha (JAX vocoder.py:114-155)."""
    a = alpha.to(x.dtype)[None, :, None]
    b = beta.to(x.dtype)[None, :, None]
    if logscale:
        a, b = torch.exp(a), torch.exp(b)
    return x + (1.0 / (b + 1e-9)) * torch.sin(x * a) ** 2


def aa_snake_plain(x, alpha, beta, logscale: bool = True):
    """K6's plain version: downsample1d(snake(upsample1d(x))) on (B, C, T)."""
    return downsample1d(snake(upsample1d(x), alpha, beta, logscale))


def aa_snake_conv_plain(x, alpha, beta, w, bias, dilation: int = 1, residual=None,
                        logscale: bool = True):
    """K5's plain version: aa_snake_plain, then the zero-padded dilated conv1d
    with the flax kernel w (k, C, C) and bias, then + residual."""
    y = aa_snake_plain(x, alpha, beta, logscale)
    k = w.shape[0]
    y = F.conv1d(y, w.to(y.dtype).permute(2, 1, 0), bias.to(y.dtype),
                 padding=(k - 1) // 2 * dilation, dilation=dilation)
    return y if residual is None else y + residual


_taps_cache: dict = {}


def _taps(device) -> torch.Tensor:
    """(24,) f32 on the device: f0 | f1 | g, after checking that the
    offsets are the ones csrc/aa_snake.cu is written for."""
    t = _taps_cache.get(device)
    if t is None:
        f0, f1, g, off0, off1, dn_off = phase_filters()
        lib = _cuda.lib()
        want = tuple(lib.us_aa_offsets(i) for i in range(3))
        if (off0, off1, dn_off) != want or len(f0) != 6 or len(f1) != 6 or len(g) != 12:
            raise ValueError(f"aa_snake: filter offsets {(off0, off1, dn_off)} do not match "
                             f"the kernel's {want}")
        t = torch.from_numpy(np.concatenate([f0, f1, g])).to(device)
        _taps_cache[device] = t
    return t


def _snake_coeffs(alpha, beta, logscale):
    """(C,) f32 alpha and 1 / (beta + 1e-9), exponentiated where log-scale."""
    a, b = alpha.to(torch.float32), beta.to(torch.float32)
    if logscale:
        a, b = torch.exp(a), torch.exp(b)
    return a.contiguous(), (1.0 / (b + 1e-9)).contiguous()


def _check_x(what, x):
    if x.dim() != 3 or x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: expected (B, C, T) bf16, got {x.dtype} {tuple(x.shape)}")
    return _cuda.require(x, f"{what} x")


def _aa_snake_cuda(x, alpha, beta, logscale):
    _check_x("fused_aa_snake", x)
    b, c, t = x.shape
    a, ib = _snake_coeffs(alpha, beta, logscale)
    out = torch.empty_like(x)
    _cuda.check(_cuda.lib().us_aa_snake(x.data_ptr(), a.data_ptr(), ib.data_ptr(),
                                        _taps(x.device).data_ptr(), out.data_ptr(), b, c, t,
                                        _cuda.stream(x)), "fused_aa_snake")
    fused_aa_snake.launches += 1
    return out


def _aa_snake_conv_cuda(x, alpha, beta, w, bias, dilation, residual, logscale):
    _check_x("fused_aa_snake_conv", x)
    b, c, t = x.shape
    k = w.shape[0]
    if c % 32 or k % 2 == 0 or tuple(w.shape) != (k, c, c):
        raise ValueError(f"fused_aa_snake_conv: needs C % 32 == 0 and an odd (k, C, C) "
                         f"kernel, got C={c}, w {tuple(w.shape)}")
    dev = x.device
    wb = _cuda.require(w.to(torch.bfloat16).contiguous(), "w", device=dev)
    bias = _cuda.require(bias.to(torch.float32).contiguous(), "bias", shape=(c,), device=dev)
    if residual is not None:
        _cuda.require(residual, "residual", dtype=torch.bfloat16, shape=x.shape, device=dev)
    a, ib = _snake_coeffs(alpha, beta, logscale)
    out = torch.empty_like(x)
    _cuda.check(
        _cuda.lib().us_aa_snake_conv(x.data_ptr(), a.data_ptr(), ib.data_ptr(),
                                     _taps(dev).data_ptr(), wb.data_ptr(), bias.data_ptr(),
                                     _cuda.ptr(residual), out.data_ptr(), b, c, t, k,
                                     int(dilation), _cuda.stream(x)),
        "fused_aa_snake_conv")
    fused_aa_snake_conv.launches += 1
    return out


def fused_aa_snake(x, alpha, beta, logscale: bool = True):
    """Anti-aliased snake activation of (B, C, T); alpha, beta (C,) the raw
    snake parameters. CUDA tensors launch K6 (bf16), CPU tensors take
    aa_snake_plain."""
    if _cuda.route(x, "fused_aa_snake"):
        return _aa_snake_cuda(x, alpha, beta, logscale)
    return aa_snake_plain(x, alpha, beta, logscale)


fused_aa_snake.launches = 0


def fused_aa_snake_conv(x, alpha, beta, w, bias, dilation: int = 1, residual=None,
                        logscale: bool = True):
    """Anti-aliased snake of (B, C, T), then the dilated conv1d (flax kernel
    w (k, C, C), odd k, SAME zero padding) + bias, + residual (B, C, T) if
    given. CUDA tensors launch K5 (bf16), CPU tensors take
    aa_snake_conv_plain."""
    if _cuda.route(x, "fused_aa_snake_conv"):
        return _aa_snake_conv_cuda(x, alpha, beta, w, bias, dilation, residual, logscale)
    return aa_snake_conv_plain(x, alpha, beta, w, bias, dilation, residual, logscale)


fused_aa_snake_conv.launches = 0
