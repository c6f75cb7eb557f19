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
laid out: K5 writes the activation once per element (bf16, channels-last)
and runs the conv on a TMA + wgmma loop whose weights, f32 bias and snake
coefficients are packed once (`pack_aa_conv`, `pack_snake`; the vocoder
packs them when its weights load). `takes` states the widths K5 takes.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from unitspeech_tpu_torch.ops import _cuda
from unitspeech_tpu_torch.ops.resample import KC, pad_chunks, swizzle128

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


class SnakePacked(NamedTuple):
    """The snake coefficients as the kernels read them, made once at load:
    (C,) f32 a = alpha and ib = 1 / (beta + 1e-9), exponentiated first where
    log-scale."""
    a: torch.Tensor
    ib: torch.Tensor


class AaConvPacked(NamedTuple):
    """What K5 reads of an activation and the conv after it, made once at
    load (pack_aa_conv): the snake coefficients, the f32 bias and the conv
    kernel in the tiles of pack_conv_weight with Cout tiles of `bn`."""
    snake: SnakePacked
    bias: torch.Tensor
    w: torch.Tensor
    bn: int


CONV_BM = 128  # time rows of K5's conv tile: two warpgroups of 64
# The largest reach R = (k - 1) / 2 * d K5 takes: up to it three slots of
# its box (128 + 2 R rows) fit shared memory beside the weight ring at any
# Cout tile (BigVGAN's convs reach 25 samples at most)
MAX_REACH = 128


def pack_snake(alpha, beta, logscale: bool = True) -> SnakePacked:
    """(C,) raw snake parameters -> the kernels' f32 coefficients."""
    a, b = alpha.detach().to(torch.float32), beta.detach().to(torch.float32)
    if logscale:
        a, b = torch.exp(a), torch.exp(b)
    return SnakePacked(a.contiguous(), (1.0 / (b + 1e-9)).contiguous())


def conv_cols(c: int) -> int:
    """The Cout tile (BN) of K5's conv: the whole width up to 128 (32, 64 or
    128), 64 above it where 64 divides C (128-column tiles would leave most
    of the card idle at the vocoder's first stage, C = 256: 22 time tiles),
    else 32 (C = 96, 160, ...)."""
    if c in (32, 64, 128):
        return c
    if c > 0 and c % 32 == 0:
        return 64 if c % 64 == 0 else 32
    raise ValueError(f"K5: no Cout tile for C={c}")


def takes(c: int, k: int, d: int = 1) -> bool:
    """The widths K5's CUDA kernels take: C a multiple of 32, an odd conv
    width k and a reach (k-1)/2 * d of at most MAX_REACH samples (K6 takes
    any C)."""
    return c > 0 and c % 32 == 0 and k % 2 == 1 and d >= 1 and (k - 1) // 2 * d <= MAX_REACH


def pack_conv_weight(w, bn=None) -> torch.Tensor:
    """A flax conv1d kernel (k, C, C) -> K5's bf16 tiles (C / BN, chunks, k,
    BN, 64), each K-major in the 128-byte swizzle, C padded to whole
    64-channel chunks with zero rows (BN = conv_cols(C))."""
    k, cin, cout = w.shape
    bn = conv_cols(cout) if bn is None else bn
    wp, nc = pad_chunks(w.detach().to(torch.bfloat16), cin)
    wp = wp.reshape(k, nc, KC, cout // bn, bn).permute(3, 1, 0, 4, 2)
    return swizzle128(wp).contiguous()


def pack_aa_conv(alpha, beta, w, bias, logscale: bool = True) -> AaConvPacked:
    """Everything K5 reads of one AMP-block activation and its conv."""
    return AaConvPacked(pack_snake(alpha, beta, logscale),
                        bias.detach().to(torch.float32).contiguous(), pack_conv_weight(w),
                        conv_cols(w.shape[-1]))


def conv_plan(b: int, c: int, t: int, k: int, d: int) -> dict:
    """K5's conv launch plan as csrc/aa_snake.cu makes it (us_aa_conv_plan):
    box rows and bytes, box slots, blocks, threads, dynamic shared memory,
    blocks an SM holds, whether it is the resident-weight form (C <= 64
    where it fits: every tap's weights in shared memory, a persistent grid
    over the time tiles) or the ring form, and the TMA copies (pieces of at
    most 256 rows) a box takes."""
    import ctypes

    info = (ctypes.c_int * 9)()
    _cuda.check(_cuda.lib().us_aa_conv_plan(b, c, t, k, d, conv_cols(c), info), "us_aa_conv_plan")
    keys = ("box_rows", "box_bytes", "boxes", "blocks", "threads", "smem", "blocks_per_sm",
            "resident", "pieces")
    out = dict(zip(keys, info))
    out["resident"] = bool(out["resident"])
    return out


_taps_host = None


def _taps():
    """The 24 f32 taps f0 | f1 | g as a host array the launches copy into
    the kernels' parameters, after checking that the offsets are the ones
    csrc/aa_snake.cu is written for."""
    global _taps_host
    if _taps_host is None:
        import ctypes

        f0, f1, g, off0, off1, dn_off = phase_filters()
        lib = _cuda.lib()
        want = tuple(lib.us_aa_offsets(i) for i in range(3))
        if (off0, off1, dn_off) != want or len(f0) != 6 or len(f1) != 6 or len(g) != 12:
            raise ValueError(f"aa_snake: filter offsets {(off0, off1, dn_off)} do not match "
                             f"the kernel's {want}")
        _taps_host = (ctypes.c_float * 24)(*np.concatenate([f0, f1, g]).tolist())
    return _taps_host


def _check_x(what, x):
    if x.dim() != 3 or x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: expected (B, C, T) bf16, got {x.dtype} {tuple(x.shape)}")
    return _cuda.require(x, f"{what} x")


def _check_snake(what, sp: SnakePacked, c, dev):
    for name, v in zip(("a", "ib"), sp):
        _cuda.require(v, f"{what} {name}", dtype=torch.float32, shape=(c,), device=dev)


def _aa_snake_cuda(x, alpha, beta, logscale, packed):
    _check_x("fused_aa_snake", x)
    b, c, t = x.shape
    sp = pack_snake(alpha, beta, logscale) if packed is None else packed
    _check_snake("fused_aa_snake", sp, c, x.device)
    out = torch.empty_like(x)
    _cuda.check(_cuda.lib().us_aa_snake(x.data_ptr(), sp.a.data_ptr(), sp.ib.data_ptr(), _taps(),
                                        out.data_ptr(), b, c, t, _cuda.stream(x)),
                "fused_aa_snake")
    fused_aa_snake.launches += 1
    return out


def _aa_snake_conv_cuda(x, alpha, beta, w, bias, dilation, residual, logscale, packed):
    _check_x("fused_aa_snake_conv", x)
    b, c, t = x.shape
    k, d = w.shape[0], int(dilation)
    if not takes(c, k, d) or tuple(w.shape) != (k, c, c):
        raise ValueError(f"fused_aa_snake_conv: needs C a multiple of 32, an odd (k, C, C) "
                         f"kernel and (k-1)/2 * d <= {MAX_REACH}, got C={c}, w "
                         f"{tuple(w.shape)}, d={d}")
    dev = x.device
    pk = pack_aa_conv(alpha, beta, w, bias, logscale) if packed is None else packed
    _check_snake("fused_aa_snake_conv", pk.snake, c, dev)
    _cuda.require(pk.bias, "bias", dtype=torch.float32, shape=(c,), device=dev)
    _cuda.require(pk.w, "packed w", dtype=torch.bfloat16, device=dev)
    if pk.w.numel() != k * -(-c // KC) * KC * c or pk.bn != conv_cols(c):
        raise ValueError(f"fused_aa_snake_conv: packed w {tuple(pk.w.shape)} (BN {pk.bn}) is "
                         f"not the tiles of a ({k}, {c}, {c}) kernel")
    if residual is not None:
        _cuda.require(residual, "residual", dtype=torch.bfloat16, shape=x.shape, device=dev)
    y = torch.empty((b, t, c), dtype=torch.bfloat16, device=dev)  # AA(x), channels-last
    out = torch.empty_like(x)
    _cuda.check(
        _cuda.lib().us_aa_snake_conv(x.data_ptr(), pk.snake.a.data_ptr(), pk.snake.ib.data_ptr(),
                                     _taps(), y.data_ptr(), pk.w.data_ptr(), pk.bn,
                                     pk.bias.data_ptr(), _cuda.ptr(residual), out.data_ptr(), b,
                                     c, t, k, d, _cuda.stream(x)),
        "fused_aa_snake_conv")
    fused_aa_snake_conv.launches += 1
    return out


def fused_aa_snake(x, alpha, beta, logscale: bool = True, packed: SnakePacked = None):
    """Anti-aliased snake activation of (B, C, T); alpha, beta (C,) the raw
    snake parameters, `packed` their pack_snake (made on the spot if None).
    CUDA tensors launch K6 (bf16), CPU tensors take aa_snake_plain."""
    if _cuda.route(x, "fused_aa_snake"):
        return _aa_snake_cuda(x, alpha, beta, logscale, packed)
    return aa_snake_plain(x, alpha, beta, logscale)


fused_aa_snake.launches = 0


def fused_aa_snake_conv(x, alpha, beta, w, bias, dilation: int = 1, residual=None,
                        logscale: bool = True, packed: AaConvPacked = None):
    """Anti-aliased snake of (B, C, T), then the dilated conv1d (flax kernel
    w (k, C, C), odd k, SAME zero padding) + bias, + residual (B, C, T) if
    given; `packed` is pack_aa_conv of the parameters (made on the spot if
    None: the vocoder makes it once at load). CUDA tensors launch K5 (bf16;
    two kernels: the activation, then the conv), CPU tensors take
    aa_snake_conv_plain."""
    if _cuda.route(x, "fused_aa_snake_conv"):
        return _aa_snake_conv_cuda(x, alpha, beta, w, bias, dilation, residual, logscale,
                                   packed)
    return aa_snake_conv_plain(x, alpha, beta, w, bias, dilation, residual, logscale)


fused_aa_snake_conv.launches = 0
