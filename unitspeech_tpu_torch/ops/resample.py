"""The estimator's strided resampling convs (kernels K11a and K11b;
counterpart of unitspeech_tpu/ops/pallas_resample.py `fused_downsample_conv`
and `fused_upsample_conv`).

Downsample is conv3x3 stride 2 'SAME', Upsample ConvTranspose 4x4 stride 2
with flax padding (2, 2) (torch padding 1). Both take the unmasked
activation and the (B, T, 1, 1) prefix mask: input rows at/after the
length read zero, so the estimator skips its `h * mask` pass, and the bias
lands on every output row, as nn.Conv / nn.ConvTranspose put it. CUDA
source: csrc/resample.cu, which states what bounds the kernels and how
they are laid out.

Numerics contract (the Pallas kernels'): bf16 products (the flax kernel is
rounded to the activation dtype), an f32 accumulator plus the f32 bias,
rounded once to the activation dtype.

The gates `supports_downsample` / `supports_upsample` are the JAX
package's own (TPU tilings that fit VMEM with 8-aligned blocks); the port
keeps them so that it routes the sites JAX routes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unitspeech_tpu_torch.models.layers import conv_transpose_weight
from unitspeech_tpu_torch.ops import _cuda
from unitspeech_tpu_torch.ops.fused_resnet import lens_rows_from_mask


def _pick_fpt_down(t_out: int, f: int, c_max: int, budget_bytes: int = 6 * 1024 * 1024):
    """pallas_resample._pick_fpt_down: output frames per TPU tile, or None."""
    best, best_key = None, None
    for k in range(1, t_out + 1):
        if t_out % k:
            continue
        if (k * (f // 2)) % 8:
            continue
        rows = (2 * k + 1) * f
        if rows * c_max * 6 + 9 * c_max * c_max * 2 > budget_bytes:
            continue
        key = (abs(rows - 1024), -k)
        if best_key is None or key < best_key:
            best, best_key = k, key
    return best


def _pick_fpt_up(t: int, f: int, c_max: int, budget_bytes: int = 6 * 1024 * 1024):
    """pallas_resample._pick_fpt_up: input frames per TPU tile, or None."""
    best, best_key = None, None
    for k in range(1, t + 1):
        if t % k:
            continue
        if (2 * k * f) % 8:
            continue
        rows = (k + 2) * f
        if (rows * c_max * 2 + 4 * k * f * c_max * 4
                + 16 * c_max * c_max * 2 + 8 * k * f * c_max) > budget_bytes:
            continue
        key = (abs(rows - 1024), -k)
        if best_key is None or key < best_key:
            best, best_key = k, key
    return best


def supports_downsample(t: int, f: int, c_max: int) -> bool:
    """The JAX gate (pallas_resample.supports_downsample): the estimator's
    F = 80 and F = 40 downsamples."""
    return t % 2 == 0 and f % 8 == 0 and _pick_fpt_down(t // 2, f, c_max) is not None


def supports_upsample(t: int, f: int, c_max: int) -> bool:
    """The JAX gate (pallas_resample.supports_upsample): the estimator's
    F = 40 upsample."""
    return f % 8 == 0 and _pick_fpt_up(t, f, c_max) is not None


def _masked_nchw(x, mask):
    """(B, T, F, C) in the activation dtype -> masked f32 (B, C, T, F)."""
    return (x * mask.to(x.dtype)).to(torch.float32).permute(0, 3, 1, 2)


def downsample_conv_plain(x, mask, kernel, bias):
    """The K11a kernel's plain version: x (B, T, F, Cin), kernel (3, 3, Cin,
    Cout) flax layout -> (B, T/2, F/2, Cout) in x's dtype."""
    w = kernel.to(x.dtype).to(torch.float32).permute(3, 2, 0, 1)
    y = F.conv2d(_masked_nchw(x, mask), w, bias.to(torch.float32), stride=2, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def upsample_conv_plain(x, mask, kernel, bias):
    """The K11b kernel's plain version: x (B, T, F, Cin), kernel (4, 4, Cin,
    Cout) flax ConvTranspose layout (unflipped) -> (B, 2T, 2F, Cout)."""
    w = conv_transpose_weight(kernel.to(x.dtype).to(torch.float32))
    y = F.conv_transpose2d(_masked_nchw(x, mask), w, bias.to(torch.float32), stride=2,
                           padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def _resample_cuda(fn, what, x, mask, kernel, bias, taps, rows_out):
    b, t, f, cin = x.shape
    cout = kernel.shape[-1]
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the kernel takes bf16 activations, got {x.dtype}")
    if cin % 8 or cout % 64:
        raise ValueError(f"{what}: unsupported Cin={cin}, Cout={cout} (Cin % 8, Cout % 64)")
    dev = x.device
    x = _cuda.require(x.contiguous(), "x", dtype=torch.bfloat16)
    w = _cuda.require(kernel.to(torch.bfloat16).reshape(taps * cin, cout).contiguous(), "kernel",
                      device=dev)
    bias = _cuda.require(bias.to(torch.float32).contiguous(), "bias", shape=(cout,), device=dev)
    lens = lens_rows_from_mask(mask, f)
    out = torch.empty((b, rows_out, cout), dtype=x.dtype, device=dev)
    _cuda.check(fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), lens.data_ptr(), out.data_ptr(),
                   b, t, f, cin, cout, _cuda.stream(x)), what)
    return out


def fused_downsample_conv(x, mask, kernel, bias):
    """Masked conv3x3 stride 2: x (B, T, F, Cin), T and F even, mask
    (B, T, 1, 1), kernel (3, 3, Cin, Cout) -> (B, T/2, F/2, Cout). CUDA
    tensors launch the kernel, CPU tensors take downsample_conv_plain."""
    b, t, f, _ = x.shape
    if _cuda.route(x, "fused_downsample_conv"):
        out = _resample_cuda(_cuda.lib().us_downsample_conv, "fused_downsample_conv", x, mask,
                             kernel, bias, 9, (t // 2) * (f // 2))
        fused_downsample_conv.launches += 1
        return out.reshape(b, t // 2, f // 2, -1)
    return downsample_conv_plain(x, mask, kernel, bias)


fused_downsample_conv.launches = 0


def fused_upsample_conv(x, mask, kernel, bias):
    """Masked ConvTranspose 4x4 stride 2 (flax padding 2): x (B, T, F, Cin),
    mask (B, T, 1, 1), kernel (4, 4, Cin, Cout) unflipped -> (B, 2T, 2F,
    Cout). CUDA tensors launch the kernel, CPU tensors take
    upsample_conv_plain."""
    b, t, f, _ = x.shape
    if _cuda.route(x, "fused_upsample_conv"):
        out = _resample_cuda(_cuda.lib().us_upsample_conv, "fused_upsample_conv", x, mask,
                             kernel, bias, 16, 4 * t * f)
        fused_upsample_conv.launches += 1
        return out.reshape(b, 2 * t, 2 * f, -1)
    return upsample_conv_plain(x, mask, kernel, bias)


fused_upsample_conv.launches = 0
