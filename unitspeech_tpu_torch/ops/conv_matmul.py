"""The deep-stage conv3x3 over flattened rows (counterpart of
unitspeech_tpu/ops/conv_matmul.py `conv3x3_taps` / `conv3x3_im2col`,
`conv3x3_int8` and `choose_conv_impl`).

JAX computes the deep-stage convs as matmuls outside any Pallas kernel
(unet.py `_flat_matmul_block`), so here they are library products too:

  * bf16: the f32 accumulator of bf16 products, as JAX's
    `preferred_element_type=jnp.float32` keeps it. On the card an im2col
    column tensor and one bf16 GEMM with an f32 output; on the CPU an f32
    conv over the bf16 values (each product is exact in f32).
  * int8: a per-tensor activation scale from the row-absmax kernel K7, per
    output channel weight scales, an int8 im2col and an int8 x int8 -> int32
    GEMM, then the f32 dequantize.

On a frame slice of the seq axis (`seq`, a parallel.FrameSlice) the convs
read the neighbours' edge frame on each side (a halo, zeros at the global
ends) and write the slice's rows, and the int8 scale comes from K7's
maxima taken over the axis: the one scale of the unsharded tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unitspeech_tpu_torch.ops.row_stats import row_absmax


def choose_conv_impl(cin: int, cout: int) -> str:
    """Which ResnetBlocks run on flattened rows: the deep stages
    (max(cin, cout) >= 512, where the JAX package picks a matmul conv)
    take "flat", the others "conv"."""
    return "flat" if max(cin, cout) >= 512 else "conv"


def im2col(xf: torch.Tensor, f: int, halo: bool = False) -> torch.Tensor:
    """(B, T*F, Cin) rows -> (B, T*F, 9*Cin) columns of the SAME 3x3 window on
    the (T, F) grid, zeros outside it; column order (dt, df) row-major, which
    matches a flax (3, 3, Cin, Cout) kernel reshaped to (9*Cin, Cout). halo:
    xf holds one extra frame on each side ((T + 2) * F rows), which stand
    where the zero frames would: the columns of the T interior frames."""
    b, n, cin = xf.shape
    t = n // f - (2 if halo else 0)
    pt = 0 if halo else 1
    xp = F.pad(xf.reshape(b, n // f, f, cin), (0, 0, 1, 1, pt, pt))
    cols = [xp[:, dt:dt + t, df:df + f] for dt in range(3) for df in range(3)]
    return torch.cat(cols, dim=-1).reshape(b, t * f, 9 * cin)


def halo_rows(xf: torch.Tensor, f: int, seq, lens_rows=None) -> torch.Tensor:
    """(B, T*F, C) rows of a frame slice -> ((T + 2) * F) rows with the
    neighbours' edge frames (seq.halo); lens_rows: the slice's valid rows,
    masking the frames it sends (an input its reader masks itself)."""
    b, n, c = xf.shape
    t = n // f
    mask = None
    if lens_rows is not None:
        mask = torch.arange(t, device=xf.device)[None, :] * f < lens_rows[:, None]
    return seq.halo(xf.reshape(b, t, f, c), mask=mask).reshape(b, n + 2 * f, c)


class _MatmulF32(torch.autograd.Function):
    """The card's bf16 GEMM with an f32 output under autograd (torch.mm with
    out_dtype has no derivative). The backward products run in f32 on the
    bf16 operands and the f32 cotangent, then round to the operands'
    dtype."""

    @staticmethod
    def forward(ctx, a2, w):
        ctx.save_for_backward(a2, w)
        return torch.mm(a2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a2, w = ctx.saved_tensors
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = (g @ w.to(torch.float32).t()).to(a2.dtype)
        if ctx.needs_input_grad[1]:
            gw = (a2.to(torch.float32).t() @ g).to(w.dtype)
        return ga, gw


def matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) -> (..., N) f32: the f32 accumulator of products in
    a's dtype (w is rounded to it first), as JAX's einsum with
    preferred_element_type=jnp.float32 keeps it. Differentiable (the
    fine-tune's plain estimator runs it under autograd)."""
    w = w.to(a.dtype)
    if a.is_cuda and a.dtype == torch.bfloat16:
        a2 = a.reshape(-1, a.shape[-1])
        if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
            y = _MatmulF32.apply(a2, w)
        else:
            y = torch.mm(a2, w, out_dtype=torch.float32)
        return y.reshape(*a.shape[:-1], -1)
    return a.to(torch.float32) @ w.to(torch.float32)


def conv3x3_rows(xf: torch.Tensor, w: torch.Tensor, f: int, seq=None) -> torch.Tensor:
    """SAME conv3x3 over (B, T*F, Cin) rows with a flax (3, 3, Cin, Cout)
    kernel (spatial (t, f)), or that kernel as the kernels read it,
    (9*Cin, Cout) -> (B, T*F, Cout) f32: the f32 accumulator of products of
    the input's dtype (the weight is rounded to that dtype first). seq: xf
    is a frame slice; the neighbours' edge frames stand in for the zero
    padding."""
    if seq is None:
        return _conv3x3(xf, w, f, halo=False)
    return _conv3x3(halo_rows(xf, f, seq), w, f, halo=True)


def conv3x3_halo_rows(xh: torch.Tensor, w: torch.Tensor, f: int) -> torch.Tensor:
    """conv3x3_rows of the T interior frames of a halo'd input xh (B, (T +
    2) * F, Cin): its edge frames stand where the zero frames would."""
    return _conv3x3(xh, w, f, halo=True)


def _conv3x3(xf, w, f, halo):
    b, n, cin = xf.shape
    w = w.reshape(9 * cin, -1).to(xf.dtype)
    if xf.is_cuda and xf.dtype == torch.bfloat16:
        return matmul_f32(im2col(xf, f, halo), w)
    x4 = xf.to(torch.float32).reshape(b, n // f, f, cin).permute(0, 3, 1, 2)
    w4 = w.to(torch.float32).reshape(3, 3, cin, -1).permute(3, 2, 0, 1)
    y = F.conv2d(x4, w4, padding=(0 if halo else 1, 1))
    return y.permute(0, 2, 3, 1).reshape(b, -1, y.shape[1])


def quantize_weight(w: torch.Tensor):
    """A conv kernel (..., Cout) -> (w8t (Cout, K) int8, sw (Cout,) f32):
    symmetric per-output-channel scales over the (K, Cout) matrix, round
    half to even, clip to +-127 (JAX conv3x3_int8). w8t is stored
    transposed, the column-major operand the int8 GEMM takes."""
    wm = w.to(torch.float32).reshape(-1, w.shape[-1])
    sw = 127.0 / torch.clamp(wm.abs().amax(dim=0), min=1e-8)
    w8 = torch.clamp(torch.round(wm * sw), -127, 127).to(torch.int8)
    return w8.t().contiguous(), sw


def quantize_activation(xf: torch.Tensor, absmax=row_absmax, seq=None):
    """(B, n, C) -> (x8 int8, sx f32 scalar): ONE symmetric scale over the
    whole tensor (all CFG rows), 127 / max|x| from the per-channel row
    abs-max, round half to even, clip to +-127. seq: xf is a frame slice;
    the maxima are taken over the axis first, so the scale is the whole
    tensor's."""
    m = absmax(xf)
    if seq is not None:
        m = seq.all_max(m)
    sx = 127.0 / torch.clamp(m.amax(), min=1e-8)
    x8 = torch.clamp(torch.round(xf.to(torch.float32) * sx), -127, 127).to(torch.int8)
    return x8, sx


def conv3x3_int8(xf: torch.Tensor, w: torch.Tensor, f: int, wq=None,
                 absmax=row_absmax, seq=None) -> torch.Tensor:
    """int8 im2col conv3x3 over (B, T*F, Cin) rows -> (B, T*F, Cout) f32.
    w: the flax kernel; wq: its quantize_weight(w), when precomputed. The
    int32 product is exact; the dequantize is y * (1 / (sx * sw)). seq: xf
    is a frame slice: the scale from the maxima over the axis, the
    neighbours' int8 edge frames as the halo."""
    b, n, cin = xf.shape
    w8t, sw = quantize_weight(w) if wq is None else wq
    x8, sx = quantize_activation(xf, absmax, seq)
    if seq is not None:
        x8 = halo_rows(x8, f, seq)
    col = im2col(x8, f, halo=seq is not None).reshape(b * n, 9 * cin)
    if col.is_cuda:
        y = torch._int_mm(col, w8t.t())
    else:
        y = col.to(torch.int32) @ w8t.t().to(torch.int32)
    return (y.to(torch.float32) * (1.0 / (sx * sw))).reshape(b, n, -1)
