"""The deep-stage ResnetBlocks of the fused configuration (kernels K8 and
K9; counterpart of unitspeech_tpu/ops/pallas_resnet.py
`fused_resnet_block_deep` and `fused_resnet_block_deep_i8`).

K8 is the whole ResnetBlock at the F = 20/10 stages in bf16. Its numbers
are K1's (ops/fused_resnet.py): convs accumulate in f32 and round once,
statistics pool over every row of the bucket, the residual is an f32 sum
of bf16 products; on the card it is K1's kernels (csrc/resnet_block.cu
says why the TPU version's differences do not carry over), and its plain
version is K1's, `resnet_block_plain`.

K9 runs the block's convs in int8 on pre-quantized activations:
activation scales per batch element (127 / max|x| over the masked rows),
weight scales per output channel (`quant_w`, computed once when the weights
load), dequantized as acc * ((1/sx) * (1/sw)) + bias, with c1 and c2 in
bf16; for cin > cout conv1 stays bf16, as in JAX. CUDA source:
csrc/resnet_deep_i8.cu, which states the chain, what bounds it and how it
is laid out.

The routing gates (`deep_route`) are the JAX estimator's TPU VMEM gates
(unet.py:321-383), kept so that the port computes what the JAX path
computes.
"""

from __future__ import annotations

import torch

from unitspeech_tpu_torch.ops import _cuda
from unitspeech_tpu_torch.ops.conv_matmul import conv3x3_rows, im2col, quantize_weight
from unitspeech_tpu_torch.ops.fused_resnet import (
    GN_EPS,
    _check_shapes,
    _f32,
    _gn_mish,
    _group_stats,
    _resnet_block_cuda,
    _valid,
    block_rows_args,
    resnet_block_plain,
)
from unitspeech_tpu_torch.ops.row_stats import row_absmax

DEEP_MAX_BYTES = 4 * 1024 * 1024  # T*F*max(cin, cout)*2, the TPU VMEM gate


def deep_route(t: int, f: int, cin: int, cout: int, use_int8: bool, use_deep: bool,
               use_i8pre: bool):
    """Which fused kernel a deep-stage ResnetBlock (one that K1 does not take
    and with max(cin, cout) >= 512) runs, as the JAX ResnetBlock routes it:
    "i8" (K9) when i8pre and int8 are on, cout <= 512 and the whole layer
    fits 4 MiB; else "bf16" (K8, also with int8 on) when the deep kernels are
    on and it fits; else None (the flat route)."""
    fits = t * f * max(cin, cout) * 2 <= DEEP_MAX_BYTES
    if use_i8pre and use_int8 and cout <= 512 and fits:
        return "i8"
    if use_deep and fits:
        return "bf16"
    return None


def fused_resnet_block_deep(x, mask, t_bias, w1, b1, gn1_scale, gn1_bias,
                            w2, b2, gn2_scale, gn2_bias, wres=None, bres=None,
                            groups: int = 8):
    """One deep-stage ResnetBlock in bf16 (K8), with fused_resnet_block's
    arguments: x (B, T, F, Cin); mask (B, T, 1, 1); t_bias (B, Cout); flax
    conv kernels; wres/bres the optional 1x1 residual. -> (B, T, F, Cout).
    CUDA tensors launch the kernel, CPU tensors take resnet_block_plain."""
    bsz, t, f, _ = x.shape
    args = block_rows_args(x, mask, t_bias, w1, b1, gn1_scale, gn1_bias, w2, b2, gn2_scale,
                           gn2_bias, wres, bres)
    if _cuda.route(x, "fused_resnet_block_deep"):
        out = _resnet_block_cuda(*args, f=f, groups=groups, what="fused_resnet_block_deep")
        fused_resnet_block_deep.launches += 1
    else:
        out = resnet_block_plain(*args, f=f, groups=groups)
    return out.reshape(bsz, t, f, -1)


fused_resnet_block_deep.launches = 0


def quant_w(w: torch.Tensor):
    """pallas_resnet._quant_w: a conv kernel (..., Cout) -> (w8t (Cout, K)
    int8, rsw (Cout,) f32), per-output-channel scales over the (K, Cout)
    matrix, round half to even, clip to +-127, the scales returned as
    reciprocals. w8t is stored n-major, as the int8 kernel reads it."""
    w8t, sw = quantize_weight(w)
    return w8t, 1.0 / sw


def _quantize_plain(x, valid):
    """The per-batch-element activation quantize: rows (B, n, C) and their
    (B, n, 1) validity -> (x8 int8 masked, sx (B,) f32)."""
    xm = x.to(torch.float32) * valid
    sx = 127.0 / torch.clamp(xm.abs().amax(dim=(1, 2)), min=1e-8)
    x8 = torch.clamp(torch.round(xm * sx[:, None, None]), -127, 127).to(torch.int8)
    return x8, sx


def _conv3x3_i8_plain(x8, wq, f):
    """int8 conv3x3 over (B, n, Cin) rows with wq = quant_w(w) and the
    per-batch scale folded in by the caller -> int32 (B, n, Cout)."""
    b, n, cin = x8.shape
    w8t, _ = wq
    col = im2col(x8, f).reshape(b * n, 9 * cin)
    if col.is_cuda:
        y = torch._int_mm(col, w8t.t())
    else:
        y = col.to(torch.int32) @ w8t.t().to(torch.int32)
    return y.reshape(b, n, -1)


def _dequant(acc32, sx, rsw, bias):
    """f32(acc) * ((1/sx) * rsw) + bias, one rounding per operation."""
    swe = (1.0 / sx)[:, None, None] * rsw
    return acc32.to(torch.float32) * swe + bias


def resnet_block_deep_i8_plain(x, lens_rows, t_bias, w1, wq1, b1, s1, be1, wq2, b2, s2, be2,
                               wres, bres, f: int, groups: int):
    """The K9 kernel's plain version on rows: x (B, N, Cin) in the
    activation dtype, w1 (9*Cin, Cout) (conv1 in bf16 when Cin > Cout),
    wq1/wq2 = quant_w of the two conv kernels, wres (Cin, Cout) or None.
    -> (B, N, Cout)."""
    dt = x.dtype
    n, cin = x.shape[1:]
    cout = b1.shape[-1]
    valid = _valid(lens_rows, n)
    if cin > cout:
        acc1 = conv3x3_rows(x.to(torch.float32) * valid, w1.to(dt).to(torch.float32), f) + b1
    else:
        x8, sx = _quantize_plain(x, valid)
        acc1 = _dequant(_conv3x3_i8_plain(x8, wq1, f), sx, wq1[1], b1)
    mean1, inv1 = _group_stats(acc1, groups)
    h = _gn_mish(acc1.to(dt), mean1, inv1, s1, be1) + t_bias.to(dt).to(torch.float32)[:, None, :]
    h8, sx2 = _quantize_plain(h, valid)
    acc2 = _dequant(_conv3x3_i8_plain(h8, wq2, f), sx2, wq2[1], b2)
    mean2, inv2 = _group_stats(acc2, groups)
    h2 = _gn_mish(acc2.to(dt), mean2, inv2, s2, be2) * valid
    xv = x.to(torch.float32) * valid
    if wres is None:
        res = xv
    else:
        res = (xv @ wres.to(dt).to(torch.float32) + bres) * valid
    return (h2 + res).to(dt)


def _deep_i8_cuda(x, lens, t_bias, w1, wq1, b1, s1, be1, wq2, b2, s2, be2, wres, bres, f,
                  groups, mask):
    b, n, cin = x.shape
    cout = b1.shape[-1]
    _check_shapes("fused_resnet_block_deep_i8", x, cout, groups)
    if cin % 16:
        raise ValueError(f"fused_resnet_block_deep_i8: Cin={cin} must be a multiple of 16")
    if wres is None and cin != cout:
        raise ValueError("fused_resnet_block_deep_i8: identity residual needs Cin == Cout")
    dt, dev = x.dtype, x.device
    x = _cuda.require(x.contiguous(), "x", dtype=dt)
    _cuda.require(lens, "lens", dtype=torch.int32, shape=(b,), device=dev)
    film = _cuda.require(t_bias.to(dt).contiguous(), "t_bias", shape=(b, cout), device=dev)
    w8t2 = _cuda.require(wq2[0], "w8t2", dtype=torch.int8, shape=(cout, 9 * cout), device=dev)
    rsw2 = _cuda.require(_f32(wq2[1]), "rsw2", shape=(cout,), device=dev)
    lib, st = _cuda.lib(), _cuda.stream(x)
    nt = lib.us_n_row_tiles(n)
    part = torch.empty((b, nt, 2, cout), dtype=torch.float32, device=dev)
    mean1, inv1, mean2, inv2, swe = torch.empty((5, b, cout), dtype=torch.float32, device=dev)
    sx = torch.empty((b,), dtype=torch.float32, device=dev)
    c1, c2, out = (torch.empty((b, n, cout), dtype=dt, device=dev) for _ in range(3))
    b1, s1, be1, b2, s2, be2 = map(_f32, (b1, s1, be1, b2, s2, be2))
    if cin > cout:  # conv1 in bf16 (JAX's hybrid): K8's kernel A
        w1 = _cuda.require(w1.to(dt).contiguous(), "w1", shape=(9 * cin, cout), device=dev)
        _cuda.check(lib.us_resnet_conv3x3(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                          lens.data_ptr(), None, None, None, None, None,
                                          c1.data_ptr(), part.data_ptr(), b, n, f, cin, cout,
                                          st), "K9 conv1 (bf16)")
    else:
        w8t1 = _cuda.require(wq1[0], "w8t1", dtype=torch.int8, shape=(cout, 9 * cin),
                             device=dev)
        rsw1 = _cuda.require(_f32(wq1[1]), "rsw1", shape=(cout,), device=dev)
        # the scale of the masked input: the row abs-max kernel K7
        amax = row_absmax((x.reshape(b, -1, f, cin) * mask.to(dt)).reshape(b, n, cin))
        x8 = torch.empty((b, n, cin), dtype=torch.int8, device=dev)
        _cuda.check(lib.us_i8_quantize_rows(x.data_ptr(), lens.data_ptr(), amax.data_ptr(), cin,
                                            rsw1.data_ptr(), x8.data_ptr(), sx.data_ptr(),
                                            swe.data_ptr(), b, n, cin, cout, st),
                    "K9 input quantize")
        _cuda.check(lib.us_resnet_conv3x3_i8(x8.data_ptr(), w8t1.data_ptr(), swe.data_ptr(),
                                             b1.data_ptr(), lens.data_ptr(), c1.data_ptr(),
                                             part.data_ptr(), b, n, f, cin, cout, st),
                    "K9 conv1")
    _cuda.check(lib.us_gn_finalize(part.data_ptr(), b, nt, cout, groups, n, GN_EPS,
                                   mean1.data_ptr(), inv1.data_ptr(), st), "K9 GroupNorm 1")
    amax_h = torch.empty((b, lib.us_i8_glue_chunks(n), cout), dtype=torch.float32, device=dev)
    h8 = torch.empty((b, n, cout), dtype=torch.int8, device=dev)
    _cuda.check(lib.us_i8_glue(c1.data_ptr(), mean1.data_ptr(), inv1.data_ptr(),
                               s1.data_ptr(), be1.data_ptr(), film.data_ptr(),
                               lens.data_ptr(), rsw2.data_ptr(), amax_h.data_ptr(),
                               h8.data_ptr(), sx.data_ptr(), swe.data_ptr(), b, n, cout, st),
                "K9 glue")
    _cuda.check(lib.us_resnet_conv3x3_i8(h8.data_ptr(), w8t2.data_ptr(), swe.data_ptr(),
                                         b2.data_ptr(), lens.data_ptr(), c2.data_ptr(),
                                         part.data_ptr(), b, n, f, cout, cout, st), "K9 conv2")
    _cuda.check(lib.us_gn_finalize(part.data_ptr(), b, nt, cout, groups, n, GN_EPS,
                                   mean2.data_ptr(), inv2.data_ptr(), st), "K9 GroupNorm 2")
    if wres is not None:
        wres = _cuda.require(wres.to(dt).contiguous(), "wres", shape=(cin, cout), device=dev)
        bres = _f32(bres)
    _cuda.check(lib.us_resnet_out(c2.data_ptr(), x.data_ptr(), mean2.data_ptr(), inv2.data_ptr(),
                                  s2.data_ptr(), be2.data_ptr(), _cuda.ptr(wres),
                                  _cuda.ptr(bres), lens.data_ptr(), out.data_ptr(), b, n, cin,
                                  cout, st), "K9 output")
    return out


def fused_resnet_block_deep_i8(x, mask, t_bias, w1, b1, gn1_scale, gn1_bias,
                               w2, b2, gn2_scale, gn2_bias, wres=None, bres=None,
                               groups: int = 8, wq=None):
    """One deep-stage ResnetBlock with int8 convs on pre-quantized
    activations (K9), with fused_resnet_block's arguments; wq = (quant_w(w1),
    quant_w(w2)) when computed at load, else computed here. -> (B, T, F,
    Cout). CUDA tensors launch the kernel, CPU tensors take
    resnet_block_deep_i8_plain."""
    bsz, t, f, cin = x.shape
    cout = w1.shape[-1]
    wq1, wq2 = (quant_w(w1), quant_w(w2)) if wq is None else wq
    xr, lens, tb, w1r, b1, s1, be1, _, b2, s2, be2, wres, bres = block_rows_args(
        x, mask, t_bias, w1, b1, gn1_scale, gn1_bias, w2, b2, gn2_scale, gn2_bias, wres, bres)
    args = (xr, lens, tb, w1r, wq1, b1, s1, be1, wq2, b2, s2, be2, wres, bres)
    if _cuda.route(x, "fused_resnet_block_deep_i8"):
        out = _deep_i8_cuda(*args, f=f, groups=groups, mask=mask)
        fused_resnet_block_deep_i8.launches += 1
    else:
        out = resnet_block_deep_i8_plain(*args, f=f, groups=groups)
    return out.reshape(bsz, t, f, cout)


fused_resnet_block_deep_i8.launches = 0
