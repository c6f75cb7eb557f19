"""The deep-stage ResnetBlocks of the fused configuration (kernels K8, K9
and K10b; counterpart of unitspeech_tpu/ops/pallas_resnet.py
`fused_resnet_block_deep` and `fused_resnet_block_deep_i8`).

K8 is the whole ResnetBlock at the F = 20/10 stages in bf16. Its numbers
are K1's (ops/fused_resnet.py): convs accumulate in f32 and round once,
statistics pool over every row of the bucket, the residual is an f32 sum
of bf16 products; on the card it is K1's kernels (csrc/resnet_block.cu
says why the TPU version's differences do not carry over), and its plain
version is K1's, `resnet_block_plain`.

K9 runs the block's convs in int8 on pre-quantized activations:
activation scales per batch element (127 / max|x| over the masked rows),
weight scales per output channel (`quant_w`, ops/fused_resnet.py, computed
once when the weights load), dequantized as acc * ((1/sx) * (1/sw)) + bias, with c1 and c2 in
bf16; for cin > cout conv1 stays bf16, as in JAX. CUDA source:
csrc/resnet_deep_i8.cu, which states the chain, what bounds it and how it
is laid out; its int8 convs run on K8's Hopper loop with the weights packed
once at load (`pack_block_weights_i8`).

K10b is K8's in-kernel int8 mode (`fused_resnet_block_deep(int8=True)`,
no model route): K9's structure with JAX's in-kernel numbers, which move
int8 roundings: the activation scale 127 / (max + 1e-8), one per batch
element over the whole layer; h rounded to the activation dtype before its
abs-max and quantize; any Cout (K8's widths). Its one scale a batch
element covers every row of the TPU kernel's window, halo frames included,
so the input quantizes once ahead of each conv and the block runs K9's
chain with K10b's roundings (`_deep_i8_cuda(..., k10b=True)`; conv1 in
bf16 for Cin > Cout, as in K9). Its plain version stays K10a's plain chain
with one tile of all T frames (`resnet_block_deep_int8_plain`).

The routing gates (`deep_route`) are the JAX estimator's TPU VMEM gates
(unet.py:321-383), kept so that the port computes what the JAX path
computes.

On a frame slice of the seq axis (`seq=`, a parallel.FrameSlice) and / or
a column slice of the model axis (`model=`, a parallel.ModelShard) K8 is
K1's sharded chain (ops/fused_resnet.py resnet_block_sharded) at F = 20/10,
and K9 runs `resnet_block_deep_i8_sharded`: JAX's GSPMD runs the Pallas
kernel on gathered operands, so the sharded chain computes the global
numbers, the one activation scale a batch element over all of its rows
(the maxima reduced over the axis between the split quantize's two
launches, us_i8_absmax and us_i8_quantize_scaled), GroupNorm 1 over the
global rows (the tile sums gathered, us_i8_glue_h) and h's scale over the
whole h (the glue's maxima reduced over both axes before us_i8_glue_q);
each int8 conv reads its input halo'd (us_resnet_conv3x3_i8_halo; the
neighbours' frames quantized with the same scale), and on a column slice
h8 is gathered before conv2 (a quarter of an f32 h's bytes). The
unsharded chain keeps its launches. Each step has its plain twin, which a
CPU tensor takes.
"""

from __future__ import annotations

import torch

from unitspeech_tpu_torch.ops import _cuda
from unitspeech_tpu_torch.ops.conv_matmul import conv3x3_rows, halo_rows, im2col
from unitspeech_tpu_torch.ops.fused_resnet import (  # noqa: F401 (I8_KC: re-exported)
    GN_EPS,
    I8_KC,
    _check_shapes,
    _f32,
    _gn_mish,
    _group_stats,
    _kernel_a_rows,
    _kernel_c_plain,
    _packed_i8,
    _packed_operand,
    _resnet_block_cuda,
    _slice_args,
    _slice_stats,
    _tiles_each,
    _valid,
    block_rows_args,
    pack_conv_weight,
    pack_conv_weight_i8,
    quant_w,
    resnet_block_i8_plain,
    resnet_block_plain,
    resnet_block_sharded,
    takes,
)
from unitspeech_tpu_torch.ops.row_stats import row_stats_plain, slice_groups

DEEP_MAX_BYTES = 4 * 1024 * 1024  # T*F*max(cin, cout)*2, the TPU VMEM gate


def takes_i8(cin: int, cout: int, groups: int = 8) -> bool:
    """The widths K9's CUDA kernels take: K8's (`takes`) and Cin a multiple
    of 16 (the int8 rows' 16-byte loads)."""
    return cin % 16 == 0 and takes(cout, groups)


def slice_takes(cout: int, groups: int, tp=None) -> bool:
    """Whether K1's / K8's / K9's kernels take a model rank's slice of Cout
    (global) channels in `groups` groups (tp a parallel.ModelShard, or None:
    no model axis): Cout / size in whole 64-column tiles and whole groups a
    rank."""
    if tp is None:
        return True
    g = slice_groups(groups, tp)
    return bool(g) and cout % tp.size == 0 and takes(cout // tp.size, g)


def deep_route(t: int, f: int, cin: int, cout: int, use_int8: bool, use_deep: bool,
               use_i8pre: bool, groups: int = 8, tp=None):
    """Which fused kernel a deep-stage ResnetBlock (one that K1 does not take
    and with max(cin, cout) >= 512) runs, as the JAX ResnetBlock routes it:
    "i8" (K9) when i8pre and int8 are on, cout <= 512 and the whole layer
    fits 4 MiB; else "bf16" (K8, also with int8 on) when the deep kernels are
    on and it fits; else None (the flat route). T and Cout are the global
    frames and widths (GSPMD traces JAX at global shapes). A kernel that does
    not take the block's widths (takes_i8, takes), or on a model axis (tp)
    the rank's slice (slice_takes), counts as a failed gate."""
    fits = t * f * max(cin, cout) * 2 <= DEEP_MAX_BYTES
    if (use_i8pre and use_int8 and cout <= 512 and fits and takes_i8(cin, cout, groups)
            and slice_takes(cout, groups, tp)):
        return "i8"
    if use_deep and fits and takes(cout, groups) and slice_takes(cout, groups, tp):
        return "bf16"
    return None


def resnet_block_deep_int8_plain(x, lens_rows, t_bias, w1, wq1, b1, s1, be1, wq2, b2, s2,
                                 be2, wres, bres, f: int, groups: int):
    """The K10b kernel's plain version on rows, with K9's arguments:
    resnet_block_i8_plain with one scale group per batch element (fpt =
    T) and conv1 in bf16 for Cin > Cout. -> (B, N, Cout)."""
    return resnet_block_i8_plain(x, lens_rows, t_bias, w1, wq1, b1, s1, be1, wq2, b2, s2, be2,
                                 wres, bres, f=f, groups=groups, fpt=x.shape[1] // f,
                                 conv1_bf16=x.shape[-1] > b1.shape[-1])


def fused_resnet_block_deep_int8(x, mask, t_bias, w1, b1, gn1_scale, gn1_bias,
                                 w2, b2, gn2_scale, gn2_bias, wres=None, bres=None,
                                 groups: int = 8, wq=None, packed=None):
    """K10b: one deep-stage ResnetBlock with both convs quantized in
    kernel (conv1 in bf16 for Cin > Cout), with fused_resnet_block_deep_i8's
    arguments; wq = (quant_w(w1), quant_w(w2)) when computed once (wq[0] is
    not read for Cin > Cout); packed: pack_block_weights_i8 of the kernels
    when made at load, else packed here. -> (B, T, F, Cout). CUDA tensors
    launch K9's chain with K10b's roundings (widths: takes_i8), CPU tensors
    take resnet_block_deep_int8_plain."""
    bsz, t, f, cin = x.shape
    cout = w1.shape[-1]
    if wq is None:
        wq = (None if cin > cout else quant_w(w1), quant_w(w2))
    xr, lens, tb, w1r, b1, s1, be1, _, b2, s2, be2, wres, bres = block_rows_args(
        x, mask, t_bias, w1, b1, gn1_scale, gn1_bias, w2, b2, gn2_scale, gn2_bias, wres, bres)
    args = (xr, lens, tb, w1r, wq[0], b1, s1, be1, wq[1], b2, s2, be2, wres, bres)
    if _cuda.route(x, "fused_resnet_block_deep(int8=True)"):
        out = _deep_i8_cuda(*args, f=f, groups=groups, packed=packed, k10b=True)
        fused_resnet_block_deep_int8.launches += 1
    else:
        out = resnet_block_deep_int8_plain(*args, f=f, groups=groups)
    return out.reshape(bsz, t, f, cout)


fused_resnet_block_deep_int8.launches = 0


def fused_resnet_block_deep(x, mask, t_bias, w1, b1, gn1_scale, gn1_bias,
                            w2, b2, gn2_scale, gn2_bias, wres=None, bres=None,
                            groups: int = 8, int8: bool = False, wq=None, packed=None,
                            seq=None, model=None):
    """One deep-stage ResnetBlock in bf16 (K8), with fused_resnet_block's
    arguments: x (B, T, F, Cin); mask (B, T, 1, 1); t_bias (B, Cout); flax
    conv kernels; wres/bres the optional 1x1 residual; packed: their
    pack_block_weights when made at load. -> (B, T, F, Cout). CUDA tensors
    launch the kernel (widths: `takes`), CPU tensors take
    resnet_block_plain. int8=True is K10b (fused_resnet_block_deep_int8,
    which takes wq, and packed from pack_block_weights_i8). seq: x is a
    frame slice of the seq axis; model: the kernels and biases are this
    rank's Cout columns of the model axis (x every channel): K1's sharded
    chain (resnet_block_sharded), the output every channel."""
    if int8:
        if seq is not None or model is not None:
            raise NotImplementedError("fused_resnet_block_deep(int8=True) on a slice: K10b "
                                      "has no model route and no sharded form")
        return fused_resnet_block_deep_int8(x, mask, t_bias, w1, b1, gn1_scale, gn1_bias, w2,
                                            b2, gn2_scale, gn2_bias, wres, bres, groups=groups,
                                            wq=wq, packed=packed)
    bsz, t, f, _ = x.shape
    args = block_rows_args(x, mask, t_bias, w1, b1, gn1_scale, gn1_bias, w2, b2, gn2_scale,
                           gn2_bias, wres, bres)
    if seq is not None or model is not None:
        out = resnet_block_sharded(*args, f=f, groups=groups, seq=seq, model=model,
                                   packed=packed)
        if x.is_cuda:
            fused_resnet_block_deep.launches += 1
    elif _cuda.route(x, "fused_resnet_block_deep"):
        out = _resnet_block_cuda(*args, f=f, groups=groups, packed=packed,
                                 what="fused_resnet_block_deep")
        fused_resnet_block_deep.launches += 1
    else:
        out = resnet_block_plain(*args, f=f, groups=groups)
    return out.reshape(bsz, t, f, -1)


fused_resnet_block_deep.launches = 0


def _quantize_plain(x, valid):
    """The per-batch-element activation quantize: rows (B, n, C) and their
    (B, n, 1) validity -> (x8 int8 masked, sx (B,) f32)."""
    xm = x.to(torch.float32) * valid
    sx = 127.0 / torch.clamp(xm.abs().amax(dim=(1, 2)), min=1e-8)
    x8 = torch.clamp(torch.round(xm * sx[:, None, None]), -127, 127).to(torch.int8)
    return x8, sx


def _conv3x3_i8_plain(x8, wq, f, halo: bool = False):
    """int8 conv3x3 over (B, n, Cin) rows with wq = quant_w(w) and the
    per-batch scale folded in by the caller -> int32 (B, n, Cout). halo: x8
    holds one extra frame on each side (im2col's halo), n the interior
    rows."""
    b, nh, cin = x8.shape
    n = nh - 2 * f if halo else nh
    w8t = wq[0]
    col = im2col(x8, f, halo).reshape(b * n, 9 * cin)
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
    return _kernel_c_plain(acc2.to(dt), x, mean2, inv2, s2, be2, valid, wres, bres)


def pack_block_weights_i8(w1, wq, wres=None, conv1_bf16=None):
    """A K9 block's conv kernels packed for its kernels, from w1 (3, 3, Cin,
    Cout), wq = (quant_w(w1), quant_w(w2)) (the int8 weights whose scales
    the kernels' epilogue reads) and the 1x1 residual wres (1, 1, Cin, Cout)
    or None: (conv1: wq[0]'s int8 tiles, or K8's bf16 tiles of w1 for Cin >
    Cout; conv2: wq[1]'s int8 tiles; the residual's bf16 tiles or None).
    conv1_bf16: whether conv1 runs in bf16, Cin > Cout when None (a model
    rank's slice passes the block's global Cout's answer)."""
    cin, cout = w1.shape[2:]
    if conv1_bf16 is None:
        conv1_bf16 = cin > cout
    c1 = pack_conv_weight(w1) if conv1_bf16 else pack_conv_weight_i8(wq[0][0], cin)
    # conv2 reads every channel: on a model rank its Cin is the whole Cout
    return (c1, pack_conv_weight_i8(wq[1][0], wq[1][0].shape[1] // 9),
            None if wres is None else pack_conv_weight(wres))


def _deep_i8_cuda(x, lens, t_bias, w1, wq1, b1, s1, be1, wq2, b2, s2, be2, wres, bres, f,
                  groups, packed, k10b=False):
    """K9's chain, or with k10b K10b's (the same launches with K10b's
    roundings: the activation scales 127 / (max + 1e-8), h rounded to the
    activation dtype before its maximum); packed: pack_block_weights_i8's
    (conv1, conv2, 1x1 residual), made here from the weights and wq when
    absent. Every launch of the chain is a programmatic dependent launch
    (its kernels wait for their predecessor before reading): each starts as
    the one before drains."""
    b, n, cin = x.shape
    cout = b1.shape[-1]
    what = "fused_resnet_block_deep(int8=True)" if k10b else "fused_resnet_block_deep_i8"
    _check_shapes(what, x, cout, groups)
    if not takes_i8(cin, cout, groups):
        raise ValueError(f"{what}: Cin={cin} must be a multiple of 16")
    if wres is None and cin != cout:
        raise ValueError(f"{what}: identity residual needs Cin == Cout")
    dt, dev = x.dtype, x.device
    x = _cuda.require(x.contiguous(), "x", dtype=dt)
    _cuda.require(lens, "lens", dtype=torch.int32, shape=(b,), device=dev)
    film = _cuda.require(t_bias.to(dt).contiguous(), "t_bias", shape=(b, cout), device=dev)
    if packed is None:
        packed = pack_block_weights_i8(w1.reshape(3, 3, cin, cout), (wq1, wq2),
                                       None if wres is None else wres.reshape(1, 1, cin, cout))
    w2p, bn2 = _packed_i8(packed[1], "w2 (int8)", cout, cout, dev)
    rsw2 = _cuda.require(_f32(wq2[1]), "rsw2", shape=(cout,), device=dev)
    lib, st = _cuda.lib(), _cuda.stream(x)
    # every conv on the Hopper loop: each GroupNorm reads its conv's tiles
    nt1, nt = lib.us_conv_n_tiles(n, f, cin), lib.us_conv_n_tiles(n, f, cout)
    part = torch.empty((b, max(nt1, nt), 2, cout), dtype=torch.float32, device=dev)
    mean2, inv2 = torch.empty((2, b, cout), dtype=torch.float32, device=dev)
    sx1, sx2 = torch.empty((2, b), dtype=torch.float32, device=dev)
    c1, c2, out = (torch.empty((b, n, cout), dtype=dt, device=dev) for _ in range(3))
    b1, s1, be1, b2, s2, be2 = map(_f32, (b1, s1, be1, b2, s2, be2))
    if cin > cout:  # conv1 in bf16 (JAX's hybrid): K8's kernel A
        w1p, bn = _packed_operand(packed[0], "w1", 9, cin, cout, dev)
        _cuda.check(lib.us_resnet_conv3x3(x.data_ptr(), w1p.data_ptr(), bn, b1.data_ptr(),
                                          lens.data_ptr(), c1.data_ptr(), part.data_ptr(), b, n,
                                          f, cin, cout, 1, st), "K9 conv1 (bf16)")
    else:
        w1p, bn = _packed_i8(packed[0], "w1 (int8)", cin, cout, dev)
        rsw1 = _cuda.require(_f32(wq1[1]), "rsw1", shape=(cout,), device=dev)
        # the input's scale from its rows before the length, then x8
        amax = torch.empty((b, lib.us_i8_quantize_chunks(n)), dtype=torch.float32, device=dev)
        x8 = torch.empty((b, n, cin), dtype=torch.int8, device=dev)
        _cuda.check(lib.us_i8_quantize_rows(x.data_ptr(), lens.data_ptr(), amax.data_ptr(),
                                            x8.data_ptr(), sx1.data_ptr(), b, n, cin, k10b, st),
                    "K9 input quantize")
        _cuda.check(lib.us_resnet_conv3x3_i8(x8.data_ptr(), w1p.data_ptr(), bn, sx1.data_ptr(),
                                             rsw1.data_ptr(), b1.data_ptr(), lens.data_ptr(),
                                             c1.data_ptr(), part.data_ptr(), b, n, f, cin, cout,
                                             st), "K9 conv1")
    amax_h = torch.empty((b, lib.us_i8_glue_blocks(n, cout)), dtype=torch.float32, device=dev)
    h = torch.empty((b, n, cout), dtype=torch.float32, device=dev)
    h8 = torch.empty((b, n, cout), dtype=torch.int8, device=dev)
    # GroupNorm 1 reduced inside the glue's first pass
    _cuda.check(lib.us_i8_glue(c1.data_ptr(), part.data_ptr(), nt1, groups, GN_EPS,
                               s1.data_ptr(), be1.data_ptr(), film.data_ptr(), lens.data_ptr(),
                               h.data_ptr(), amax_h.data_ptr(), h8.data_ptr(), sx2.data_ptr(), b,
                               n, cout, k10b, st), "K9 glue")
    _cuda.check(lib.us_resnet_conv3x3_i8(h8.data_ptr(), w2p.data_ptr(), bn2, sx2.data_ptr(),
                                         rsw2.data_ptr(), b2.data_ptr(), lens.data_ptr(),
                                         c2.data_ptr(), part.data_ptr(), b, n, f, cout, cout,
                                         st), "K9 conv2")
    _cuda.check(lib.us_gn_finalize(part.data_ptr(), b, nt, cout, groups, n, GN_EPS,
                                   mean2.data_ptr(), inv2.data_ptr(), 1, st), "K9 GroupNorm 2")
    wrp, bn = None, 0
    if wres is not None:
        wrp, bn = _packed_operand(packed[2], "wres", 1, cin, cout, dev)
        bres = _f32(bres)
    _cuda.check(lib.us_resnet_out(c2.data_ptr(), x.data_ptr(), mean2.data_ptr(), inv2.data_ptr(),
                                  s2.data_ptr(), be2.data_ptr(), _cuda.ptr(wrp), bn,
                                  _cuda.ptr(bres), lens.data_ptr(), out.data_ptr(), b, n, cin,
                                  cout, 1, st), "K9 output")
    return out


def resnet_conv3x3_i8(x8, sx, wq, bias, lens_rows, f: int, packed=None):
    """K9's int8 conv alone: x8 (B, N, Cin) int8 rows, zero at/after
    lens_rows; sx (B,) their scales; wq = quant_w(w) -> bf16(f32(acc) *
    ((1 / sx) * rsw) + bias) (B, N, Cout). packed: pack_conv_weight_i8(wq[0],
    Cin), else packed here. CUDA tensors launch the kernel, CPU tensors take
    _conv3x3_i8_plain + _dequant (the kernel's numbers: integer products are
    exact, so the two are equal bit for bit)."""
    if not _cuda.route(x8, "resnet_conv3x3_i8"):
        return _dequant(_conv3x3_i8_plain(x8, wq, f), sx, wq[1], bias).to(torch.bfloat16)
    b, n, cin = x8.shape
    cout = bias.shape[-1]
    dev = x8.device
    if cin % 16 or not takes(cout):
        raise ValueError(f"resnet_conv3x3_i8: Cin={cin}, Cout={cout}")
    _cuda.require(x8, "x8", dtype=torch.int8)
    wp, bn = _packed_i8(pack_conv_weight_i8(wq[0], cin) if packed is None else packed, "w8",
                        cin, cout, dev)
    sx = _cuda.require(_f32(sx), "sx", shape=(b,), device=dev)
    rsw = _cuda.require(_f32(wq[1]), "rsw", shape=(cout,), device=dev)
    bias = _cuda.require(_f32(bias), "bias", shape=(cout,), device=dev)
    lens = _cuda.require(lens_rows.to(torch.int32).contiguous(), "lens", shape=(b,), device=dev)
    lib = _cuda.lib()
    part = torch.empty((b, lib.us_conv_n_tiles(n, f, cin), 2, cout), dtype=torch.float32,
                       device=dev)
    out = torch.empty((b, n, cout), dtype=torch.bfloat16, device=dev)
    _cuda.check(lib.us_resnet_conv3x3_i8(x8.data_ptr(), wp.data_ptr(), bn, sx.data_ptr(),
                                         rsw.data_ptr(), bias.data_ptr(), lens.data_ptr(),
                                         out.data_ptr(), part.data_ptr(), b, n, f, cin, cout,
                                         _cuda.stream(x8)), "resnet_conv3x3_i8")
    resnet_conv3x3_i8.launches += 1
    return out


resnet_conv3x3_i8.launches = 0


def fused_resnet_block_deep_i8(x, mask, t_bias, w1, b1, gn1_scale, gn1_bias,
                               w2, b2, gn2_scale, gn2_bias, wres=None, bres=None,
                               groups: int = 8, wq=None, packed=None, lens_rows=None,
                               seq=None, model=None):
    """One deep-stage ResnetBlock with int8 convs on pre-quantized
    activations (K9), with fused_resnet_block's arguments; wq = (quant_w(w1),
    quant_w(w2)) when computed at load, else computed here; packed: the
    kernels' pack_block_weights_i8 when made at load (else packed here);
    lens_rows: the mask's valid rows (B,) int32 when the caller has them
    (the estimator, once a U-Net level), else counted here.
    -> (B, T, F, Cout). CUDA tensors
    launch the kernel (widths: takes_i8), CPU tensors take
    resnet_block_deep_i8_plain. seq: x is a frame slice of the seq axis
    (lens_rows its valid rows); model: the kernels, biases, wq and packed
    are this rank's Cout columns of the model axis (x every channel): the
    sharded chain (resnet_block_deep_i8_sharded), the output every
    channel."""
    bsz, t, f, cin = x.shape
    cout = w1.shape[-1]
    wq1, wq2 = (quant_w(w1), quant_w(w2)) if wq is None else wq
    xr, lens, tb, w1r, b1, s1, be1, _, b2, s2, be2, wres, bres = block_rows_args(
        x, mask, t_bias, w1, b1, gn1_scale, gn1_bias, w2, b2, gn2_scale, gn2_bias, wres, bres,
        lens_rows)
    args = (xr, lens, tb, w1r, wq1, b1, s1, be1, wq2, b2, s2, be2, wres, bres)
    if seq is not None or model is not None:
        out = resnet_block_deep_i8_sharded(*args, f=f, groups=groups, seq=seq, model=model,
                                           packed=packed)
        if x.is_cuda:
            fused_resnet_block_deep_i8.launches += 1
        return out.reshape(bsz, t, f, -1)
    if _cuda.route(x, "fused_resnet_block_deep_i8"):
        out = _deep_i8_cuda(*args, f=f, groups=groups, packed=packed)
        fused_resnet_block_deep_i8.launches += 1
    else:
        out = resnet_block_deep_i8_plain(*args, f=f, groups=groups)
    return out.reshape(bsz, t, f, cout)


fused_resnet_block_deep_i8.launches = 0


# --- K9 on a frame slice of the seq axis and / or a column slice of the
# model axis ---------------------------------------------------------------


def _maxima_width(seq, n: int, f: int, per) -> int:
    """The row width of a maxima buffer (B, ld) that every seq rank shares:
    the most that any rank's rows write (per(rows)); per(n) without a seq
    axis. The zeros past a rank's own maxima leave a maximum of |x| as it
    is."""
    if seq is None:
        return per(n)
    return max(per(m * f) for _, m in seq.bounds)


def _axis_max(m, seq, model):
    """Maxima reduced over the seq and the model axes given (one MAX
    all-reduce each)."""
    if seq is not None:
        m = seq.all_max(m)
    if model is not None:
        m = model.all_max(m)
    return m


def _quantize_sharded(x, lens, f, seq, cuda):
    """K9's input quantize with its scale over the seq axis: x (B, n, Cin)
    the slice's rows, lens its valid rows -> (x8 int8, rows >= lens zero;
    sx (B,) f32, 127 / max|x| over the batch element's global rows). On the
    card two launches, the maxima (us_i8_absmax) reduced over the axis
    before the quantize (us_i8_quantize_scaled); the plain twin on the
    CPU."""
    b, n, cin = x.shape
    if not cuda:
        xm = x.to(torch.float32) * _valid(lens, n)
        m = _axis_max(xm.abs().amax(dim=(1, 2))[:, None], seq, None)[:, 0]
        sx = 127.0 / torch.clamp(m, min=1e-8)
        x8 = torch.clamp(torch.round(xm * sx[:, None, None]), -127, 127).to(torch.int8)
        return x8, sx
    lib, st, dev = _cuda.lib(), _cuda.stream(x), x.device
    ld = _maxima_width(seq, n, f, lib.us_i8_quantize_chunks)
    amax = torch.zeros((b, ld), dtype=torch.float32, device=dev)
    _cuda.check(lib.us_i8_absmax(x.data_ptr(), lens.data_ptr(), amax.data_ptr(), ld, b, n, cin,
                                 st), "K9 input maxima")
    amax = _axis_max(amax, seq, None)
    x8 = torch.empty((b, n, cin), dtype=torch.int8, device=dev)
    sx = torch.empty((b,), dtype=torch.float32, device=dev)
    _cuda.check(lib.us_i8_quantize_scaled(x.data_ptr(), lens.data_ptr(), amax.data_ptr(), ld,
                                          x8.data_ptr(), sx.data_ptr(), b, n, cin, st),
                "K9 input quantize (given maxima)")
    return x8, sx


def _conv_i8_rows(x8, sx, wq, bias, lens, f, packed, seq, dt, cuda):
    """K9's int8 conv3x3 over this rank's rows (over their halo'd rows on a
    frame slice: the neighbours' edge frames, quantized with the same
    scale, zero past their length) -> (c in dt, tile sums (B, tiles, 2,
    Cout) of the f32 dequantized value, every seq rank's gathered). wq:
    quant_w of the rank's columns; packed: their pack_conv_weight_i8."""
    b, n, cin = x8.shape
    cout = bias.shape[-1]
    xh = x8 if seq is None else halo_rows(x8, f, seq)
    if cuda:
        lib, dev = _cuda.lib(), x8.device
        wp, bn = _packed_i8(packed, "w (int8)", cin, cout, dev)
        rsw = _cuda.require(_f32(wq[1]), "rsw", shape=(cout,), device=dev)
        part = torch.empty((b, lib.us_conv_n_tiles(n, f, cin), 2, cout), dtype=torch.float32,
                           device=dev)
        c = torch.empty((b, n, cout), dtype=dt, device=dev)
        fn = lib.us_resnet_conv3x3_i8 if seq is None else lib.us_resnet_conv3x3_i8_halo
        _cuda.check(fn(xh.data_ptr(), wp.data_ptr(), bn, sx.data_ptr(), rsw.data_ptr(),
                       _f32(bias).data_ptr(), lens.data_ptr(), c.data_ptr(), part.data_ptr(), b,
                       n, f, cin, cout, _cuda.stream(x8)),
                    "K9 int8 conv" + ("" if seq is None else " (halo)"))
    else:
        acc = _dequant(_conv3x3_i8_plain(xh, wq, f, halo=seq is not None), sx, wq[1], bias)
        c, part = acc.to(dt), row_stats_plain(acc)[:, None]
    if seq is not None:
        part = seq.cat(part, _tiles_each(seq, f, cin, cuda))
    return c, part


def _glue_sharded(c1, part, lens, s1, be1, t_bias, g, groups, n_glob, f, seq, model, cuda):
    """K9's glue on the rank's rows and columns: GroupNorm 1 over n_glob
    rows from the gathered tile sums (the slice's g groups), h = mish(GN1) +
    FiLM masked, then h8 with h's scale over the whole h: on the card pass 0
    (us_i8_glue_h), its maxima reduced over seq and model, pass 1
    (us_i8_glue_q). -> (h8 (B, n, C') int8, sx2 (B,) f32)."""
    b, n, c = c1.shape
    if not cuda:
        mean, inv = _slice_stats(part, groups, n_glob, model)
        film = t_bias.to(c1.dtype).to(torch.float32)[:, None, :]
        h = (_gn_mish(c1, mean, inv, s1, be1) + film) * _valid(lens, n)
        m = _axis_max(h.abs().amax(dim=(1, 2))[:, None], seq, model)[:, 0]
        sx = 127.0 / torch.clamp(m, min=1e-8)
        return torch.clamp(torch.round(h * sx[:, None, None]), -127, 127).to(torch.int8), sx
    lib, st, dev = _cuda.lib(), _cuda.stream(c1), c1.device
    film = _cuda.require(t_bias.to(c1.dtype).contiguous(), "t_bias", shape=(b, c), device=dev)
    ld = _maxima_width(seq, n, f, lambda rows: lib.us_i8_glue_blocks(rows, c))
    amax = torch.zeros((b, ld), dtype=torch.float32, device=dev)
    h = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    _cuda.check(lib.us_i8_glue_h(c1.data_ptr(), part.data_ptr(), part.shape[1], g, GN_EPS,
                                 _f32(s1).data_ptr(), _f32(be1).data_ptr(), film.data_ptr(),
                                 lens.data_ptr(), h.data_ptr(), amax.data_ptr(), ld, b, n, c,
                                 n_glob, st), "K9 glue (pass 0)")
    amax = _axis_max(amax, seq, model)
    h8 = torch.empty((b, n, c), dtype=torch.int8, device=dev)
    sx = torch.empty((b,), dtype=torch.float32, device=dev)
    _cuda.check(lib.us_i8_glue_q(h.data_ptr(), amax.data_ptr(), ld, h8.data_ptr(),
                                 sx.data_ptr(), b, n, c, st), "K9 glue (pass 1)")
    return h8, sx


def resnet_block_deep_i8_sharded(x, lens, t_bias, w1, wq1, b1, s1, be1, wq2, b2, s2, be2, wres,
                                 bres, f: int, groups: int, seq=None, model=None, packed=None):
    """K9 on a frame slice of the seq axis and / or a column slice of the
    model axis, with the global numbers of the unsharded block: x (B, N,
    Cin) this rank's rows of every channel, lens its valid rows; w1 (9*Cin,
    Cout'), wq1 / wq2 (quant_w of the rank's columns: per-output-channel
    scales are column-local, so they are the whole's columns), b1, t_bias,
    wres (Cin, Cout') and bres the rank's Cout' = Cout / size columns (all
    of Cout without a model axis), the GroupNorm vectors whole; packed:
    pack_block_weights_i8 of the rank's columns (conv1 in bf16 where the
    block's global Cin > Cout). 1 conv1: Cin > Cout K8's kernel A over
    x's halo'd rows; else the input quantize, its maxima reduced over seq
    (one scale a batch element over its global rows), and the int8 conv
    over x8's halo'd rows; the tile sums gathered over seq; 2 the glue
    (GroupNorm 1 over the global rows on the slice's groups, h's maxima
    reduced over seq and model); 3 h8 gathered over model (conv2 reads
    every channel); 4 the int8 conv2 over h8's halo'd rows, its sums
    gathered over seq; 5 gn_finalize; 6 kernel C with the residual's
    columns; 7 the output gathered over model. Collectives: 6 over seq
    (5 for Cin > Cout: no input maxima), 3 over model. CUDA tensors launch
    the kernels, CPU tensors run each step's plain twin."""
    b, n, cin = x.shape
    cout = b1.shape[-1]
    c_all = cout * (1 if model is None else model.size)
    dt, dev = x.dtype, x.device
    what = "fused_resnet_block_deep_i8"
    cuda = _cuda.route(x, what)
    n_glob = n if seq is None else seq.rows(n)
    g, (s1, be1, s2, be2) = _slice_args(model, what, cout, groups, x, cuda, s1, be1, s2, be2)
    xres = x if wres is not None or model is None else model.take(x)
    conv1_bf16 = cin > c_all  # JAX's hybrid, at the global widths
    p1 = p2 = pr = None
    if cuda:
        if not takes_i8(cin, cout, g):
            raise ValueError(f"{what}: Cin={cin} must be a multiple of 16")
        if wres is None and xres.shape[-1] != cout:
            raise ValueError(f"{what}: identity residual needs Cin == Cout")
        x = _cuda.require(x.contiguous(), "x", dtype=dt)
        _cuda.require(lens, "lens", dtype=torch.int32, shape=(b,), device=dev)
        if packed is None:
            packed = pack_block_weights_i8(
                w1.reshape(3, 3, cin, cout), (wq1, wq2),
                None if wres is None else wres.reshape(1, 1, cin, cout), conv1_bf16)
        p1, p2, pr = packed
    if conv1_bf16:
        c1, part = _kernel_a_rows(x, lens, w1, b1, f, p1, seq, lens)
    else:
        x8, sx = _quantize_sharded(x, lens, f, seq, cuda)
        c1, part = _conv_i8_rows(x8, sx, wq1, b1, lens, f, p1, seq, dt, cuda)
    h8, sx2 = _glue_sharded(c1, part, lens, s1, be1, t_bias, g, groups, n_glob, f, seq, model,
                            cuda)
    if model is not None:
        h8 = model.gather(h8)
    c2, part = _conv_i8_rows(h8, sx2, wq2, b2, lens, f, p2, seq, dt, cuda)
    if not cuda:
        out = _kernel_c_plain(c2, xres, *_slice_stats(part, groups, n_glob, model), s2, be2,
                              _valid(lens, n), wres, bres)
        return out if model is None else model.gather(out)
    lib, st = _cuda.lib(), _cuda.stream(x)
    stats = torch.empty((2, b, cout), dtype=torch.float32, device=dev)
    _cuda.check(lib.us_gn_finalize(part.data_ptr(), b, part.shape[1], cout, g, n_glob, GN_EPS,
                                   stats[0].data_ptr(), stats[1].data_ptr(), 0, st),
                "K9 GroupNorm 2")
    wr, bn = None, 0
    if wres is not None:
        wr, bn = _packed_operand(pr, "wres", 1, cin, cout, dev)
        bres = _f32(bres)
    out = torch.empty((b, n, cout), dtype=dt, device=dev)
    _cuda.check(lib.us_resnet_out(c2.data_ptr(), xres.data_ptr(), stats[0].data_ptr(),
                                  stats[1].data_ptr(), _f32(s2).data_ptr(), _f32(be2).data_ptr(),
                                  _cuda.ptr(wr), bn, _cuda.ptr(bres), lens.data_ptr(),
                                  out.data_ptr(), b, n, xres.shape[-1], cout, 0, st), "K9 output")
    return out if model is None else model.gather(out)
