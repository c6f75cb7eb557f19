"""Fused U-Net ResnetBlock and final block (kernels K1 and K2; counterpart of
unitspeech_tpu/ops/pallas_resnet.py `fused_resnet_block` and
`fused_final_block`).

One ResnetBlock runs as three steps over (B, T*F, C) rows:

  A: mask input rows, conv3x3 + bias -> c1 (bf16) + GroupNorm statistics
  B: GN1-apply + mish + FiLM + re-mask, conv3x3 + bias -> c2 + statistics
  C: GN2-apply + mish + mask + residual (1x1 conv or identity)

and the final block as A followed by D: GN + mish + mask + the 1-channel
1x1 final_conv, giving an f32 score (on the card two launches: D reduces
A's tile statistics and folds the group statistics in its prologue).
CUDA source: csrc/resnet_block.cu,
which states what bounds the kernels and how they are laid out: on the card
kernel B's input transform runs once per element (gn_film) and the convs
run on a TMA + wgmma main loop whose weights are packed once
(`pack_conv_weight`; the estimator packs them when its weights load, a
direct call packs on the spot). `takes` states the widths the kernels take;
the estimator routes other widths elsewhere.

`fused_resnet_block(..., int8=True)` is K10a (JAX's in-kernel int8 mode,
no model route): both convs quantize their input window per TPU tile of
`frames_per_tile` frames (pick_frames_per_tile), one scale
127 / (max|window| + 1e-8) over the tile plus one halo frame on each side,
and dequantize as acc * ((1/s) * rsw) + bias. On the card each conv input
is first written as a per-tile quantized copy (`quantize_tiles`: every
tile's window, its halo frames duplicated and rounded with the tile's own
scale), which the int8 Hopper loop reads by TMA (`resnet_conv3x3_i8_tiles`),
with the weights packed once (`pack_block_weights_int8`). CUDA source:
csrc/resnet_block_i8.cu. `resnet_conv3x3` and `resnet_out` run kernel A and
kernel C alone (tools/bisect_deep_compile.py).

Numerics contract (the Pallas kernels'): convs accumulate in f32 and round
once to the activation dtype; the statistics come from the f32
accumulators and pool over every row of the padded bucket; GN math and
mish run in f32.

On a frame slice of the seq axis (`seq=`, a parallel.FrameSlice) and / or
a column slice of the model axis (`model=`, a parallel.ModelShard) K1 and
K2 run the same kernels one launch at a time with collectives between
them (`resnet_block_sharded`, `final_block_sharded`). On a frame slice
each conv reads a halo'd input
(the neighbours' edge frame on each side, masked by the sender, zeros at
the global ends; us_resnet_conv3x3_halo) and writes and sums the slice's
rows only, so every global frame enters the statistics once; the tile
sums of every rank are gathered (parallel.FrameSlice.cat) and folded
with the global row count (us_gn_film_rows, us_gn_finalize, us_final_tail).
On a column slice each conv writes the rank's output columns from the
whole input and the statistics fold the slice's whole groups; K1 gathers
h before its second conv and its output at the end, K2 sums the ranks'
partial dots of the final conv. Each step has its plain twin, which a CPU
tensor takes: the chain is the same code on both.
"""

from __future__ import annotations

import torch

import torch.nn.functional as F

from unitspeech_tpu_torch.ops import _cuda
from unitspeech_tpu_torch.ops.conv_matmul import (
    conv3x3_halo_rows,
    conv3x3_rows,
    halo_rows,
    im2col,
    quantize_weight,
)
from unitspeech_tpu_torch.ops.masking import frames_from_mask
from unitspeech_tpu_torch.ops.resample import KC, pad_chunks, swizzle128
from unitspeech_tpu_torch.ops.row_stats import fold_slice, row_stats_plain, slice_groups

GN_EPS = 1e-5
I8_KC = 128  # input channels per chunk of the int8 Hopper conv: one 128-byte row


def takes(cout: int, groups: int = 8) -> bool:
    """The widths the CUDA kernels of K1, K2 and K8 take: Cout in whole
    64-column tiles (the element-load loop's tile, and the Hopper loop's 64
    or 128) and GroupNorm groups of a multiple of 8 channels (gn_film's
    16-byte pieces). Any Cin: Cin % 8 != 0 takes element loads."""
    return cout % 64 == 0 and cout % groups == 0 and (cout // groups) % 8 == 0


def tile_cols(cout: int) -> int:
    """The Cout tile (BN) of the packed weights, which the launch takes from
    them: 128 where it divides Cout, else 64."""
    if cout % 64:
        raise ValueError(f"Cout={cout} is not a multiple of 64")
    return 128 if cout % 128 == 0 else 64


def pack_conv_weight(kernel):
    """A flax conv kernel (kt, kf, Cin, Cout) -> what the CUDA conv reads,
    made once at load: for Cin % 8 == 0 the bf16 tiles (Cout / BN, chunks,
    kt * kf taps, BN, 64), each K-major in the 128-byte swizzle, Cin padded
    to whole 64-channel chunks with zero rows (BN = tile_cols(Cout)); for
    other Cin (element loads) the (taps * Cin, Cout) bf16 rows."""
    *k, cin, cout = kernel.shape
    taps = k[0] * k[1]
    w = kernel.detach().to(torch.bfloat16).reshape(taps, cin, cout)
    if cin % 8:
        return w.reshape(taps * cin, cout).contiguous()
    bn = tile_cols(cout)
    w, nc = pad_chunks(w, cin)
    w = w.reshape(taps, nc, KC, cout // bn, bn).permute(3, 1, 0, 4, 2)
    return swizzle128(w).contiguous()


def conv_plan(taps: int, b: int, t: int, f: int, cin: int, cout: int) -> dict:
    """The Hopper loop's launch plan of a conv (taps 9: conv3x3 over the
    (T, F) grid; 1: the 1x1 residual over its T*F rows) with the packer's
    Cout tile, as csrc/resnet_block.cu makes it (the card's us_conv_plan):
    row tile, Cout tile, blocks, threads, dynamic shared memory, tiles a
    batch element and blocks an SM holds. Cin % 8 == 0."""
    import ctypes

    info = (ctypes.c_int * 8)()
    _cuda.check(_cuda.lib().us_conv_plan(taps, b, t, f, cin, cout, tile_cols(cout), info),
                "us_conv_plan")
    keys = ("tt", "tf", "bn", "blocks", "threads", "smem", "tiles", "blocks_per_sm")
    return dict(zip(keys, info))


def pack_block_weights(w1, w2, wres=None):
    """A ResnetBlock's three conv kernels (flax layout) packed for K1 / K8:
    (conv1, conv2, the 1x1 residual or None)."""
    return (pack_conv_weight(w1), pack_conv_weight(w2),
            None if wres is None else pack_conv_weight(wres))


def pack_conv_weight_i8(w8t, cin: int):
    """quant_w's int8 conv weights w8t (Cout, 9 * Cin), n-major, -> what the
    int8 Hopper conv (K9, K10a) reads, made once at load: (Cout / BN, chunks,
    9 taps, BN, 128) int8, each BN x 128 tile K-major (128 input channels,
    one 128-byte row) in the 128-byte swizzle, Cin padded to whole chunks
    with zeros (BN = tile_cols(Cout))."""
    cout = w8t.shape[0]
    bn = tile_cols(cout)
    nc = -(-cin // I8_KC)
    w = F.pad(w8t.reshape(cout, 9, cin), (0, nc * I8_KC - cin))
    w = w.reshape(cout // bn, bn, 9, nc, I8_KC).permute(0, 3, 2, 1, 4)
    return swizzle128(w).contiguous()


def pack_block_weights_int8(wq, wres=None):
    """K10a's conv kernels packed for its chain, from wq = (quant_w(w1),
    quant_w(w2)) and the 1x1 residual wres (1, 1, Cin, Cout) or None:
    (conv1's int8 tiles, conv2's int8 tiles, the residual as K1's kernel C
    reads it, or None). Both convs are int8 at every width."""
    cout, k1 = wq[0][0].shape
    return (pack_conv_weight_i8(wq[0][0], k1 // 9), pack_conv_weight_i8(wq[1][0], cout),
            None if wres is None else pack_conv_weight(wres))


def _packed_i8(packed, what, cin, cout, dev):
    """Check a pack_conv_weight_i8 result. -> (the tensor, its Cout tile BN)."""
    bn = packed.shape[-2] if packed.dim() == 5 else 0
    if bn not in (64, 128) or cout % bn:
        raise ValueError(f"{what}: packed kernel {tuple(packed.shape)} for Cout={cout}")
    shape = (cout // bn, -(-cin // I8_KC), 9, bn, I8_KC)
    return _cuda.require(packed, what, dtype=torch.int8, shape=shape, device=dev), bn


def pick_frames_per_tile(t: int, f: int, c_max: int,
                         budget_bytes: int = 6 * 1024 * 1024) -> int:
    """pallas_resnet._pick_frames_per_tile: the divisor of T whose tile is
    closest to 1024 rows within the TPU's VMEM budget (10 bytes per row and
    channel), the larger on a tie. K10a's activation scales are per tile of
    this many frames, so the port computes what the TPU computes."""
    target_rows = 1024
    best, best_key = 1, None
    for k in range(1, t + 1):
        if t % k == 0 and k * f * c_max * 10 <= budget_bytes:
            key = (abs(k * f - target_rows), -k)
            if best_key is None or key < best_key:
                best, best_key = k, key
    return best


def quant_w(w: torch.Tensor):
    """pallas_resnet._quant_w: a conv kernel (..., Cout) -> (w8t (Cout, K)
    int8, rsw (Cout,) f32), per-output-channel scales over the (K, Cout)
    matrix, round half to even, clip to +-127, the scales returned as
    reciprocals. w8t is stored n-major, as the int8 kernels read it."""
    w8t, sw = quantize_weight(w)
    return w8t, 1.0 / sw


def mish_one_exp(x: torch.Tensor) -> torch.Tensor:
    """mish with one exp, as the kernels compute it (pallas_resnet.py
    _mish_f32): tanh(softplus(x)) = ((1+e^x)^2 - 1) / ((1+e^x)^2 + 1), and
    x itself past 20 where the factor is 1.0 in f32."""
    e = torch.exp(torch.clamp(x, max=30.0))
    t = (1.0 + e) * (1.0 + e)
    return torch.where(x > 20.0, x, x * ((t - 1.0) / (t + 1.0)))


def lens_rows_from_mask(mask: torch.Tensor, f: int) -> torch.Tensor:
    """(B, T, ...) prefix mask -> (B,) int32 valid row counts len*F."""
    return frames_from_mask(mask) * f


def block_rows_args(x, mask, t_bias, w1, b1, s1, be1, w2, b2, s2, be2, wres, bres,
                    lens_rows=None):
    """A ResnetBlock's arguments (x (B, T, F, Cin), mask (B, T, 1, 1), flax
    kernels) on rows, as resnet_block_plain and the kernels take them;
    lens_rows: the mask's valid rows when the caller has them."""
    bsz, t, f, cin = x.shape
    cout = w1.shape[-1]
    lens = lens_rows_from_mask(mask, f) if lens_rows is None else lens_rows
    return (x.reshape(bsz, t * f, cin), lens, t_bias,
            w1.reshape(9 * cin, cout), b1, s1, be1, w2.reshape(-1, cout), b2, s2, be2,
            None if wres is None else wres.reshape(cin, cout), bres)


def _valid(lens_rows: torch.Tensor, n: int) -> torch.Tensor:
    pos = torch.arange(n, device=lens_rows.device)
    return (pos[None, :] < lens_rows[:, None]).to(torch.float32)[..., None]


def _group_stats(acc: torch.Tensor, groups: int, eps: float = GN_EPS):
    """f32 accumulators (B, n, C) -> per-channel (mean, inv), each (B, 1, C)."""
    b, n, c = acc.shape
    cg = c // groups
    m = float(n * cg)
    s = acc.sum(dim=1).reshape(b, groups, cg).sum(-1) / m
    ex2 = (acc * acc).sum(dim=1).reshape(b, groups, cg).sum(-1) / m
    inv = torch.rsqrt(ex2 - s * s + eps)
    return (s.repeat_interleave(cg, dim=1)[:, None, :],
            inv.repeat_interleave(cg, dim=1)[:, None, :])


def _gn_mish(c: torch.Tensor, mean, inv, scale, shift) -> torch.Tensor:
    h = (c.to(torch.float32) - mean) * inv
    return mish_one_exp(h * scale.to(torch.float32) + shift.to(torch.float32))


def _kernel_c_plain(c2, x, mean, inv, s2, be2, valid, wres, bres, residual: bool = True):
    """Kernel C's plain version: mish(GN2(c2)) * valid plus the residual
    (x * valid, or the 1x1 conv when wres is given), rounded once to x's
    dtype; without the residual (JAX's res_mode "none") the f32 term."""
    h2 = _gn_mish(c2, mean, inv, s2, be2) * valid
    if not residual:
        return h2
    dt = x.dtype
    xv = x.to(torch.float32) * valid
    if wres is None:
        res = xv
    else:
        res = (xv @ wres.to(dt).to(torch.float32) + bres) * valid
    return (h2 + res).to(dt)


def _film_masked(acc1, mean1, inv1, s1, be1, t_bias, valid, dt):
    """Kernel B's conv input: mish(GN1(c1)) + FiLM, masked, in dtype dt."""
    h = _gn_mish(acc1.to(dt), mean1, inv1, s1, be1)
    return ((h + t_bias.to(dt).to(torch.float32)[:, None, :]) * valid).to(dt)


def resnet_block_plain(x, lens_rows, t_bias, w1, b1, s1, be1, w2, b2, s2, be2,
                       wres, bres, f: int, groups: int):
    """The K1 kernel's plain version on rows: x (B, N, Cin) in the
    activation dtype, w1 (9*Cin, Cout), w2 (9*Cout, Cout), wres (Cin, Cout)
    or None for the identity residual, t_bias (B, Cout). -> (B, N, Cout)."""
    dt = x.dtype
    n = x.shape[1]
    valid = _valid(lens_rows, n)
    acc1 = conv3x3_rows(x.to(torch.float32) * valid, w1.to(dt).to(torch.float32), f) + b1
    mean1, inv1 = _group_stats(acc1, groups)
    h = _film_masked(acc1, mean1, inv1, s1, be1, t_bias, valid, dt)
    acc2 = conv3x3_rows(h.to(torch.float32), w2.to(dt).to(torch.float32), f) + b2
    mean2, inv2 = _group_stats(acc2, groups)
    return _kernel_c_plain(acc2.to(dt), x, mean2, inv2, s2, be2, valid, wres, bres)


def _int_mm(col8: torch.Tensor, w8t: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x the n-major int8 (Cout, K) -> int32 (M, Cout), exact.
    On the card torch._int_mm, K padded with zeros to a multiple of 8."""
    if not col8.is_cuda:
        return col8.to(torch.int32) @ w8t.t().to(torch.int32)
    pad = -col8.shape[1] % 8
    if pad:
        col8, w8t = F.pad(col8, (0, pad)), F.pad(w8t, (0, pad))
    return torch._int_mm(col8, w8t.t())


def tile_scales(v: torch.Tensor, f: int, fpt: int) -> torch.Tensor:
    """The activation scale of every TPU tile: v (B, T*F, C) the conv input
    as the kernel sees it (masked; f32 values) -> (B, T / fpt) f32,
    127 / (max|window| + 1e-8) with the window the tile's fpt frames and one
    frame on each side (zero outside the array)."""
    b, n, c = v.shape
    t = n // f
    frame_max = v.abs().reshape(b, t, f * c).amax(dim=-1)
    window_max = F.pad(frame_max, (1, 1)).unfold(1, fpt + 2, fpt).amax(dim=-1)
    # a true division (a Python number over a tensor multiplies by the
    # reciprocal, which rounds twice)
    return torch.full_like(window_max, 127.0) / (window_max + 1e-8)


def tile_row_scales(v: torch.Tensor, f: int, fpt: int) -> torch.Tensor:
    """tile_scales repeated for every row of its tile: (B, T*F) f32."""
    return tile_scales(v, f, fpt).repeat_interleave(fpt * f, dim=1)


def tile_copy_plain(v: torch.Tensor, f: int, fpt: int):
    """K10a's per-tile copy (csrc/resnet_block_i8.cu tile_copy) of v (B,
    T*F, C), the conv input as the kernel sees it (masked; f32 values) ->
    (x8t (B, T / fpt, fpt + 2, F, Cp) int8, sx = tile_scales (B, T / fpt)),
    Cp = C rounded up to 16: copy frame c of tile j is frame j fpt - 1 + c
    (the tile's window: its halo frames duplicated from the neighbouring
    tiles), clip(round_half_even(v * sx[b, j]), -127, 127), zero outside the
    array and at channels past C."""
    b, n, c = v.shape
    t = n // f
    sx = tile_scales(v, f, fpt)
    frames = F.pad(v.reshape(b, t, f, c), (0, -c % 16, 0, 0, 1, 1))
    win = frames.unfold(1, fpt + 2, fpt).permute(0, 1, 4, 2, 3)  # (B, tiles, fpt+2, F, Cp)
    q = torch.clamp(torch.round(win * sx[:, :, None, None, None]), -127, 127)
    return q.to(torch.int8).contiguous(), sx


def conv3x3_i8_copy(x8t: torch.Tensor, wq, sx: torch.Tensor) -> torch.Tensor:
    """K10a's int8 conv over a per-tile copy as the card runs it
    (us_resnet_conv3x3_i8_tiles): x8t (B, tiles, fpt + 2, F, Cp) int8, wq =
    quant_w(w) for Cin <= Cp input channels, sx (B, tiles) -> (B, tiles *
    fpt * F, Cout) f32 before the bias: output frame u of tile j takes taps
    from copy frames u .. u + 2 (zero past the frequency edges), int8 x int8
    -> int32, then f32(acc) * ((1 / sx[b, j]) * rsw)."""
    b, nt, fp2, f, _ = x8t.shape
    fpt = fp2 - 2
    w8t, rsw = wq
    cin = w8t.shape[1] // 9
    xp = F.pad(x8t[..., :cin], (0, 0, 1, 1))
    col = torch.stack([xp[:, :, dt:dt + fpt, df:df + f] for dt in range(3) for df in range(3)],
                      dim=4)  # (B, tiles, fpt, F, 9 taps, Cin)
    acc = _int_mm(col.reshape(-1, 9 * cin), w8t).reshape(b, nt * fpt * f, -1)
    s = sx.repeat_interleave(fpt * f, dim=1)[..., None]
    return acc.to(torch.float32) * ((1.0 / s) * rsw)


def conv3x3_i8_tiles(v: torch.Tensor, wq, f: int, fpt: int) -> torch.Tensor:
    """pallas_resnet._conv3x3_taps_int8 over every tile of (B, T*F, Cin)
    rows: each output row's window quantized with its tile's scale
    (tile_row_scales), int8 x int8 -> int32 with wq = quant_w(w), then
    f32(acc) * ((1/s) * rsw). -> (B, T*F, Cout) f32, before the bias."""
    b, n, cin = v.shape
    w8t, rsw = wq
    s = tile_row_scales(v, f, fpt)[..., None]
    col8 = torch.clamp(torch.round(im2col(v, f) * s), -127, 127).to(torch.int8)
    acc = _int_mm(col8.reshape(b * n, 9 * cin), w8t).reshape(b, n, -1)
    return acc.to(torch.float32) * ((1.0 / s) * rsw)


def resnet_block_i8_plain(x, lens_rows, t_bias, w1, wq1, b1, s1, be1, wq2, b2, s2, be2,
                          wres, bres, f: int, groups: int, fpt: int, conv1_bf16: bool = False):
    """The K10 kernels' plain version on rows (K10a; K10b with fpt = T):
    x (B, N, Cin) in the activation dtype, wq1/wq2 = quant_w of the conv
    kernels; with conv1_bf16 conv1 runs in bf16 from w1 (9*Cin, Cout)
    (JAX's deep hybrid for Cin > Cout) and wq1 is not read. -> (B, N,
    Cout)."""
    dt = x.dtype
    n = x.shape[1]
    valid = _valid(lens_rows, n)
    xv = x.to(torch.float32) * valid
    if conv1_bf16:
        acc1 = conv3x3_rows(xv, w1.to(dt).to(torch.float32), f) + b1
    else:
        acc1 = conv3x3_i8_tiles(xv, wq1, f, fpt) + b1
    mean1, inv1 = _group_stats(acc1, groups)
    h = _film_masked(acc1, mean1, inv1, s1, be1, t_bias, valid, dt)
    acc2 = conv3x3_i8_tiles(h.to(torch.float32), wq2, f, fpt) + b2
    mean2, inv2 = _group_stats(acc2, groups)
    return _kernel_c_plain(acc2.to(dt), x, mean2, inv2, s2, be2, valid, wres, bres)


def final_block_plain(x, lens_rows, w1, b1, s1, be1, wo, bo, f: int, groups: int):
    """The K2 kernel's plain version: x (B, N, Cin), w1 (9*Cin, C), wo (C,)
    -> (B, N) f32 score."""
    dt = x.dtype
    n = x.shape[1]
    valid = _valid(lens_rows, n)
    acc1 = conv3x3_rows(x.to(torch.float32) * valid, w1.to(dt).to(torch.float32), f) + b1
    mean1, inv1 = _group_stats(acc1, groups)
    h = (_gn_mish(acc1.to(dt), mean1, inv1, s1, be1) * valid).to(dt)
    y = h.to(torch.float32) @ wo.to(dt).to(torch.float32) + bo
    return y * valid[..., 0]


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _packed_operand(packed, what, taps, cin, cout, dev):
    """Check a pack_conv_weight result for a conv of `taps` taps from Cin to
    Cout. -> (the tensor, its Cout tile BN; 0 for the raw rows)."""
    if cin % 8:
        shape, bn = (taps * cin, cout), 0
    else:
        bn = packed.shape[-2] if packed.dim() == 5 else 0  # the packer's choice
        if bn not in (64, 128) or cout % bn:
            raise ValueError(f"{what}: packed kernel {tuple(packed.shape)} for Cout={cout}")
        shape = (cout // bn, -(-cin // KC), taps, bn, KC)
    return _cuda.require(packed, what, dtype=torch.bfloat16, shape=shape, device=dev), bn


def _conv_part(lib, x, w, bn, bias, lens, f):
    """Launch kernel A (w from pack_conv_weight, BN its Cout tile; bias f32).
    -> (c, its tile sums (B, tiles, 2, Cout))."""
    b, n, cin = x.shape
    cout = bias.shape[-1]
    part = torch.empty((b, lib.us_conv_n_tiles(n, f, cin), 2, cout), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((b, n, cout), dtype=x.dtype, device=x.device)
    _cuda.check(
        lib.us_resnet_conv3x3(x.data_ptr(), w.data_ptr(), bn, bias.data_ptr(), lens.data_ptr(),
                              out.data_ptr(), part.data_ptr(), b, n, f, cin, cout, 0,
                              _cuda.stream(x)),
        "resnet conv3x3",
    )
    return out, part


def _conv_stats(lib, x, w, bn, bias, lens, f, groups):
    """Launch kernel A, then reduce its tile statistics. -> (c, mean, inv)."""
    b, n, _ = x.shape
    cout = bias.shape[-1]
    out, part = _conv_part(lib, x, w, bn, bias, lens, f)
    mean = torch.empty((b, cout), dtype=torch.float32, device=x.device)
    inv = torch.empty_like(mean)
    _cuda.check(
        lib.us_gn_finalize(part.data_ptr(), b, part.shape[1], cout, groups, n, GN_EPS,
                           mean.data_ptr(), inv.data_ptr(), 0, _cuda.stream(x)),
        "groupnorm statistics",
    )
    return out, mean, inv


def _check_shapes(what, x, cout, groups):
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the kernel takes bf16 activations, got {x.dtype}")
    if not takes(cout, groups):
        raise ValueError(f"{what}: unsupported Cout={cout} with groups={groups} (a multiple "
                         f"of 64, groups of a multiple of 8 channels)")


def _resnet_block_cuda(x, lens, t_bias, w1, b1, s1, be1, w2, b2, s2, be2, wres, bres,
                       f, groups, packed=None, what="fused_resnet_block"):
    """K1 (and K8, ops/fused_resnet_deep.py): the block's five launches in
    one call of us_resnet_block. packed: pack_block_weights of the flax
    kernels, made here when absent."""
    b, n, cin = x.shape
    cout = b1.shape[-1]
    _check_shapes(what, x, cout, groups)
    if wres is None and cin != cout:
        raise ValueError(f"{what}: identity residual needs Cin == Cout")
    if packed is None:
        packed = pack_block_weights(w1.reshape(3, 3, cin, cout), w2.reshape(3, 3, cout, cout),
                                    None if wres is None else wres.reshape(1, 1, cin, cout))
    dt, dev = x.dtype, x.device
    _cuda.require(x, "x", dtype=dt)
    _cuda.require(lens, "lens", dtype=torch.int32, shape=(b,), device=dev)
    w1, bn = _packed_operand(packed[0], "w1", 9, cin, cout, dev)
    w2, bn2 = _packed_operand(packed[1], "w2", 9, cout, cout, dev)
    wr, bnr = (None, bn2) if wres is None else _packed_operand(packed[2], "wres", 1, cin,
                                                               cout, dev)
    if len({t for t in (bn, bn2, bnr) if t}) != 1:
        raise ValueError(f"{what}: the packed kernels' Cout tiles differ")
    film = _cuda.require(t_bias.to(dt).contiguous(), "t_bias", shape=(b, cout), device=dev)
    if wres is not None:
        bres = _f32(bres)
    lib = _cuda.lib()
    c1, c2, out = (torch.empty((b, n, cout), dtype=dt, device=dev) for _ in range(3))
    nt = max(lib.us_conv_n_tiles(n, f, cin), lib.us_conv_n_tiles(n, f, cout))
    part = torch.empty((b, nt, 2, cout), dtype=torch.float32, device=dev)
    stats = torch.empty((4, b, cout), dtype=torch.float32, device=dev)  # mean/inv x 2
    operands = (x, w1, _f32(b1), _f32(s1), _f32(be1), film, w2, _f32(b2), _f32(s2), _f32(be2))
    _cuda.check(lib.us_resnet_block(
        *(t.data_ptr() for t in operands), _cuda.ptr(wr), _cuda.ptr(bres), lens.data_ptr(),
        c1.data_ptr(), c2.data_ptr(), part.data_ptr(), *(t.data_ptr() for t in stats),
        out.data_ptr(), b, n, f, cin, cout, groups, GN_EPS, bn2, _cuda.stream(x)),
        what)
    return out


def _i8_tiles_shape(what, n, f, fpt):
    t = n // f
    if n != t * f or fpt <= 0 or t % fpt:
        raise ValueError(f"{what}: {n} rows of F={f} do not split into tiles of {fpt} frames")
    return t


def conv_plan_i8_tiles(b: int, t: int, f: int, cp: int, cout: int, fpt: int) -> dict:
    """K10a's conv launch plan (the card's us_conv_plan_i8_tiles) over a
    per-tile copy of Cp channels with the packer's Cout tile: conv_plan's
    keys and `sub`, the row tiles of one TPU tile of fpt frames."""
    import ctypes

    info = (ctypes.c_int * 9)()
    _cuda.check(_cuda.lib().us_conv_plan_i8_tiles(b, t, f, cp, cout, tile_cols(cout), fpt, info),
                "us_conv_plan_i8_tiles")
    keys = ("tt", "tf", "bn", "blocks", "threads", "smem", "tiles", "blocks_per_sm", "sub")
    return dict(zip(keys, info))


def quantize_tiles(x, lens_rows, f: int, fpt: int):
    """K10a's per-tile copy of a conv input alone: x (B, T*F, C) bf16 rows,
    lens_rows (B,) -> (x8t (B, T / fpt, fpt + 2, F, Cp) int8, sx (B, T / fpt)
    f32) as tile_copy_plain gives them for the masked rows. CUDA tensors
    launch the chain's first two kernels (frame maxima, then the copy with
    the tile scales), CPU tensors take tile_copy_plain."""
    b, n, c = x.shape
    if not _cuda.route(x, "quantize_tiles"):
        return tile_copy_plain(x.to(torch.float32) * _valid(lens_rows, n), f, fpt)
    t = _i8_tiles_shape("quantize_tiles", n, f, fpt)
    dev = x.device
    _cuda.require(x, "x", dtype=torch.bfloat16)
    lens = _cuda.require(lens_rows.to(torch.int32).contiguous(), "lens", shape=(b,), device=dev)
    fmax = torch.empty((b, t), dtype=torch.float32, device=dev)
    sx = torch.empty((b, t // fpt), dtype=torch.float32, device=dev)
    x8t = torch.empty((b, t // fpt, fpt + 2, f, -(-c // 16) * 16), dtype=torch.int8, device=dev)
    _cuda.check(_cuda.lib().us_i8_tile_copy(x.data_ptr(), lens.data_ptr(), fmax.data_ptr(),
                                            sx.data_ptr(), x8t.data_ptr(), b, n, f, c, fpt,
                                            _cuda.stream(x)), "quantize_tiles")
    quantize_tiles.launches += 1
    return x8t, sx


quantize_tiles.launches = 0


def resnet_conv3x3_i8_tiles(x8t, sx, wq, bias, packed=None):
    """K10a's int8 conv alone over a per-tile copy (quantize_tiles): x8t (B,
    tiles, fpt + 2, F, Cp) int8, sx (B, tiles), wq = quant_w(w) ->
    bf16(conv3x3_i8_copy + bias) (B, tiles * fpt * F, Cout). packed:
    pack_conv_weight_i8(wq[0], Cin), else packed here. CUDA tensors launch
    the kernel, CPU tensors take conv3x3_i8_copy (integer products are
    exact: the two are equal bit for bit)."""
    if not _cuda.route(x8t, "resnet_conv3x3_i8_tiles"):
        return (conv3x3_i8_copy(x8t, wq, sx) + bias).to(torch.bfloat16)
    b, nt, fp2, f, cp = x8t.shape
    cout, k = wq[0].shape
    cin, fpt, n = k // 9, fp2 - 2, nt * (fp2 - 2) * f
    if not takes(cout) or cp % 16 or cin > cp:
        raise ValueError(f"resnet_conv3x3_i8_tiles: Cin={cin} (copy {cp}), Cout={cout}")
    dev = x8t.device
    _cuda.require(x8t, "x8t", dtype=torch.int8)
    wp, bn = _packed_i8(pack_conv_weight_i8(wq[0], cin) if packed is None else packed, "w8",
                        cin, cout, dev)
    sx = _cuda.require(_f32(sx), "sx", shape=(b, nt), device=dev)
    rsw = _cuda.require(_f32(wq[1]), "rsw", shape=(cout,), device=dev)
    bias = _cuda.require(_f32(bias), "bias", shape=(cout,), device=dev)
    lib = _cuda.lib()
    part = torch.empty((b, lib.us_conv_i8_tiles_n_tiles(n, f, fpt), 2, cout),
                       dtype=torch.float32, device=dev)
    out = torch.empty((b, n, cout), dtype=torch.bfloat16, device=dev)
    _cuda.check(lib.us_resnet_conv3x3_i8_tiles(x8t.data_ptr(), wp.data_ptr(), bn, sx.data_ptr(),
                                               rsw.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                               part.data_ptr(), b, n, f, cp, cout, fpt,
                                               _cuda.stream(x8t)), "resnet_conv3x3_i8_tiles")
    resnet_conv3x3_i8_tiles.launches += 1
    return out


resnet_conv3x3_i8_tiles.launches = 0


def _resnet_block_i8_cuda(x, lens, t_bias, wq1, b1, s1, be1, wq2, b2, s2, be2, wres, bres, f,
                          groups, fpt, packed, what):
    """K10a: the block's nine launches in one call of us_resnet_block_i8
    (csrc/resnet_block_i8.cu); packed: pack_block_weights_int8's (conv1,
    conv2, the 1x1 residual), made here from wq and wres when absent."""
    b, n, cin = x.shape
    cout = b1.shape[-1]
    _check_shapes(what, x, cout, groups)
    if wres is None and cin != cout:
        raise ValueError(f"{what}: identity residual needs Cin == Cout")
    t = _i8_tiles_shape(what, n, f, fpt)
    dt, dev = x.dtype, x.device
    x = _cuda.require(x.contiguous(), "x", dtype=dt)
    _cuda.require(lens, "lens", dtype=torch.int32, shape=(b,), device=dev)
    film = _cuda.require(t_bias.to(dt).contiguous(), "t_bias", shape=(b, cout), device=dev)
    if packed is None:
        packed = pack_block_weights_int8((wq1, wq2),
                                         None if wres is None else wres.reshape(1, 1, cin, cout))
    w1p, bn = _packed_i8(packed[0], "w1 (int8)", cin, cout, dev)
    w2p, bn2 = _packed_i8(packed[1], "w2 (int8)", cout, cout, dev)
    wrp, bnr = None, bn
    if wres is not None:
        wrp, bnr = _packed_operand(packed[2], "wres", 1, cin, cout, dev)
        bres = _f32(bres)
    if bn != bn2 or bnr not in (0, bn):
        raise ValueError(f"{what}: the packed kernels' Cout tiles differ")
    rsw1 = _cuda.require(_f32(wq1[1]), "rsw1", shape=(cout,), device=dev)
    rsw2 = _cuda.require(_f32(wq2[1]), "rsw2", shape=(cout,), device=dev)
    lib = _cuda.lib()
    nt = t // fpt
    fmax = torch.empty((b, t), dtype=torch.float32, device=dev)
    sx = torch.empty((2, b, nt), dtype=torch.float32, device=dev)
    x8t = torch.empty((b, nt, fpt + 2, f, -(-cin // 16) * 16), dtype=torch.int8, device=dev)
    h8t = torch.empty((b, nt, fpt + 2, f, cout), dtype=torch.int8, device=dev)
    c1, c2, out = (torch.empty((b, n, cout), dtype=dt, device=dev) for _ in range(3))
    part = torch.empty((b, lib.us_conv_i8_tiles_n_tiles(n, f, fpt), 2, cout),
                       dtype=torch.float32, device=dev)
    stats = torch.empty((4, b, cout), dtype=torch.float32, device=dev)  # mean/inv x 2
    vecs = tuple(map(_f32, (b1, s1, be1)))
    vecs2 = tuple(map(_f32, (b2, s2, be2)))
    _cuda.check(lib.us_resnet_block_i8(
        x.data_ptr(), w1p.data_ptr(), rsw1.data_ptr(), *(v.data_ptr() for v in vecs),
        film.data_ptr(), w2p.data_ptr(), rsw2.data_ptr(), *(v.data_ptr() for v in vecs2),
        _cuda.ptr(wrp), _cuda.ptr(bres), lens.data_ptr(), fmax.data_ptr(), sx[0].data_ptr(),
        sx[1].data_ptr(), x8t.data_ptr(), h8t.data_ptr(), c1.data_ptr(), c2.data_ptr(),
        part.data_ptr(), *(t_.data_ptr() for t_ in stats), out.data_ptr(), b, n, f, cin, cout,
        fpt, groups, GN_EPS, bn, _cuda.stream(x)), what)
    return out


def fused_resnet_block_int8(x, mask, t_bias, w1, b1, gn1_scale, gn1_bias,
                            w2, b2, gn2_scale, gn2_bias, wres=None, bres=None,
                            groups: int = 8, frames_per_tile: int = 0, wq=None, packed=None):
    """K10a: fused_resnet_block with both convs in int8, quantized in
    kernel per tile of frames_per_tile frames (0: pick_frames_per_tile, as
    JAX picks it). wq = (quant_w(w1), quant_w(w2)) when computed once, else
    computed here; packed: pack_block_weights_int8 of wq and wres when made
    once, else packed here. -> (B, T, F, Cout). CUDA tensors launch the
    kernel, CPU tensors take resnet_block_i8_plain."""
    bsz, t, f, cin = x.shape
    cout = w1.shape[-1]
    fpt = frames_per_tile or pick_frames_per_tile(t, f, max(cin, cout))
    if t % fpt:
        raise ValueError(f"fused_resnet_block: frames_per_tile={fpt} does not divide T={t}")
    wq1, wq2 = (quant_w(w1), quant_w(w2)) if wq is None else wq
    xr, lens, tb, w1r, b1, s1, be1, _, b2, s2, be2, wres, bres = block_rows_args(
        x, mask, t_bias, w1, b1, gn1_scale, gn1_bias, w2, b2, gn2_scale, gn2_bias, wres, bres)
    args = (xr, lens, tb, w1r, wq1, b1, s1, be1, wq2, b2, s2, be2, wres, bres)
    if _cuda.route(x, "fused_resnet_block(int8=True)"):
        out = _resnet_block_i8_cuda(xr, lens, tb, wq1, b1, s1, be1, wq2, b2, s2, be2, wres, bres,
                                    f=f, groups=groups, fpt=fpt, packed=packed,
                                    what="fused_resnet_block(int8=True)")
        fused_resnet_block_int8.launches += 1
    else:
        out = resnet_block_i8_plain(*args, f=f, groups=groups, fpt=fpt)
    return out.reshape(bsz, t, f, cout)


fused_resnet_block_int8.launches = 0


def fused_resnet_block(x, mask, t_bias, w1, b1, gn1_scale, gn1_bias,
                       w2, b2, gn2_scale, gn2_bias, wres=None, bres=None,
                       groups: int = 8, int8: bool = False, frames_per_tile: int = 0,
                       wq=None, packed=None, seq=None, model=None):
    """One U-Net ResnetBlock (plain twin: models/unet.py ResnetBlock).

    x (B, T, F, Cin); mask (B, T, 1, 1) prefix mask; t_bias (B, Cout) the
    FiLM bias Dense(mish(t_emb)); w1/w2 (3, 3, Cin|Cout, Cout) flax conv
    kernels (spatial (t, f)); wres/bres the optional 1x1 residual; packed:
    pack_block_weights of the three kernels when made at load (else the
    launch packs them). -> (B, T, F, Cout). CUDA tensors launch the kernel
    (widths: `takes`), CPU tensors take resnet_block_plain. int8=True is
    K10a (fused_resnet_block_int8, which takes frames_per_tile, wq, and
    packed from pack_block_weights_int8); in bf16 they change nothing.
    seq: x is a frame slice of the seq axis (parallel.FrameSlice); model:
    the kernels and biases are this rank's Cout columns of the model axis
    (parallel.ModelShard; x every channel, the GroupNorm vectors whole):
    the sharded chain (resnet_block_sharded), kernels on CUDA tensors,
    their plain twins on CPU tensors; the output is every channel."""
    if (seq is not None or model is not None) and int8:
        raise NotImplementedError("fused_resnet_block(int8=True) on a slice: K10a has no "
                                  "model route and no sharded form")
    if int8:
        return fused_resnet_block_int8(x, mask, t_bias, w1, b1, gn1_scale, gn1_bias, w2, b2,
                                       gn2_scale, gn2_bias, wres, bres, groups=groups,
                                       frames_per_tile=frames_per_tile, wq=wq, packed=packed)
    bsz, t, f, _ = x.shape
    args = block_rows_args(x, mask, t_bias, w1, b1, gn1_scale, gn1_bias, w2, b2, gn2_scale,
                           gn2_bias, wres, bres)
    if seq is not None or model is not None:
        out = resnet_block_sharded(*args, f=f, groups=groups, seq=seq, model=model,
                                   packed=packed)
        if x.is_cuda:
            fused_resnet_block.launches += 1
    elif _cuda.route(x, "fused_resnet_block"):
        out = _resnet_block_cuda(*args, f=f, groups=groups, packed=packed)
        fused_resnet_block.launches += 1
    else:
        out = resnet_block_plain(*args, f=f, groups=groups)
    return out.reshape(bsz, t, f, -1)


fused_resnet_block.launches = 0


def resnet_conv3x3_plain(x, lens_rows, w, bias, f: int, groups: int):
    """Kernel A's plain version: masked x (B, N, Cin) rows, w (9*Cin, Cout)
    -> (c in x's dtype, mean, inv), mean/inv (B, Cout) the GroupNorm
    statistics of the f32 conv output over every row."""
    valid = _valid(lens_rows, x.shape[1])
    acc = conv3x3_rows(x.to(torch.float32) * valid, w.to(x.dtype).to(torch.float32), f) + bias
    mean, inv = _group_stats(acc, groups)
    return acc.to(x.dtype), mean[:, 0], inv[:, 0]


def resnet_conv3x3(x, lens_rows, w, bias, f: int, groups: int = 8, packed=None):
    """Kernel A alone (K1/K8's conv1 with its statistics; JAX's
    _kernel_a_deep, probed alone by tools/bisect_deep_compile.py): x (B, N,
    Cin) bf16 rows, lens_rows (B,) int32, w (9*Cin, Cout); packed:
    pack_conv_weight of w as a (3, 3, Cin, Cout) kernel, made here when
    absent. -> (c bf16, mean, inv (B, Cout) f32). CUDA tensors launch the
    kernel, CPU tensors take resnet_conv3x3_plain."""
    if not _cuda.route(x, "resnet_conv3x3"):
        return resnet_conv3x3_plain(x, lens_rows, w, bias, f, groups)
    b, n, cin = x.shape
    cout = w.shape[-1]
    _check_shapes("resnet_conv3x3", x, cout, groups)
    _cuda.require(x, "x", dtype=x.dtype)
    _cuda.require(lens_rows, "lens", dtype=torch.int32, shape=(b,), device=x.device)
    if packed is None:
        packed = pack_conv_weight(w.reshape(3, 3, cin, cout))
    wp, bn = _packed_operand(packed, "w", 9, cin, cout, x.device)
    out = _conv_stats(_cuda.lib(), x, wp, bn, _f32(bias), lens_rows, f, groups)
    resnet_conv3x3.launches += 1
    return out


resnet_conv3x3.launches = 0

OUT_MODES = ("identity", "none", "matmul")  # JAX's _kernel_c res_mode


def resnet_out_plain(c2, x, mean, inv, scale, shift, lens_rows, mode: str, wres=None,
                     bres=None):
    """Kernel C's plain version: c2 (B, N, Cout), x (B, N, Cin), mean/inv
    (B, Cout); mode "identity" adds x, "matmul" the 1x1 conv (wres (Cin,
    Cout), bres), "none" returns the f32 GN2 + mish + mask term alone."""
    valid = _valid(lens_rows, c2.shape[1])
    return _kernel_c_plain(c2, x, mean[:, None, :], inv[:, None, :], scale, shift, valid,
                           wres if mode == "matmul" else None, bres, residual=mode != "none")


def resnet_out(c2, x, mean, inv, scale, shift, lens_rows, mode: str = "identity", wres=None,
               bres=None, packed=None):
    """Kernel C alone (K1/K8's output kernel; JAX's _kernel_c in res_mode
    `mode`, probed alone by tools/bisect_deep_compile.py), arguments as
    resnet_out_plain; packed: pack_conv_weight of wres as a (1, 1, Cin,
    Cout) kernel, made here when absent. bf16 out, f32 in mode "none". CUDA
    tensors launch the kernel, CPU tensors take resnet_out_plain."""
    if mode not in OUT_MODES:
        raise ValueError(f"resnet_out: mode {mode!r}, expected one of {OUT_MODES}")
    if (mode == "matmul") != (wres is not None):
        raise ValueError("resnet_out: wres is given in mode 'matmul' and only there")
    if not _cuda.route(c2, "resnet_out"):
        return resnet_out_plain(c2, x, mean, inv, scale, shift, lens_rows, mode, wres, bres)
    b, n, cout = c2.shape
    cin = x.shape[-1]
    if mode == "identity" and cin != cout:
        raise ValueError("resnet_out: identity residual needs Cin == Cout")
    _check_shapes("resnet_out", c2, cout, 1)
    dt, dev = c2.dtype, c2.device
    _cuda.require(c2, "c2", dtype=dt)
    x = _cuda.require(x, "x", dtype=dt, shape=(b, n, cin), device=dev)
    _cuda.require(lens_rows, "lens", dtype=torch.int32, shape=(b,), device=dev)
    mean, inv = (_cuda.require(_f32(v), name, shape=(b, cout), device=dev)
                 for v, name in ((mean, "mean"), (inv, "inv")))
    scale, shift = _f32(scale), _f32(shift)
    lib, st = _cuda.lib(), _cuda.stream(c2)
    if mode == "none":
        out = torch.empty((b, n, cout), dtype=torch.float32, device=dev)
        _cuda.check(lib.us_resnet_out_none(c2.data_ptr(), mean.data_ptr(), inv.data_ptr(),
                                           scale.data_ptr(), shift.data_ptr(),
                                           lens_rows.data_ptr(), out.data_ptr(), b, n, cout,
                                           st), "resnet_out(none)")
    else:
        wp, bn = None, 0
        if wres is not None:
            if packed is None:
                packed = pack_conv_weight(wres.reshape(1, 1, cin, cout))
            wp, bn = _packed_operand(packed, "wres", 1, cin, cout, dev)
            bres = _f32(bres)
        out = torch.empty((b, n, cout), dtype=dt, device=dev)
        _cuda.check(lib.us_resnet_out(c2.data_ptr(), x.data_ptr(), mean.data_ptr(),
                                      inv.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                                      _cuda.ptr(wp), bn, _cuda.ptr(bres), lens_rows.data_ptr(),
                                      out.data_ptr(), b, n, cin, cout, 0, st),
                    f"resnet_out({mode})")
    resnet_out.launches += 1
    return out


resnet_out.launches = 0


def _final_block_cuda(x, lens, w1, b1, s1, be1, wo, bo, f, groups, packed=None):
    """K2: two launches (csrc/resnet_block.cu us_final_block): kernel A, then
    the tail (kernel A's tile sums reduced, the group fold, GroupNorm + mish
    + mask and the 1-channel final conv) as a programmatic dependent
    launch."""
    b, n, cin = x.shape
    cout = w1.shape[-1]
    _check_shapes("fused_final_block", x, cout, groups)
    dt, dev = x.dtype, x.device
    _cuda.require(x, "x", dtype=dt)
    _cuda.require(lens, "lens", dtype=torch.int32, shape=(b,), device=dev)
    if packed is None:
        packed = pack_conv_weight(w1.reshape(3, 3, cin, cout))
    w1, bn = _packed_operand(packed, "w1", 9, cin, cout, dev)
    # w_out in f32: the tail rounds it to bf16 as it stages it
    wo = _cuda.require(_f32(wo), "w_out", shape=(cout,), device=dev)
    lib = _cuda.lib()
    part = torch.empty((b, lib.us_conv_n_tiles(n, f, cin), 2, cout), dtype=torch.float32,
                       device=dev)
    c1 = torch.empty((b, n, cout), dtype=dt, device=dev)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    _cuda.check(
        lib.us_final_block(x.data_ptr(), w1.data_ptr(), bn, _f32(b1).data_ptr(), lens.data_ptr(),
                           c1.data_ptr(), part.data_ptr(), _f32(s1).data_ptr(),
                           _f32(be1).data_ptr(), wo.data_ptr(), _f32(bo).data_ptr(),
                           out.data_ptr(), b, n, f, cin, cout, groups, GN_EPS, _cuda.stream(x)),
        "fused_final_block",
    )
    return out


def fused_final_block(x, mask, w1, b1, gn_scale, gn_bias, w_out, b_out, groups: int = 8,
                      packed=None, seq=None, model=None):
    """conv3x3 + GN + mish + mask (the estimator's final_block) fused with
    the 1-channel final_conv: x (B, T, F, C) -> (B, T, F) f32 score.
    packed: pack_conv_weight(w1) when made at load. CUDA tensors launch the
    kernel (widths: `takes`), CPU tensors take final_block_plain. seq: x
    is a frame slice of the seq axis; model: w1 and b1 are this rank's
    columns of the model axis (w_out whole): the sharded chain
    (final_block_sharded)."""
    bsz, t, f, cin = x.shape
    cout = w1.shape[-1]
    args = (
        x.reshape(bsz, t * f, cin), lens_rows_from_mask(mask, f),
        w1.reshape(9 * cin, cout), b1, gn_scale, gn_bias, w_out.reshape(-1), b_out,
    )
    if seq is not None or model is not None:
        out = final_block_sharded(*args, f=f, groups=groups, seq=seq, model=model,
                                  packed=packed)
        if x.is_cuda:
            fused_final_block.launches += 1
    elif _cuda.route(x, "fused_final_block"):
        out = _final_block_cuda(*args, f=f, groups=groups, packed=packed)
        fused_final_block.launches += 1
    else:
        out = final_block_plain(*args, f=f, groups=groups)
    return out.reshape(bsz, t, f)


fused_final_block.launches = 0


# --- the sharded chain on a frame slice of the seq axis -----------------------


def _tiles_each(seq, f, cin, cuda):
    """Every rank's kernel-A tile count at this level (the tile sums' second
    dimension): the card's plan of each rank's rows; one on the CPU (the
    plain twin's one sum)."""
    if not cuda:
        return [1] * len(seq.bounds)
    lib = _cuda.lib()
    return [lib.us_conv_n_tiles(n * f, f, cin) for _, n in seq.bounds]


def resnet_conv3x3_halo_plain(xh, lens_rows, w, bias, f: int):
    """Kernel A on a halo'd input, plain: xh (B, (T + 2) * F, Cin), its
    halo frames read as they are, the interior rows at/after lens_rows
    zero; w (9*Cin, Cout) -> (c (B, T*F, Cout) in xh's dtype, the sums (B,
    1, 2, Cout) f32 of the f32 accumulator: one tile)."""
    dt = xh.dtype
    b, nh = xh.shape[:2]
    n = nh - 2 * f
    one = torch.ones((b, f, 1), dtype=torch.float32, device=xh.device)
    v = torch.cat([one, _valid(lens_rows, n), one], dim=1)
    acc = conv3x3_halo_rows(xh.to(torch.float32) * v, w.to(dt).to(torch.float32), f) + bias
    return acc.to(dt), row_stats_plain(acc)[:, None]


def resnet_conv3x3_halo(xh, lens_rows, w, bias, f: int, packed=None):
    """Kernel A on a halo'd input (us_resnet_conv3x3_halo; uncounted, a step
    of the sharded chains): arguments as resnet_conv3x3_halo_plain, packed
    the conv's pack_conv_weight -> (c, tile sums (B, tiles, 2, Cout)). CUDA
    tensors launch the kernel, CPU tensors take the plain twin."""
    if not _cuda.route(xh, "resnet_conv3x3_halo"):
        return resnet_conv3x3_halo_plain(xh, lens_rows, w, bias, f)
    b, nh, cin = xh.shape
    n, cout = nh - 2 * f, bias.shape[-1]
    if packed is None:
        packed = pack_conv_weight(w.reshape(3, 3, cin, cout))
    wp, bn = _packed_operand(packed, "w", 9, cin, cout, xh.device)
    _cuda.require(xh, "x (halo)", dtype=torch.bfloat16)
    _cuda.require(lens_rows, "lens", dtype=torch.int32, shape=(b,), device=xh.device)
    lib = _cuda.lib()
    part = torch.empty((b, lib.us_conv_n_tiles(n, f, cin), 2, cout), dtype=torch.float32,
                       device=xh.device)
    out = torch.empty((b, n, cout), dtype=xh.dtype, device=xh.device)
    _cuda.check(lib.us_resnet_conv3x3_halo(xh.data_ptr(), wp.data_ptr(), bn,
                                           _f32(bias).data_ptr(), lens_rows.data_ptr(),
                                           out.data_ptr(), part.data_ptr(), b, n, f, cin, cout,
                                           _cuda.stream(xh)), "resnet conv3x3 (halo)")
    return out, part


def resnet_conv3x3_part_plain(x, lens_rows, w, bias, f: int):
    """Kernel A's plain version with its sums: masked x (B, N, Cin) rows, w
    (9*Cin, Cout) -> (c in x's dtype, the sums (B, 1, 2, Cout) f32 of the
    f32 accumulator: one tile)."""
    valid = _valid(lens_rows, x.shape[1])
    acc = conv3x3_rows(x.to(torch.float32) * valid, w.to(x.dtype).to(torch.float32), f) + bias
    return acc.to(x.dtype), row_stats_plain(acc)[:, None]


def resnet_conv3x3_part(x, lens_rows, w, bias, f: int, packed=None):
    """Kernel A alone with its tile sums (us_resnet_conv3x3; uncounted, a
    step of the sharded chains): arguments as resnet_conv3x3_part_plain,
    packed the conv's pack_conv_weight -> (c, tile sums (B, tiles, 2,
    Cout)). CUDA tensors launch the kernel, CPU tensors take the plain
    twin."""
    if not _cuda.route(x, "resnet_conv3x3_part"):
        return resnet_conv3x3_part_plain(x, lens_rows, w, bias, f)
    b, n, cin = x.shape
    cout = bias.shape[-1]
    if packed is None:
        packed = pack_conv_weight(w.reshape(3, 3, cin, cout))
    wp, bn = _packed_operand(packed, "w", 9, cin, cout, x.device)
    _cuda.require(x, "x", dtype=torch.bfloat16)
    _cuda.require(lens_rows, "lens", dtype=torch.int32, shape=(b,), device=x.device)
    return _conv_part(_cuda.lib(), x, wp, bn, _f32(bias), lens_rows, f)


def _kernel_a_rows(x, lens, w, bias, f, packed, seq, mask_sent):
    """Kernel A over this rank's rows -> (c, tile sums (B, tiles, 2, Cout)):
    on a frame slice over its halo'd rows (the frames sent masked by
    mask_sent's valid rows when given), every seq rank's sums gathered."""
    if seq is None:
        return resnet_conv3x3_part(x, lens, w, bias, f, packed)
    c, part = resnet_conv3x3_halo(halo_rows(x, f, seq, mask_sent), lens, w, bias, f, packed)
    return c, seq.cat(part, _tiles_each(seq, f, x.shape[-1], _cuda.route(x, "kernel A")))


def _slice_stats(part, groups, n_rows, model):
    """Gathered tile sums (B, tiles, 2, C) of n_rows rows -> per-channel
    (mean, inv), each (B, 1, C); C a model rank's slice (fold_slice)."""
    mean, inv = fold_slice(part.sum(dim=1), groups, n_rows, GN_EPS, model)
    return mean[:, None], inv[:, None]


def _slice_args(model, what, cout, groups, x, cuda, *vecs):
    """A chain's per-channel vectors cut to this model rank's columns, and
    the slice's groups (the whole groups when there is no model axis); the
    kernels take whole groups only."""
    g = slice_groups(groups, model)
    if model is not None:
        vecs = tuple(model.take(v.reshape(-1), 0) for v in vecs)
    if cuda:
        if not g:
            raise ValueError(f"{what}: {groups} groups straddle the model axis's "
                             f"{model.size} ranks")
        _check_shapes(what, x, cout, g)
    return g, vecs


def resnet_block_sharded(x, lens, t_bias, w1, b1, s1, be1, w2, b2, s2, be2, wres, bres, f: int,
                         groups: int, seq=None, model=None, packed=None):
    """K1 on a frame slice of the seq axis and / or a column slice of the
    model axis, in the card's launch order: x (B, N, Cin) this rank's rows
    of every channel, lens its valid rows; w1 (9*Cin, Cout'), b1, t_bias (B,
    Cout'), w2 (9*Cout, Cout'), wres (Cin, Cout') and bres the rank's Cout'
    = Cout / size columns (all of Cout without a model axis), the GroupNorm
    vectors whole. 1 kernel A (over x's halo'd rows on a frame slice);
    2 the tile sums gathered over seq; 3 gn_film on the slice's groups
    with the global row count; 4 h gathered over model (conv2 reads every
    channel); 5 kernel B, its sums gathered over seq; 6 gn_finalize; 7
    kernel C with the residual's columns (the 1x1 conv's, or x's own for
    the identity); 8 the output gathered over model. Collectives: 4 over
    seq (two halos, two sum gathers), 2 over model. CUDA tensors launch
    the kernels, CPU tensors run each step's plain twin; a group that
    straddles two model ranks is summed over the axis in the plain twin and
    refused by the kernels."""
    b, n, cin = x.shape
    cout = b1.shape[-1]
    c_all = w2.shape[0] // 9
    dt, dev = x.dtype, x.device
    cuda = _cuda.route(x, "fused_resnet_block")
    n_glob = n if seq is None else seq.rows(n)
    g, (s1, be1, s2, be2) = _slice_args(model, "fused_resnet_block", cout, groups, x, cuda,
                                        s1, be1, s2, be2)
    xres = x if wres is not None or model is None else model.take(x)
    p1 = p2 = pr = None
    if cuda:
        if wres is None and xres.shape[-1] != cout:
            raise ValueError("fused_resnet_block: identity residual needs Cin == Cout")
        if packed is None:
            packed = pack_block_weights(w1.reshape(3, 3, cin, cout),
                                        w2.reshape(3, 3, c_all, cout),
                                        None if wres is None else wres.reshape(1, 1, cin, cout))
        p1, p2, pr = packed
        _cuda.require(lens, "lens", dtype=torch.int32, shape=(b,), device=dev)
    c1, part = _kernel_a_rows(x, lens, w1, b1, f, p1, seq, lens)
    if cuda:
        lib, st = _cuda.lib(), _cuda.stream(x)
        film = _cuda.require(t_bias.to(dt).contiguous(), "t_bias", shape=(b, cout), device=dev)
        stats = torch.empty((4, b, cout), dtype=torch.float32, device=dev)
        _cuda.check(lib.us_gn_film_rows(part.data_ptr(), part.shape[1], c1.data_ptr(),
                                        lens.data_ptr(), _f32(s1).data_ptr(),
                                        _f32(be1).data_ptr(), film.data_ptr(),
                                        stats[0].data_ptr(), stats[1].data_ptr(), b, n, cout,
                                        g, n_glob, GN_EPS, st), "gn_film (rows)")
        h = c1
    else:
        h = _film_masked(c1, *_slice_stats(part, groups, n_glob, model), s1, be1, t_bias,
                         _valid(lens, n), dt)
    if model is not None:
        h = model.gather(h)
    c2, part = _kernel_a_rows(h, lens, w2, b2, f, p2, seq, None)
    if not cuda:
        out = _kernel_c_plain(c2, xres, *_slice_stats(part, groups, n_glob, model), s2, be2,
                              _valid(lens, n), wres, bres)
        return out if model is None else model.gather(out)
    _cuda.check(lib.us_gn_finalize(part.data_ptr(), b, part.shape[1], cout, g, n_glob,
                                   GN_EPS, stats[2].data_ptr(), stats[3].data_ptr(), 0, st),
                "groupnorm statistics")
    wr, bn = None, 0
    if wres is not None:
        wr, bn = _packed_operand(pr, "wres", 1, cin, cout, dev)
        bres = _f32(bres)
    out = torch.empty((b, n, cout), dtype=dt, device=dev)
    _cuda.check(lib.us_resnet_out(c2.data_ptr(), xres.data_ptr(), stats[2].data_ptr(),
                                  stats[3].data_ptr(), _f32(s2).data_ptr(), _f32(be2).data_ptr(),
                                  _cuda.ptr(wr), bn, _cuda.ptr(bres), lens.data_ptr(),
                                  out.data_ptr(), b, n, xres.shape[-1], cout, 0, st),
                "resnet_out")
    return out if model is None else model.gather(out)


def final_block_sharded(x, lens, w1, b1, s1, be1, wo, bo, f: int, groups: int, seq=None,
                        model=None, packed=None):
    """K2 on a frame slice of the seq axis and / or a column slice of the
    model axis, in the card's launch order: kernel A (over x's halo'd rows
    on a frame slice; w1 (9*Cin, Cout') and b1 the rank's columns), every
    seq rank's tile sums gathered, then the tail (us_final_tail) with the
    global row count on the slice's groups and the rank's columns of the
    1-channel final conv (wo whole, replicated as JAX replicates its (C, 1)
    kernel): the rank's partial dot, the bias on model rank 0 alone, summed
    over model in f32 (one B x N all-reduce in place of gathering the
    B x N x C activation). Arguments as final_block_plain. Collectives: 2
    over seq (the halo, the sums), 1 over model. CUDA tensors launch the
    kernels, CPU tensors run each step's plain twin."""
    b, n, cin = x.shape
    cout = w1.shape[-1]
    dt, dev = x.dtype, x.device
    cuda = _cuda.route(x, "fused_final_block")
    n_glob = n if seq is None else seq.rows(n)
    g, (s1, be1, wo) = _slice_args(model, "fused_final_block", cout, groups, x, cuda,
                                   s1, be1, wo)
    if model is not None and model.rank:
        bo = torch.zeros_like(bo)
    if cuda:
        _cuda.require(lens, "lens", dtype=torch.int32, shape=(b,), device=dev)
    c1, part = _kernel_a_rows(x, lens, w1, b1, f, packed, seq, lens)
    valid = _valid(lens, n)
    if not cuda:
        mean, inv = _slice_stats(part, groups, n_glob, model)
        h = (_gn_mish(c1, mean, inv, s1, be1) * valid).to(dt)
        y = (h.to(torch.float32) @ wo.to(dt).to(torch.float32) + bo) * valid[..., 0]
        return y if model is None else model.all_sum(y)
    wo = _cuda.require(_f32(wo), "w_out", shape=(cout,), device=dev)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    _cuda.check(_cuda.lib().us_final_tail(c1.data_ptr(), part.data_ptr(), part.shape[1],
                                          _f32(s1).data_ptr(), _f32(be1).data_ptr(),
                                          wo.data_ptr(), _f32(bo).data_ptr(), lens.data_ptr(),
                                          out.data_ptr(), b, n, n_glob, cout, g, GN_EPS,
                                          _cuda.stream(x)), "final tail")
    return out if model is None else model.all_sum(out)
