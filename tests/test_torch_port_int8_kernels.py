"""The in-kernel int8 ResnetBlocks of the port against the JAX package on
the CPU: K10a (`fused_resnet_block(int8=True)`, per-tile activation
scales) and K10b (`fused_resnet_block_deep(int8=True)`, one scale per
batch element), their tile choice and window quantize, in f32; the
decompositions their card chains compute (K10b: K9's launches with K10b's
roundings; K10a: per-tile quantized copies and the int8 conv over them)
against JAX's kernels bit for bit; and K10a's tiled conv plan replayed.

Tolerances are stated per case."""

from functools import partial

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests._torch_port import mask as _mask
from tests._torch_port import randomize
from tests.test_torch_port_deep import BLOCK_CASES, _block_case, _port_args
from unitspeech_tpu.models import unet as junet
from unitspeech_tpu.ops import conv_matmul as jcm
from unitspeech_tpu.ops import pallas_resnet as jpr
from unitspeech_tpu_torch.ops import fused_resnet as fr
from unitspeech_tpu_torch.ops import fused_resnet_deep as frd

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("f", [80, 40, 20, 10, 8, 6])
def test_pick_frames_per_tile_matches_jax(f):
    """The port's copy picks JAX's tile at every bucket length up to 600
    frames and every width of the estimator (the 6 MiB budget binds at the
    wide ones)."""
    for t in range(1, 601):
        for c in (2, 64, 128, 256, 512, 1024, 2048):
            assert fr.pick_frames_per_tile(t, f, c) == jpr._pick_frames_per_tile(t, f, c), (t, c)


def test_pick_frames_per_tile_at_the_bucket():
    """At the 344-frame bucket, K10a's sites: F=80 8 frames (43 tiles);
    F=40 43 frames at 128 and 256 channels, 4 frames at 512 -> 128."""
    assert fr.pick_frames_per_tile(344, 80, 128) == 8
    assert fr.pick_frames_per_tile(172, 40, 256) == 43
    assert fr.pick_frames_per_tile(172, 40, 128) == 43
    assert fr.pick_frames_per_tile(172, 40, 512) == 4


def _window(xv, j, f, tile):
    """JAX's kernel-A window of tile j: its rows plus one frame above and
    below, zero outside the array (_assemble_window, _halo_specs)."""
    b, n, c = xv.shape
    lo, hi = j * tile - f, (j + 1) * tile + f
    win = np.zeros((b, hi - lo, c), np.float32)
    src_lo, src_hi = max(lo, 0), min(hi, n)
    win[:, src_lo - lo:src_hi - lo] = xv[:, src_lo:src_hi]
    return win


@pytest.mark.parametrize("b,t,f,cin,cout,fpt,lens", [
    (2, 12, 8, 16, 32, 3, [12, 7]), (1, 6, 8, 2, 32, 2, [6]), (2, 10, 6, 24, 16, 5, [4, 10]),
    (2, 9, 10, 32, 32, 9, [9, 2])])
def test_window_quantize_matches_jax_exactly(b, t, f, cin, cout, fpt, lens):
    """conv3x3_i8_tiles (per-tile scale, int8 products, dequantize) equals
    JAX's _conv3x3_taps_int8 on each tile's window bit for bit, given the
    same int8 weights and reciprocal scales: the scales are one f32
    division of the same maximum, the int32 sums are exact, and the
    dequantize is the same two f32 multiplies. Includes Cin = 2, a padded
    length, several tiles and one tile of the whole layer (K10b's)."""
    rng = np.random.default_rng(cin + fpt)
    x = rng.standard_normal((b, t * f, cin)).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()  # bf16 values, as in kernel A
    valid = np.repeat(_mask(t, lens), f, axis=1)[..., None]
    xv = x * valid
    w = (rng.standard_normal((3, 3, cin, cout)) * (9 * cin) ** -0.5).astype(np.float32)
    w8t, rsw = fr.quant_w(_t(w))
    got = fr.conv3x3_i8_tiles(_t(xv), (w8t, rsw), f, fpt).numpy()
    tile = fpt * f
    w_ref = jnp.asarray(w8t.t().contiguous().numpy())
    sw_ref = jnp.asarray(rsw.numpy()[None, :])
    for j in range(t // fpt):
        win = _window(xv, j, f, tile)
        for bb in range(b):
            want = np.asarray(jpr._conv3x3_taps_int8(jnp.asarray(win[bb]), w_ref, sw_ref, f,
                                                     tile))
            np.testing.assert_array_equal(got[bb, j * tile:(j + 1) * tile], want)


def _early_case(cin, cout, t, lens, seed):
    """An early-stage block (F = 8, groups 4) from the JAX init redrawn
    from a seed: (x, mask, t_bias, args, res, float twin's output)."""
    b, f = len(lens), 8
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, f, cin)).astype(np.float32)
    t_emb = rng.standard_normal((b, 12)).astype(np.float32)
    mask = _mask(t, lens)[:, :, None, None]
    block = junet.ResnetBlock(cout, groups=4)
    params = randomize(block.init(jax.random.PRNGKey(0), x, mask, t_emb), seed)
    p = jax.device_get(params["params"])
    t_bias = np.asarray(junet.mish(t_emb) @ p["mlp"]["kernel"] + p["mlp"]["bias"])
    args = (p["block1"]["conv"]["kernel"], p["block1"]["conv"]["bias"],
            p["block1"]["norm"]["scale"], p["block1"]["norm"]["bias"],
            p["block2"]["conv"]["kernel"], p["block2"]["conv"]["bias"],
            p["block2"]["norm"]["scale"], p["block2"]["norm"]["bias"])
    res = (p["res_conv"]["kernel"], p["res_conv"]["bias"]) if cin != cout else (None, None)
    return x, mask, t_bias, args, res, np.asarray(block.apply(params, x, mask, t_emb))


def _assert_int8_close(got, want, ref, lens):
    """The K9 block tolerance (test_torch_port_deep.py): conv1 is exact up
    to the dequantize, conv2 quantizes h, whose GroupNorm statistics are
    summed in another order, so a value within f32 round-off of a .5
    boundary may take the other int8 step: atol 1e-2 on outputs of size ~5,
    mean error 1e-4. Against the float block the int8 error stays within
    the JAX tests' band; padding rows are exactly zero."""
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)
    assert np.abs(got - want).mean() < 1e-4
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert 1e-4 < rel < 0.05, rel
    for i, n in enumerate(lens):
        assert np.abs(got[i, n:]).max(initial=0.0) == 0.0


EARLY_CASES = [  # (cin, cout, t, lens, frames_per_tile): at least 2 tiles
    (16, 32, 8, [8, 5], 2), (32, 32, 12, [12, 12], 4), (2, 32, 6, [6, 3], 3),
    (32, 16, 9, [9, 4], 3)]


@pytest.mark.parametrize("cin,cout,t,lens,fpt", EARLY_CASES)
def test_int8_block_plain_matches_pallas(cin, cout, t, lens, fpt):
    """K10a's plain version (the wrapper on CPU tensors) against
    fused_resnet_block(int8=True) in interpret mode, f32, with tiles of
    2-4 frames (the halo frames take their tile's scale), Cin < Cout,
    Cin == Cout, Cin > Cout, Cin = 2 and padded lengths."""
    x, mask, t_bias, args, res, ref = _early_case(cin, cout, t, lens, cin * 7 + cout + fpt)
    want = np.asarray(jpr.fused_resnet_block(x, mask, t_bias, *args, wres=res[0], bres=res[1],
                                             groups=4, interpret=True, int8=True,
                                             frames_per_tile=fpt))
    before = fr.fused_resnet_block_int8.launches
    pa, kw = _port_args(x, mask, t_bias, args, res)
    got = fr.fused_resnet_block(*pa, **kw, groups=4, int8=True, frames_per_tile=fpt).numpy()
    assert fr.fused_resnet_block_int8.launches == before  # CPU: the plain version
    _assert_int8_close(got, want, ref, lens)


def test_int8_block_default_tiles_and_weights():
    """frames_per_tile=0 takes pick_frames_per_tile as JAX does; weights
    quantized once (wq) give what quantizing per call gives; in bf16 mode
    frames_per_tile changes nothing."""
    cin, cout, t, lens = 16, 16, 16, [16, 11]
    x, mask, t_bias, args, res, _ = _early_case(cin, cout, t, lens, 3)
    want = np.asarray(jpr.fused_resnet_block(x, mask, t_bias, *args, groups=4, interpret=True,
                                             int8=True))
    pa, _ = _port_args(x, mask, t_bias, args, res)
    got = fr.fused_resnet_block(*pa, groups=4, int8=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-2, rtol=0)
    wq = (fr.quant_w(pa[3]), fr.quant_w(pa[7]))
    assert torch.equal(got, fr.fused_resnet_block(*pa, groups=4, int8=True, wq=wq))
    bf = fr.fused_resnet_block(*pa, groups=4)
    assert torch.equal(bf, fr.fused_resnet_block(*pa, groups=4, frames_per_tile=4))
    with pytest.raises(ValueError):
        fr.fused_resnet_block(*pa, groups=4, int8=True, frames_per_tile=5)


@pytest.mark.parametrize("cin,cout,lens", BLOCK_CASES)
def test_deep_int8_plain_matches_pallas(cin, cout, lens):
    """K10b's plain version against fused_resnet_block_deep(int8=True) in
    interpret mode, f32 ((b, t, f) = (2, 15, 6), odd T, F % 8 != 0): one
    scale per batch element (127 / (max + 1e-8)), conv1 in bf16 for
    Cin > Cout; K9's tolerance, padding rows exactly zero."""
    x, mask, t_bias, args, res, ref = _block_case(cin, cout, lens, 5 * cin + cout)
    want = np.asarray(jpr.fused_resnet_block_deep(x, mask, t_bias, *args, wres=res[0],
                                                  bres=res[1], groups=4, interpret=True,
                                                  int8=True))
    before = frd.fused_resnet_block_deep_int8.launches
    pa, kw = _port_args(x, mask, t_bias, args, res)
    got = frd.fused_resnet_block_deep(*pa, **kw, groups=4, int8=True).numpy()
    assert frd.fused_resnet_block_deep_int8.launches == before
    _assert_int8_close(got, want, ref, lens)


def test_deep_int8_differs_from_i8pre_where_jax_does():
    """K10b is not K9: its scale adds 1e-8 where K9 clamps, and it rounds h
    to the activation dtype first, so on bf16 inputs the two int8 blocks
    differ, as JAX's two kernels do, by int8 steps."""
    x, mask, t_bias, args, res, _ = _block_case(16, 16, [15, 9], 2)
    pa, _ = _port_args(x, mask, t_bias, args, res)
    pa = (pa[0].to(torch.bfloat16), *pa[1:])
    a = frd.fused_resnet_block_deep(*pa, groups=4, int8=True).float()
    b = frd.fused_resnet_block_deep_i8(*pa, groups=4).float()
    assert 0 < (a - b).abs().max() < 0.1 * b.abs().max()


def _bf16(a):
    """f32 values rounded to bf16 (the card's activation dtype), as f32."""
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16).float()


def _k10b_quantize(v, valid):
    """K10b's quantize as the card runs it (us_i8_quantize_rows and the
    glue's pass 1 with k10b): the masked layer of each batch element once,
    s = 127 / (max + 1e-8) (one f32 add, one f32 division), x8 =
    clip(round_half_even(v * s), -127, 127)."""
    vm = v * valid
    m = vm.abs().amax(dim=(1, 2))
    s = torch.full_like(m, 127.0) / (m + 1e-8)
    return torch.clamp(torch.round(vm * s[:, None, None]), -127, 127).to(torch.int8), s


def _as_written(fn, *args):
    """fn(*args) compiled without XLA's algebraic simplifier, which on the
    CPU folds JAX's dequantize factor 1.0 / (127 / (m + 1e-8)) into
    (m + 1e-8) / 127 (one rounding fewer), a rewrite the TPU's Mosaic
    lowering of the kernel does not make."""
    comp = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})
    return comp(*args)


def _jax_deep_kernel(kernel, n, cin, cout, operands, out_dtype, **kw):
    """One of JAX's whole-layer kernels (_kernel_a_deep / _kernel_b_deep)
    with int8=True in interpret mode over the batch, one Cout block,
    _as_written: its (c, stats (B, 2, Cout))."""
    b = operands[1].shape[0]
    full = lambda c: pl.BlockSpec((1, n, c), lambda bb, cb: (bb, 0, 0),  # noqa: E731
                                  memory_space=pltpu.VMEM)
    row = lambda c: pl.BlockSpec((1, c), lambda bb, cb: (0, 0),  # noqa: E731
                                 memory_space=pltpu.VMEM)
    lens = pl.BlockSpec((1, 1, 1), lambda bb, cb: (bb, 0, 0), memory_space=pltpu.SMEM)
    stats = pl.BlockSpec((1, 2, cout), lambda bb, cb: (bb, 0, 0), memory_space=pltpu.VMEM)
    w = pl.BlockSpec((9 * cin, cout), lambda bb, cb: (0, 0), memory_space=pltpu.VMEM)
    if kernel is jpr._kernel_a_deep:
        specs = [lens, full(cin), w, row(cout), row(cout)]
    else:
        film = pl.BlockSpec((1, 1, cout), lambda bb, cb: (bb, 0, 0), memory_space=pltpu.VMEM)
        specs = [lens, full(cout), stats, row(cout), row(cout), film, w, row(cout), row(cout)]
    call = pl.pallas_call(
        partial(kernel, f=operands[-1], n=n, n_true=n, out_dtype=out_dtype, int8=True, **kw),
        grid=(b, 1), in_specs=specs, out_specs=(full(cout), stats),
        out_shape=(jax.ShapeDtypeStruct((b, n, cout), out_dtype),
                   jax.ShapeDtypeStruct((b, 2, cout), jnp.float32)),
        interpret=True,
    )
    c, st = _as_written(call, *operands[:-1])
    return np.array(c, np.float32), np.array(st)


K10B_CASES = [  # (cin, cout, lens, max|x|): Cin < Cout, ==, >, and a small layer
    (8, 16, [15, 9], None), (16, 16, [15, 15], None), (16, 8, [15, 9], None),
    (16, 16, [15, 9], 1e-3)]


@pytest.mark.parametrize("cin,cout,lens,amax", K10B_CASES)
def test_k10b_card_decomposition_matches_pallas_exactly(cin, cout, lens, amax):
    """K10b's chain on the card, modelled in plain PyTorch, against JAX's
    K10b kernels (_kernel_a_deep, _kernel_b_deep with int8=True) in
    interpret mode, bit for bit, on bf16 values: x quantized once per batch
    element over its masked layer with 127 / (max + 1e-8) (the TPU window's
    zero halo frames add nothing to the maximum), the int8 taps, the
    dequantize f32(acc) * ((1/s) * rsw) + b1 -> c1; the glue h = mish(GN1(c1)
    * scale + shift) + FiLM, masked and rounded to bf16, then quantized the
    same way -> conv2 -> c2. Both sides take the same int8 weights and
    reciprocal scales, and the glue takes JAX's GroupNorm 1 statistics (the
    card sums them in its own order; a separate tolerance covers that).
    XLA on the CPU contracts a multiply and the add after it into one fused
    multiply-add (acc * f + bias, h * scale + shift), which rounds once
    where JAX's text, and the card, round twice: the conv biases and
    GroupNorm 1's shift, the terms those adds bring in, are zero here, so
    both sides round alike (the non-zero terms are held to the plain
    version by test_deep_int8_plain_matches_pallas and on the card). For
    Cin > Cout conv1 is JAX's XLA hybrid in float, whose sums XLA orders its
    own way: there c1 is K8's conv within 1e-5, and c2 is bit-equal from
    JAX's c1. At max|x| = 1e-3 the two scale forms differ (K9's 127 /
    max(m, 1e-8) is another f32 value): the card must take K10b's."""
    x, _, t_bias, args, _, _ = _block_case(cin, cout, lens, 11 * cin + cout)
    bsz, t, f = x.shape[:3]
    n = t * f
    if amax is not None:
        x = x * (amax / np.abs(x).max())
    x = _bf16(x.reshape(bsz, n, cin))  # the card's bf16 activations
    film = _bf16(t_bias)
    w1, _, s1, _, w2 = map(_t, args[:5])
    b1, be1, b2 = torch.zeros((3, cout))  # the adds XLA would contract (see above)
    wq1, wq2 = fr.quant_w(w1), fr.quant_w(w2)
    lens_rows = torch.tensor(lens, dtype=torch.int32) * f
    valid = fr._valid(lens_rows, n)
    jlens = jnp.asarray(lens_rows.numpy().reshape(bsz, 1, 1))
    row = lambda v: jnp.asarray(v.numpy()[None])  # noqa: E731

    if cin <= cout:
        x8, sx = _k10b_quantize(x, valid)
        c1 = frd._dequant(frd._conv3x3_i8_plain(x8, wq1, f), sx, wq1[1], b1)
        jc1, jstats1 = _jax_deep_kernel(
            jpr._kernel_a_deep, n, cin, cout,
            (jlens, jnp.asarray(x.numpy()), jnp.asarray(wq1[0].t().contiguous().numpy()),
             row(wq1[1]), row(b1), f), jnp.float32)
        np.testing.assert_array_equal(c1.numpy(), jc1)
        if amax is not None:
            k9 = frd._quantize_plain(x, valid)[1]
            assert not torch.equal(sx, k9)  # the forms differ here
    else:
        xm = jnp.asarray((x * valid).numpy())
        conv = jcm.conv3x3_im2col if jcm.choose_conv_impl(cin, cout) == "im2col" else \
            jcm.conv3x3_taps
        jacc = conv(xm, jnp.asarray(w1.numpy()), f) + jnp.asarray(b1.numpy())
        jc1 = np.asarray(jacc, np.float32)
        jstats1 = np.stack([jc1.sum(1), (jc1 * jc1).sum(1)], axis=1)
        c1 = fr.conv3x3_rows(x * valid, w1.reshape(9 * cin, cout), f) + b1
        np.testing.assert_allclose(c1.numpy(), jc1, atol=1e-5, rtol=1e-5)

    # the glue from JAX's c1 and GroupNorm 1 statistics, rounded to bf16
    c1b = _bf16(jc1)
    stats = partial(jpr._group_stats, n_rows=n, groups=4)
    mean, inv = zip(*(_as_written(stats, jnp.asarray(jstats1[i, 0]), jnp.asarray(jstats1[i, 1]))
                      for i in range(bsz)))
    mean, inv = (torch.from_numpy(np.stack([np.asarray(m) for m in v])) for v in (mean, inv))
    h = fr._gn_mish(c1b, mean, inv, s1, be1) + film[:, None, :]
    h = (h * valid).to(torch.bfloat16).float()
    h8, sx2 = _k10b_quantize(h, valid)
    c2 = frd._dequant(frd._conv3x3_i8_plain(h8, wq2, f), sx2, wq2[1], b2)
    jc2, _ = _jax_deep_kernel(
        jpr._kernel_b_deep, n, cout, cout,
        (jlens, jnp.asarray(jc1, jnp.bfloat16), jnp.asarray(jstats1), row(s1), row(be1),
         jnp.asarray(film.numpy()[:, None, :]), jnp.asarray(wq2[0].t().contiguous().numpy()),
         row(wq2[1]), row(b2), f), jnp.float32, groups=4)
    np.testing.assert_array_equal(c2.numpy(), jc2)


# --- K10a's card chain: per-tile quantized copies on the int8 Hopper loop ----


def _jax_tile_kernel(kernel, t, f, fpt, cin, cout, operands, groups=4):
    """One of JAX's tiled kernels (_kernel_a / _kernel_b) with int8=True in
    interpret mode, over the batch and the tiles as _fused_resnet grids
    them (the halo blocks of _halo_specs), f32 out, _as_written: its (c (B,
    N, Cout), stats (B, 2, Cout))."""
    b, n = operands[1].shape[:2]
    tile, n_tiles = fpt * f, t // fpt
    lens = pl.BlockSpec((1, 1, 1), lambda bb, j: (bb, 0, 0), memory_space=pltpu.SMEM)
    row = lambda c: pl.BlockSpec((1, c), lambda bb, j: (0, 0),  # noqa: E731
                                 memory_space=pltpu.VMEM)
    w = pl.BlockSpec((9 * cin, cout), lambda bb, j: (0, 0), memory_space=pltpu.VMEM)
    out = pl.BlockSpec((1, tile, cout), lambda bb, j: (bb, j, 0), memory_space=pltpu.VMEM)
    stats = pl.BlockSpec((1, 2, cout), lambda bb, j: (bb, 0, 0), memory_space=pltpu.VMEM)
    halo = list(jpr._halo_specs(t, f, cin, n_tiles, fpt))
    kw = dict(f=f, tile=tile, n_tiles=n_tiles, out_dtype=jnp.float32, tap_mode="taps",
              int8=True)
    if kernel is jpr._kernel_a:
        specs = [lens, *halo, w, row(cout), row(cout)]
    else:
        film = pl.BlockSpec((1, 1, cout), lambda bb, j: (bb, 0, 0), memory_space=pltpu.VMEM)
        specs = [lens, *halo, stats, row(cout), row(cout), film, w, row(cout), row(cout)]
        kw.update(n_rows=n, groups=groups)
    call = pl.pallas_call(
        partial(kernel, **kw), grid=(b, n_tiles), in_specs=specs, out_specs=(out, stats),
        out_shape=(jax.ShapeDtypeStruct((b, n, cout), jnp.float32),
                   jax.ShapeDtypeStruct((b, 2, cout), jnp.float32)),
        interpret=True,
    )
    c, st = _as_written(call, *operands)
    return np.array(c, np.float32), np.array(st)


def _assert_copy_layout(x8t, sx, v, f, fpt):
    """The per-tile copy's layout, element by element: copy frame c of tile j
    is frame j fpt - 1 + c of v rounded with tile j's scale (the halo frames
    duplicate the neighbouring tiles' edge frames with this tile's scale),
    zero outside the array and at channels past C; sx the tile scales."""
    b, n, c = v.shape
    t = n // f
    assert x8t.shape == (b, t // fpt, fpt + 2, f, -(-c // 16) * 16)
    assert torch.equal(sx, fr.tile_scales(v, f, fpt))
    frames = v.reshape(b, t, f, c)
    for j in range(t // fpt):
        for cc in range(fpt + 2):
            src = j * fpt - 1 + cc
            want = torch.zeros((b, f, c), dtype=torch.int8)
            if 0 <= src < t:
                want = torch.clamp(torch.round(frames[:, src] * sx[:, j, None, None]), -127,
                                   127).to(torch.int8)
            assert torch.equal(x8t[:, j, cc, :, :c], want), (j, cc)
    assert not x8t[..., c:].any()


K10A_CASES = [  # (cin, cout, t, lens, frames_per_tile, max|x|)
    (2, 32, 10, [10, 7], 5, None),    # Cin = 2, a prime fpt, a length inside tile 1
    (16, 32, 8, [8, 5], 2, None),     # Cin < Cout
    (32, 32, 12, [12, 9], 4, None),   # Cin == Cout
    (32, 16, 9, [9, 4], 3, None),     # Cin > Cout
    (16, 16, 10, [10, 6], 10, None),  # fpt = T: one tile
    (16, 32, 10, [10, 8], 5, 1e-3),   # a small layer
]


@pytest.mark.parametrize("cin,cout,t,lens,fpt,amax", K10A_CASES)
def test_k10a_card_decomposition_matches_pallas_exactly(cin, cout, t, lens, fpt, amax):
    """K10a's chain on the card, modelled in plain PyTorch (the per-tile copy
    tile_copy_plain, the conv over it conv3x3_i8_copy), against JAX's K10a
    kernels (_kernel_a, _kernel_b with int8=True) in interpret mode, bit for
    bit, on bf16 values: the tile scales 127 / (max|window| + 1e-8), each
    tile's copy with its halo frames duplicated from the neighbouring tiles
    and rounded with the tile's own scale, zero channels up to a multiple
    of 16, the int8 taps over the copy, the dequantize with each tile's
    scale -> c1; kernel B's h = mish(GN1(c1) * scale + shift) + FiLM, masked
    and rounded to bf16, its copy -> c2. Both sides take the same int8
    weights and reciprocal scales, and h takes JAX's GroupNorm 1 statistics
    (the card sums them in its own order; the card tests bound that). The
    conv biases and GroupNorm 1's shift are zero and the JAX side is
    compiled without `algsimp`, as test_k10b_card_decomposition_matches_
    pallas_exactly explains (XLA on the CPU contracts or folds what JAX's
    text and the card round twice)."""
    x, _, t_bias, args, _, _ = _early_case(cin, cout, t, lens, 13 * cin + cout + fpt)
    bsz, _, f = x.shape[:3]
    n = t * f
    if amax is not None:
        x = x * (amax / np.abs(x).max())
    x = _bf16(x.reshape(bsz, n, cin))
    film = _bf16(t_bias)
    w1, _, s1, _, w2 = map(_t, args[:5])
    b1, be1, b2 = torch.zeros((3, cout))  # the adds XLA would contract
    wq1, wq2 = fr.quant_w(w1), fr.quant_w(w2)
    lens_rows = torch.tensor(lens, dtype=torch.int32) * f
    valid = fr._valid(lens_rows, n)
    jlens = jnp.asarray(lens_rows.numpy().reshape(bsz, 1, 1))
    row = lambda v: jnp.asarray(v.numpy()[None])  # noqa: E731
    jw = lambda wq: jnp.asarray(wq[0].t().contiguous().numpy())  # noqa: E731

    x8t, sx1 = fr.tile_copy_plain(x * valid, f, fpt)
    _assert_copy_layout(x8t, sx1, x * valid, f, fpt)
    c1 = fr.conv3x3_i8_copy(x8t, wq1, sx1) + b1
    jx = jnp.asarray(x.numpy(), jnp.bfloat16)
    jc1, jstats1 = _jax_tile_kernel(jpr._kernel_a, t, f, fpt, cin, cout,
                                    (jlens, jx, jx, jx, jw(wq1), row(wq1[1]), row(b1)))
    np.testing.assert_array_equal(c1.numpy(), jc1)
    # the card's wrapper of the copy on CPU tensors is the same plain copy
    assert all(torch.equal(a, b_) for a, b_ in zip(fr.quantize_tiles(x, lens_rows, f, fpt),
                                                  (x8t, sx1)))

    c1b = _bf16(jc1)
    stats = partial(jpr._group_stats, n_rows=n, groups=4)
    mean, inv = zip(*(_as_written(stats, jnp.asarray(jstats1[i, 0]), jnp.asarray(jstats1[i, 1]))
                      for i in range(bsz)))
    mean, inv = (torch.from_numpy(np.stack([np.asarray(m) for m in v])) for v in (mean, inv))
    h = fr._gn_mish(c1b, mean, inv, s1, be1) + film[:, None, :]
    h = (h * valid).to(torch.bfloat16).float()
    h8t, sx2 = fr.tile_copy_plain(h, f, fpt)
    _assert_copy_layout(h8t, sx2, h, f, fpt)
    c2 = fr.conv3x3_i8_copy(h8t, wq2, sx2) + b2
    jc1b = jnp.asarray(jc1, jnp.bfloat16)
    jc2, _ = _jax_tile_kernel(
        jpr._kernel_b, t, f, fpt, cout, cout,
        (jlens, jc1b, jc1b, jc1b, jnp.asarray(jstats1), row(s1), row(be1),
         jnp.asarray(film.numpy()[:, None, :]), jw(wq2), row(wq2[1]), row(b2)))
    np.testing.assert_array_equal(c2.numpy(), jc2)
    # the conv wrapper on CPU tensors: the same values, rounded once to bf16
    assert torch.equal(fr.resnet_conv3x3_i8_tiles(h8t, sx2, wq2, b2), c2.to(torch.bfloat16))


# chip_smoke.py's K1_SITES (F, Cin, Cout): K10a's six sites at every bucket
K1_SITES = [(80, 2, 128), (80, 128, 128), (40, 128, 256), (40, 256, 256), (40, 512, 128),
            (40, 128, 128)]
# (T, F, fpt) -> (TT, TF): K10a's conv row tile on the card at those sites at
# the 344- and 880-frame buckets (us_conv_plan_i8_tiles; tests/
# test_torch_port_cuda.py holds the card's plan to this table)
K10A_PLANS = {(344, 80, 8): (8, 16), (172, 40, 43): (16, 8), (172, 40, 4): (4, 20),
              (880, 80, 11): (11, 10), (440, 40, 22): (22, 5)}


def _row_tile_rule(fpt, f, rows=128):
    """conv_tc's tile choice for a TPU tile of fpt frames (resnet_block.cu
    pick_tile with T = fpt): TF a divisor of F, TT = min(rows / TF, fpt), the
    fewest row tiles, then the smallest box of (TT + 2) x (TF + 2) rows."""
    best = None
    for d in range(1, min(f, rows) + 1):
        if f % d == 0:
            tt = min(rows // d, fpt)
            key = (-(-fpt // tt) * (f // d), (tt + 2) * (d + 2))
            if best is None or key < best[0]:
                best = (key, (tt, d))
    return best[1]


@pytest.mark.parametrize("frames", [344, 880])
@pytest.mark.parametrize("f,cin,cout", K1_SITES)
def test_k10a_tiled_plan_replay(frames, f, cin, cout):
    """K10a's conv grid replayed block by block at each site and bucket:
    block x is row tile s of TPU tile j (x / tiles_f = j * sub + s); its rows
    (tt, ff) < (TT, TF) with to0 + tt < fpt are output frames inside tile j,
    every output row is written exactly once, every row's taps read copy
    frames 0 .. fpt + 1 of tile j's copy, and the share of each block's 128
    rows that is useful is fpt F / (sub tiles_f 128): 1 at F = 80, 43/48 at
    fpt = 43 and 5/8 at fpt = 4 (the 344-frame bucket)."""
    t = frames * f // 80
    fpt = fr.pick_frames_per_tile(t, f, max(cin, cout))
    tt, tf = K10A_PLANS[(t, f, fpt)]
    assert (tt, tf) == _row_tile_rule(fpt, f)
    sub, tiles_f = -(-fpt // tt), f // tf
    assert tt <= fpt and tt * tf <= 128 and tt + 2 <= 256 and tf + 2 <= 256
    written = np.zeros(t * f, np.int64)
    useful = []
    for blk in range(t // fpt * sub * tiles_f):
        tile_t, tile_f = divmod(blk, tiles_f)
        j, s = divmod(tile_t, sub)
        to0, fo0 = s * tt, tile_f * tf
        rows = 0
        for r in range(128):
            a, ff = divmod(r, tf)
            if a >= tt or to0 + a >= fpt:
                continue
            frame = j * fpt + to0 + a
            assert j * fpt <= frame < (j + 1) * fpt  # no row tile crosses a TPU tile
            assert 0 <= to0 + a and to0 + a + 2 <= fpt + 1  # taps inside the copy
            written[frame * f + fo0 + ff] += 1
            rows += 1
        useful.append(rows / 128)
    assert (written == 1).all()
    share = float(np.mean(useful))
    assert share == pytest.approx(fpt * f / (sub * tiles_f * 128), abs=1e-12)
    if frames == 344:
        assert share == pytest.approx({8: 1.0, 43: 43 / 48, 4: 5 / 8}[fpt], abs=1e-12)
