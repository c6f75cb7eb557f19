"""The in-kernel int8 ResnetBlocks of the port against the JAX package on
the CPU: K10a (`fused_resnet_block(int8=True)`, per-tile activation
scales) and K10b (`fused_resnet_block_deep(int8=True)`, one scale per
batch element), their tile choice and window quantize, in f32.

Tolerances are stated per case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port import mask as _mask
from tests._torch_port import randomize
from tests.test_torch_port_deep import BLOCK_CASES, _block_case, _port_args
from unitspeech_tpu.models import unet as junet
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
