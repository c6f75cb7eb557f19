"""The port's estimator kernels K1-K4: their plain PyTorch versions (what a
CPU tensor runs) against the JAX Pallas kernels in interpret mode, at tiny
shapes with several tiles, padded batches, Cin=2, and both residual kinds.
The CUDA kernels themselves are held against the plain versions on the
card (tests/test_torch_port_cuda.py, and chip_smoke.py at the main-path
shapes).

Tolerance: 2e-5 abs / 1e-4 rel in f32 (sums taken in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitspeech_tpu.ops.pallas_attention import fused_rezero_attention as j_attention
from unitspeech_tpu.ops.pallas_resnet import fused_final_block as j_final
from unitspeech_tpu.ops.pallas_resnet import fused_resnet_block as j_resnet
from unitspeech_tpu.ops.pallas_stats import _row_stats_pallas
from unitspeech_tpu.ops.pallas_stats import group_mean_inv as j_group_mean_inv
from unitspeech_tpu_torch.ops import fused_attention, fused_resnet, row_stats

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _mask(t, lens):
    m = (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)
    return m[:, :, None, None]


def _resnet_params(rng, cin, cout):
    p = dict(t_bias=_rand(rng, 2, cout),
             w1=_rand(rng, 3, 3, cin, cout, scale=0.3), b1=_rand(rng, cout, scale=0.1),
             gn1_scale=1 + _rand(rng, cout, scale=0.1), gn1_bias=_rand(rng, cout, scale=0.1),
             w2=_rand(rng, 3, 3, cout, cout, scale=0.3), b2=_rand(rng, cout, scale=0.1),
             gn2_scale=1 + _rand(rng, cout, scale=0.1), gn2_bias=_rand(rng, cout, scale=0.1))
    if cin != cout:
        p.update(wres=_rand(rng, 1, 1, cin, cout, scale=0.3), bres=_rand(rng, cout, scale=0.1))
    return p


@pytest.mark.parametrize("cin,cout,lens,fpt", [
    (2, 8, [16, 11], 4),   # first-block width, res_conv, padded batch, 4 tiles
    (8, 8, [16, 5], 4),    # identity residual, heavy padding
    (4, 16, [16, 16], 0),  # res_conv, full mask, default tiling
    (8, 16, [9, 16], 2),   # odd length, 8 tiles
])
def test_resnet_block_plain_matches_pallas(cin, cout, lens, fpt):
    rng = np.random.default_rng(cin * 100 + cout)
    t, f, groups = 16, 8, 4
    x = _rand(rng, 2, t, f, cin)
    mask = _mask(t, lens)
    p = _resnet_params(rng, cin, cout)
    want = np.asarray(j_resnet(
        jnp.asarray(x), jnp.asarray(mask), **{k: jnp.asarray(v) for k, v in p.items()},
        groups=groups, interpret=True, frames_per_tile=fpt))
    got = fused_resnet.fused_resnet_block(
        torch.from_numpy(x), torch.from_numpy(mask),
        **{k: torch.from_numpy(v) for k, v in p.items()}, groups=groups).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # padding rows come out zero
    assert not np.any(got[1, lens[1]:])


@pytest.mark.parametrize("lens,fpt", [([16, 11], 4), ([16, 16], 0)])
def test_final_block_plain_matches_pallas(lens, fpt):
    rng = np.random.default_rng(7)
    t, f, c, groups = 16, 8, 8, 4
    x = _rand(rng, 2, t, f, c)
    mask = _mask(t, lens)
    w1, b1 = _rand(rng, 3, 3, c, c, scale=0.3), _rand(rng, c, scale=0.1)
    s1, be1 = 1 + _rand(rng, c, scale=0.1), _rand(rng, c, scale=0.1)
    wo, bo = _rand(rng, 1, 1, c, 1, scale=0.3), _rand(rng, 1, scale=0.1)
    args = (x, mask, w1, b1, s1, be1, wo, bo)
    want = np.asarray(j_final(*map(jnp.asarray, args), groups=groups, interpret=True,
                              frames_per_tile=fpt))
    got = fused_resnet.fused_final_block(*map(torch.from_numpy, args), groups=groups).numpy()
    assert got.shape == (2, t, f) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", [(3, 430, 256), (2, 100, 64), (1, 16, 128)])
def test_row_stats_plain_matches_pallas(shape):
    rng = np.random.default_rng(shape[1])
    x = _rand(rng, *shape) + 0.25
    want = np.asarray(_row_stats_pallas(jnp.asarray(x), interpret=True))
    got = row_stats.row_stats(torch.from_numpy(x)).numpy()
    # sums of up to 430 terms of magnitude ~1: f32 rounding of the total
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=RTOL)

    jm, ji = j_group_mean_inv(jnp.asarray(x), 8)
    tm, ti = row_stats.group_mean_inv(torch.from_numpy(x), 8)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n,c,t_tile,padded", [
    (64, 16, 16, True), (90, 16, 32, True), (96, 32, 32, False),
])
def test_rezero_attention_plain_matches_pallas(n, c, t_tile, padded):
    rng = np.random.default_rng(n)
    h, d = 2, 8
    x = _rand(rng, 2, n, c, scale=0.5)
    w_qkv = _rand(rng, c, 3 * h * d, scale=0.2)
    w_out = _rand(rng, h * d, c, scale=0.2)
    b_out = _rand(rng, c, scale=0.1)
    g = np.array([0.7], np.float32)
    lens = np.array([n, n - 13], np.int32) if padded else None
    want = np.asarray(j_attention(
        *map(jnp.asarray, (x, w_qkv, w_out, b_out, g)),
        lens_rows=None if lens is None else jnp.asarray(lens.reshape(2, 1, 1)),
        heads=h, dim_head=d, t_tile=t_tile, interpret=True))
    got = fused_attention.fused_rezero_attention(
        *map(torch.from_numpy, (x, w_qkv, w_out, b_out, g)),
        lens_rows=None if lens is None else torch.from_numpy(lens),
        heads=h, dim_head=d).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_wrappers_refuse_other_devices():
    """A wrapper picks its plain version only for CPU tensors."""
    x = torch.empty(2, 64, 128, device="meta")
    with pytest.raises(ValueError, match="device"):
        row_stats.row_stats(x)
    with pytest.raises(ValueError, match="device"):
        fused_attention.fused_rezero_attention(x, x, x, x, x)
