"""The port's CUDA kernels K1-K4 against their plain PyTorch versions on the
card, in bf16, at small shapes with partial tiles and a padded batch
(chip_smoke.py holds them at the main-path shapes). Every test needs a CUDA
device and skips without one.

This file imports neither jax nor tests/conftest.py's helpers, so that it
runs on a machine with the card and no jax:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Bound: 2^-6 of max|plain| for the bf16 kernels (both round to bf16 at the
same points; f32 sums in another order may round to a neighbouring bf16
value), 1e-4 of max|plain| for the f32 row statistics.
"""

import numpy as np
import pytest
import torch

from unitspeech_tpu_torch.ops import fused_attention, fused_resnet, row_stats

BF16_REL = 2.0 ** -6


@pytest.fixture
def dev():
    """The card, with TF32 off for the plain versions' f32 products."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _rand(rng, dev, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


def _mask(dev, t, lens):
    m = (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)
    return torch.from_numpy(m[:, :, None, None]).to(dev)


def _assert_close(got, want, rel):
    got, want = got.float().reshape(want.shape), want.float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    bound = rel * max(1.0, want.abs().max().item())
    assert err <= bound, f"max |kernel - plain| {err} > {bound}"


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(2, 128), (128, 128), (512, 128), (128, 256)])
def test_fused_resnet_block(dev, cin, cout):
    rng = np.random.default_rng(cin + cout)
    t, f = 24, 40  # 960 rows: 7.5 row tiles
    mask = _mask(dev, t, [24, 17, 24])
    r = lambda *s, scale=1.0: _rand(rng, dev, *s, scale=scale)  # noqa: E731
    p = dict(t_bias=r(3, cout), w1=r(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
             b1=r(cout, scale=0.1), gn1_scale=1 + r(cout, scale=0.1), gn1_bias=r(cout, scale=0.1),
             w2=r(3, 3, cout, cout, scale=(9 * cout) ** -0.5), b2=r(cout, scale=0.1),
             gn2_scale=1 + r(cout, scale=0.1), gn2_bias=r(cout, scale=0.1))
    if cin != cout:
        p.update(wres=r(1, 1, cin, cout, scale=cin ** -0.5), bres=r(cout, scale=0.1))
    x = r(3, t, f, cin).to(torch.bfloat16)
    before = fused_resnet.fused_resnet_block.launches
    got = fused_resnet.fused_resnet_block(x, mask, **p, groups=8)
    assert fused_resnet.fused_resnet_block.launches == before + 1  # the kernel ran
    want = fused_resnet.resnet_block_plain(
        x.reshape(3, t * f, cin), fused_resnet.lens_rows_from_mask(mask, f), p["t_bias"],
        p["w1"].reshape(9 * cin, cout), p["b1"], p["gn1_scale"], p["gn1_bias"],
        p["w2"].reshape(9 * cout, cout), p["b2"], p["gn2_scale"], p["gn2_bias"],
        p["wres"].reshape(cin, cout) if "wres" in p else None, p.get("bres"), f=f, groups=8)
    assert got.dtype == torch.bfloat16
    _assert_close(got, want, BF16_REL)


@pytest.mark.cuda
def test_fused_final_block(dev):
    rng = np.random.default_rng(1)
    t, f, c = 24, 80, 128
    mask = _mask(dev, t, [24, 13, 24])
    r = lambda *s, scale=1.0: _rand(rng, dev, *s, scale=scale)  # noqa: E731
    x = r(3, t, f, c).to(torch.bfloat16)
    w1, b1 = r(3, 3, c, c, scale=(9 * c) ** -0.5), r(c, scale=0.1)
    s1, be1 = 1 + r(c, scale=0.1), r(c, scale=0.1)
    wo, bo = r(1, 1, c, 1, scale=c ** -0.5), r(1, scale=0.1)
    got = fused_resnet.fused_final_block(x, mask, w1, b1, s1, be1, wo, bo, groups=8)
    want = fused_resnet.final_block_plain(
        x.reshape(3, t * f, c), fused_resnet.lens_rows_from_mask(mask, f),
        w1.reshape(9 * c, c), b1, s1, be1, wo.reshape(c), bo, f=f, groups=8)
    assert got.dtype == torch.float32
    _assert_close(got, want, BF16_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_stats(dev, dtype):
    rng = np.random.default_rng(2)
    x = (_rand(rng, dev, 3, 300, 512) + 0.5).to(dtype)
    _assert_close(row_stats.row_stats(x), row_stats.row_stats_plain(x), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(1000, 256), (4096, 128)])
def test_fused_rezero_attention(dev, n, c):
    rng = np.random.default_rng(n)
    r = lambda *s, scale=1.0: _rand(rng, dev, *s, scale=scale)  # noqa: E731
    x = r(3, n, c).to(torch.bfloat16)
    w_qkv, w_out = r(c, 384, scale=c ** -0.5), r(128, c, scale=128 ** -0.5)
    b_out, g = r(c, scale=0.1), torch.tensor([0.7], device=dev)
    lens = torch.tensor([n, n * 7 // 9, n], dtype=torch.int32, device=dev)
    got = fused_attention.fused_rezero_attention(x, w_qkv, w_out, b_out, g, lens)
    want = fused_attention.rezero_attention_plain(x, w_qkv, w_out, b_out, g, lens, 4, 32)
    assert not got[1, lens[1]:].any()  # rows past the length come out zero
    _assert_close(got, want, BF16_REL)
