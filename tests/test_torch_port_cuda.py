"""The port's CUDA kernels K1-K9 and K11 against their plain PyTorch
versions on the card, at small shapes with partial tiles and a padded batch
(chip_smoke.py holds them at the main-path shapes), and the library GEMMs
of the deep convs against their CPU versions. Every test needs a CUDA
device and skips without one.

This file imports neither jax nor tests/conftest.py's helpers, so that it
runs on a machine with the card and no jax:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Bound: 2^-6 of max|plain| for the bf16 kernels K1-K4, K8 and K11 (both
round to bf16 at the same points; f32 sums in another order may round to a
neighbouring bf16 value), 1e-4 of max|plain| for the f32 row statistics, 0
for the row abs-max K7. K9 adds one int8 step at the few values within f32
round-off of a rounding boundary (I8_REL below). K5/K6 against their plain
version run in f32 on the same bf16-rounded inputs and weights: 2^-7 of
max(|ref|, 1), one bf16 rounding of the output (and of the activation the
conv's tensor cores take) plus f32 order.
"""

import numpy as np
import pytest
import torch

from unitspeech_tpu_torch.ops import (
    aa_snake,
    conv_matmul,
    fused_attention,
    fused_resnet,
    fused_resnet_deep,
    resample,
    row_stats,
)

BF16_REL = 2.0 ** -6
AA_REL = 2.0 ** -7
# K9: the kernel's GroupNorm statistics are summed in another order than
# the plain version's, so a glue value within f32 round-off of a .5 int8
# boundary may round the other way. One such step moves a conv2 output by
# max|w2| * max|h| / 127, i.e. about max|w2| / (127 * rms(w2) * sqrt(K)) of
# its normalised value (3e-3 at these widths, a few of them at most), well
# under 2^-7 of max|plain|; the bound is BF16_REL plus that step.
I8_REL = 2.0 ** -6 + 2.0 ** -7


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


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,dtype", [(301, 256, torch.bfloat16), (430, 1024, torch.bfloat16),
                                       (77, 24, torch.float32), (1720, 512, torch.float32)])
def test_row_absmax(dev, n, c, dtype):
    """Bit for bit: a max does not depend on the order."""
    x = _rand(np.random.default_rng(n), dev, 3, n, c).to(dtype)
    x[1, n // 2, c - 1] = -9.0
    before = row_stats.row_absmax.launches
    got = row_stats.row_absmax(x)
    assert row_stats.row_absmax.launches == before + 1
    assert torch.equal(got, row_stats.row_absmax_plain(x))


def _aa_inputs(rng, dev, c, t, k=None):
    """bf16 activation and conv weight, f32 snake parameters and bias."""
    r = lambda *s, scale=1.0: _rand(rng, dev, *s, scale=scale)  # noqa: E731
    p = dict(x=r(1, c, t, scale=0.7).to(torch.bfloat16), alpha=r(c, scale=0.3),
             beta=r(c, scale=0.3))
    if k is not None:
        p.update(w=r(k, c, c, scale=(k * c) ** -0.5).to(torch.bfloat16), bias=r(c, scale=0.1),
                 res=r(1, c, t, scale=0.5).to(torch.bfloat16))
    return p


def _f32(p):
    return {k: v.float() for k, v in p.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("c,t", [(32, 1001), (256, 333), (64, 5)])
def test_fused_aa_snake(dev, c, t):
    """K6 against its plain version in f32 on the same inputs, T not a
    multiple of the 256-sample tile."""
    p = _aa_inputs(np.random.default_rng(c + t), dev, c, t)
    before = aa_snake.fused_aa_snake.launches
    got = aa_snake.fused_aa_snake(p["x"], p["alpha"], p["beta"])
    assert aa_snake.fused_aa_snake.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == p["x"].shape
    q = _f32(p)
    _assert_close(got, aa_snake.aa_snake_plain(q["x"], q["alpha"], q["beta"]), AA_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("c,t,k,d,residual", [
    (32, 1001, 3, 1, True), (32, 777, 11, 5, False), (256, 333, 11, 5, True),
    (256, 130, 7, 3, False), (128, 64, 3, 3, True), (64, 9, 11, 1, True),
])
def test_fused_aa_snake_conv(dev, c, t, k, d, residual):
    """K5 against its plain version in f32 on the same inputs: C = 32 and
    256, k = 11 with d = 5, with and without the residual, T not a
    multiple of the 64-sample tile and shorter than the conv's reach."""
    p = _aa_inputs(np.random.default_rng(c * k + t), dev, c, t, k)
    res = p["res"] if residual else None
    before = aa_snake.fused_aa_snake_conv.launches
    got = aa_snake.fused_aa_snake_conv(p["x"], p["alpha"], p["beta"], p["w"], p["bias"], d, res)
    assert aa_snake.fused_aa_snake_conv.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == p["x"].shape
    q = _f32(p)
    want = aa_snake.aa_snake_conv_plain(q["x"], q["alpha"], q["beta"], q["w"], q["bias"], d,
                                        q["res"] if residual else None)
    _assert_close(got, want, AA_REL)


@pytest.mark.cuda
def test_deep_conv_gemms_match_cpu(dev):
    """The deep-stage library GEMMs on the card: the bf16 conv keeps its f32
    accumulator (aten::mm with an f32 output): within 1e-5 of max|CPU| of
    the CPU's f32 sum of the same 4608 bf16 products (sums in another
    order; a bf16-rounded output would miss by up to 2^-9 relative); the
    int8 conv is exact up to the f32 dequantize (1e-6 relative)."""
    rng = np.random.default_rng(11)
    x = _rand(rng, dev, 3, 430, 512).to(torch.bfloat16)
    w = _rand(rng, dev, 3, 3, 512, 256, scale=(9 * 512) ** -0.5)
    got = conv_matmul.conv3x3_rows(x, w, 10)
    want = conv_matmul.conv3x3_rows(x.cpu(), w.cpu(), 10)
    assert got.dtype == torch.float32
    assert not torch.equal(got, got.to(torch.bfloat16).float())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 * want.abs().max().item())
    got8 = conv_matmul.conv3x3_int8(x, w, 10)
    want8 = conv_matmul.conv3x3_int8(x.cpu(), w.cpu(), 10)
    torch.testing.assert_close(got8.cpu(), want8, rtol=1e-6, atol=1e-6 * want8.abs().max().item())


def _block_params(rng, dev, cin, cout):
    r = lambda *s, scale=1.0: _rand(rng, dev, *s, scale=scale)  # noqa: E731
    p = dict(t_bias=r(3, cout), w1=r(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
             b1=r(cout, scale=0.1), gn1_scale=1 + r(cout, scale=0.1), gn1_bias=r(cout, scale=0.1),
             w2=r(3, 3, cout, cout, scale=(9 * cout) ** -0.5), b2=r(cout, scale=0.1),
             gn2_scale=1 + r(cout, scale=0.1), gn2_bias=r(cout, scale=0.1))
    if cin != cout:
        p.update(wres=r(1, 1, cin, cout, scale=cin ** -0.5), bres=r(cout, scale=0.1))
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("t,f,cin,cout", [(14, 20, 256, 512), (7, 10, 1024, 1024),
                                          (7, 10, 2048, 512), (14, 20, 1024, 256)])
def test_fused_resnet_block_deep(dev, t, f, cin, cout):
    """K8 at the deep stages' widths: Cin up to 2048 (the up-stage skip
    concat), Cout 1024 (kernel B's transform table above 48 KB of shared
    memory), partial row tiles, one padded row."""
    rng = np.random.default_rng(cin + cout + f)
    mask = _mask(dev, t, [t, t - 5, t])
    p = _block_params(rng, dev, cin, cout)
    x = _rand(rng, dev, 3, t, f, cin).to(torch.bfloat16)
    before = fused_resnet_deep.fused_resnet_block_deep.launches
    got = fused_resnet_deep.fused_resnet_block_deep(x, mask, **p, groups=8)
    assert fused_resnet_deep.fused_resnet_block_deep.launches == before + 1
    want = fused_resnet_deep.fused_resnet_block_deep(x.cpu(), mask.cpu(),
                                                     **{k: v.cpu() for k, v in p.items()},
                                                     groups=8)
    assert got.dtype == torch.bfloat16 and got.shape == (3, t, f, cout)
    _assert_close(got.cpu(), want, BF16_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("t,f,cin,cout", [(14, 20, 256, 512), (7, 10, 512, 512),
                                          (7, 10, 2048, 512), (14, 20, 1024, 256)])
def test_fused_resnet_block_deep_i8(dev, t, f, cin, cout):
    """K9 against its plain version on the card (same int8 operands, the
    plain int8 GEMM exact): conv1 in int8 for Cin <= Cout, in bf16 for the
    Cin > Cout hybrids; padding rows come out zero."""
    rng = np.random.default_rng(cin * 3 + cout + f)
    mask = _mask(dev, t, [t, t - 5, t])
    p = _block_params(rng, dev, cin, cout)
    x = _rand(rng, dev, 3, t, f, cin).to(torch.bfloat16)
    wq = (fused_resnet_deep.quant_w(p["w1"]), fused_resnet_deep.quant_w(p["w2"]))
    before = fused_resnet_deep.fused_resnet_block_deep_i8.launches
    got = fused_resnet_deep.fused_resnet_block_deep_i8(x, mask, **p, groups=8, wq=wq)
    assert fused_resnet_deep.fused_resnet_block_deep_i8.launches == before + 1
    args = (x.reshape(3, t * f, cin), fused_resnet.lens_rows_from_mask(mask, f), p["t_bias"],
            p["w1"].reshape(9 * cin, cout), wq[0], p["b1"], p["gn1_scale"], p["gn1_bias"], wq[1],
            p["b2"], p["gn2_scale"], p["gn2_bias"],
            p["wres"].reshape(cin, cout) if "wres" in p else None, p.get("bres"))
    want = fused_resnet_deep.resnet_block_deep_i8_plain(*args, f=f, groups=8)
    assert got.dtype == torch.bfloat16
    assert not got[1, t - 5:].any()
    _assert_close(got, want, I8_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("t,f,cin,cout,lens", [(24, 80, 128, 128, [24, 17, 24]),
                                               (18, 40, 256, 256, [18, 5, 18]),
                                               (6, 16, 64, 128, [6, 6, 3])])
def test_fused_downsample_conv(dev, t, f, cin, cout, lens):
    rng = np.random.default_rng(t * f + cin)
    mask = _mask(dev, t, lens)
    x = _rand(rng, dev, 3, t, f, cin).to(torch.bfloat16)
    w, b = _rand(rng, dev, 3, 3, cin, cout, scale=(9 * cin) ** -0.5), _rand(rng, dev, cout)
    before = resample.fused_downsample_conv.launches
    got = resample.fused_downsample_conv(x, mask, w, b)
    assert resample.fused_downsample_conv.launches == before + 1
    assert got.shape == (3, t // 2, f // 2, cout) and got.dtype == torch.bfloat16
    _assert_close(got, resample.downsample_conv_plain(x, mask, w, b), BF16_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("t,f,cin,cout,lens", [(24, 40, 128, 128, [24, 17, 24]),
                                               (7, 20, 256, 64, [7, 2, 7])])
def test_fused_upsample_conv(dev, t, f, cin, cout, lens):
    rng = np.random.default_rng(t * f + cin + 1)
    mask = _mask(dev, t, lens)
    x = _rand(rng, dev, 3, t, f, cin).to(torch.bfloat16)
    w, b = _rand(rng, dev, 4, 4, cin, cout, scale=(4 * cin) ** -0.5), _rand(rng, dev, cout)
    before = resample.fused_upsample_conv.launches
    got = resample.fused_upsample_conv(x, mask, w, b)
    assert resample.fused_upsample_conv.launches == before + 1
    assert got.shape == (3, 2 * t, 2 * f, cout) and got.dtype == torch.bfloat16
    _assert_close(got, resample.upsample_conv_plain(x, mask, w, b), BF16_REL)
