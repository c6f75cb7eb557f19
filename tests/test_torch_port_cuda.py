"""The port's CUDA kernels K1-K11 and the tools' kernels P1-P3 against
their plain PyTorch versions on the card, at small shapes with partial
tiles and a padded batch (chip_smoke.py holds them at the main-path
shapes), the library GEMMs of the deep convs against their CPU
versions, the fine-tune step against the CPU's, `cli inference --fp32`
against the CPU with the caller's TF32 left on (the CLI's f32 policy),
twelve full-width fine-tune steps at lr 1e-3 in f32 and bf16 (the record
of which goes non-finite), the full-width estimator on the kernels at one
row (the `:cs<k>` samplers' cheap steps) and `cli voice-conversion --fp32`
against the CPU. Every test needs a CUDA device and skips
without one.

This file imports neither jax nor tests/conftest.py's helpers, so that it
runs on a machine with the card and no jax:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Bound: 2^-6 of max|plain| for the bf16 kernels K1-K4, K8 and K11 (both
round to bf16 at the same points; f32 sums in another order may round to a
neighbouring bf16 value), 1e-4 of max|plain| for the f32 row statistics and
2e-4 for their group fold (FOLD_REL below), 0 for the row abs-max K7. K9 adds one int8 step at the few values within f32
round-off of a rounding boundary (I8_REL below), and so do K10a/K10b: their
int8 products are exact and their scales equal the plain version's, but
kernel B's input h rounds to bf16 after GroupNorm statistics summed in
another order; K10a's per-tile copy and its int8 conv over the copy alone
are exact (the same f32 roundings, exact integer sums). P1: 2^-12 of
max(|plain|, 1) (P1_REL below). P2 is exact.
K5/K6 against their plain
version run in f32 on the same bf16-rounded inputs and weights: 2^-7 of
max(|ref|, 1), one bf16 rounding of the output (and of the activation the
conv's tensor cores take) plus f32 order.
"""

import numpy as np
import pytest
import torch

from unitspeech_tpu_torch.ops import (
    _cuda,
    aa_snake,
    conv_matmul,
    fused_attention,
    fused_resnet,
    fused_resnet_deep,
    probes,
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
# P1: the accurate bodies may differ by an ulp or two where the kernel's
# sinf / expf / tanhf / rsqrtf and PyTorch's differ; the exp chain amplifies
# such a difference by up to e^8 / 2 per round until it saturates at e^8
# (XLA's exp against PyTorch's on the CPU: up to 1e-4 of max|plain| at
# k = 64, tests/test_torch_port_probes.py)
P1_REL = 2.0 ** -12


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


def _final_inputs(rng, dev, b, t, f, cin, c):
    r = lambda *s, scale=1.0: _rand(rng, dev, *s, scale=scale)  # noqa: E731
    x = r(b, t, f, cin).to(torch.bfloat16)
    w = dict(w1=r(3, 3, cin, c, scale=(9 * cin) ** -0.5), b1=r(c, scale=0.1),
             gn_scale=1 + r(c, scale=0.1), gn_bias=r(c, scale=0.1),
             w_out=r(1, 1, c, 1, scale=c ** -0.5), b_out=r(1, scale=0.1))
    return x, w


def _final_plain(x, mask, w, f):
    b, t, _, cin = x.shape
    c = w["w1"].shape[-1]
    return fused_resnet.final_block_plain(
        x.reshape(b, t * f, cin), fused_resnet.lens_rows_from_mask(mask, f),
        w["w1"].reshape(9 * cin, c), w["b1"], w["gn_scale"], w["gn_bias"],
        w["w_out"].reshape(c), w["b_out"], f=f, groups=8).reshape(b, t, f)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [32, 64, 128])
def test_fused_final_block_dims(dev, dim):
    """K2 at decoder.dim 32, 64 and 128 (F = 80, a ragged last row tile,
    one padded row): two C launches a call, equal bits on a second call;
    dim 32 (C % 64 != 0) is not a width K2 takes and is refused on the
    card (the estimator routes it to plain Blocks)."""
    rng = np.random.default_rng(dim)
    t, f = 21, 80
    mask = _mask(dev, t, [21, 8, 21])
    x, w = _final_inputs(rng, dev, 3, t, f, dim, dim)
    if not fused_resnet.takes(dim, 8):
        assert dim == 32
        with pytest.raises(ValueError):
            fused_resnet.fused_final_block(x, mask, **w, groups=8)
        return
    before = fused_resnet.fused_final_block.launches
    got = fused_resnet.fused_final_block(x, mask, **w, groups=8)
    assert fused_resnet.fused_final_block.launches == before + 1
    assert torch.equal(got, fused_resnet.fused_final_block(x, mask, **w, groups=8))
    assert not got[1, 8:].any()
    _assert_close(got, _final_plain(x, mask, w, f), BF16_REL)


@pytest.mark.cuda
def test_fused_final_block_batches(dev):
    """Calls of batch 1, 3 and 2 in turn (the tail's clusters split the rows
    of each batch element), and a Cin % 8 != 0 input (kernel A's element
    loads, whose row tiles the tail reduces the same way), each against the
    plain version."""
    rng = np.random.default_rng(7)
    t, f = 16, 40
    for b, cin in ((1, 128), (3, 128), (2, 2), (2, 128)):
        mask = _mask(dev, t, [t, 5, 11][:b])
        x, w = _final_inputs(rng, dev, b, t, f, cin, 128)
        got = fused_resnet.fused_final_block(x, mask, **w, groups=8)
        _assert_close(got, _final_plain(x, mask, w, f), BF16_REL)


# sha-256 of the bf16 outputs of K1, K8 and K9 at fixed inputs, taken on an
# NVIDIA H100 with the kernels as they were before K2's redesign, which
# reads kernel A's tile sums in its tail and leaves kernel A as it was
def _k1_k8_k9_outputs(dev):
    rng = np.random.default_rng(2024)
    out = {}
    for name, (t, f, cin, cout) in (("K1", (24, 40, 128, 256)), ("K8", (14, 20, 256, 512)),
                                    ("K9", (7, 10, 512, 512))):
        mask = _mask(dev, t, [t, t - 5, t])
        p = _block_params(rng, dev, cin, cout)
        x = _rand(rng, dev, 3, t, f, cin).to(torch.bfloat16)
        if name == "K1":
            y = fused_resnet.fused_resnet_block(x, mask, **p, groups=8)
        elif name == "K8":
            y = fused_resnet_deep.fused_resnet_block_deep(x, mask, **p, groups=8)
        else:
            wq = (fused_resnet_deep.quant_w(p["w1"]), fused_resnet_deep.quant_w(p["w2"]))
            y = fused_resnet_deep.fused_resnet_block_deep_i8(x, mask, **p, groups=8, wq=wq)
        out[name] = y
    return out


def k1_k8_k9_digests(dev):
    import hashlib

    return {k: hashlib.sha256(v.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
            for k, v in _k1_k8_k9_outputs(dev).items()}


K1_K8_K9_DIGESTS = {
    "K1": "e39c80ba00ac74847e00a724ae122611ea239c8180ecb27bdb755a7d2fb8907f",
    "K8": "7b3317e1228934f07c02b2d3deec58fa4b62c7888644814bf130617d415e57b7",
    "K9": "defa4af16510367bd06f2763019d1ce7a8d24cd52e84a001e44214882950ef50",
}


@pytest.mark.cuda
def test_k1_k8_k9_bits_unchanged(dev):
    """K1, K8 and K9 give the bits they gave before K2's redesign."""
    assert k1_k8_k9_digests(dev) == K1_K8_K9_DIGESTS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_stats(dev, dtype):
    rng = np.random.default_rng(2)
    x = (_rand(rng, dev, 3, 300, 512) + 0.5).to(dtype)
    _assert_close(row_stats.row_stats(x), row_stats.row_stats_plain(x), 1e-4)


# K3: its 8 served sites (chip_smoke.py K3_SITES), rows fewer than the
# cluster's 8 ranks, C not a multiple of 128 or of 8, and the group widths
# of decoder.dim 32 and 64 (cg 4-16). (n, C, groups)
K3_CASES = [(1720, 512, 8), (430, 1024, 8), (430, 512, 8), (1720, 256, 8),
            (1, 64, 8), (3, 512, 8), (7, 256, 8), (37, 320, 10), (45, 200, 25), (29, 54, 27),
            (344, 32, 8), (172, 128, 8), (860, 64, 8), (86, 512, 8)]
# the fold form's bound: var = E[x^2] - mean^2 cancels mean^2, here at most
# a fifth of E[x^2] (inputs N(0.5, 1)), so var keeps the sums' relative
# error within 1.25x and inv half of that; mean and inv within 2 x 1e-4
FOLD_REL = 2e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,c,groups", K3_CASES)
def test_row_stats_both_forms(dev, n, c, groups, dtype):
    """K3 in both forms, one launch each: the sums against row_stats_plain,
    the fold (where fold_takes) against the plain fold; two calls give
    equal bits."""
    rng = np.random.default_rng(n + c)
    x = (_rand(rng, dev, 3, n, c) + 0.5).to(dtype)
    before = row_stats.row_stats.launches
    st = row_stats.row_stats(x)
    assert row_stats.row_stats.launches == before + 1
    assert torch.equal(st, row_stats.row_stats(x))
    _assert_close(st, row_stats.row_stats_plain(x), 1e-4)
    assert row_stats.fold_takes(c, groups)
    before = row_stats.row_stats.launches
    mean, inv = row_stats.group_mean_inv(x, groups)
    assert row_stats.row_stats.launches == before + 1
    again = row_stats.group_mean_inv(x, groups)
    assert torch.equal(mean, again[0]) and torch.equal(inv, again[1])
    want = row_stats.group_mean_inv_plain(x, groups, stats=row_stats.row_stats_plain)
    _assert_close(torch.stack([mean, inv]), torch.stack(want), FOLD_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,groups", [(430, 384, 2), (77, 96, 8), (50, 2048, 8)])
def test_group_mean_inv_straddling_groups(dev, n, c, groups):
    """Groups that do not fit one cluster's slice (cg not dividing 128) take
    K3's sums form, one launch, and the PyTorch fold."""
    assert not row_stats.fold_takes(c, groups) and row_stats.takes(c, n)
    x = (_rand(np.random.default_rng(c), dev, 2, n, c) + 0.5).to(torch.bfloat16)
    before = row_stats.row_stats.launches
    mean, inv = row_stats.group_mean_inv(x, groups)
    assert row_stats.row_stats.launches == before + 1
    want = row_stats.group_mean_inv_plain(x, groups, stats=row_stats.row_stats_plain)
    _assert_close(torch.stack([mean, inv]), torch.stack(want), FOLD_REL)


@pytest.mark.cuda
def test_row_stats_refuses_what_it_does_not_take(dev):
    """An odd C or no rows raise on the card (no plain fallback)."""
    for shape in ((2, 10, 33), (2, 0, 64)):
        x = torch.zeros(shape, device=dev)
        with pytest.raises(ValueError):
            row_stats.row_stats(x)
        with pytest.raises(ValueError):
            row_stats.group_mean_inv(x, 1)


# K4: the five sites of one estimator call, ragged N (a 1-row last tile, a
# tile count the blocks do not divide), and the weights packed at load or
# on the spot
ATTN_CASES = [(27520, 128, True), (6880, 256, True), (6880, 128, True), (1720, 512, True),
              (1720, 256, True), (1000, 256, False), (4096, 128, False), (129, 128, True),
              (1337, 512, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,pack", ATTN_CASES)
def test_fused_rezero_attention(dev, n, c, pack):
    rng = np.random.default_rng(n)
    r = lambda *s, scale=1.0: _rand(rng, dev, *s, scale=scale)  # noqa: E731
    x = r(3, n, c).to(torch.bfloat16)
    w_qkv, w_out = r(c, 384, scale=c ** -0.5), r(128, c, scale=128 ** -0.5)
    b_out, g = r(c, scale=0.1), torch.tensor([0.7], device=dev)
    lens = torch.tensor([n, n * 7 // 9, n], dtype=torch.int32, device=dev)
    packed = fused_attention.pack_attention_weights(w_qkv, w_out) if pack else None
    before = fused_attention.fused_rezero_attention.launches
    got = fused_attention.fused_rezero_attention(x, w_qkv, w_out, b_out, g, lens, packed=packed)
    assert fused_attention.fused_rezero_attention.launches == before + 1
    want = fused_attention.rezero_attention_plain(x, w_qkv, w_out, b_out, g, lens, 4, 32)
    assert not got[1, lens[1]:].any()  # rows past the length come out zero
    _assert_close(got, want, BF16_REL)
    again = fused_attention.fused_rezero_attention(x, w_qkv, w_out, b_out, g, lens,
                                                   packed=packed)
    assert torch.equal(got, again)  # fixed order: the same bits every call


# (B, N) -> K4's schedule on the H100 (132 SMs): (tiles, P, P2), the plans
# tests/test_torch_port_attention.py replays
K4_PLANS = {(3, 27520): (215, 22, 44), (3, 6880): (54, 22, 44), (3, 1720): (14, 14, 14),
            (3, 1000): (8, 8, 8), (3, 129): (2, 2, 2), (1, 27520): (215, 66, 132),
            (3, 4096): (32, 22, 32)}


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", list(K4_PLANS))
def test_attn_plan_matches_replay(dev, b, n):
    """The card's schedule (us_attn_plan, which the kernel launches by and
    the wrapper sizes the partials by) is the one the CPU tests replay."""
    plan = fused_attention.attn_plan(b, n)
    assert (plan["tiles"], plan["p1"], plan["p2"]) == K4_PLANS[(b, n)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [27520, 300])
def test_fused_rezero_attention_one_row(dev, n):
    """B = 1 (twice the blocks a batch element) and no output mask."""
    rng = np.random.default_rng(n + 1)
    r = lambda *s, scale=1.0: _rand(rng, dev, *s, scale=scale)  # noqa: E731
    x = r(1, n, 128).to(torch.bfloat16)
    w_qkv, w_out = r(128, 384, scale=128 ** -0.5), r(128, 128, scale=128 ** -0.5)
    b_out, g = r(128, scale=0.1), torch.tensor([0.7], device=dev)
    got = fused_attention.fused_rezero_attention(x, w_qkv, w_out, b_out, g)
    want = fused_attention.rezero_attention_plain(x, w_qkv, w_out, b_out, g, None, 4, 32)
    _assert_close(got, want, BF16_REL)


# K9's int8 conv alone (F, T, Cin, Cout): its conv sites at the 344-frame
# bucket, and ragged shapes (a Cin of one partial 128-channel chunk, T that
# leaves a partial row tile, Cout = 64 tiles)
I8_CONV_CASES = [(20, 86, 256, 512), (20, 86, 512, 512), (10, 43, 512, 512), (20, 86, 256, 256),
                 (10, 43, 512, 1024), (10, 7, 48, 128), (20, 13, 1024, 192)]


@pytest.mark.cuda
@pytest.mark.parametrize("f,t,cin,cout", I8_CONV_CASES)
def test_resnet_conv3x3_i8_bit_exact(dev, f, t, cin, cout):
    """The Hopper int8 conv equals _conv3x3_i8_plain + _dequant bit for bit
    (integer products are exact; the dequantize rounds the same operations),
    rows past each length zero in its input; packed once or on the spot."""
    g = torch.Generator().manual_seed(cin + cout + t)
    n = t * f
    lens = torch.tensor([n, (t - 3) * f, 2 * f], dtype=torch.int32, device=dev)
    x8 = torch.randint(-127, 128, (3, n, cin), generator=g).to(torch.int8).to(dev)
    for i in range(3):
        x8[i, int(lens[i]):] = 0
    w = torch.randn(3, 3, cin, cout, generator=g).to(dev)
    wq = fused_resnet_deep.quant_w(w)
    sx = (torch.rand(3, generator=g) * 40 + 10).to(dev)
    bias = torch.randn(cout, generator=g).to(dev)
    got = fused_resnet_deep.resnet_conv3x3_i8(x8, sx, wq, bias, lens, f)
    want = fused_resnet_deep._dequant(fused_resnet_deep._conv3x3_i8_plain(x8, wq, f), sx, wq[1],
                                      bias).to(torch.bfloat16)
    packed = fused_resnet_deep.pack_conv_weight_i8(wq[0], cin)
    again = fused_resnet_deep.resnet_conv3x3_i8(x8, sx, wq, bias, lens, f, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(again, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,dtype", [(301, 256, torch.bfloat16), (430, 1024, torch.bfloat16),
                                       (77, 24, torch.float32), (1720, 512, torch.float32),
                                       (1, 8, torch.bfloat16), (9, 2048, torch.float32)])
def test_row_absmax(dev, n, c, dtype):
    """Bit for bit: a max does not depend on the order; n = 1 and n below
    the cluster's eight slices leave ranks with no rows. One launch."""
    x = _rand(np.random.default_rng(n), dev, 3, n, c).to(dtype)
    x[1, n // 2, c - 1] = -9.0
    before = row_stats.row_absmax.launches
    got = row_stats.row_absmax(x)
    assert row_stats.row_absmax.launches == before + 1
    assert torch.equal(got, row_stats.row_absmax_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_absmax_nan(dev, dtype):
    """A NaN in a row propagates to its channel, as torch.amax propagates
    it; the other channels stay bit-equal."""
    x = _rand(np.random.default_rng(5), dev, 3, 430, 512).to(dtype)
    x[0, 7, 3] = float("nan")
    x[2, 429, 511] = float("nan")
    got, want = row_stats.row_absmax(x), row_stats.row_absmax_plain(x)
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and int(torch.isnan(got).sum()) == 2
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])


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
@pytest.mark.parametrize("c,t", [(32, 1001), (256, 333), (64, 5), (24, 130)])
def test_fused_aa_snake(dev, c, t):
    """K6 against its plain version in f32 on the same inputs, T not a
    multiple of the 64-sample tile, C not a multiple of the 32-channel
    block."""
    p = _aa_inputs(np.random.default_rng(c + t), dev, c, t)
    before = aa_snake.fused_aa_snake.launches
    got = aa_snake.fused_aa_snake(p["x"], p["alpha"], p["beta"],
                                  packed=aa_snake.pack_snake(p["alpha"], p["beta"]))
    assert aa_snake.fused_aa_snake.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == p["x"].shape
    q = _f32(p)
    _assert_close(got, aa_snake.aa_snake_plain(q["x"], q["alpha"], q["beta"]), AA_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("c,t,k,d,residual", [
    (32, 1001, 3, 1, True), (32, 777, 11, 5, False), (256, 333, 11, 5, True),
    (256, 130, 7, 3, False), (128, 64, 3, 3, True), (64, 9, 11, 1, True), (128, 2000, 11, 3, True),
    (64, 256, 7, 1, False), (512, 40, 3, 1, True), (32, 3, 11, 5, True),
    (96, 333, 11, 5, True), (160, 200, 3, 3, False), (32, 500, 3, 100, True),
    (256, 300, 5, 64, False), (96, 70, 3, 128, True), (64, 300, 23, 1, True),
])
@pytest.mark.parametrize("pack", [True, False], ids=["packed", "on_the_spot"])
def test_fused_aa_snake_conv(dev, c, t, k, d, residual, pack):
    """K5 against its plain version in f32 on the same inputs: every Cout
    tile (32, 64, 128, 64 of 256 or 512, 32 of 96 or 160), k = 11 with
    d = 5, with and without the residual, T not a multiple of the
    128-sample tiles (or of 8: the epilogue's element stores) and shorter
    than the conv's reach; reaches over 64 (a box in two pieces, up to
    MAX_REACH), a narrow stage whose k = 23 weights do not stay resident;
    the weights packed once as at load or on the spot. One wrapper call."""
    p = _aa_inputs(np.random.default_rng(c * k + t), dev, c, t, k)
    res = p["res"] if residual else None
    kw = {"packed": aa_snake.pack_aa_conv(p["alpha"], p["beta"], p["w"], p["bias"])} if pack else {}
    before = aa_snake.fused_aa_snake_conv.launches
    got = aa_snake.fused_aa_snake_conv(p["x"], p["alpha"], p["beta"], p["w"], p["bias"], d, res,
                                       **kw)
    assert aa_snake.fused_aa_snake_conv.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == p["x"].shape
    q = _f32(p)
    want = aa_snake.aa_snake_conv_plain(q["x"], q["alpha"], q["beta"], q["w"], q["bias"], d,
                                        q["res"] if residual else None)
    _assert_close(got, want, AA_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("c,t,k,d", [(256, 2752, 11, 5), (128, 22016, 3, 1), (64, 44032, 7, 3),
                                     (32, 88064, 11, 5), (64, 9, 11, 1), (96, 5000, 11, 5),
                                     (128, 900, 3, 128), (512, 900, 5, 64), (32, 900, 3, 65),
                                     (64, 900, 11, 25), (64, 300, 23, 1)])
def test_aa_conv_plan(dev, c, t, k, d):
    """The card's K5 conv plan at the served stages and at the widths past
    them K5 takes, up to MAX_REACH: a box of 128 + (k-1) d rows, one TMA
    copy up to 256 rows, else two pieces of whole 8-row atoms (the CPU
    replay's); C > 64 (and C <= 64 where k tiles of weights and two boxes
    do not fit) the ring form, as many box slots as 64-channel chunks up to
    three, one block per 128 samples and Cout tile (conv_cols); else the
    resident form, two box slots, a persistent grid of at most one block
    per tile that fills the SMs it can."""
    pl = aa_snake.conv_plan(1, c, t, k, d)
    rows = aa_snake.CONV_BM + (k - 1) * d
    pieces = 1 if rows <= 256 else 2
    each = rows if pieces == 1 else -(-rows // 16) * 8  # half the rows, to whole atoms
    tiles = -(-t // aa_snake.CONV_BM)
    assert pl["pieces"] == pieces and pl["box_rows"] == pieces * each
    assert pl["box_bytes"] == -(-pieces * each * 128 // 1024) * 1024
    assert pl["threads"] == 288 and pl["blocks_per_sm"] >= 1
    assert pl["resident"] == (c <= 64 and k <= 11)
    if pl["resident"]:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert pl["boxes"] == 2 and pl["blocks"] == min(tiles, pl["blocks_per_sm"] * sms)
    else:
        assert pl["boxes"] == min(3, -(-c // 64))
        assert pl["blocks"] == tiles * (c // aa_snake.conv_cols(c))


@pytest.mark.cuda
def test_vocoder_repacks_on_load(dev):
    """The vocoder's snake coefficients, f32 biases and K5 tiles are made
    by load_state_dict: a weight update loaded again re-packs them, and the
    kernel vocoder then gives what a fresh one loaded with the new weights
    gives, bit for bit; an in-place update followed by pack() does too."""
    from unitspeech_tpu_torch.models import vocoder as tvoc

    rng = np.random.default_rng(11)
    kw = dict(num_mels=16, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
              upsample_initial_channel=128, resblock_kernel_sizes=(3, 7),
              resblock_dilation_sizes=((1, 3), (1, 5)), dtype=torch.bfloat16, use_kernels=True)
    with dev:
        voc, fresh = tvoc.BigVGAN(**kw), tvoc.BigVGAN(**kw)
    sd = {k: _rand(rng, dev, *v.shape, scale=0.1) for k, v in voc.state_dict().items()}
    voc.load_state_dict(sd)
    act = voc.resblock_0_0.act1_0
    old = (act.packed.w.clone(), act.packed.snake.a.clone(), voc.post_packed.ib.clone())
    for k in ("resblock_0_0.conv1_0.kernel", "resblock_0_0.act1_0.act.alpha", "act_post.beta"):
        sd[k] = sd[k] * -1.5 + 0.01
    voc.load_state_dict(sd)
    fresh.load_state_dict(sd)
    new = (act.packed.w, act.packed.snake.a, voc.post_packed.ib)
    assert not any(torch.equal(a, b) for a, b in zip(old, new))
    mel = _rand(rng, dev, 1, 24, 16)
    with torch.no_grad():
        assert torch.equal(voc(mel), fresh(mel))
        voc.resblock_0_1.conv2_1.kernel.mul_(0.5)
        voc.pack()
        fresh.load_state_dict(voc.state_dict())
        assert torch.equal(voc(mel), fresh(mel))


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


# K11 cases: the small ones of the old kernels, the three full-width sites
# (D1, D2, U at the 344-frame bucket), and the new kernels' edges: a frame
# run that does not divide the 2-D row tile, a length ending mid-tile, a
# narrow frequency axis (TF of 4, 2, 1), Cout = 64 and 256 and a Cout split
# into tiles (192, 320), Cin of 8 and 8 mod 16 (a half k16 step), Cin over
# two chunks with a partial one.
DOWN_CASES = [(24, 80, 128, 128, [24, 17, 24]), (18, 40, 256, 256, [18, 5, 18]),
              (6, 16, 64, 128, [6, 6, 3]),
              (344, 80, 128, 128, [344, 301, 344]), (172, 40, 256, 256, [172, 151, 172]),
              (30, 80, 128, 128, [30, 13, 1]), (22, 12, 64, 64, [22, 9, 22]),
              (10, 10, 24, 192, [10, 7, 10]), (14, 4, 8, 320, [14, 3, 14]),
              (8, 2, 136, 256, [8, 5, 8])]
UP_CASES = [(24, 40, 128, 128, [24, 17, 24]), (7, 20, 256, 64, [7, 2, 7]),
            (172, 40, 128, 128, [172, 151, 172]),
            (15, 40, 128, 128, [15, 4, 1]), (9, 6, 24, 192, [9, 6, 2]),
            (11, 5, 72, 256, [11, 10, 3]), (5, 8, 8, 64, [5, 5, 5])]


@pytest.mark.cuda
@pytest.mark.parametrize("t,f,cin,cout,lens", DOWN_CASES)
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
@pytest.mark.parametrize("t,f,cin,cout,lens", UP_CASES)
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


@pytest.mark.cuda
@pytest.mark.parametrize("up", [False, True], ids=["down", "up"])
def test_resample_packed_call_and_plan(dev, up):
    """The estimator's call (weights packed once, frame counts given) gives
    the raw-kernel call's output bit for bit, and the card's launch plan
    takes the packed weights' Cout tile and the row tile the CPU tests
    replay."""
    t, f, cin, cout, lens = (40, 40, 128, 128, [40, 23, 40]) if up else (88, 80, 128, 128,
                                                                         [88, 61, 88])
    rng = np.random.default_rng(5 + up)
    taps = 4 if up else 3
    mask = _mask(dev, t, lens)
    x = _rand(rng, dev, 3, t, f, cin).to(torch.bfloat16)
    w, b = _rand(rng, dev, taps, taps, cin, cout, scale=(taps * taps * cin) ** -0.5), _rand(
        rng, dev, cout)
    fn = resample.fused_upsample_conv if up else resample.fused_downsample_conv
    pack = resample.pack_upsample_weight if up else resample.pack_downsample_weight
    packed, frames = pack(w), torch.tensor(lens, dtype=torch.int32, device=dev)
    before = fn.launches
    got = fn(x, mask, w, b, packed=packed, lens=frames)
    assert fn.launches == before + 1
    assert torch.equal(got, fn(x, mask, w, b))
    plan = resample.resample_plan(up, 3, t, f, cin, cout)
    # the row tile the CPU tests' replay of the tiling takes: TF the largest
    # of 8, 4, 2, 1 dividing the frequency rows, TT = 64 / TF
    rows_t, rows_f = (t, f) if up else (t // 2, f // 2)
    tf = next(v for v in (8, 4, 2, 1) if rows_f % v == 0)
    bn = packed.shape[-2]  # the launch takes the packer's Cout tile
    assert (plan["tt"], plan["tf"], plan["bn"]) == (64 // tf, tf, bn)
    assert plan["blocks"] == -(-rows_t // (64 // tf)) * (rows_f // tf) * (cout // bn) * 3
    assert plan["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_estimator_resample_padded_lengths(dev, monkeypatch):
    """The full-width bf16 estimator on the kernel path at the 32-frame
    bucket, with lengths 32, 26 and 27, gives the same score with K11 as
    without it (the library convs on masked input), and each K11 call gets
    the valid frames of its own level's mask. At this bucket the level-1
    attention (16 x 40 = 640 tokens) takes the plain path, whose padded rows
    carry to_out.bias * g: both are made large in up_0_attn, so that a K11b
    reading level 1's padded frames as valid (its frame 13 at length 26
    feeds the valid output frame 25) would move the score. Bound: 2^-5 of
    max|score|, a few bf16 roundings of the resample outputs carried on
    through the stages after them."""
    from unitspeech_tpu_torch.models import unet as tunet
    from unitspeech_tpu_torch.utils.params import _random_leaf

    full = dict(dim=128, dim_mults=(1, 2, 4, 8), groups=8, spk_emb_dim=256)
    rng = np.random.default_rng(32)
    t, lens = 32, [32, 26, 27]
    x, mu = _rand(rng, dev, 3, t, 80), _rand(rng, dev, 3, t, 80)
    mask = _mask(dev, t, lens)[:, :, 0, 0]
    tt, spk = torch.tensor([0.7, 0.4, 0.2], device=dev), _rand(rng, dev, 3, 256, scale=1 / 16)
    with torch.device("meta"):
        names = {k: tuple(v.shape) for k, v in tunet.GradLogPEstimator2d(**full).state_dict()
                 .items()}
    sd = {k: torch.from_numpy(_random_leaf(rng, k, s).astype(np.float32)) for k, s in
          names.items()}
    sd["up_0_attn.g"].fill_(1.0)
    sd["up_0_attn.fn.to_out.bias"].fill_(8.0)
    calls = []
    for name in ("fused_downsample_conv", "fused_upsample_conv"):
        real = getattr(tunet, name)

        def spy(h, mk, *a, _real=real, lens=None, **kw):
            calls.append((lens, resample.frames_from_mask(mk)))
            return _real(h, mk, *a, lens=lens, **kw)

        monkeypatch.setattr(tunet, name, spy)
    outs = []
    for on in (True, False):
        with dev:
            est = tunet.GradLogPEstimator2d(**full, dtype=torch.bfloat16, use_kernels=True,
                                            use_resample=on)
        est.load_state_dict(sd)
        before = (resample.fused_downsample_conv.launches,
                  resample.fused_upsample_conv.launches)
        with torch.no_grad():
            outs.append(est(x, mask, mu, tt, spk))
        after = (resample.fused_downsample_conv.launches,
                 resample.fused_upsample_conv.launches)
        assert [a - b for a, b in zip(after, before)] == ([2, 1] if on else [0, 0])
    assert len(calls) == 3
    for given, want in calls:
        assert torch.equal(given, want)
    assert torch.isfinite(outs[0]).all()
    _assert_close(outs[0], outs[1], 2.0 ** -5)


def _rows_args(x, mask, p, f):
    """fused_resnet.block_rows_args of a block's keyword parameters."""
    return fused_resnet.block_rows_args(x, mask, p["t_bias"], p["w1"], p["b1"], p["gn1_scale"],
                                        p["gn1_bias"], p["w2"], p["b2"], p["gn2_scale"],
                                        p["gn2_bias"], p.get("wres"), p.get("bres"))


@pytest.mark.cuda
@pytest.mark.parametrize("t,f,cin,cout,fpt", [(24, 40, 2, 128, 0), (24, 40, 128, 128, 4),
                                              (24, 40, 512, 128, 6), (12, 80, 128, 256, 3)])
def test_fused_resnet_block_int8(dev, t, f, cin, cout, fpt):
    """K10a against its plain version: Cin = 2 (a per-tile copy of 16
    channels), tiles of 3-6 frames whose halo frames take the tile's scale,
    a padded row; padding rows come out zero."""
    rng = np.random.default_rng(cin + cout + fpt)
    mask = _mask(dev, t, [t, t - 7, t])
    p = _block_params(rng, dev, cin, cout)
    x = _rand(rng, dev, 3, t, f, cin).to(torch.bfloat16)
    before = fused_resnet.fused_resnet_block_int8.launches
    got = fused_resnet.fused_resnet_block(x, mask, **p, groups=8, int8=True, frames_per_tile=fpt)
    assert fused_resnet.fused_resnet_block_int8.launches == before + 1
    a = _rows_args(x, mask, p, f)
    wq = (fused_resnet.quant_w(p["w1"]), fused_resnet.quant_w(p["w2"]))
    want = fused_resnet.resnet_block_i8_plain(
        *a[:4], wq[0], *a[4:7], wq[1], *a[8:], f=f, groups=8,
        fpt=fpt or fused_resnet.pick_frames_per_tile(t, f, max(cin, cout)))
    assert got.dtype == torch.bfloat16
    assert not got[1, t - 7:].any()
    _assert_close(got, want, I8_REL)


# chip_smoke.py's K1_SITES (F, Cin, Cout): K10a's sites at the 344-frame
# bucket (F = 40: tiles of 43 frames, 4 at 512 -> 128)
K1_SITES = [(80, 2, 128), (80, 128, 128), (40, 128, 256), (40, 256, 256), (40, 512, 128),
            (40, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("f,cin,cout", K1_SITES)
def test_fused_resnet_block_int8_sites(dev, f, cin, cout):
    """K10a at its six sites, B = 3 with lengths 344 / 301 / 200 frames of
    the bucket (halved at F = 40), JAX's tiles, the int8 weights packed once
    and packed on the spot: within I8_REL of the plain version, padding rows
    zero, the two packings the same bits."""
    rng = np.random.default_rng(f + cin + 3 * cout)
    t = 344 * f // 80
    lens = [t, -(-301 * t // 344), 200 * t // 344]
    mask = _mask(dev, t, lens)
    p = _block_params(rng, dev, cin, cout)
    x = _rand(rng, dev, 3, t, f, cin).to(torch.bfloat16)
    wq = (fused_resnet.quant_w(p["w1"]), fused_resnet.quant_w(p["w2"]))
    packed = fused_resnet.pack_block_weights_int8(wq, p.get("wres"))
    before = fused_resnet.fused_resnet_block_int8.launches
    got = fused_resnet.fused_resnet_block(x, mask, **p, groups=8, int8=True, wq=wq,
                                          packed=packed)
    again = fused_resnet.fused_resnet_block(x, mask, **p, groups=8, int8=True, wq=wq)
    assert fused_resnet.fused_resnet_block_int8.launches == before + 2
    a = _rows_args(x, mask, p, f)
    fpt = fused_resnet.pick_frames_per_tile(t, f, max(cin, cout))
    want = fused_resnet.resnet_block_i8_plain(*a[:4], wq[0], *a[4:7], wq[1], *a[8:], f=f,
                                              groups=8, fpt=fpt)
    for i, n in enumerate(lens):
        assert not got[i, n:].any()
    _assert_close(got, want, I8_REL)
    assert torch.equal(got, again)


# per-tile copies (t, f, c, fpt, lens): K10a's conv inputs at the bucket
# (x at both F, h at Cout 128 / 256) and ragged ones (C % 16 == 8, C = 2,
# one tile, lengths inside a tile)
TILE_COPY_CASES = [(344, 80, 2, 8, [344, 301, 200]), (344, 80, 128, 8, [344, 301, 200]),
                   (172, 40, 256, 43, [172, 151, 100]), (172, 40, 512, 4, [172, 151, 100]),
                   (15, 8, 24, 5, [15, 7, 12]), (10, 16, 40, 10, [10, 3, 10])]


@pytest.mark.cuda
@pytest.mark.parametrize("t,f,c,fpt,lens", TILE_COPY_CASES)
def test_quantize_tiles_bit_exact(dev, t, f, c, fpt, lens):
    """K10a's per-tile copy (frame maxima, then the copy with its tile
    scales) equals tile_copy_plain of the masked rows on the CPU bit for bit:
    the scales are one f32 add and one division of the same maximum, each
    element one f32 multiply and a round half to even; the rows past each
    length are garbage in the input and zero in the copy."""
    rng = np.random.default_rng(t + c + fpt)
    x = _rand(rng, dev, 3, t * f, c, scale=3.0).to(torch.bfloat16)
    lens_rows = torch.tensor(lens, dtype=torch.int32, device=dev) * f
    before = fused_resnet.quantize_tiles.launches
    x8t, sx = fused_resnet.quantize_tiles(x, lens_rows, f, fpt)
    assert fused_resnet.quantize_tiles.launches == before + 1
    w8t, wsx = fused_resnet.quantize_tiles(x.cpu(), lens_rows.cpu(), f, fpt)
    torch.cuda.synchronize()
    assert torch.equal(sx.cpu(), wsx)
    assert torch.equal(x8t.cpu(), w8t)


@pytest.mark.cuda
@pytest.mark.parametrize("t,f,c,fpt,lens", TILE_COPY_CASES)
def test_resnet_conv3x3_i8_tiles_bit_exact(dev, t, f, c, fpt, lens):
    """K10a's int8 conv over a per-tile copy (conv1's c1, conv2's c2) equals
    conv3x3_i8_copy + bias rounded to bf16 bit for bit (the int32 sums are
    exact, the dequantize the same two f32 multiplies and one add), on the
    copy the card made, with the weights packed once or on the spot; Cout
    128 and 64-column tiles (Cout 192)."""
    rng = np.random.default_rng(2 * t + c + fpt)
    x = _rand(rng, dev, 3, t * f, c, scale=3.0).to(torch.bfloat16)
    lens_rows = torch.tensor(lens, dtype=torch.int32, device=dev) * f
    x8t, sx = fused_resnet.quantize_tiles(x, lens_rows, f, fpt)
    for cout in (128, 192):
        w = _rand(rng, dev, 3, 3, c, cout, scale=(9 * c) ** -0.5)
        wq = fused_resnet.quant_w(w)
        bias = _rand(rng, dev, cout, scale=0.1)
        before = fused_resnet.resnet_conv3x3_i8_tiles.launches
        got = fused_resnet.resnet_conv3x3_i8_tiles(x8t, sx, wq, bias)
        again = fused_resnet.resnet_conv3x3_i8_tiles(
            x8t, sx, wq, bias, packed=fused_resnet.pack_conv_weight_i8(wq[0], c))
        assert fused_resnet.resnet_conv3x3_i8_tiles.launches == before + 2
        want = (fused_resnet.conv3x3_i8_copy(x8t, wq, sx) + bias).to(torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(again, want)


# (T, F, fpt) -> (TT, TF): the row tiles tests/test_torch_port_int8_kernels.py
# replays (its K10A_PLANS) at K10a's sites at the 344- and 880-frame buckets
K10A_PLANS = {(344, 80, 8): (8, 16), (172, 40, 43): (16, 8), (172, 40, 4): (4, 20),
              (880, 80, 11): (11, 10), (440, 40, 22): (22, 5)}


@pytest.mark.cuda
@pytest.mark.parametrize("t,f,fpt", list(K10A_PLANS))
def test_conv_plan_i8_tiles_matches_replay(dev, t, f, fpt):
    """The card's K10a conv plan (us_conv_plan_i8_tiles, which the conv
    launches by and the wrapper sizes its statistics by) is the one the CPU
    tests replay: the row tile, its count a TPU tile, the tiles a batch
    element."""
    tt, tf = K10A_PLANS[(t, f, fpt)]
    plan = fused_resnet.conv_plan_i8_tiles(3, t, f, 128, 128, fpt)
    sub = -(-fpt // tt)
    assert (plan["tt"], plan["tf"], plan["sub"]) == (tt, tf, sub)
    assert plan["tiles"] == t // fpt * sub * (f // tf)
    assert plan["tiles"] == _cuda.lib().us_conv_i8_tiles_n_tiles(t * f, f, fpt)


@pytest.mark.cuda
@pytest.mark.parametrize("t,f,cin,cout", [(14, 20, 256, 512), (7, 10, 1024, 1024),
                                          (7, 10, 512, 1024), (7, 10, 2048, 512),
                                          (14, 20, 1024, 256), (14, 20, 512, 512),
                                          (7, 10, 512, 512)])
def test_fused_resnet_block_deep_int8(dev, t, f, cin, cout):
    """K10b (K9's chain with K10b's roundings) against its plain version at
    every width of chip_smoke.py's K8_SITES: one scale per batch element,
    Cout 1024, conv1 in bf16 for Cin > Cout (Cin 2048); padding rows come
    out zero."""
    rng = np.random.default_rng(cin + 2 * cout + f)
    mask = _mask(dev, t, [t, t - 5, t])
    p = _block_params(rng, dev, cin, cout)
    x = _rand(rng, dev, 3, t, f, cin).to(torch.bfloat16)
    before = fused_resnet_deep.fused_resnet_block_deep_int8.launches
    got = fused_resnet_deep.fused_resnet_block_deep(x, mask, **p, groups=8, int8=True)
    assert fused_resnet_deep.fused_resnet_block_deep_int8.launches == before + 1
    a = _rows_args(x, mask, p, f)
    wq = (fused_resnet.quant_w(p["w1"]), fused_resnet.quant_w(p["w2"]))
    want = fused_resnet_deep.resnet_block_deep_int8_plain(*a[:4], wq[0], *a[4:7], wq[1], *a[8:],
                                                          f=f, groups=8)
    assert got.dtype == torch.bfloat16
    assert not got[1, t - 5:].any()
    _assert_close(got, want, I8_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("body", list(probes.BODIES))
def test_transcendental_chain(dev, body):
    x = _rand(np.random.default_rng(5), dev, 300, 128)
    before = probes.transcendental_chain.launches
    got = probes.transcendental_chain(x, 64, body)
    assert probes.transcendental_chain.launches == before + 1
    _assert_close(got, probes.transcendental_chain_plain(x, 64, body), P1_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,k", [((4096, 128), 64), ((333, 7), 7), ((3,), 5)])
@pytest.mark.parametrize("body", list(probes.BODIES))
def test_transcendental_chain_shapes(dev, body, shape, k):
    """P1 at the tool's shape, and at element counts that are not a multiple
    of 4 (the float4 loop's tail; three elements: no float4 at all) with a
    round count that is not a multiple of the loop's unroll."""
    x = _rand(np.random.default_rng(8), dev, *shape)
    got = probes.transcendental_chain(x, k, body)
    _assert_close(got, probes.transcendental_chain_plain(x, k, body), P1_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["stride2", "frame_block", "selection", "interleave"])
def test_probe_stride_forms(dev, form):
    """P2's kernels equal their plain versions bit for bit (copies, a 0/1
    product with one term per output, one bf16 rounding of x + 1)."""
    x = _rand(np.random.default_rng(6), dev, 512, 128).to(torch.bfloat16)
    fn, plain = {
        "stride2": (lambda: probes.row_select(x, 2, 1), lambda: probes.row_select_plain(x, 2, 1)),
        "frame_block": (lambda: probes.row_select(x, 32, 16),
                        lambda: probes.row_select_plain(x, 32, 16)),
        "selection": (lambda: probes.selection_matmul(x), lambda: probes.selection_matmul_plain(x)),
        "interleave": (lambda: probes.interleave_rows(x), lambda: probes.interleave_rows_plain(x)),
    }[form]
    assert torch.equal(fn(), plain())


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [[(3, 5, "inf")], [(301, 70, "nan")],
                                 [(3, 5, "inf"), (301, 70, "nan"), (130, 8, "-inf")],
                                 [(0, 0, "nan"), (511, 127, "inf"), (256, 64, "inf")]])
def test_selection_matmul_non_finite(dev, bad):
    """P2's band product with an inf or NaN in rows it skips (odd rows, and
    even rows of other outputs): the full product's NaN columns (0 * inf),
    the selected -inf / inf kept, the rest bit-equal to the plain version."""
    x = _rand(np.random.default_rng(7), dev, 512, 128).to(torch.bfloat16)
    for r, c, v in bad:
        x[r, c] = float(v)
    before = probes.selection_matmul.launches
    got = probes.selection_matmul(x)
    assert probes.selection_matmul.launches == before + 1
    want = probes.selection_matmul_plain(x)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0))
    assert int(want.isnan().any(0).sum()) == len(bad)


@pytest.mark.cuda
@pytest.mark.parametrize("t,f,cin,cout", [(9, 10, 1024, 1024), (43, 10, 512, 1024)])
def test_resnet_kernels_alone(dev, t, f, cin, cout):
    """P3's calls: kernel A alone (conv + GroupNorm statistics) and kernel C
    alone in its three residual modes, against their plain versions."""
    rng = np.random.default_rng(t + cin)
    n = t * f
    lens = torch.tensor([n, n - 3 * f], dtype=torch.int32, device=dev)
    x = _rand(rng, dev, 2, n, cin).to(torch.bfloat16)
    w, bias = _rand(rng, dev, 9 * cin, cout, scale=(9 * cin) ** -0.5), _rand(rng, dev, cout)
    c, mean, inv = fused_resnet.resnet_conv3x3(x, lens, w, bias, f)
    c_p, mean_p, inv_p = fused_resnet.resnet_conv3x3_plain(x, lens, w, bias, f, 8)
    _assert_close(c, c_p, BF16_REL)
    torch.testing.assert_close(mean, mean_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(inv, inv_p, rtol=1e-4, atol=1e-5)
    s, sh = 1 + _rand(rng, dev, cout, scale=0.1), _rand(rng, dev, cout, scale=0.1)
    wres, bres = _rand(rng, dev, cin, cout, scale=cin ** -0.5), _rand(rng, dev, cout)
    for mode in fused_resnet.OUT_MODES:
        if mode == "identity" and cin != cout:
            continue
        w_b = (wres, bres) if mode == "matmul" else (None, None)
        got = fused_resnet.resnet_out(c_p, x, mean_p, inv_p, s, sh, lens, mode, *w_b)
        want = fused_resnet.resnet_out_plain(c_p, x, mean_p, inv_p, s, sh, lens, mode, *w_b)
        assert got.dtype == (torch.float32 if mode == "none" else torch.bfloat16)
        _assert_close(got, want, BF16_REL)


# K1 / K8 on the Hopper loop (csrc/resnet_block.cu conv_tc): T not a
# multiple of the tile (F = 80: 8 x 16; F = 40: 16 x 8; F = 20: 6 x 20;
# F = 10: 12 x 10), lengths ending mid-tile and a 2-frame row, Cin = 2 (the
# element-load conv1 and 1x1 residual), Cout tiles of 64 (64, 192), 128, and
# 64 read from 128-column packing (F = 10, 2048 -> 512: 48 blocks of 128)
RAGGED_BLOCKS = [(27, 80, 2, 128, [27, 13, 2]), (27, 80, 128, 64, [27, 14, 27]),
                 (11, 40, 64, 192, [11, 6, 2]), (9, 20, 1024, 256, [9, 4, 9]),
                 (43, 10, 512, 1024, [43, 30, 7]), (13, 10, 1024, 1024, [13, 13, 2]),
                 (43, 10, 2048, 512, [43, 19, 43])]


@pytest.mark.cuda
@pytest.mark.parametrize("t,f,cin,cout,lens", RAGGED_BLOCKS)
def test_resnet_block_ragged_tiles(dev, t, f, cin, cout, lens):
    """The whole block (K1 at F % 8 == 0, K8's wrapper at F = 20 / 10) with
    the weights packed as at load, against its plain version; rows past the
    length come out zero; the packed call equals the raw-kernel call bit
    for bit."""
    rng = np.random.default_rng(t * f + cin + cout)
    mask = _mask(dev, t, lens)
    p = _block_params(rng, dev, cin, cout)
    x = _rand(rng, dev, 3, t, f, cin).to(torch.bfloat16)
    fn = (fused_resnet.fused_resnet_block if f % 8 == 0
          else fused_resnet_deep.fused_resnet_block_deep)
    packed = fused_resnet.pack_block_weights(p["w1"], p["w2"], p.get("wres"))
    before = fn.launches
    got = fn(x, mask, **p, groups=8, packed=packed)
    assert fn.launches == before + 1
    assert torch.equal(got, fn(x, mask, **p, groups=8))
    want = fused_resnet.resnet_block_plain(*_rows_args(x, mask, p, f), f=f, groups=8)
    assert got.dtype == torch.bfloat16
    for i, n in enumerate(lens):
        assert not got[i, n:].any()
    _assert_close(got, want, BF16_REL)


# (T, F, Cin, Cout) -> the plan's (TT, TF, Cout tile) on the H100 (132 SMs):
# the served grids' tiles (as tests/test_torch_port_conv.py replays them),
# 64 of 128 packed columns at F = 10, 2048 -> 512 (128 would give 48 blocks)
CONV_PLANS = {(344, 80, 128, 128): (8, 16, 128), (172, 40, 256, 128): (16, 8, 128),
              (86, 20, 512, 256): (6, 20, 128), (43, 10, 1024, 1024): (12, 10, 128),
              (43, 10, 2048, 512): (12, 10, 64), (9, 10, 64, 64): (9, 10, 64),
              (5, 6, 24, 192): (5, 6, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("t,f,cin,cout", list(CONV_PLANS))
def test_conv_plan_matches_tiling(dev, t, f, cin, cout):
    """The card's launch plan (us_conv_plan) at the served grids takes the
    row tile the CPU tests replay and the Cout tile stated above; its tile
    count is the one us_conv_n_tiles sizes the statistics by, its blocks
    cover every tile and Cout tile of the batch, one block an SM at least;
    the 1x1 residual tiles 128 whole rows."""
    plan = fused_resnet.conv_plan(9, 3, t, f, cin, cout)
    assert (plan["tt"], plan["tf"], plan["bn"]) == CONV_PLANS[(t, f, cin, cout)]
    assert plan["tiles"] == _cuda.lib().us_conv_n_tiles(t * f, f, cin)
    assert plan["blocks"] == plan["tiles"] * (cout // plan["bn"]) * 3
    assert plan["blocks_per_sm"] >= 1
    res = fused_resnet.conv_plan(1, 3, t, f, cin, cout)
    assert (res["tt"], res["tf"], res["tiles"]) == (min(128, t * f), 1, -(-t * f // 128))


@pytest.mark.cuda
@pytest.mark.parametrize("cin", [2, 64, 1024])
def test_kernel_a_packed_and_statistics(dev, cin):
    """Kernel A alone with the weights packed once equals the call that packs
    them, bit for bit; its GroupNorm statistics (tile sums reduced in a
    fixed order) match the plain version's and repeat exactly."""
    rng = np.random.default_rng(cin)
    t, f, cout = 21, 10, 256
    n = t * f
    lens = torch.tensor([n, n - 4 * f, 3 * f], dtype=torch.int32, device=dev)
    x = _rand(rng, dev, 3, n, cin).to(torch.bfloat16)
    w, bias = _rand(rng, dev, 9 * cin, cout, scale=(9 * cin) ** -0.5), _rand(rng, dev, cout)
    packed = fused_resnet.pack_conv_weight(w.reshape(3, 3, cin, cout))
    got = fused_resnet.resnet_conv3x3(x, lens, w, bias, f, packed=packed)
    again = fused_resnet.resnet_conv3x3(x, lens, w, bias, f)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    c_p, mean_p, inv_p = fused_resnet.resnet_conv3x3_plain(x, lens, w, bias, f, 8)
    _assert_close(got[0], c_p, BF16_REL)
    torch.testing.assert_close(got[1], mean_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got[2], inv_p, rtol=1e-4, atol=1e-5)


DIM64 = dict(dim=64, dim_mults=(1, 2, 4, 8), groups=8, spk_emb_dim=256)


def _estimator_sd(tunet, rng, est):
    from unitspeech_tpu_torch.utils.params import _random_leaf

    sd = {k: torch.from_numpy(_random_leaf(rng, k, tuple(v.shape)).astype(np.float32))
          for k, v in est.state_dict().items()}
    for k in sd:
        if k.endswith(".g"):
            sd[k] *= 0.1
    return sd


@pytest.mark.cuda
@pytest.mark.parametrize("i8pre", [False, True], ids=["deep", "deep_i8"])
def test_estimator_dim64_serves(dev, i8pre):
    """decoder.dim 64 on the card with every kernel switch: the estimator
    serves (finite scores), routing each site to a kernel only where the
    kernel takes its widths; the kernels that launched are reported and are
    those the CPU route test expects (K1 at the 64/128-wide stages, K4 once
    at C = 128, K11 three times, K2, and the six deep blocks on K8 or K9)."""
    from unitspeech_tpu_torch.models import unet as tunet

    rng = np.random.default_rng(64)
    t = 64
    flags = dict(use_kernels=True, use_int8_deep=True, use_deep=True, use_resample=True,
                 use_i8pre_deep=i8pre)
    with dev:
        est = tunet.GradLogPEstimator2d(**DIM64, dtype=torch.bfloat16, **flags)
    est.load_state_dict(_estimator_sd(tunet, rng, est))
    wrappers = {"fused_resnet_block": fused_resnet.fused_resnet_block,
                "fused_resnet_block_deep": fused_resnet_deep.fused_resnet_block_deep,
                "fused_resnet_block_deep_i8": fused_resnet_deep.fused_resnet_block_deep_i8,
                "fused_final_block": fused_resnet.fused_final_block,
                "fused_rezero_attention": fused_attention.fused_rezero_attention,
                "fused_downsample_conv": resample.fused_downsample_conv,
                "fused_upsample_conv": resample.fused_upsample_conv}
    before = {k: w.launches for k, w in wrappers.items()}
    x, mu = _rand(rng, dev, 3, t, 80), _rand(rng, dev, 3, t, 80)
    mask = _mask(dev, t, [t, 41, t])[:, :, 0, 0]
    spk = _rand(rng, dev, 3, 256, scale=1 / 16)
    with torch.no_grad():
        out = est(x, mask, mu, torch.tensor([0.7, 0.4, 0.2], device=dev), spk)
    torch.cuda.synchronize()
    launched = {k: w.launches - before[k] for k, w in wrappers.items()}
    print(f"kernels launched at decoder.dim 64 ({'deep_i8' if i8pre else 'deep'}): {launched}")
    assert out.shape == (3, t, 80) and torch.isfinite(out).all()
    deep = 6 if not i8pre else 0
    assert launched == {"fused_resnet_block": 6, "fused_resnet_block_deep": deep,
                        "fused_resnet_block_deep_i8": 6 - deep, "fused_final_block": 1,
                        "fused_rezero_attention": 1, "fused_downsample_conv": 2,
                        "fused_upsample_conv": 1}


@pytest.mark.cuda
def test_cli_inference_dim64(dev, tmp_path):
    """`cli inference` with decoder.dim 64 serves on the card, with the
    serving defaults and with --deep --i8pre --resample (2 DDPM steps)."""
    import json
    import wave

    from unitspeech_tpu_torch import cli

    cfg = tmp_path / "dim64.json"
    cfg.write_text(json.dumps({"decoder": {"dim": 64}}))
    ckpt = str(tmp_path / "ckpt.pt")
    assert cli.main(["make-random-checkpoint", "--seed", "1", "--config", str(cfg),
                     "--output", ckpt]) == 0
    for flags in ([], ["--deep", "--i8pre", "--resample"]):
        out = str(tmp_path / "out.wav")
        stats = cli.main_inference(["--ipa", "--text", "həloʊ wɜːld", "--checkpoint", ckpt,
                                    "--output", out, "--device", "cuda", "--diffusion-steps",
                                    "2", *flags])
        with wave.open(out, "rb") as w:
            n = w.getnframes()
            pcm = np.frombuffer(w.readframes(n), np.int16)
        assert n > 0 and np.any(pcm) and stats["kernels"]


@pytest.mark.cuda
def test_weight_update_requantizes_on_load(dev):
    """K9's int8 tiles and K4's packed projections are made by
    load_state_dict: a weight update loaded again re-quantizes and re-packs
    them, and the estimator then gives what a fresh estimator with the new
    weights gives, bit for bit."""
    from unitspeech_tpu_torch.models import unet as tunet

    rng = np.random.default_rng(8)
    flags = dict(use_kernels=True, use_int8_deep=True, use_deep=True, use_resample=True,
                 use_i8pre_deep=True)
    with dev:
        est = tunet.GradLogPEstimator2d(**DIM64, dtype=torch.bfloat16, **flags)
        fresh = tunet.GradLogPEstimator2d(**DIM64, dtype=torch.bfloat16, **flags)
    sd = _estimator_sd(tunet, rng, est)
    est.load_state_dict(sd)
    old = (est.mid_res1.packed[0].clone(), est.mid_res1.packed[1].clone(),
           est.mid_res1.i8pre_weights[1][0].clone(), est.down_1_attn.packed[0].clone())
    for k in ("mid_res1.block1.conv.kernel", "mid_res1.block2.conv.kernel",
              "down_1_attn.fn.to_qkv.kernel"):
        sd[k] = sd[k] * -1.5 + 0.01
    est.load_state_dict(sd)
    fresh.load_state_dict(sd)
    new = (est.mid_res1.packed[0], est.mid_res1.packed[1], est.mid_res1.i8pre_weights[1][0],
           est.down_1_attn.packed[0])
    assert est.mid_res1.packed[1].dtype == torch.int8
    assert not any(torch.equal(a, b) for a, b in zip(old, new))
    w2 = est.mid_res1.block2.conv.kernel
    assert torch.equal(new[1], fused_resnet_deep.pack_conv_weight_i8(
        fused_resnet.quant_w(w2)[0], w2.shape[2]))
    t = 32
    x, mu = _rand(rng, dev, 2, t, 80), _rand(rng, dev, 2, t, 80)
    mask = _mask(dev, t, [t, 19])[:, :, 0, 0]
    args = (x, mask, mu, torch.tensor([0.6, 0.3], device=dev), _rand(rng, dev, 2, 256))
    with torch.no_grad():
        assert torch.equal(est(*args), fresh(*args))


@pytest.mark.cuda
def test_weight_update_in_place_then_pack(dev):
    """A conv weight of a K9 block changed in place and then
    `GradLogPEstimator2d.pack()`: the int8 tiles and the scales K9's
    epilogue reads are made anew together, and the estimator gives what a
    fresh estimator loaded with the new weights gives, bit for bit."""
    from unitspeech_tpu_torch.models import unet as tunet

    rng = np.random.default_rng(9)
    flags = dict(use_kernels=True, use_int8_deep=True, use_deep=True, use_resample=True,
                 use_i8pre_deep=True)
    with dev:
        est = tunet.GradLogPEstimator2d(**DIM64, dtype=torch.bfloat16, **flags)
        fresh = tunet.GradLogPEstimator2d(**DIM64, dtype=torch.bfloat16, **flags)
    est.load_state_dict(_estimator_sd(tunet, rng, est))
    assert est.mid_res1.packed_for == "k9"
    with torch.no_grad():
        for b in (est.mid_res1.block1, est.mid_res1.block2):
            b.conv.kernel.mul_(-1.5).add_(0.01)
    est.pack()
    fresh.load_state_dict(est.state_dict())
    w2 = est.mid_res1.block2.conv.kernel
    assert torch.equal(est.mid_res1.packed[1], fused_resnet_deep.pack_conv_weight_i8(
        fused_resnet.quant_w(w2)[0], w2.shape[2]))
    t = 32
    x, mu = _rand(rng, dev, 2, t, 80), _rand(rng, dev, 2, t, 80)
    mask = _mask(dev, t, [t, 19])[:, :, 0, 0]
    args = (x, mask, mu, torch.tensor([0.6, 0.3], device=dev), _rand(rng, dev, 2, 256))
    with torch.no_grad():
        assert torch.equal(est(*args), fresh(*args))


@pytest.mark.cuda
def test_weight_update_repacks_on_load(dev):
    """The packed K1 / K8 / K11 weights are made by load_state_dict: a
    weight update loaded again re-packs them, and the estimator then gives
    what a fresh estimator with the new weights gives, bit for bit."""
    from unitspeech_tpu_torch.models import unet as tunet

    rng = np.random.default_rng(7)
    flags = dict(use_kernels=True, use_deep=True, use_resample=True)
    with dev:
        est = tunet.GradLogPEstimator2d(**DIM64, dtype=torch.bfloat16, **flags)
        fresh = tunet.GradLogPEstimator2d(**DIM64, dtype=torch.bfloat16, **flags)
    sd = _estimator_sd(tunet, rng, est)
    est.load_state_dict(sd)
    old = (est.down_1_res1.packed[0].clone(), est.mid_res1.packed[1].clone(),
           est.down_0_down.packed.clone(), est.final_packed.clone())
    for k in ("down_1_res1.block1.conv.kernel", "mid_res1.block2.conv.kernel",
              "down_0_down.conv.kernel", "final_block.conv.kernel"):
        sd[k] = sd[k] * -1.5
    est.load_state_dict(sd)
    fresh.load_state_dict(sd)
    new = (est.down_1_res1.packed[0], est.mid_res1.packed[1], est.down_0_down.packed,
           est.final_packed)
    assert not any(torch.equal(a, b) for a, b in zip(old, new))
    assert torch.equal(new[0], fused_resnet.pack_conv_weight(
        est.down_1_res1.block1.conv.kernel))
    t = 32
    x, mu = _rand(rng, dev, 2, t, 80), _rand(rng, dev, 2, t, 80)
    mask = _mask(dev, t, [t, 19])[:, :, 0, 0]
    args = (x, mask, mu, torch.tensor([0.6, 0.3], device=dev), _rand(rng, dev, 2, 256))
    with torch.no_grad():
        assert torch.equal(est(*args), fresh(*args))


def _finetune_inputs(rng, dev, t_y=200, t_x=60, n_feats=80):
    """One utterance's fine-tune inputs: a cond_x from no encoder (random,
    as the unit encoder's output), a normalized mel and a monotonic path."""
    from unitspeech_tpu_torch.ops.masking import generate_path

    cond_x = _rand(rng, dev, 1, t_x, n_feats)
    y = torch.tanh(_rand(rng, dev, 1, t_y, n_feats))
    dur = torch.full((1, t_x), float(t_y // t_x), device=dev)
    dur[0, 0] += t_y - float(dur.sum())
    attn = generate_path(dur, torch.ones(1, t_x, t_y, device=dev))
    spk = _rand(rng, dev, 1, 256)
    return cond_x, y, torch.tensor([t_y], device=dev), attn, spk / spk.norm()


def _draws(rng, dev, seg, n_feats=80):
    return {"u": torch.tensor([0.37], device=dev), "t": torch.tensor([0.61], device=dev),
            "z": _rand(rng, dev, 1, seg, n_feats)}


def _all_launches():
    from chip_smoke import _kernel_wrappers

    return {k: w.launches for k, w in _kernel_wrappers().items()}


@pytest.mark.cuda
def test_finetune_step_f32_matches_cpu(dev):
    """One f32 fine-tune step (decoder.dim 64, segment 176) on the card with
    TF32 off against the same step on the CPU with the same draws: the loss
    within 1e-4 relative; each gradient within rtol 1e-3, atol 1e-4 of its
    tensor's largest (convolutions summed in another order); each parameter
    within 3e-3 * lr plus one f32 rounding where the two gradients agree
    within 1% and exceed 1e-7, else within 2 * lr: Adam's first step moves
    an entry by lr * u(g), u(g) = g / (|g| + 1e-8), about lr whatever g's
    size, so an entry whose gradient is rounding noise may go either way,
    and a 1% change of g moves u by at most 0.25%. cuDNN runs its
    deterministic algorithms here, so the step's gradients on the card are
    the ones recomputed beside it. The step launches no kernel: the
    fine-tune's estimator is the plain path (K3 has no backward)."""
    from unitspeech_tpu_torch.config import DecoderConfig
    from unitspeech_tpu_torch.models import unet as tunet

    rng = np.random.default_rng(21)
    cfg = DecoderConfig(**DIM64)
    with torch.device("meta"):
        est = tunet.GradLogPEstimator2d(**DIM64)
    sd = {f"estimator.{k}": v for k, v in _estimator_sd(tunet, rng, est).items()}
    sd["text_uncon"], sd["spk_uncon"] = torch.zeros(80), torch.ones(256)
    inputs = _finetune_inputs(rng, dev)
    draws = [_draws(rng, dev, 176)]
    lr = 1e-3
    before = _all_launches()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _check_f32_step(dev, cfg, sd, inputs, draws, lr, before)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _check_f32_step(dev, cfg, sd, inputs, draws, lr, before):
    """test_finetune_step_f32_matches_cpu's comparison."""
    from unitspeech_tpu_torch.models import diffusion as tdiff
    from unitspeech_tpu_torch.train.finetune import finetune_decoder

    got, loss = finetune_decoder(cfg, sd, *inputs, dtype=torch.float32, segment_size=176,
                                 n_iters=1, learning_rate=lr, draws=draws)
    assert _all_launches() == before
    cpu = [x.cpu() for x in inputs]
    cdraws = [{k: v.cpu() for k, v in draws[0].items()}]
    want, want_loss = finetune_decoder(cfg, sd, *cpu, dtype=torch.float32, segment_size=176,
                                       n_iters=1, learning_rate=lr, draws=cdraws)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    grads = {}
    for d, args, dr in ((dev, inputs, draws[0]), (torch.device("cpu"), cpu, cdraws[0])):
        with d:
            dec = tdiff.UnitSpeech.from_config(cfg)
        dec.load_state_dict(sd)
        tdiff.fine_tune_loss(dec, *args, 176, draws=dr).backward()
        assert _all_launches() == before
        grads[d.type] = {n: p.grad.cpu().numpy() for n, p in dec.named_parameters()
                         if p.grad is not None}
    for name, w in want.items():
        g, w = got[name].cpu().numpy(), w.numpy()
        tol = np.full(g.shape, 3e-3 * lr) + np.spacing(np.abs(w))
        if name in grads["cpu"]:
            gc, gd = grads["cuda"][name], grads["cpu"][name]
            np.testing.assert_allclose(gc, gd, rtol=1e-3, atol=1e-4 * np.abs(gd).max(),
                                       err_msg=name)
            noisy = (np.abs(gc - gd) > 1e-2 * np.abs(gd)) | (np.abs(gd) < 1e-7)
            tol[noisy] = 2 * lr
        assert np.all(np.abs(g - w) <= tol), (name, np.abs(g - w).max())


@pytest.fixture
def full_width_step(dev):
    """The full-width decoder (MainConfig) from random_params' draws, its
    inputs at the 344-frame bucket, and one bf16 and one f32 fine-tune step
    of lr 1e-3 from it with the same draws."""
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.models.diffusion import UnitSpeech
    from unitspeech_tpu_torch.train.finetune import finetune_decoder
    from unitspeech_tpu_torch.utils.params import _random_state_dict

    cfg = MainConfig().decoder
    rng = np.random.default_rng(22)
    with torch.device("meta"):
        base = _random_state_dict(rng, UnitSpeech.from_config(cfg))
    inputs = _finetune_inputs(rng, dev, t_y=300, t_x=90)
    draws = [_draws(rng, dev, 176)]
    steps = {dt: finetune_decoder(cfg, base, *inputs, dtype=dt, segment_size=176, n_iters=1,
                                  learning_rate=1e-3, draws=draws)
             for dt in (torch.bfloat16, torch.float32)}
    return cfg, base, steps


@pytest.mark.cuda
def test_finetune_bf16_step_near_f32(dev, full_width_step):
    """At full width: a bf16 step's loss (f32 parameters, bf16 activations,
    the default) finite and within 5% of the f32 step's; no kernel
    launched."""
    _, _, steps = full_width_step
    (sd16, l16), (_, l32) = steps[torch.bfloat16], steps[torch.float32]
    assert np.isfinite(l16).all() and abs(l16[0] - l32[0]) <= 0.05 * abs(l32[0])
    assert all(v.dtype == torch.float32 for v in sd16.values())


@pytest.mark.cuda
def test_adapted_weights_repack_every_buffer_on_load(dev, full_width_step):
    """load_state_dict of adapted weights into a kernel-route decoder (the
    serving default, int8) re-packs every packed buffer: each equals a
    fresh decoder's pack of the adapted weights bit for bit, and differs
    from the pack of the base weights it replaced."""
    from unitspeech_tpu_torch.models.diffusion import UnitSpeech

    cfg, base, steps = full_width_step
    adapted = steps[torch.bfloat16][0]
    with dev:
        served, fresh = (UnitSpeech.from_config(cfg, dtype=torch.bfloat16, use_kernels=True,
                                                use_int8_deep=True) for _ in range(2))
    served.load_state_dict(base)
    old = {k: v.clone() for k, v in served.estimator.packed_tensors().items()}
    served.load_state_dict(adapted)
    fresh.load_state_dict(adapted)
    new, ref = served.estimator.packed_tensors(), fresh.estimator.packed_tensors()
    assert len(new) == len(ref) == len(old) > 100
    for k in ref:
        assert torch.equal(new[k], ref[k]), k
        assert not torch.equal(new[k], old[k]), k


@pytest.mark.cuda
def test_cli_inference_fp32_matches_cpu_with_tf32_left_on(dev, tmp_path, monkeypatch):
    """The CLI's f32 policy on the card: `cli inference --fp32` (decoder
    .dim 64, forced 64 frames, 2 DDPM steps, noise injected from one numpy
    seed so that both devices draw the same) with the caller's TF32 left
    on, against the same command on the CPU: inside the command TF32 is off
    for matmuls and cuDNN convs, the caller's settings are back after it,
    and the mels agree within F32_REL of the CPU mel's largest magnitude
    (f32 sums in another order)."""
    import json

    from unitspeech_tpu_torch import cli
    from unitspeech_tpu_torch.infer import tts

    cfg = tmp_path / "dim64.json"
    cfg.write_text(json.dumps({"decoder": {"dim": 64}}))
    ckpt = str(tmp_path / "ckpt.pt")
    assert cli.main(["make-random-checkpoint", "--seed", "2", "--config", str(cfg),
                     "--output", ckpt]) == 0
    real, seen, mels = tts.Synthesizer.synthesize_mel, [], {}

    def injected(self, ids, generator=None, **kw):
        rng = np.random.default_rng(5)
        d = self.models.device
        kw["noise_z"] = torch.from_numpy(rng.standard_normal((1, 64, 80), np.float32)).to(d)
        kw["noises"] = torch.from_numpy(rng.standard_normal((2, 1, 64, 80), np.float32)).to(d)
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        out = real(self, ids, generator, **kw)
        mels[d.type] = out[0].float().cpu()
        return out

    monkeypatch.setattr(tts.Synthesizer, "synthesize_mel", injected)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    for device in ("cuda", "cpu"):
        cli.main_inference(["--ipa", "--text", "həloʊ wɜːld", "--checkpoint", ckpt, "--fp32",
                            "--frames", "64", "--diffusion-steps", "2", "--no-sv56",
                            "--device", device, "--output", str(tmp_path / f"{device}.wav")])
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    assert seen == [(False, False)] * 2
    err = (mels["cuda"] - mels["cpu"]).abs().max().item()
    assert err <= F32_REL * mels["cpu"].abs().max().item(), err


# f32 on the card against f32 on the CPU, relative to the largest magnitude
F32_REL = 1e-4


@pytest.mark.cuda
def test_finetune_lr1e3_full_width_which_goes_non_finite(dev, tmp_path):
    """Twelve fine-tune steps at lr 1e-3 (fifty times the reference's) at
    full width on chip_smoke.py's adapt inputs (the seed-0 random
    checkpoint, the seed-10 synthetic 6 s reference and its sidecars, the
    688-frame bucket), in f32 (TF32 off) and in bf16 activations, each
    with the draws of a generator seeded 0: prints each run's losses and
    its first non-finite step, the record behind PERF.md's lr 1e-3
    finding. Both start finite, and once a run's loss is non-finite it
    stays so."""
    from unitspeech_tpu_torch import cli
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.tools import synthetic_reference
    from unitspeech_tpu_torch.train.finetune import finetune_decoder
    from unitspeech_tpu_torch.utils.audio import load_wav
    from unitspeech_tpu_torch.utils.params import random_params

    cfg = MainConfig()
    ckpt = random_params(cfg, 0)
    flags = synthetic_reference(str(tmp_path), cfg, 6.0, seed=10)
    with np.load(flags[3]) as z:
        units, durations = z["units"], z["durations"]
    inputs = cli.finetune_inputs(cfg, load_wav(flags[1])[0], units, durations,
                                 ckpt["unit_encoder"], ckpt["mel_min"], ckpt["mel_max"],
                                 cli.DEFAULT_ADAPT_BUCKETS, dev)
    spk = torch.from_numpy(np.load(flags[5])).reshape(1, -1).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        _, losses = finetune_decoder(cfg.decoder, ckpt["decoder"], *inputs, spk / spk.norm(),
                                     dtype=dt, segment_size=cfg.out_size, n_iters=12,
                                     learning_rate=1e-3,
                                     generator=torch.Generator(device=dev).manual_seed(0))
        fin = np.isfinite(losses)
        first = int(np.argmin(fin)) if not fin.all() else None
        print(f"lr 1e-3 full width {dt}: losses {losses.tolist()}; first non-finite step "
              f"{first}")
        assert fin[0] and not np.any(fin[1:] & ~fin[:-1]), losses


# one estimator call at B = 1 against a reference, relative to the
# reference's largest magnitude. Against the plain path a whole call rounds
# to bf16 at ~100 points on each side, at different points (the kernels fuse
# GroupNorm, mish, the FiLM and the residual), int8 activations may round
# the other way at a .5 boundary, and on deep_i8 some convs are int8 on one
# side only (~1% each, JAX's int8 band); against the 3-row call, the conv
# tiles and sums may run in another order: looser than a single kernel's
# 2^-6, far below the O(1) error of a wrong row or scale
EST_REL = 2.0 ** -4


@pytest.mark.cuda
@pytest.mark.parametrize("deep", [False, True], ids=["int8", "deep_i8"])
def test_estimator_one_row_matches_plain(dev, deep):
    """The full-width estimator on the kernels at B = 1 (the `:cs<k>`
    samplers' cheap steps) on the int8 serving default, where K7's per-tensor
    scale then pools over one row, and with --deep --i8pre --resample:
    finite, every kernel launching as often as in a 3-row call, and within
    EST_REL of the plain path with int8 deep convs (no kernel; on deep_i8
    its int8 and bf16 convs are not all the same ones) and, on deep_i8,
    whose scales are per batch element at this bucket (K9), of the kernel
    path's own 3-row call's first row (the same inputs)."""
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.models.diffusion import UnitSpeech
    from unitspeech_tpu_torch.utils.params import random_params

    cfg = MainConfig()
    sd = random_params(cfg, 0)["decoder"]

    def build(kernels, **routes):
        with dev:
            mod = UnitSpeech.from_config(cfg.decoder, dtype=torch.bfloat16, use_kernels=kernels,
                                         use_int8_deep=True, **routes)
        mod.load_state_dict(sd)
        return mod.eval()

    deep_routes = dict(use_deep=True, use_resample=True, use_i8pre_deep=True) if deep else {}
    kern = build(True, **deep_routes)
    wrappers = {"fused_resnet_block": fused_resnet.fused_resnet_block,
                "fused_final_block": fused_resnet.fused_final_block,
                "row_stats": row_stats.row_stats, "row_absmax": row_stats.row_absmax,
                "fused_rezero_attention": fused_attention.fused_rezero_attention,
                "fused_resnet_block_deep": fused_resnet_deep.fused_resnet_block_deep,
                "fused_resnet_block_deep_i8": fused_resnet_deep.fused_resnet_block_deep_i8,
                "fused_downsample_conv": resample.fused_downsample_conv,
                "fused_upsample_conv": resample.fused_upsample_conv}
    rng = np.random.default_rng(12)
    t = 344
    x, mu = _rand(rng, dev, 3, t, 80), _rand(rng, dev, 3, t, 80)
    mask = _mask(dev, t, [301, t, t])[:, :, 0, 0]
    spk = _rand(rng, dev, 3, 256, scale=1 / 16)
    tt = torch.tensor([0.7, 0.4, 0.2], device=dev)
    out, launched = {}, {}
    with torch.no_grad():
        for b in (3, 1):
            before = {k: w.launches for k, w in wrappers.items()}
            out[b] = kern(x[:b], mask[:b], mu[:b], tt[:b], spk[:b])
            torch.cuda.synchronize()
            launched[b] = {k: w.launches - before[k] for k, w in wrappers.items()}
        refs = {"the plain int8 path": build(False)(x[:1], mask[:1], mu[:1], tt[:1], spk[:1])}
    if deep:
        refs["its 3-row call"] = out[3][:1]
    assert out[1].shape == (1, t, 80) and torch.isfinite(out[1]).all()
    for what, want in refs.items():
        err = (out[1] - want).abs().max().item() / want.abs().max().item()
        print(f"estimator {'deep_i8' if deep else 'int8'} at B=1 against {what}: max |diff| "
              f"{err:.3e} of the largest; launches {launched[1]}")
        assert err <= EST_REL, (what, err)
    assert launched[1] == launched[3] and launched[1]["fused_resnet_block"] == 6


@pytest.mark.cuda
def test_cli_voice_conversion_fp32_matches_cpu(dev, tmp_path, monkeypatch):
    """`cli voice-conversion --fp32` on the card against the same command on
    the CPU (decoder.dim 64, contentvec features from one numpy seed, a
    0.3 s source, 2 dpm2:cs2 steps, the prior injected from one numpy seed so
    that both devices draw the same), the caller's TF32 left on: the mels
    agree within F32_REL of the CPU mel's largest magnitude, and the
    caller's TF32 settings are back after each command."""
    import json

    from unitspeech_tpu_torch import cli
    from unitspeech_tpu_torch.config import config_from_dict
    from unitspeech_tpu_torch.infer import vc
    from unitspeech_tpu_torch.tools import vc_reference

    cfg_d = {"decoder": {"dim": 64}}
    (tmp_path / "dim64.json").write_text(json.dumps(cfg_d))
    cfg = config_from_dict(cfg_d)
    ckpt = str(tmp_path / "ckpt.pt")
    assert cli.main(["make-random-checkpoint", "--seed", "2", "--config",
                     str(tmp_path / "dim64.json"), "--output", ckpt]) == 0
    files = vc_reference.random_vc_reference(str(tmp_path), cfg, seed=3)
    src = vc_reference.random_source(str(tmp_path / "src.wav"), cfg, 0.3, seed=4)
    np.save(tmp_path / "feats.npy",
            np.random.default_rng(5).standard_normal((15, 768)).astype(np.float32))
    real, mels = vc.voice_conversion, {}

    def injected(encoder, decoder, content, mel_len, *a, **kw):
        pad = vc.vc_frames(mel_len, cfg.decoder.num_downsamplings)
        kw["noise_z"] = torch.from_numpy(np.random.default_rng(6).standard_normal(
            (1, pad, 80), np.float32)).to(content.device)
        out = real(encoder, decoder, content, mel_len, *a, **kw)
        mels[content.device.type] = out.float().cpu()
        return out

    monkeypatch.setattr(vc, "voice_conversion", injected)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    for device in ("cuda", "cpu"):
        stats = cli.main_voice_conversion([
            "--source", src, "--decoder", ckpt, "--content-encoder",
            files["contentvec-encoder"], "--content-features", str(tmp_path / "feats.npy"),
            "--vocoder", ckpt, "--fp32", "--sampler", "dpm2:cs2", "--diffusion-steps", "2",
            "--no-sv56", "--device", device, "--config", str(tmp_path / "dim64.json"),
            "--output", str(tmp_path / f"{device}.wav")])
        assert stats["frames"] == int(0.3 * 22050) // 256 and not stats["kernels"]
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    err = (mels["cuda"] - mels["cpu"]).abs().max().item()
    assert err <= F32_REL * mels["cpu"].abs().max().item(), err
