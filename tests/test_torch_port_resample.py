"""The port's strided resampling convs (kernel K11, ops/resample.py) against
the JAX package on the CPU: the plain versions against the Pallas kernels
`fused_downsample_conv` / `fused_upsample_conv` in interpret mode at the JAX
tests' shapes (odd tile counts, heavy padding), the CUDA kernels' index
arithmetic written out in numpy against the plain versions, and the
routing gates against JAX's.

Tolerances: 2e-5 abs / 1e-4 rel in f32 (the JAX tests' own); bf16 outputs
within one bf16 step (both round the f32 accumulator once)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unitspeech_tpu.models.unet import Downsample, Upsample
from unitspeech_tpu.ops import pallas_resample as jrs
from unitspeech_tpu_torch.ops import resample

ATOL, RTOL = 2e-5, 1e-4


def _mask(t, lens):
    return (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)[
        :, :, None, None]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _case(mod, b, t, f, cin, lens, seed):
    key = jax.random.PRNGKey(seed)
    x = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (b, t, f, cin)))
    params = mod.init(key, x)["params"]["conv"]
    return x, _mask(t, lens), np.asarray(params["kernel"]), np.asarray(params["bias"])


@pytest.mark.parametrize("b,t,f,cin,cout,lens,fpt", [
    (2, 16, 8, 4, 4, [16, 16], 0),   # full mask
    (2, 16, 8, 4, 8, [16, 10], 0),   # padded batch, channel change
    (1, 8, 16, 4, 4, [8], 2),        # explicit small tile
    (2, 12, 8, 4, 4, [12, 5], 3),    # odd tile count, heavy padding
])
def test_downsample_plain_matches_pallas(b, t, f, cin, cout, lens, fpt):
    x, mask, k, bias = _case(Downsample(cout), b, t, f, cin, lens, 0)
    want = np.asarray(jrs.fused_downsample_conv(x, mask, k, bias, interpret=True, fpt=fpt))
    before = resample.fused_downsample_conv.launches
    got = resample.fused_downsample_conv(_t(x), _t(mask), _t(k), _t(bias))
    assert resample.fused_downsample_conv.launches == before  # CPU: the plain version
    assert got.shape == (b, t // 2, f // 2, cout)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("b,t,f,cin,cout,lens,fpt", [
    (2, 8, 8, 4, 4, [8, 8], 0),      # full mask
    (2, 8, 8, 8, 4, [8, 5], 0),      # padded batch, channel change
    (1, 6, 8, 4, 4, [6], 2),         # explicit small tile
    (2, 12, 16, 4, 4, [12, 7], 3),   # odd tile count, heavy padding
])
def test_upsample_plain_matches_pallas(b, t, f, cin, cout, lens, fpt):
    x, mask, k, bias = _case(Upsample(cout), b, t, f, cin, lens, 1)
    want = np.asarray(jrs.fused_upsample_conv(x, mask, k, bias, interpret=True, fpt=fpt))
    before = resample.fused_upsample_conv.launches
    got = resample.fused_upsample_conv(_t(x), _t(mask), _t(k), _t(bias))
    assert resample.fused_upsample_conv.launches == before
    assert got.shape == (b, 2 * t, 2 * f, cout)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("up", [False, True], ids=["down", "up"])
def test_bf16_rounds_once_as_pallas(up):
    """bf16 activations: the plain version and the Pallas kernel both round
    the f32 accumulator plus bias once, so they differ by at most one bf16
    step (f32 sums in another order)."""
    mod = Upsample(8) if up else Downsample(8)
    x, mask, k, bias = _case(mod, 2, 8, 16, 8, [8, 5], 2)
    xb = jnp.asarray(x, jnp.bfloat16)
    fn = jrs.fused_upsample_conv if up else jrs.fused_downsample_conv
    want = np.asarray(fn(xb, mask, k, bias, interpret=True), np.float32)
    port = resample.fused_upsample_conv if up else resample.fused_downsample_conv
    got = port(_t(x).to(torch.bfloat16), _t(mask), _t(k), _t(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8, atol=1e-6)


def _down_index_replay(x, lens_rows, w, bias):
    """csrc/resample.cu downsample_conv in numpy (f64): output row m = (to,
    fo), tap = k // Cin, input row (2 to + tap / 3 - 1, 2 fo + tap % 3 - 1),
    zero outside the grid and at/after lens_rows; w (9*Cin, Cout)."""
    b, t, f, cin = x.shape
    to_, fo_ = t // 2, f // 2
    xr = x.reshape(b, t * f, cin).astype(np.float64)
    out = np.zeros((b, to_ * fo_, w.shape[1]))
    for bb in range(b):
        for m in range(to_ * fo_):
            to, fo = divmod(m, fo_)
            for tap in range(9):
                ti, fi = 2 * to + tap // 3 - 1, 2 * fo + tap % 3 - 1
                if not (0 <= ti < t and 0 <= fi < f):
                    continue
                src = ti * f + fi
                if src >= lens_rows[bb]:
                    continue
                out[bb, m] += xr[bb, src] @ w[tap * cin:(tap + 1) * cin]
    return (out + bias).reshape(b, to_, fo_, -1)


def _up_index_replay(x, lens_rows, w, bias):
    """csrc/resample.cu upsample_conv in numpy (f64): phase (pa, pb), input
    row m = (mt, mf), tap q = it * 2 + jf reads input (mt + it - 1 + pa,
    mf + jf - 1 + pb) with kernel tap (pa + 2 it, pb + 2 jf) of w (16*Cin,
    Cout), written to output row (2 mt + pa, 2 mf + pb)."""
    b, t, f, cin = x.shape
    xr = x.reshape(b, t * f, cin).astype(np.float64)
    out = np.zeros((b, 2 * t, 2 * f, w.shape[1]))
    for bb in range(b):
        for pa in (0, 1):
            for pb in (0, 1):
                for m in range(t * f):
                    mt, mf = divmod(m, f)
                    acc = np.zeros(w.shape[1])
                    for q in range(4):
                        ti, fi = mt + (q >> 1) - 1 + pa, mf + (q & 1) - 1 + pb
                        if not (0 <= ti < t and 0 <= fi < f) or ti * f + fi >= lens_rows[bb]:
                            continue
                        kt, kf = pa + 2 * (q >> 1), pb + 2 * (q & 1)
                        row = (kt * 4 + kf) * cin
                        acc += xr[bb, ti * f + fi] @ w[row:row + cin]
                    out[bb, 2 * mt + pa, 2 * mf + pb] = acc + bias
    return out


@pytest.mark.parametrize("t,f,lens", [(6, 8, [6, 3]), (4, 6, [2, 4])])
def test_kernel_index_arithmetic_matches_plain(t, f, lens):
    """The CUDA kernels' source rows and up-phase taps, replayed in numpy,
    give the plain versions' convs (f32 vs f64: 1e-5 relative)."""
    rng = np.random.default_rng(t * f)
    b, cin, cout = 2, 3, 5
    x = rng.standard_normal((b, t, f, cin)).astype(np.float32)
    mask = _mask(t, lens)
    lens_rows = np.asarray(lens) * f
    for replay, plain, taps in ((_down_index_replay, resample.downsample_conv_plain, 3),
                                (_up_index_replay, resample.upsample_conv_plain, 4)):
        k = rng.standard_normal((taps, taps, cin, cout)).astype(np.float32)
        bias = rng.standard_normal(cout).astype(np.float32)
        want = replay(x, lens_rows, k.reshape(taps * taps * cin, cout), bias)
        got = plain(_t(x), _t(mask), _t(k), _t(bias)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("f", [80, 40, 20, 16, 10, 8])
def test_gates_match_jax(f):
    """supports_downsample / supports_upsample are the JAX package's, at the
    estimator's widths for every frame count up to 700."""
    for c in (128, 256, 512):
        for t in range(1, 701):
            assert resample.supports_downsample(t, f, c) == jrs.supports_downsample(t, f, c)
            assert resample.supports_upsample(t, f, c) == jrs.supports_upsample(t, f, c)
    if f in (80, 40):
        assert resample.supports_downsample(344 * f // 80, f, 128 * 80 // f)
