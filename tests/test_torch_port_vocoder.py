"""The port's anti-aliased snake kernels K5/K6 and the BigVGAN that runs them,
against the JAX package on the CPU in f32:

  * the polyphase filters the kernels apply vs the JAX `_phase_filters()`,
    and the kernels' clamped-index arithmetic (written out in numpy here,
    as csrc/aa_snake.cu computes it) vs the plain path at every sample;
  * the plain versions (what a CPU tensor runs) vs the JAX XLA twin
    (AntiAliasedActivation(use_pallas=False) + conv + residual) at every
    sample, edges included;
  * the plain versions vs the Pallas kernels in interpret mode: equal in the
    interior, and the edge difference recorded (the Pallas kernels pad the
    utterance ends as an extended LTI filter, the port as the reference);
  * a tiny BigVGAN on the kernel route vs the JAX BigVGAN(use_pallas=False).

The port's tensors are (B, C, T); JAX's are (B, T, C). Tolerance: 2e-5 abs
/ 1e-4 rel (f32 sums in another order) unless a case says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port import load, randomize
from unitspeech_tpu.config import VocoderConfig
from unitspeech_tpu.models import vocoder as jvoc
from unitspeech_tpu.ops.pallas_kernels import HALO
from unitspeech_tpu.ops.pallas_kernels import _phase_filters as j_phase_filters
from unitspeech_tpu.ops.pallas_kernels import fused_aa_snake as j_aa_snake
from unitspeech_tpu.ops.pallas_kernels import fused_aa_snake_conv as j_aa_snake_conv
from unitspeech_tpu_torch.models import vocoder as tvoc
from unitspeech_tpu_torch.ops import aa_snake

ATOL, RTOL = 2e-5, 1e-4


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def _inputs(seed, b, c, t, k=None):
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    p = dict(x=r(b, c, t, scale=0.7), alpha=r(c, scale=0.3), beta=r(c, scale=0.3))
    if k is not None:
        p.update(w=r(k, c, c, scale=(k * c) ** -0.5), bias=r(c, scale=0.1),
                 res=r(b, c, t, scale=0.5))
    return p


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _btc(a):
    """(B, C, T) numpy -> JAX (B, T, C)."""
    return jnp.asarray(np.swapaxes(a, 1, 2))


def _bct(a):
    return np.swapaxes(np.asarray(a), 1, 2)


def test_phase_filters_match_jax():
    f0, f1, g, o0, o1, od = aa_snake.phase_filters()
    jf0, jf1, jg, jo0, jo1, jod = j_phase_filters()
    assert (o0, o1, od) == (jo0, jo1, jod) == (-3, -2, -5)
    for got, want in ((f0, jf0), (f1, jf1), (g, jg)):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


def _kernel_arithmetic(x, alpha, beta, logscale, w=None, bias=None, dil=1, res=None):
    """csrc/aa_snake.cu's per-sample formulas in numpy (f64): every index
    clamped to the signal, the conv reading zeros outside [0, T)."""
    f0, f1, g, o0, o1, od = (np.asarray(v, np.float64) if isinstance(v, np.ndarray) else v
                             for v in aa_snake.phase_filters())
    b, c, t = x.shape
    a, bb = alpha.astype(np.float64), beta.astype(np.float64)
    if logscale:
        a, bb = np.exp(a), np.exp(bb)
    ib = 1.0 / (bb + 1e-9)
    m = np.arange(2 * t)
    u, p = m // 2, m % 2
    cl = lambda i: np.clip(i, 0, t - 1)  # noqa: E731
    y2 = np.where(p == 0,
                  sum(f0[k] * x[..., cl(u + o0 + k)] for k in range(6)),
                  sum(f1[k] * x[..., cl(u + o1 + k)] for k in range(6)))
    z = y2 + ib[None, :, None] * np.sin(y2 * a[None, :, None]) ** 2
    tt = np.arange(t)
    y = sum(g[i] * z[..., np.clip(2 * tt + od + i, 0, 2 * t - 1)] for i in range(12))
    if w is None:
        return y
    k = w.shape[0]
    half = (k - 1) // 2
    yp = np.pad(y, ((0, 0), (0, 0), (half * dil, half * dil)))
    out = sum(np.einsum("bct,cd->bdt", yp[..., j * dil: j * dil + t], w[j]) for j in range(k))
    out = out + bias[None, :, None]
    return out if res is None else out + res


@pytest.mark.parametrize("t,k,d,residual", [(37, 3, 1, False), (29, 11, 5, True),
                                            (8, 7, 3, True), (3, 3, 1, False)])
def test_kernel_arithmetic_matches_plain(t, k, d, residual):
    """The index arithmetic of the CUDA kernels (clamped x and z windows,
    zero conv padding) reproduces the plain path at every sample, for
    lengths shorter than the filters' and the conv's reach."""
    p = _inputs(t + k, 2, 8, t, k)
    res = p["res"] if residual else None
    want = aa_snake.aa_snake_conv_plain(_t(p["x"]), _t(p["alpha"]), _t(p["beta"]),
                                        _t(p["w"]), _t(p["bias"]), d,
                                        None if res is None else _t(res)).numpy()
    _close(_kernel_arithmetic(p["x"], p["alpha"], p["beta"], True, p["w"], p["bias"], d, res),
           want)
    _close(_kernel_arithmetic(p["x"], p["alpha"], p["beta"], False),
           aa_snake.aa_snake_plain(_t(p["x"]), _t(p["alpha"]), _t(p["beta"]), False).numpy())


def _jax_act(c, activation, logscale, alpha, beta):
    act = jvoc.AntiAliasedActivation(c, activation, logscale, use_pallas=False)
    params = {"alpha": jnp.asarray(alpha)}
    if activation == "snakebeta":
        params["beta"] = jnp.asarray(beta)
    return act, {"params": {"act": params}}


@pytest.mark.parametrize("t,c,activation,logscale", [
    (53, 8, "snakebeta", True), (40, 16, "snake", True), (17, 4, "snakebeta", False),
])
def test_aa_snake_plain_matches_xla_twin(t, c, activation, logscale):
    """K6's plain version vs the XLA twin at every sample, edges included."""
    p = _inputs(t, 2, c, t)
    beta = p["beta"] if activation == "snakebeta" else p["alpha"]
    act, params = _jax_act(c, activation, logscale, p["alpha"], beta)
    want = _bct(act.apply(params, _btc(p["x"])))
    got = aa_snake.fused_aa_snake(_t(p["x"]), _t(p["alpha"]), _t(beta), logscale).numpy()
    assert got.shape == p["x"].shape
    _close(got, want)


@pytest.mark.parametrize("t,k,d,residual", [
    (61, 3, 1, False), (61, 3, 3, True), (45, 7, 5, False), (45, 11, 5, True), (30, 11, 1, True),
])
def test_aa_snake_conv_plain_matches_xla_twin(t, k, d, residual):
    """K5's plain version vs the XLA twin at every sample, edges included:
    the activation, then the AMP block's unfused conv (`_conv1d_torchpad`,
    SAME padding (k-1)/2*d) + bias, + residual. (The conv_kernel argument
    of the JAX AntiAliasedActivation pads by d alone, which is SAME only
    for k = 3; the JAX package never calls it so.)"""
    c = 8
    p = _inputs(t * k + d, 2, c, t, k)
    res = p["res"] if residual else None
    act, params = _jax_act(c, "snakebeta", True, p["alpha"], p["beta"])
    conv = jvoc._conv1d_torchpad(c, k, d)
    want = conv.apply({"params": {"kernel": jnp.asarray(p["w"]), "bias": jnp.asarray(p["bias"])}},
                      act.apply(params, _btc(p["x"])))
    want = _bct(want if res is None else want + _btc(res))
    got = aa_snake.fused_aa_snake_conv(_t(p["x"]), _t(p["alpha"]), _t(p["beta"]), _t(p["w"]),
                                       _t(p["bias"]), d, None if res is None else _t(res))
    _close(got.numpy(), want)


def _edge_split(got, want, e):
    """max |got - want| in the interior (e samples in from each end) and at
    the edges."""
    diff = np.abs(got - want)
    return diff[..., e:-e].max(), max(diff[..., :e].max(), diff[..., -e:].max())


def test_aa_snake_plain_vs_pallas_interpret():
    """K6's plain version vs the interpret-mode Pallas kernel: equal in the
    interior (the Pallas snake is a polynomial sine within 1e-6, so 1e-4);
    within HALO/2 samples of the ends the Pallas kernel's extended-LTI
    padding differs from the reference's replicate padding, held to the JAX
    package's own edge bound (tests/test_pallas_kernels.py: 0.1 rel, 0.05 abs)."""
    p = _inputs(3, 2, 16, 200)
    got = aa_snake.fused_aa_snake(_t(p["x"]), _t(p["alpha"]), _t(p["beta"])).numpy()
    want = _bct(j_aa_snake(_btc(p["x"]), jnp.asarray(p["alpha"]), jnp.asarray(p["beta"]),
                           t_tile=64, interpret=True))
    inner, edge = _edge_split(got, want, HALO // 2)
    assert inner <= 1e-4, inner
    assert 1e-4 < edge, edge  # the edge decision is visible
    _close(got, want, atol=0.05, rtol=0.1)


@pytest.mark.parametrize("k,d,residual", [(3, 1, True), (11, 5, False)])
def test_aa_snake_conv_plain_vs_pallas_interpret(k, d, residual):
    """K5's plain version vs the interpret-mode Pallas kernel: equal in the
    interior, which here also excludes the conv's reach (k-1)/2*d. Within
    that reach of the ends the Pallas conv reads its own activation values
    past the signal where the reference reads zeros, so the edge difference
    is of the order of the output itself (bounded by max |plain|)."""
    c, t = 8, 160
    p = _inputs(k + d, 1, c, t, k)
    res = p["res"] if residual else None
    got = aa_snake.fused_aa_snake_conv(_t(p["x"]), _t(p["alpha"]), _t(p["beta"]), _t(p["w"]),
                                       _t(p["bias"]), d, None if res is None else _t(res)).numpy()
    want = _bct(j_aa_snake_conv(_btc(p["x"]), jnp.asarray(p["alpha"]), jnp.asarray(p["beta"]),
                                jnp.asarray(p["w"]), jnp.asarray(p["bias"]), dilation=d,
                                residual=None if res is None else _btc(res), t_tile=64,
                                interpret=True))
    inner, edge = _edge_split(got, want, HALO // 2 + (k - 1) // 2 * d)
    assert inner <= 1e-4, inner
    assert 1e-4 < edge <= np.abs(got).max(), edge


@pytest.mark.parametrize("resblock,activation,logscale", [
    ("1", "snakebeta", True), ("2", "snake", True), ("2", "snakebeta", False),
    ("1", "snake", False),
])
def test_bigvgan_kernel_route_matches_jax(resblock, activation, logscale):
    """A tiny BigVGAN with use_kernels=True (every activation through the
    K5/K6 wrappers, which run their plain versions on CPU tensors) and with
    use_kernels=False, against the JAX BigVGAN(use_pallas=False) on the same
    flax parameters."""
    cfg = VocoderConfig(num_mels=16, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                        upsample_initial_channel=16, resblock=resblock,
                        resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 2)),
                        activation=activation, snake_logscale=logscale)
    rng = np.random.default_rng(8)
    mel = rng.standard_normal((2, 11, 16)).astype(np.float32)
    jv = jvoc.BigVGAN.from_config(cfg)
    params = randomize(jv.init(jax.random.PRNGKey(0), mel), 9)
    want = np.asarray(jv.apply(params, mel))
    before = aa_snake.fused_aa_snake_conv.launches
    for use_kernels in (True, False):
        tv = load(tvoc.BigVGAN.from_config(cfg, use_kernels=use_kernels), params)
        with torch.no_grad():
            got = tv(torch.from_numpy(mel)).numpy()
        assert got.shape == (2, 44)
        _close(got, want)
    assert aa_snake.fused_aa_snake_conv.launches == before  # CPU: no kernel launch
