"""The sampler specs in the port against the JAX package on the CPU:
parse_sampler_spec, the DPM-Solver++(2M) schedule, reverse_diffusion_ode
at stride 1 and with the guidance stride (`:cs<k>`), the strided DDPM with
JAX's fold_in draws injected (on a cheap nonlinear score over the whole
grid of steps, strides and guidance, and driving the estimator), the
stride's call pattern (3-row guidance calls every k-th step, 1-row calls
between, the trailing n % k steps full) and its exactness on a score whose
cached delta is constant.

The estimator is the 2-stage one at dim 8 with small rezero gates
(tests/_torch_port.scale_gates), f32. Tolerance: 1e-5 absolute plus 1e-4
relative of the output's largest magnitude (f32 sums in another order
through ~20 normalized layers per step, a few steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tests._torch_port import randomize, scale_gates
from unitspeech_tpu.models import diffusion as jdiff
from unitspeech_tpu.ops import schedule as jsched
from unitspeech_tpu_torch.models import diffusion as tdiff
from unitspeech_tpu_torch.ops import schedule as tsched
from unitspeech_tpu_torch.utils.params import params_from_jax

DEC = dict(n_feats=16, dim=8, dim_mults=(1, 2), groups=4, spk_emb_dim=8)
ATOL, RTOL = 1e-5, 1e-4
GUIDANCE = [(1.0, 1.0), (1.3, 0.0), (0.0, 0.7)]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=ATOL + RTOL * np.abs(want).max())


def test_parse_sampler_spec_matches_jax():
    """JAX's cases (tests/test_cfg_cache.py): the same names and strides,
    and the same ValueError messages for every malformed spec."""
    for spec in ("ddpm", "dpm2", "ddpm:cs1", "dpm2:cs2", "ddpm:cs10"):
        assert tdiff.parse_sampler_spec(spec) == jdiff.parse_sampler_spec(spec)
    for bad in ("euler", "dpm2:cs0", "dpm2:cs", "dpm2:stride2", "ddpm:cs-1", "dpm2:cs2x", ""):
        with pytest.raises(ValueError) as want:
            jdiff.parse_sampler_spec(bad)
        with pytest.raises(ValueError, match=f"^{__import__('re').escape(str(want.value))}$"):
            tdiff.parse_sampler_spec(bad)


@pytest.mark.parametrize("n", [1, 7, 25, 50])
def test_ode_schedule_matches_jax(n):
    """make_ode_schedule(n).stacked(): (n, 7) f32, equal to JAX's bit for
    bit (the same float64 host arithmetic)."""
    got = tsched.make_ode_schedule(n).stacked()
    want = np.asarray(jsched.make_ode_schedule(n).stacked())
    assert got.shape == (n, 7) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def pair():
    """(JAX UnitSpeech, its params, the port decoder with the same weights,
    inputs z, mask (one padded row), cond, spk)."""
    rng = np.random.default_rng(3)
    b, t, f = 2, 16, DEC["n_feats"]
    z = rng.standard_normal((b, t, f)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[1, 11:] = 0
    cond = rng.standard_normal((b, t, f)).astype(np.float32)
    spk = rng.standard_normal((b, DEC["spk_emb_dim"])).astype(np.float32)
    jm = jdiff.UnitSpeech(**DEC)
    init = jax.jit(jm.init)(jax.random.PRNGKey(0), z, mask, cond, np.zeros(b, np.float32), spk)
    params = jax.device_get(scale_gates(randomize(init, 4), 0.003))
    port = tdiff.UnitSpeech(**DEC)
    port.load_state_dict(params_from_jax(params))
    return jm, params, port.eval(), z, mask, cond, spk


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _jax_score(params, xt, mask, cond, t, spk):
    """A cheap score that depends on xt, t, cond and spk nonlinearly, so the
    guidance delta changes from step to step (the sampler's arithmetic and
    step indexing, with no estimator to compile)."""
    tt = t[:, None, None]
    return (-0.3 * jnp.tanh(xt) + cond * (0.5 + tt)
            + 0.1 * jnp.sum(spk, -1)[:, None, None] * jnp.sin(xt + tt)) * mask[:, :, None]


class _Score(nn.Module):
    """_jax_score in torch, with the decoder's attributes the samplers read."""

    beta_min, beta_max = 0.05, 20.0

    def __init__(self, params):
        super().__init__()
        p = params["params"]
        self.text_uncon = nn.Parameter(torch.from_numpy(np.asarray(p["text_uncon"])))
        self.spk_uncon = nn.Parameter(torch.from_numpy(np.asarray(p["spk_uncon"])))

    def forward(self, xt, mask, cond, t, spk):
        tt = t[:, None, None]
        return (-0.3 * torch.tanh(xt) + cond * (0.5 + tt)
                + 0.1 * spk.sum(-1)[:, None, None] * torch.sin(xt + tt)) * mask[:, :, None]


def _score_params(pair):
    p = pair[1]["params"]
    return {"params": {"text_uncon": np.asarray(p["text_uncon"]),
                       "spk_uncon": np.asarray(p["spk_uncon"])}}


@pytest.mark.parametrize("n,stride", [(8, 2), (7, 3), (4, 8)])
@pytest.mark.parametrize("tg,sg", GUIDANCE)
def test_reverse_diffusion_ode_matches_jax(pair, n, stride, tg, sg):
    """dpm2 at stride 1 and at `stride` (clamped to n) against JAX's on one
    z, the score a cheap nonlinear function (_jax_score; the estimator's
    own runs: test_samplers_on_the_estimator_match_jax); the strided run
    differs from stride 1 where guidance is on."""
    _, _, _, z, mask, cond, spk = pair
    params = _score_params(pair)
    kw = dict(n_timesteps=n, text_gradient_scale=tg, spk_gradient_scale=sg)
    outs = []
    for k in (1, stride):
        want = jdiff.reverse_diffusion_ode(_jax_score, params, z, mask, cond, spk, cfg_stride=k,
                                           **kw)
        got = tdiff.reverse_diffusion_ode(_Score(params), *_t(z, mask, cond, spk), cfg_stride=k,
                                          **kw)
        _close(got, want)
        outs.append(got)
    np.testing.assert_array_equal(outs[1][1, 11:].numpy(), 0.0)
    assert (outs[1] - outs[0]).abs().max() > 1e-6


def _jax_noises(key, n, shape):
    """The strided DDPM's draws: normal(fold_in(key, i)) at step i."""
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape))
                     for i in range(n)])


@pytest.mark.parametrize("n,stride", [(8, 2), (7, 3), (4, 8)])
@pytest.mark.parametrize("tg,sg", GUIDANCE)
def test_strided_ddpm_matches_jax(pair, n, stride, tg, sg):
    """reverse_diffusion with cfg_stride against JAX's on the cheap score,
    JAX drawing step i's noise from fold_in(key, i) (and refusing injected
    noise at a stride above 1): the port is given those draws."""
    _, _, _, z, mask, cond, spk = pair
    params = _score_params(pair)
    key = jax.random.PRNGKey(9)
    kw = dict(n_timesteps=n, text_gradient_scale=tg, spk_gradient_scale=sg)
    want = jdiff.reverse_diffusion(_jax_score, params, z, mask, cond, spk, key,
                                   cfg_stride=stride, **kw)
    got = tdiff.reverse_diffusion(_Score(params), *_t(z, mask, cond, spk), cfg_stride=stride,
                                  noises=torch.from_numpy(_jax_noises(key, n, z.shape)), **kw)
    _close(got, want)


@pytest.mark.parametrize("sampler,n,stride", [("dpm2", 7, 1), ("dpm2", 7, 3), ("ddpm", 6, 2)])
def test_samplers_on_the_estimator_match_jax(pair, sampler, n, stride):
    """The samplers driving the 2-stage estimator, dual guidance 1.0 / 1.0,
    against JAX's (the DDPM with JAX's fold_in draws); finite, the padded
    frames zero."""
    jm, params, port, z, mask, cond, spk = pair
    kw = dict(n_timesteps=n, text_gradient_scale=1.0, spk_gradient_scale=1.0, cfg_stride=stride)
    if sampler == "dpm2":
        want = jdiff.reverse_diffusion_ode(jm.apply, params, z, mask, cond, spk, **kw)
        got = tdiff.reverse_diffusion_ode(port, *_t(z, mask, cond, spk), **kw)
    else:
        key = jax.random.PRNGKey(10)
        want = jdiff.reverse_diffusion(jm.apply, params, z, mask, cond, spk, key, **kw)
        got = tdiff.reverse_diffusion(port, *_t(z, mask, cond, spk),
                                      noises=torch.from_numpy(_jax_noises(key, n, z.shape)), **kw)
    assert np.isfinite(np.asarray(want)).all()
    _close(got, want)
    np.testing.assert_array_equal(got[1, 11:].numpy(), 0.0)


@pytest.mark.parametrize("sampler", ["ddpm", "dpm2"])
def test_stride_is_a_no_op_without_guidance(pair, sampler):
    """With both scales 0 there are no guidance rows to cache: any stride
    gives the stride-1 result bit for bit (the same generator draws)."""
    _, _, port, z, mask, cond, spk = pair
    out = [tdiff.sample(port, f"{sampler}:cs{k}", *_t(z, mask, cond, spk), 6,
                        generator=torch.Generator().manual_seed(5)) for k in (1, 4)]
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)


class _Oracle(nn.Module):
    """A score whose guidance delta is constant in eps space (the JAX
    package's tests/test_cfg_cache.py oracle): the cond- and spk-dependent
    terms scale as 1/std(t), so the strided sampler must reproduce stride 1
    to float tolerance. Records each call's batch rows."""

    beta_min, beta_max = 0.05, 20.0

    def __init__(self, f, s, seed=0):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.text_uncon = nn.Parameter(torch.from_numpy(rng.standard_normal(f).astype(np.float32)))
        self.spk_uncon = nn.Parameter(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
        self.rows = []

    def forward(self, xt, mask, cond, t, spk):
        self.rows.append(xt.shape[0])
        _, std = tsched.forward_diffusion_coefficients(t[:, None, None], self.beta_min,
                                                       self.beta_max)
        return (-0.1 * xt + (cond + spk.sum(-1)[:, None, None]) / std) * mask[:, :, None]


@pytest.mark.parametrize("n,stride", [(8, 2), (7, 2), (7, 3), (8, 3), (4, 8)])
@pytest.mark.parametrize("sampler", ["ddpm", "dpm2"])
def test_strided_exact_on_constant_delta_and_its_calls(pair, sampler, n, stride):
    """On the oracle the strided sampler equals stride 1 (2e-4, the JAX
    test's bound), and its calls are 3B rows on each group's first step and
    on the trailing n % k steps, B rows otherwise (stride clamped to n)."""
    _, _, _, z, mask, cond, spk = pair
    b = z.shape[0]
    outs, calls = [], []
    for k in (1, stride):
        model = _Oracle(z.shape[2], spk.shape[1])
        outs.append(tdiff.sample(model, f"{sampler}:cs{k}", *_t(z, mask, cond, spk), n,
                                 text_gradient_scale=1.0, spk_gradient_scale=1.0,
                                 generator=torch.Generator().manual_seed(2)))
        calls.append(model.rows)
    torch.testing.assert_close(outs[1], outs[0], rtol=2e-4, atol=2e-4)
    k = min(stride, n)
    grouped = (n // k) * k
    assert calls[0] == [3 * b] * n
    assert calls[1] == [3 * b if (i % k == 0 or i >= grouped) else b for i in range(n)]
