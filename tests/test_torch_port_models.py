"""The port's slice modules against their JAX counterparts on the CPU in f32:
Encoder, DurationPredictor, ResnetBlock (early and deep-stage routes), the
tiny GradLogPEstimator2d on both port paths, reverse_diffusion with dual CFG
and injected noise, and BigVGAN.

Parameters come from the JAX `init`, every leaf redrawn from a numpy seed
(zero-initialised leaves such as the rezero gate and the unconditional
embeddings would hide whole branches), then carried across with
params_from_jax. Tolerance: 2e-5 abs / 1e-4 rel per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port import load, randomize, scale_gates
from tests._torch_port import mask as _mask
from unitspeech_tpu.config import DurationPredictorConfig, EncoderConfig, VocoderConfig
from unitspeech_tpu.models import diffusion as jdiff
from unitspeech_tpu.models import duration as jdur
from unitspeech_tpu.models import encoder as jenc
from unitspeech_tpu.models import unet as junet
from unitspeech_tpu.models import vocoder as jvoc
from unitspeech_tpu_torch.models import diffusion as tdiff
from unitspeech_tpu_torch.models import duration as tdur
from unitspeech_tpu_torch.models import encoder as tenc
from unitspeech_tpu_torch.models import unet as tunet
from unitspeech_tpu_torch.models import vocoder as tvoc

ATOL, RTOL = 2e-5, 1e-4


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


def test_encoder_and_duration_predictor():
    cfg = EncoderConfig(n_vocab=40, n_feats=16, n_channels=16, filter_channels=32,
                        n_layers=2, n_heads=2)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 40, size=(2, 11)).astype(np.int32)
    lengths = np.array([11, 7], np.int32)
    jm = jenc.Encoder.from_config(cfg)
    params = randomize(jm.init(jax.random.PRNGKey(0), tokens, lengths), 1)
    want = jm.apply(params, tokens, lengths)
    tm = load(tenc.Encoder.from_config(cfg), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(tokens).long(), torch.from_numpy(lengths))
    for g, w in zip(got, want):
        _close(g.numpy(), w)

    dcfg = DurationPredictorConfig(in_channels=16, filter_channels=24, spk_emb_dim=8)
    jd = jdur.DurationPredictor(in_channels=16, filter_channels=24, spk_emb_dim=8)
    hidden, x_mask = np.array(want[1]), np.array(want[2])
    spk = rng.standard_normal((2, 8)).astype(np.float32)
    dparams = randomize(jd.init(jax.random.PRNGKey(1), hidden, x_mask, g=spk, reverse=True), 2)
    want_logw = jd.apply(dparams, hidden, x_mask, g=spk, reverse=True)
    td = load(tdur.DurationPredictor.from_config(dcfg), dparams)
    with torch.no_grad():
        got_logw = td(*map(torch.from_numpy, (hidden, x_mask, spk)))
    _close(got_logw.numpy(), want_logw)


@pytest.mark.parametrize("cin,cout,f,pre_masked", [
    (4, 8, 16, False),      # early stage, res_conv
    (256, 512, 5, False),   # deep stage (flat rows, taps), res_conv
    (512, 512, 5, True),    # deep stage, identity residual, pre-masked input
])
def test_resnet_block_routes(cin, cout, f, pre_masked):
    """JAX ResnetBlock (XLA or flat route) against the port's block on both
    paths; the port's kernel path runs the K1/K3 plain versions on CPU."""
    rng = np.random.default_rng(cin + cout)
    t, groups, t_dim = 8, 4 if cout < 64 else 8, 12
    lens = [8, 5]
    mask = _mask(t, lens)[:, :, None, None]
    x = rng.standard_normal((2, t, f, cin)).astype(np.float32)
    if pre_masked:
        x = x * mask
    t_emb = rng.standard_normal((2, t_dim)).astype(np.float32)
    jb = junet.ResnetBlock(cout, groups, input_pre_masked=pre_masked)
    params = randomize(jb.init(jax.random.PRNGKey(0), x, mask, t_emb), 3)
    want = np.asarray(jb.apply(params, x, mask, t_emb))
    tb = load(tunet.ResnetBlock(cin, cout, t_dim, groups), params)
    for use_kernels in (False, True):
        with torch.no_grad():
            got = tb(*map(torch.from_numpy, (x, mask, t_emb)), torch.float32, use_kernels,
                     pre_masked=pre_masked)
        # the JAX block leaves the padding of an unmasked identity input alone
        _close(got.numpy() * mask, want * mask, atol=ATOL * 5 if cin >= 256 else ATOL)


TINY_DECODER = dict(n_feats=16, dim=8, dim_mults=(1, 2), groups=4, spk_emb_dim=8)


@pytest.fixture(scope="module")
def tiny_decoder():
    """Stages (F, C) = (16, 8), (8, 16): on the kernel path both run the
    fused ResnetBlock, the output runs the fused final block, and T*F = 1024
    at the first stage reaches the attention kernel's gate. (The deep-stage
    route with row statistics is held in test_resnet_block_routes.)"""
    t = 64
    rng = np.random.default_rng(4)
    jd = jdiff.UnitSpeech(**TINY_DECODER)
    z = np.zeros((1, t, 16), np.float32)
    params = randomize(jd.init(jax.random.PRNGKey(0), z, np.ones((1, t), np.float32), z,
                               np.zeros((1,), np.float32), np.zeros((1, 8), np.float32)), 5)
    # rezero gates 0.03-0.06: each linear attention squares its input, and
    # with larger gates the activations reach ~1e11, where GroupNorm's
    # cancellation turns f32 roundoff into differences of 1e-3
    params = scale_gates(params, 0.1)
    ports = {uk: load(tdiff.UnitSpeech(**TINY_DECODER, use_kernels=uk), params)
             for uk in (False, True)}
    return jd, params, ports, rng


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_estimator_matches_jax(tiny_decoder, kernels):
    """The port's estimator on one path against JAX's on the same routing:
    its XLA twin (use_pallas_*=False) for the plain path; its Pallas
    kernels in interpret mode (use_pallas_resnet, use_pallas_attention) for
    the kernel path, whose CPU tensors take the kernels' plain versions.
    Tolerance: 2e-5 abs per unit of output scale, 1e-4 rel (f32 sums in
    another order, through ~20 normalised layers)."""
    jd, params, ports, rng = tiny_decoder
    t = 64
    x = rng.standard_normal((2, t, 16)).astype(np.float32)
    mu = rng.standard_normal((2, t, 16)).astype(np.float32)
    mask = _mask(t, [64, 45])
    tt = np.array([0.7, 0.2], np.float32)
    spk = rng.standard_normal((2, 8)).astype(np.float32)
    if kernels:
        jd = jdiff.UnitSpeech(**TINY_DECODER, use_pallas_resnet=True, use_pallas_attention=True)
    want = np.asarray(jd.apply(params, x, mask, mu, tt, spk))
    with torch.no_grad():
        got = ports[kernels](*map(torch.from_numpy, (x, mask, mu, tt, spk))).numpy()
    _close(got, want, atol=ATOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("tg,sg", [(1.0, 1.0), (1.5, 0.0), (0.0, 2.0)])
def test_cfg_score_matches_jax(tiny_decoder, tg, sg):
    """Dual classifier-free guidance in one batched estimator call, each
    branch of build_cfg_rows (3 rows, text only, speaker only)."""
    jd, params, ports, rng = tiny_decoder
    t = 32
    xt, cond = (rng.standard_normal((1, t, 16)).astype(np.float32) for _ in range(2))
    mask = _mask(t, [29])
    tt = np.array([0.4], np.float32)
    spk = rng.standard_normal((1, 8)).astype(np.float32)
    want = np.asarray(jdiff.cfg_score(jd.apply, params, xt, mask, cond, tt, spk, tg, sg))
    with torch.no_grad():
        got = tdiff.cfg_score(ports[False], *map(torch.from_numpy, (xt, mask, cond, tt, spk)),
                              tg, sg).numpy()
    _close(got, want, atol=ATOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
def test_reverse_diffusion_dual_cfg_injected_noise(tiny_decoder, kernels):
    """4 DDPM steps with dual CFG 1.0/1.0 and injected noise; rezero gates
    scaled down for a sampler run (tests/_torch_port.scale_gates)."""
    jd, params, _, rng = tiny_decoder
    params = scale_gates(params, 0.03)
    port = load(tdiff.UnitSpeech(**TINY_DECODER, use_kernels=kernels), params)
    t, steps = 32, 4
    z = rng.standard_normal((1, t, 16)).astype(np.float32)
    cond = rng.standard_normal((1, t, 16)).astype(np.float32)
    mask = _mask(t, [27])
    spk = rng.standard_normal((1, 8)).astype(np.float32)
    spk /= np.linalg.norm(spk)
    noises = rng.standard_normal((steps, 1, t, 16)).astype(np.float32)
    want = np.asarray(jdiff.reverse_diffusion(
        jd.apply, params, z, mask, cond, spk, jax.random.PRNGKey(0), n_timesteps=steps,
        text_gradient_scale=1.0, spk_gradient_scale=1.0, noises=jnp.asarray(noises)))
    got = tdiff.reverse_diffusion(
        port, *map(torch.from_numpy, (z, mask, cond, spk)), n_timesteps=steps,
        text_gradient_scale=1.0, spk_gradient_scale=1.0, noises=torch.from_numpy(noises)).numpy()
    assert np.isfinite(want).all()
    # 4 steps multiply the state by up to ~9x a step: tolerance relative to its size
    _close(got, want, atol=RTOL * np.abs(want).max())


def test_bigvgan_matches():
    cfg = VocoderConfig(num_mels=16, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                        upsample_initial_channel=16, resblock_kernel_sizes=(3, 5),
                        resblock_dilation_sizes=((1, 3), (1, 2)))
    rng = np.random.default_rng(6)
    mel = rng.standard_normal((2, 10, 16)).astype(np.float32)
    jv = jvoc.BigVGAN.from_config(cfg)
    params = randomize(jv.init(jax.random.PRNGKey(0), mel), 7)
    want = np.asarray(jv.apply(params, mel))
    tv = load(tvoc.BigVGAN.from_config(cfg), params)
    with torch.no_grad():
        got = tv(torch.from_numpy(mel)).numpy()
    assert got.shape == (2, 40)
    _close(got, want)
