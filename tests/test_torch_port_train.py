"""STEP1 training in the port against the JAX package on the CPU: MAS (bit
for bit), the four loss functions and random_replace_rows, step1_loss and
its alignment, three train steps against `make_step1_train_step`, the data
pipeline, the preprocessors, `init_params` against flax's `init`, the
checkpoints, resume and the SIGTERM path of the loop, the duration
predictor's detached input, `cli train-step1` from wavs to a checkpoint
that `cli inference` serves, and an overfit run.

The JAX PRNG streams cannot be reproduced in torch, so the port is fed
JAX's draws, derived from the key JAX's step1_loss splits (setup's `draws`):
the replaced rows' permutation, the dropout masks (captured by wrapping
flax's nn.Dropout with nn.intercept_methods on a forward call with the same
key: the mask is `out != 0`; where the input is zero the mask does not
matter), the crop's u and the diffusion t and z. The modules are those of
tests/test_train_steps.py (text encoder 16 channels, decoder dim 8, mults
(1, 2)), in f32."""

import json
import os
import signal
import sys
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests._torch_port import randomize
from unitspeech_tpu import text as jtext
from unitspeech_tpu.data import dataset as jdata
from unitspeech_tpu.models.diffusion import UnitSpeech as JUnitSpeech
from unitspeech_tpu.models.duration import DurationPredictor as JDurationPredictor
from unitspeech_tpu.models.encoder import Encoder as JEncoder
from unitspeech_tpu.ops.mas import maximum_path as jmaximum_path
from unitspeech_tpu.ops.masking import sequence_mask as jsequence_mask
from unitspeech_tpu.preprocess import stats as jstats
from unitspeech_tpu.train import steps as jsteps
from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch import text as ttext
from unitspeech_tpu_torch.config import load_json
from unitspeech_tpu_torch.data import dataset as tdata
from unitspeech_tpu_torch.infer.tts import TTSModels
from unitspeech_tpu_torch.models.diffusion import UnitSpeech
from unitspeech_tpu_torch.models.duration import DurationPredictor
from unitspeech_tpu_torch.models.encoder import Encoder
from unitspeech_tpu_torch.models.layers import Dropout
from unitspeech_tpu_torch.ops.mas import maximum_path, maximum_path_plain
from unitspeech_tpu_torch.preprocess import stats as tstats
from unitspeech_tpu_torch.tools import synthetic_corpus
from unitspeech_tpu_torch.train import steps as tsteps
from unitspeech_tpu_torch.train.loop import TrainLoop
from unitspeech_tpu_torch.utils import checkpoint as tckpt
from unitspeech_tpu_torch.utils.params import init_params, params_from_jax

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

N_FEATS, SPK, B, TX, TY, SEG, LR = 16, 8, 4, 8, 24, 16, 1e-3
TE = dict(n_vocab=40, n_feats=N_FEATS, n_channels=16, filter_channels=32, n_heads=2,
          n_layers=1, kernel_size=3, p_dropout=0.1, window_size=4)
DP = dict(in_channels=16, filter_channels=16, spk_emb_dim=SPK)
DEC = dict(n_feats=N_FEATS, dim=8, dim_mults=(1, 2), groups=4, spk_emb_dim=SPK)
MODULES = ("text_encoder", "duration_predictor", "decoder")
# the tiny configuration of `cli train-step1` on the CPU: 1.6 kHz audio, 100
# mel frames a second, 100-frame segments
TINY_TRAIN = dict(
    data=dict(n_feats=16, n_fft=64, hop_length=16, win_length=64, sampling_rate=1600,
              mel_fmax=800.0),
    text_encoder=dict(n_vocab=180, n_feats=16, n_channels=16, filter_channels=32, n_layers=1,
                      n_heads=2),
    duration_predictor=dict(in_channels=16, filter_channels=16, spk_emb_dim=8),
    decoder=dict(DEC, dim_mults=[1, 2]),
    vocoder=dict(num_mels=16, upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
                 upsample_initial_channel=16, resblock_kernel_sizes=[3],
                 resblock_dilation_sizes=[[1, 3]], sampling_rate=1600),
    train=dict(out_size_second=1, batch_size=4, save_every=1, learning_rate=1e-3),
)
# XLA's backend optimization off for the JAX side's two large compiles (the
# modules' init, the train step): 6 and 8 s instead of 13 and 14 on this CPU
O0 = {"compiler_options": {"xla_backend_optimization_level": 0}}
WORDS = ("ðə", "kwɪk", "bɹaʊn", "fɑks", "dʒʌmpt", "oʊvɚ", "leɪzi", "dɑɡ")


def _texts(n, seed=0, lo=1, hi=3):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, int(rng.integers(lo, hi)))) + "." for _ in range(n)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's tiny modules on one CPU thread: their many small ops run
    about twice as fast as on eight (the caller's count is restored). The
    train loop's TensorBoard writer, made only when tensorboardX imports,
    is left out, as on a machine without it (its import takes 4 s here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorboardX", None)
        yield
    torch.set_num_threads(n)


# --- the modules and JAX's draws -------------------------------------------


def _masked(module, params, *args, key, **kwargs):
    """One forward with dropout key `key`, and the mask of every flax
    nn.Dropout call in it (rate > 0), in call order: `out != 0`."""
    masks = []

    def interceptor(next_fun, args_, kwargs_, context):
        out = next_fun(*args_, **kwargs_)
        if isinstance(context.module, fnn.Dropout) and context.module.rate > 0:
            masks.append(out != 0)
        return out

    with fnn.intercept_methods(interceptor):
        out = module.apply(params, *args, deterministic=False, rngs={"dropout": key}, **kwargs)
    return masks, out


@pytest.fixture(scope="module")
def setup():
    """The JAX modules, their `init` trees, the parameters the tests train
    (redrawn so that no branch is zero; small rezero gates), one batch, and
    the jitted forwards that capture the dropout masks."""
    te, dp, dec = JEncoder(**TE), JDurationPredictor(**DP), JUnitSpeech(**DEC)

    def init_all(key):
        k1, k2, k3 = jax.random.split(key, 3)
        return {"text_encoder": te.init(k1, jnp.zeros((1, 6), jnp.int32), jnp.array([6])),
                "duration_predictor": dp.init(k2, jnp.zeros((1, 6, 16)), jnp.ones((1, 6, 1)),
                                              g=jnp.zeros((1, SPK)), reverse=True),
                "decoder": dec.init(k3, jnp.zeros((1, 8, N_FEATS)), jnp.ones((1, 8)),
                                    jnp.zeros((1, 8, N_FEATS)), jnp.zeros((1,)),
                                    jnp.zeros((1, SPK)))}

    key = jax.random.PRNGKey(0)
    init = jax.jit(init_all).lower(key).compile(**O0)(key)
    params = {k: randomize(v, i + 1) for i, (k, v) in enumerate(init.items())}
    params["decoder"] = jax.tree_util.tree_map_with_path(
        lambda p, x: x * 0.1 if str(getattr(p[-1], "key", "")) == "g" else x, params["decoder"])
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(1, 40, (B, TX)).astype(np.int32),
             "token_lengths": np.array([TX, TX - 2, TX - 1, TX - 3], np.int32),
             "mel": rng.uniform(-1, 1, (B, TY, N_FEATS)).astype(np.float32),
             "mel_lengths": np.array([TY, 20, 22, 17], np.int32),
             "spk_emb": rng.standard_normal((B, SPK)).astype(np.float32)}

    def draws(p, bt, key):
        """JAX step1_loss's draws from `key` (its split order), and its
        alignment: MAS on its text encoder's output under that dropout."""
        k_cfg, k_te, k_dp, k_crop, k_diff = jax.random.split(key, 5)
        key_t, key_z = jax.random.split(k_diff)
        te_masks, (mu_x, hidden, x_mask) = _masked(te, p["text_encoder"], bt["tokens"],
                                                   bt["token_lengths"], key=k_te)
        dp_masks, _ = _masked(dp, p["duration_predictor"], hidden, x_mask, g=bt["spk_emb"],
                              reverse=True, key=k_dp)
        y_mask = jsequence_mask(bt["mel_lengths"], TY, dtype=x_mask.dtype)
        attn = jmaximum_path(jsteps.gaussian_log_prior(mu_x, bt["mel"], x_mask, y_mask),
                             x_mask * y_mask[:, None, :])
        return {"perm": jax.random.permutation(k_cfg, B), "te": te_masks, "dp": dp_masks,
                "u": jax.random.uniform(k_crop, (B,)), "t": jax.random.uniform(key_t, (B,)),
                "z": jax.random.normal(key_z, (B, SEG, N_FEATS)), "attn": attn}

    return {"mods": (te, dp, dec), "init": jax.device_get(init),
            "params": jax.device_get(params), "batch": batch, "draws": draws,
            "spk_uncond": rng.standard_normal(SPK).astype(np.float32)}


def _port_modules(params):
    mods = {"text_encoder": Encoder(**TE), "duration_predictor": DurationPredictor(**DP),
            "decoder": UnitSpeech(**DEC)}
    for k, m in mods.items():
        m.load_state_dict(params_from_jax(jax.device_get(params[k])))
    return mods


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() if v.dtype.kind == "i"
            else torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _torch_draws(d):
    """JAX's draws (setup's `draws`) as the port's `draws`, with JAX's
    alignment under them ("attn")."""
    d = jax.device_get(d)
    out = {k: torch.from_numpy(np.array(v)) for k, v in d.items() if k not in ("te", "dp")}
    out["perm"] = out["perm"].long()
    return {**out, "te": [torch.from_numpy(np.array(m)) for m in d["te"]],
            "dp": [torch.from_numpy(np.array(m)) for m in d["dp"]]}


# --- MAS ------------------------------------------------------------------


def _mas_case(kind):
    rng = np.random.default_rng({"random": 1, "ties": 2, "lengths": 3}[kind])
    b, tx, ty = 5, 9, 31
    if kind == "ties":  # integers: equal stay / advance values everywhere
        lp = rng.integers(-2, 1, (b, tx, ty)).astype(np.float32)
        xl, yl = [tx] * b, [ty] * b
    else:
        lp = (rng.standard_normal((b, tx, ty)) * 3).astype(np.float32)
        xl, yl = ([tx] * b, [ty] * b) if kind == "random" else ([9, 4, 1, 7, 6], [31, 12, 5, 3, 20])
    mask = ((np.arange(tx)[None, :, None] < np.asarray(xl)[:, None, None])
            & (np.arange(ty)[None, None, :] < np.asarray(yl)[:, None, None])).astype(np.float32)
    return lp, mask


@pytest.mark.parametrize("kind", ["random", "ties", "lengths"])
def test_maximum_path_matches_jax_bit_for_bit(kind):
    """maximum_path_plain (and the CPU route of maximum_path) equal JAX's
    maximum_path exactly: random log-priors, integer ones (ties at every
    cell, the Cython tie rule), and varied lengths (a frame count below the
    token count and single-token rows included)."""
    lp, mask = _mas_case(kind)
    want = np.asarray(jax.jit(jmaximum_path)(jnp.asarray(lp), jnp.asarray(mask)))
    got = maximum_path_plain(torch.from_numpy(lp), torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(maximum_path(torch.from_numpy(lp), torch.from_numpy(mask))
                                  .numpy(), want)
    assert want.sum() > 0


# --- the loss functions ---------------------------------------------------


@pytest.mark.parametrize("fn", ["gaussian_log_prior", "duration_loss", "prior_loss_fn",
                                "random_replace_rows"])
def test_loss_functions_match_jax(fn):
    """Each function on the same inputs within 1e-6 relative of JAX's;
    random_replace_rows with JAX's permutation injected replaces exactly
    JAX's floor(B * rate) rows."""
    rng = np.random.default_rng(4)
    mu_x = rng.standard_normal((B, TX, N_FEATS)).astype(np.float32)
    y = rng.standard_normal((B, TY, N_FEATS)).astype(np.float32)
    x_mask = np.ones((B, TX, 1), np.float32)
    y_mask = np.asarray(jsequence_mask(jnp.array([TY, 20, 22, 17]), TY))
    t = torch.from_numpy
    if fn == "gaussian_log_prior":
        want = jsteps.gaussian_log_prior(jnp.asarray(mu_x), jnp.asarray(y), x_mask, y_mask)
        got = tsteps.gaussian_log_prior(t(mu_x), t(y))
    elif fn == "duration_loss":
        logw, logw_ = mu_x[..., 0], y[:, :TX, 0]
        lens = np.array([8, 6, 7, 5], np.int32)
        want = jsteps.duration_loss(jnp.asarray(logw), jnp.asarray(logw_), jnp.asarray(lens))
        got = tsteps.duration_loss(t(logw), t(logw_), t(lens).long())
    elif fn == "prior_loss_fn":
        mu_y = rng.standard_normal(y.shape).astype(np.float32)
        want = jsteps.prior_loss_fn(jnp.asarray(y), jnp.asarray(mu_y), jnp.asarray(y_mask),
                                    N_FEATS)
        got = tsteps.prior_loss_fn(t(y), t(mu_y), t(y_mask), N_FEATS)
    else:
        x = rng.standard_normal((8, SPK)).astype(np.float32)
        rep = rng.standard_normal(SPK).astype(np.float32)
        key = jax.random.PRNGKey(7)
        want = jsteps.random_replace_rows(jnp.asarray(x), jnp.asarray(rep), 0.25, key)
        perm = t(np.asarray(jax.random.permutation(key, 8))).long()
        got = tsteps.random_replace_rows(t(x), t(rep), 0.25, perm=perm)
        assert int((np.asarray(want) == rep).all(axis=1).sum()) == 2
        gen = torch.Generator().manual_seed(0)
        drawn = tsteps.random_replace_rows(t(x), t(rep), 0.25, gen)
        assert int((drawn.numpy() == rep).all(axis=1).sum()) == 2  # exact count
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_dropout_draws():
    """layers.Dropout: flax's arithmetic (kept / (1 - p), others 0) with an
    injected mask; from a generator, the same seed gives the same masks and
    about 1 - p kept; p = 0 returns its input and takes no mask."""
    x = torch.randn(64, 32)
    m = torch.rand(64, 32) < 0.9
    got = Dropout(masks=[m])(x, 0.1)
    np.testing.assert_array_equal(got.numpy(), np.where(m.numpy(), x.numpy() / np.float32(0.9),
                                                        0.0).astype(np.float32))
    a = Dropout(torch.Generator().manual_seed(3))
    b = Dropout(torch.Generator().manual_seed(3))
    assert torch.equal(a(x, 0.5), b(x, 0.5)) and abs((a(x, 0.5) != 0).float().mean() - 0.5) < 0.05
    d = Dropout(masks=[])
    assert d(x, 0.0) is x and d.calls == 0


# --- step1_loss and the train step ----------------------------------------


def test_step1_loss_matches_jax(setup, jax_steps):
    """step1_loss in f32 with JAX's draws (its first train step's key):
    the total and each part within 1e-5 relative of the losses JAX's step
    reports, and the alignment equal to JAX's MAS on JAX's own encoder
    output under the same dropout."""
    s = setup
    draws, want, _ = jax_steps
    draws = draws[0]
    assert len(draws["te"]) == 3 + 4 and len(draws["dp"]) == 2  # prenet 3, a layer's 4
    mods = _port_modules(s["params"])
    total, parts, attn = tsteps.step1_loss(*mods.values(), _torch_batch(s["batch"]), SEG,
                                           torch.from_numpy(s["spk_uncond"]), draws=draws)
    np.testing.assert_array_equal(attn.numpy(), draws["attn"].numpy())
    np.testing.assert_allclose(total.item(), want[0]["total_loss"], rtol=1e-5)
    for k, v in parts.items():
        np.testing.assert_allclose(v.item(), want[0][k], rtol=1e-5, err_msg=k)


def test_duration_loss_does_not_reach_the_text_encoder(setup, jax_steps):
    """The duration predictor detaches its input (JAX stops its gradient):
    after step1_loss(...).backward() the text encoder's gradient equals
    the gradient of prior_loss + diff_loss alone, and the duration loss
    alone gives it none, while it does reach the duration predictor."""
    s = setup
    draws = jax_steps[0][0]

    def grads(which):
        mods = _port_modules(s["params"])
        total, parts, _ = tsteps.step1_loss(*mods.values(), _torch_batch(s["batch"]), SEG,
                                            torch.from_numpy(s["spk_uncond"]), draws=draws)
        loss = {"total": total, "prior_diff": parts["prior_loss"] + parts["diff_loss"],
                "dur": parts["dur_loss"]}[which]
        loss.backward()
        return ({k: p.grad for k, p in mods["text_encoder"].named_parameters()},
                [p.grad for p in mods["duration_predictor"].parameters()])

    total, _ = grads("total")
    prior_diff, _ = grads("prior_diff")
    dur_te, dur_dp = grads("dur")
    for k in total:
        np.testing.assert_allclose(total[k].numpy(), prior_diff[k].numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    assert all(g is None for g in dur_te.values())
    assert all(g is not None and g.abs().sum() > 0 for g in dur_dp)


@pytest.fixture(scope="module")
def jax_steps(setup):
    """Three STEP1 steps of JAX's make_step1_train_step (Adam at LR, the
    5 / 5 / 2 clipping), each with its draws (taken at the parameters
    before it, in the same compiled program) and its metrics; the
    parameters after them."""
    s = setup
    te, dp, dec = s["mods"]
    opt = optax.adam(LR)
    step = jsteps.make_step1_train_step(te, dp, dec, opt, out_size=SEG,
                                        spk_uncond=jnp.asarray(s["spk_uncond"]))
    params = jax.tree_util.tree_map(jnp.asarray, s["params"])
    state = jsteps.TrainState(params, opt.init(params), jnp.array(0))
    jb = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    run = jax.jit(lambda st, b, k: (s["draws"](st.params, b, k), step(st, b, k)))
    run = run.lower(state, jb, jax.random.PRNGKey(0)).compile(**O0)
    draws, metrics = [], []
    for i in range(3):
        d, (state, m) = run(state, jb, jax.random.fold_in(jax.random.PRNGKey(30), i))
        draws.append(_torch_draws(d))
        metrics.append({k: float(v) for k, v in m.items()})
    return draws, metrics, jax.device_get(state.params)


def test_three_train_steps_match_jax(setup, jax_steps):
    """Three steps of make_step1_train_step with JAX's draws: each step's
    losses within 1e-5 and its three pre-clip gradient norms within 1e-4
    relative of JAX's (every module clipped: norms above 5 / 5 / 2 or not,
    both sides agree); after the three steps each parameter within
    2e-3 * lr * steps (one part in 500 of the most Adam moves it) plus one
    f32 rounding of its value. Adam moves an entry by about lr a step
    whatever the size of its gradient, so an entry whose first-step
    gradient is below 1e-3 of its module's RMS gradient (rounding level,
    its sign a coin toss between the two packages: the attention's key
    biases, whose exact gradient is zero, are such) is held to 2 * lr *
    steps, the most Adam can move it; the decoder's unconditional
    embeddings get no gradient and stay where they were."""
    s = setup
    draws, want_metrics, want_params = jax_steps
    mods = _port_modules(s["params"])
    opt = torch.optim.Adam([p for m in mods.values() for p in m.parameters()], lr=LR,
                           betas=(0.9, 0.999), eps=1e-8)
    step = tsteps.make_step1_train_step(*mods.values(), opt, SEG,
                                        torch.from_numpy(s["spk_uncond"]))
    batch = _torch_batch(s["batch"])
    for i in range(3):
        got = step(batch, draws=draws[i])
        for k, v in want_metrics[i].items():
            tol = 1e-4 if k.startswith("grad_norm") else 1e-5
            np.testing.assert_allclose(got[k].item(), v, rtol=tol, err_msg=f"step {i} {k}")

    first = _port_modules(s["params"])
    tsteps.step1_loss(*first.values(), batch, SEG, torch.from_numpy(s["spk_uncond"]),
                      draws=draws[0])[0].backward()
    bound = 2e-3 * LR * 3
    for name in MODULES:
        want = params_from_jax(want_params[name])
        base = params_from_jax(s["params"][name])
        grads = dict(first[name].named_parameters())
        rms = np.sqrt(np.mean(np.concatenate([g.grad.numpy().ravel() for g in grads.values()
                                              if g.grad is not None]) ** 2))
        for k, p in mods[name].named_parameters():
            g, w = p.detach().numpy(), want[k].numpy()
            tol = np.full(g.shape, bound) + np.spacing(np.abs(w))
            if grads[k].grad is None:
                np.testing.assert_array_equal(g, base[k].numpy(), err_msg=k)
                continue
            gg = grads[k].grad.numpy()
            tol[np.abs(gg) < 1e-3 * rms] = 2 * LR * 3
            assert np.all(np.abs(g - w) <= tol), (name, k, np.abs(g - w).max())
    assert opt.state_dict()["state"][0]["step"].item() == 3


# --- init_params ------------------------------------------------------------


def test_init_params_matches_flax_init(setup):
    """init_params against the JAX modules' `init` trees (the modules of
    this file), through params_from_jax: the same keys and shapes; every
    tensor flax makes zeros or ones exactly so; every random tensor's mean
    and standard deviation within six standard errors of the flax draw's,
    and its largest magnitude within the initializer's support (truncated
    normals within 2 std / 0.8796, uniforms within their limit)."""
    from unitspeech_tpu_torch.config import (
        DecoderConfig,
        DurationPredictorConfig,
        EncoderConfig,
        MainConfig,
    )

    cfg = MainConfig(text_encoder=EncoderConfig(**{k: v for k, v in TE.items()
                                                   if k != "window_size"}),
                     duration_predictor=DurationPredictorConfig(**DP),
                     decoder=DecoderConfig(**DEC))
    want = setup["init"]
    got = init_params(cfg, torch.Generator().manual_seed(0))
    n_random = 0
    for name in MODULES:
        w = params_from_jax(jax.device_get(want[name]))
        assert set(got[name]) == set(w), name
        for k, v in w.items():
            g, v = got[name][k].numpy(), v.numpy()
            assert g.shape == v.shape and g.dtype == np.float32, k
            if not v.any() or (v == 1).all():
                np.testing.assert_array_equal(g, v, err_msg=k)
                continue
            n_random += 1
            n, sd = v.size, v.std()
            assert abs(g.mean() - v.mean()) <= 6 * sd * np.sqrt(2 / n), k
            assert abs(g.std() - sd) <= 6 * sd * np.sqrt(1 / n), k
            leaf = k.rsplit(".", 2)
            if leaf[-1] == "kernel" and leaf[-2] in ("conv_q", "conv_k", "conv_v"):
                limit = np.sqrt(6 / (v.shape[0] + v.shape[1]))
                assert np.abs(g).max() <= limit and np.abs(v).max() <= limit, k
            elif leaf[-1] == "kernel":
                cap = 2 * np.sqrt(1 / np.prod(v.shape[:-1])) / 0.87962566103423978
                assert np.abs(g).max() <= cap * (1 + 1e-6) and np.abs(v).max() <= cap * 1.001, k
    assert n_random > 25


# --- data and preprocessing -------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    (d / "tiny.json").write_text(json.dumps(TINY_TRAIN))
    cfg = load_json(str(d / "tiny.json"))
    out = synthetic_corpus(str(d), cfg, _texts(8), n_speakers=3, seconds=(0.5, 1.2), seed=2)
    return {**out, "dir": d, "config": str(d / "tiny.json"), "cfg": cfg}


def test_dataset_collator_and_batches_match_jax(corpus):
    """parse_filelist, TextMelSpeakerDataset (IDs from the port's text
    frontend, cached), BucketCollator (the buckets, fix_len_compatibility
    at one downsampling, padded wavs) and two epochs of iterate_batches
    from one numpy generator: every array equal to JAX's."""
    fl = corpus["filelist"]
    assert tdata.parse_filelist(fl) == jdata.parse_filelist(fl)
    jds = jdata.TextMelSpeakerDataset(jdata.parse_filelist(fl), jtext.phonemes_to_sequence,
                                      hop_length=16, sampling_rate=1600)
    tds = tdata.TextMelSpeakerDataset(tdata.parse_filelist(fl), ttext.phonemes_to_sequence,
                                      hop_length=16, sampling_rate=1600)
    assert len(tds) == len(jds) == 8
    jcol, tcol = jdata.BucketCollator(16, 1), tdata.BucketCollator(16, 1)
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    n = 0
    for _ in range(2):
        for jb, tb in zip(jdata.iterate_batches(jds, jcol, 4, key=jrng),
                          tdata.iterate_batches(tds, tcol, 4, key=trng), strict=True):
            assert set(jb) == set(tb)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
                assert tb[k].dtype == jb[k].dtype, k
            n += 1
    assert n == 4 and tds._token_cache.keys() == set(range(8))
    with pytest.raises(ValueError, match="1600"):
        tdata.TextMelSpeakerDataset(tdata.parse_filelist(fl), ttext.phonemes_to_sequence,
                                    sampling_rate=22050)[0]


def test_preprocess_matches_jax(corpus):
    """compute_mel_stats, compute_uncond_mel and compute_uncond_spk on the
    corpus (max_files 5) within 1e-5 of JAX's (the mels in f32 on both
    sides)."""
    d, cfg, fl = corpus["dir"], corpus["cfg"], [corpus["filelist"]]
    from unitspeech_tpu.config import load_json as jload

    jcfg = jload(corpus["config"])
    want = jstats.compute_mel_stats(fl, jcfg.data, str(d / "jm.npz"), max_files=5)
    got = tstats.compute_mel_stats(fl, cfg.data, str(d / "tm.npz"), max_files=5)
    for k in ("mel_min", "mel_max"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(np.load(str(d / "tm.npz"))[k], got[k])
    want_u = jstats.compute_uncond_mel(fl, jcfg.data, want["mel_min"], want["mel_max"],
                                       max_files=5)
    got_u = tstats.compute_uncond_mel(fl, cfg.data, want["mel_min"], want["mel_max"],
                                      max_files=5)
    np.testing.assert_allclose(got_u, want_u, rtol=1e-5, atol=1e-5)
    embs = dict(np.load(corpus["spk_embs"]))
    np.testing.assert_allclose(tstats.compute_uncond_spk(embs), jstats.compute_uncond_spk(embs),
                               rtol=1e-6)


# --- checkpoints and the loop ---------------------------------------------


def test_checkpoint_save_prune_latest_and_load(tmp_path):
    """save_checkpoint writes step_<n> atomically (no temporary file left),
    keeps the newest `keep`; latest_checkpoint picks the highest n and
    ignores other names; load_checkpoint gives the tree back on the CPU."""
    d = str(tmp_path / "ck")
    assert tckpt.latest_checkpoint(d) is None
    for n in (1, 2, 10, 3):
        tckpt.save_checkpoint(d, n, {"w": torch.full((3,), float(n)), "step": n, "x": [n, "a"]},
                              keep=3)
    (tmp_path / "ck" / "step_99.tmp.1").write_text("partial")
    (tmp_path / "ck" / "notes").write_text("")
    names = sorted(os.listdir(d))
    assert [x for x in names if x.startswith("step_") and "." not in x] == \
        ["step_10", "step_2", "step_3"]
    latest = tckpt.latest_checkpoint(d)
    assert tckpt.checkpoint_step(latest) == 10 and tckpt.checkpoint_step("/x/other") == -1
    tree = tckpt.load_checkpoint(latest)
    assert tree["step"] == 10 and tree["x"] == [10, "a"] and torch.equal(tree["w"],
                                                                          torch.full((3,), 10.0))


def _loop(corpus, ckdir, seed=0, **kw):
    """A TrainLoop of the tiny configuration on the CPU from init_params."""
    cfg = corpus["cfg"]
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    mods = {"text_encoder": Encoder.from_config(cfg.text_encoder),
            "duration_predictor": DurationPredictor.from_config(cfg.duration_predictor),
            "decoder": UnitSpeech.from_config(cfg.decoder)}
    for k, m in mods.items():
        m.load_state_dict(params[k])
    opt = torch.optim.Adam([p for m in mods.values() for p in m.parameters()],
                           lr=cfg.train.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    step = tsteps.make_step1_train_step(*mods.values(), opt, cfg.out_size,
                                        torch.zeros(cfg.decoder.spk_emb_dim))
    ds = tdata.TextMelSpeakerDataset(tdata.parse_filelist(corpus["filelist"]),
                                     ttext.phonemes_to_sequence, 16, 1600)
    mel = tstats.compute_mel_stats([corpus["filelist"]], cfg.data, str(corpus["dir"] / "m.npz"))
    from unitspeech_tpu_torch.utils.artifacts import load_speaker_embs

    return TrainLoop(cfg=cfg, train_step=step, modules=mods, optimizer=opt, dataset=ds,
                     collator=tdata.BucketCollator(16, 1),
                     mel_min=torch.from_numpy(mel["mel_min"]),
                     mel_max=torch.from_numpy(mel["mel_max"]),
                     spk_embs=load_speaker_embs(corpus["spk_embs"]), log_dir=str(ckdir / "log"),
                     checkpoint_dir=str(ckdir / "ck"), save_every=1, device="cpu", **kw)


def test_resume_restores_parameters_adam_state_and_step(corpus, tmp_path):
    """Two epochs (2 steps each, save_every 1), then a fresh loop from
    other weights resumes: epoch 2, step 4, every parameter and Adam
    moment equal to the saved ones; its next epoch runs from there and
    writes step_3; train.log holds one summary line an epoch."""
    first = _loop(corpus, tmp_path)
    assert first.run(2) == 4
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_1", "step_2"]
    again = _loop(corpus, tmp_path, seed=5)
    assert again.resume() == 2 and again.step == 4
    for k, m in first.modules.items():
        for (n, a), b in zip(m.state_dict().items(), again.modules[k].state_dict().values()):
            assert torch.equal(a, b), (k, n)
    sa, sb = first.optimizer.state_dict()["state"], again.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys() and len(sa) > 100
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert again.run(3, 2) == 6 and tckpt.latest_checkpoint(str(tmp_path / "ck")).endswith(
        "step_3")
    lines = (tmp_path / "log" / "train.log").read_text().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["Epoch 0", "Epoch 1", "Epoch 2"]
    assert all(np.isfinite(float(p.rsplit(": ", 1)[1])) for ln in lines for p in ln.split(" | "))


def test_sigterm_checkpoints_at_the_next_step_boundary(corpus, tmp_path):
    """SIGTERM raised (signal.raise_signal, no thread) from the step hook
    of step 2: the loop saves step_1 (epoch 0 + 1) holding step 2 and
    returns; the previous SIGTERM handler is back afterwards."""
    assert threading.current_thread() is threading.main_thread()
    seen = []

    def hook(step, metrics):
        seen.append(step)
        if step == 2:
            signal.raise_signal(signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    loop = _loop(corpus, tmp_path, step_hook=hook)
    assert loop.run(5) == 2 and seen == [1, 2]
    assert os.listdir(tmp_path / "ck") == ["step_1"]
    tree = tckpt.load_checkpoint(str(tmp_path / "ck" / "step_1"))
    assert tree["step"] == 2 and tree["epoch"] == 1 and set(MODULES) <= set(tree)
    assert signal.getsignal(signal.SIGTERM) == before


# --- the CLI ----------------------------------------------------------------


def test_cli_train_step1_then_inference(corpus, tmp_path):
    """`cli preprocess-mel-stats`, `preprocess-uncond`, `train-step1` for
    one epoch on the CPU (the decoder's unconditional embeddings from
    --uncond-stats, flax's initializers elsewhere), its checkpoint served by
    `cli inference --checkpoint ... --vocoder ... --spk-emb`; without
    --spk-emb, and through TTSModels.from_checkpoint, it is refused with
    a message that names the missing voice."""
    cfgp, fl = corpus["config"], corpus["filelist"]
    ms, un = str(tmp_path / "ms.npz"), str(tmp_path / "un.npz")
    cli.main(["preprocess-mel-stats", "--filelist", fl, "--out", ms, "--config", cfgp,
              "--device", "cpu"])
    cli.main(["preprocess-uncond", "--filelist", fl, "--mel-stats", ms, "--spk-embs",
              corpus["spk_embs"], "--out", un, "--config", cfgp, "--device", "cpu"])
    res = cli.main_train_step1(["--filelist", fl, "--spk-embs", corpus["spk_embs"],
                                "--mel-stats", ms, "--uncond-stats", un, "--config", cfgp,
                                "--device", "cpu", "--n-epochs", "1", "--checkpoint-dir",
                                str(tmp_path / "ck"), "--log-dir", str(tmp_path / "log")])
    assert res["steps"] == 2 and res["checkpoint"].endswith("step_1")
    assert all(np.isfinite(v) for m in res["metrics"] for v in m.values())
    ck = torch.load(res["checkpoint"], weights_only=True)
    uz = np.load(un)
    np.testing.assert_array_equal(ck["decoder"]["text_uncon"].numpy(), uz["text_uncond"])
    assert ck["epoch"] == 1 and ck["step"] == 2 and "opt_state" in ck and "spk_emb" not in ck

    rand = str(tmp_path / "rand.pt")
    cli.main_make_random_checkpoint(["--config", cfgp, "--output", rand])
    spk = str(tmp_path / "spk.npy")
    np.save(spk, np.load(corpus["spk_embs"])["1"])
    args = ["--ipa", "--text", corpus["texts"][0], "--checkpoint", res["checkpoint"],
            "--output", str(tmp_path / "o.wav"), "--device", "cpu", "--diffusion-steps", "2"]
    with pytest.raises(SystemExit, match="vocoder"):
        cli.main_inference(args)
    with pytest.raises(SystemExit, match="spk_emb; pass --spk-emb"):
        cli.main_inference(args + ["--vocoder", rand])
    stats = cli.main_inference(args + ["--vocoder", rand, "--spk-emb", spk])
    assert stats["frames"] > 0 and stats["kernels"]
    with pytest.raises(ValueError, match="spk_emb"):
        TTSModels.from_checkpoint(ck, device="cpu")


# --- overfitting a tiny corpus ----------------------------------------------


def _diagonal_spread(attn, x_len, y_len):
    """Mean over the batch of the mean |x / t_x - y / t_y| along each path."""
    out = []
    for a, tx, ty in zip(attn, x_len, y_len):
        xs, ys = np.nonzero(a[:tx, :ty])
        out.append(np.mean(np.abs((xs + 0.5) / tx - (ys + 0.5) / ty)))
    return float(np.mean(out))


def test_overfit_tiny_corpus(corpus):
    """Twenty STEP1 steps at lr 1e-3 on four utterances, one batch a step,
    fixed seed: the duration, prior and diffusion losses each drop (the
    mean of the last 10 steps below that of the first 10), and MAS
    concentrates near the diagonal (the path's mean distance from it
    falls)."""
    loop = _loop(corpus, corpus["dir"] / "overfit")
    ds = tdata.TextMelSpeakerDataset(tdata.parse_filelist(corpus["filelist"])[:4],
                                     ttext.phonemes_to_sequence, 16, 1600)
    batch = loop._prepare_batch(tdata.BucketCollator(16, 1)([ds[i] for i in range(4)]))
    gen = torch.Generator().manual_seed(0)
    hist, spread = [], []
    mods = loop.modules
    for i in range(20):
        hist.append({k: v.item() for k, v in loop.train_step(batch, gen).items()})
        if i in (0, 19):  # the alignment of the encoder without dropout
            with torch.no_grad():
                mu_x, _, x_mask = mods["text_encoder"](batch["tokens"], batch["token_lengths"])
                y_mask = (torch.arange(batch["mel"].shape[1])[None] < batch["mel_lengths"][:, None])
                attn = maximum_path(tsteps.gaussian_log_prior(mu_x, batch["mel"]),
                                    x_mask * y_mask[:, None, :].float())
            spread.append(_diagonal_spread(attn.numpy(), batch["token_lengths"].tolist(),
                                           batch["mel_lengths"].tolist()))
    for k in ("dur_loss", "prior_loss", "diff_loss"):
        first, last = (np.mean([h[k] for h in hist[s]]) for s in (slice(0, 10), slice(-10, None)))
        assert last < first, (k, first, last)
    assert spread[1] < spread[0], spread
