"""BigVGAN's GAN training in the port against the JAX package on the CPU:
the MPD and MRD (outputs and feature maps, a period that does not divide
the length, windows shorter than n_fft), the three losses, one fused GAN
step from the same parameters and segments (both sides' parameters after
it; the generator untouched by the discriminator step; nothing of the
generator's loss in the discriminators' gradients), SegmentSampler's
draws, AdamW with the per-step decay against optax's, the vocoder's flax
initializers, and `cli train-vocoder` with --resume into `cli inference
--vocoder`.

The discriminators of the comparisons are narrow (channel_mult 1/8, two
small STFT resolutions) and the generator tiny; `cli train-vocoder` runs
the full MPD and MRD on 2048-sample segments. Tolerance: 1e-5 relative
plus 1e-6 of the largest magnitude for forwards and losses (f32 sums in
another order), as each test states otherwise."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests._torch_port import randomize
from tests.test_torch_port_train import TINY_TRAIN
from unitspeech_tpu.config import load_json as jload_json
from unitspeech_tpu.models import discriminators as jd
from unitspeech_tpu.models.vocoder import BigVGAN as JBigVGAN
from unitspeech_tpu.train import steps as jsteps
from unitspeech_tpu.train import vocoder_gan as jgan
from unitspeech_tpu.train import vocoder_loop as jloop
from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch.config import load_json
from unitspeech_tpu_torch.models import discriminators as td
from unitspeech_tpu_torch.models.vocoder import BigVGAN
from unitspeech_tpu_torch.train import vocoder_gan as tgan
from unitspeech_tpu_torch.train import vocoder_loop as tloop
from unitspeech_tpu_torch.utils import artifacts
from unitspeech_tpu_torch.utils.params import _flax_init_, init_module, params_from_jax

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

MULT, PERIODS, RES = 0.125, (2, 3), ((128, 20, 64), (64, 10, 40))
LR, SEGMENT, B = 1e-3, 512, 2


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * np.abs(want).max())


def _wavs(seed, b, t):
    rng = np.random.default_rng(seed)
    return (0.5 * np.sin(np.arange(t) * rng.uniform(0.05, 0.3, (b, 1)))
            + 0.1 * rng.standard_normal((b, t))).astype(np.float32)


@pytest.fixture(scope="module")
def discs():
    """The JAX MPD / MRD (narrow), their parameters redrawn from a seed, and
    the port's modules holding them."""
    jmpd = jd.MultiPeriodDiscriminator(PERIODS, channel_mult=MULT)
    jmrd = jd.MultiResolutionDiscriminator(RES, channel_mult=MULT)
    w = jnp.zeros((1, SEGMENT))
    pv = {"mpd": randomize(jmpd.init(jax.random.PRNGKey(1), w, w), 3),
          "mrd": randomize(jmrd.init(jax.random.PRNGKey(2), w, w), 4)}
    mpd = td.MultiPeriodDiscriminator(PERIODS, channel_mult=MULT)
    mrd = td.MultiResolutionDiscriminator(RES, channel_mult=MULT)
    mpd.load_state_dict(params_from_jax(jax.device_get(pv["mpd"])))
    mrd.load_state_dict(params_from_jax(jax.device_get(pv["mrd"])))
    return {"jax": (jmpd, jmrd), "params": jax.device_get(pv), "port": (mpd, mrd)}


@pytest.mark.parametrize("which", ["mpd", "mrd"])
def test_discriminators_match_jax(discs, which):
    """Each discriminator's logits and every feature map (the port's NCHW
    maps as NHWC) for a real and a generated batch of 1001 samples (3 does
    not divide it: the reflect pad) within the tolerance; the flax names
    (p{period}.conv_{i}, r{n_fft}_{hop}.conv_{i}, conv kernels (kh, kw, in,
    out)) load as they are."""
    i = ["mpd", "mrd"].index(which)
    y, y_hat = _wavs(0, 2, 1001), _wavs(1, 2, 1001)
    want = discs["jax"][i].apply(discs["params"][which], jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        got = discs["port"][i](torch.from_numpy(y), torch.from_numpy(y_hat))
    names = [f"p{p}" for p in PERIODS] if which == "mpd" else [f"r{r[0]}_{r[1]}" for r in RES]
    assert sorted({k.split(".")[0] for k in discs["port"][i].state_dict()}) == sorted(names)
    for g_out, w_out in zip(got[:2], want[:2]):
        for g, w in zip(g_out, w_out):
            _close(g.numpy(), w)
    n = 0
    for g_maps, w_maps in zip(got[2:], want[2:]):
        for g_list, w_list in zip(g_maps, w_maps):
            for g, w in zip(g_list, w_list):
                _close(g.permute(0, 2, 3, 1).numpy(), w)
                n += 1
    assert n == 2 * len(names) * 6


def test_losses_match_jax(discs):
    """feature_loss (its x2 inside), discriminator_loss (and its two lists)
    and generator_loss on the MPD's outputs within 1e-5 relative of JAX's."""
    y, y_hat = _wavs(2, 2, 900), _wavs(3, 2, 900)
    jr, jg, jfr, jfg = discs["jax"][0].apply(discs["params"]["mpd"], jnp.asarray(y),
                                             jnp.asarray(y_hat))
    with torch.no_grad():
        tr, tg, tfr, tfg = discs["port"][0](torch.from_numpy(y), torch.from_numpy(y_hat))
    _close(td.feature_loss(tfr, tfg).item(), jd.feature_loss(jfr, jfg))
    (gl, gr, gg), (wl, wr, wg) = td.discriminator_loss(tr, tg), jd.discriminator_loss(jr, jg)
    _close(gl.item(), wl)
    _close([v.item() for v in gr + gg], [float(v) for v in wr + wg])
    (gl, gs), (wl, ws) = td.generator_loss(tg), jd.generator_loss(jg)
    _close(gl.item(), wl)
    _close([v.item() for v in gs], [float(v) for v in ws])


# --- one fused GAN step ---------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_cfg(tmp_path_factory):
    d = tmp_path_factory.mktemp("gan")
    (d / "tiny.json").write_text(json.dumps(TINY_TRAIN))
    return str(d / "tiny.json")


def _adam_tol(got, want, grad, rms, steps=1):
    """2e-3 * lr * steps plus one f32 rounding of JAX's value; entries whose
    gradient is below 1e-3 of the RMS gradient (the sign of their Adam move
    is a rounding coin toss) 2 * lr * steps."""
    tol = np.full(got.shape, 2e-3 * LR * steps) + np.spacing(np.abs(want))
    tol[np.abs(grad) < 1e-3 * rms] = 2 * LR * steps
    return np.abs(got - want) <= tol


def test_one_gan_step_matches_jax(discs, tiny_cfg):
    """One step from the same parameters and segments, AdamW (0.8, 0.99,
    weight decay 1e-4) at LR on both sides: the port's discriminator step
    leaves the generator bit-unchanged and without gradients, the
    generator step leaves the discriminators' gradients exactly as their
    own step left them; the nine metrics within 1e-5 relative (the two
    gradient norms 1e-4) of JAX's fused step; every parameter of both sides
    after the step as _adam_tol holds it."""
    jcfg, cfg = jload_json(tiny_cfg), load_json(tiny_cfg)
    jgen = JBigVGAN.from_config(jcfg.vocoder)
    wav = _wavs(5, B, SEGMENT)
    gv = jax.device_get(randomize(jgen.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, SEGMENT // 16, 16))), 7))
    jopt = optax.adamw(LR, b1=0.8, b2=0.99)
    jmpd, jmrd = discs["jax"]
    fused = jgan.make_fused_vocoder_gan_step(jgen, jmpd, jmrd, jopt, jopt, jcfg.data)
    dp = discs["params"]
    d_state, g_state, want = fused(jsteps.TrainState(dp, jopt.init(dp), 0),
                                   jsteps.TrainState(gv, jopt.init(gv), 0), jnp.asarray(wav))
    want = {k: float(v) for k, v in want.items()}

    gen = BigVGAN.from_config(cfg.vocoder)
    gen.load_state_dict(params_from_jax(gv))
    mpd = td.MultiPeriodDiscriminator(PERIODS, channel_mult=MULT)
    mrd = td.MultiResolutionDiscriminator(RES, channel_mult=MULT)
    mpd.load_state_dict(params_from_jax(dp["mpd"]))
    mrd.load_state_dict(params_from_jax(dp["mrd"]))

    def adamw(params):
        return torch.optim.AdamW(params, lr=LR, betas=(0.8, 0.99), eps=1e-8,
                                 weight_decay=tloop.WEIGHT_DECAY)

    disc_params = list(mpd.parameters()) + list(mrd.parameters())
    gen_opt, disc_opt = adamw(gen.parameters()), adamw(disc_params)
    disc_step, gen_step = tgan.make_vocoder_gan_steps(gen, mpd, mrd, gen_opt, disc_opt, cfg.data)
    w = torch.from_numpy(wav)
    batch = {"wav": w, "mel": tgan._mel(w, cfg.data)}
    g0 = {k: v.clone() for k, v in gen.state_dict().items()}
    got = disc_step(batch)
    assert all(torch.equal(v, g0[k]) for k, v in gen.state_dict().items())
    assert all(p.grad is None for p in gen.parameters())
    d_grads = [p.grad.clone() for p in disc_params]
    got.update(gen_step(batch))
    assert all(torch.equal(p.grad, g) for p, g in zip(disc_params, d_grads))
    assert all(p.requires_grad for p in disc_params)
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k].item(), v, rtol=1e-4 if k.endswith("grad_norm") else 1e-5)

    for mod, tree in ((gen, g_state.params), (mpd, d_state.params["mpd"]),
                      (mrd, d_state.params["mrd"])):
        ref = params_from_jax(jax.device_get(tree))
        params = dict(mod.named_parameters())
        rms = np.sqrt(np.mean(np.concatenate([p.grad.numpy().ravel()
                                              for p in params.values()]) ** 2))
        for k, p in params.items():
            ok = _adam_tol(p.detach().numpy(), ref[k].numpy(), p.grad.numpy(), rms)
            assert ok.all(), (k, np.abs(p.detach().numpy() - ref[k].numpy()).max())


# --- the sampler, the optimizer, the initializers -------------------------------


def test_segment_sampler_draws_equal_jax():
    """SegmentSampler against JAX's over five batches from one seed: clips
    shorter than the segment (zero-padded), longer ones (cropped at a drawn
    start), and a lazily loaded entry, equal bit for bit."""
    rng = np.random.default_rng(0)
    wavs = [rng.standard_normal(n).astype(np.float32) for n in (100, 300, 1000, 257, 4000)]
    lazy = wavs[:4] + [lambda: wavs[4]]
    j, t = jloop.SegmentSampler(wavs, 256, 3, 11), tloop.SegmentSampler(lazy, 256, 3, 11)
    for _ in range(5):
        np.testing.assert_array_equal(t.next(), j.next())
    with pytest.raises(ValueError, match="empty"):
        tloop.SegmentSampler([], 256, 3, 0)


def test_adamw_and_schedule_match_optax():
    """torch's AdamW (0.8, 0.99, eps 1e-8, weight decay 1e-4) with the
    LambdaLR of lr_lambda(3, 0.9) against optax.adamw over
    optax.exponential_decay(lr, 3, 0.9) (not staircase) for seven updates
    of the same gradients: the parameters within 1e-6 relative at every
    step; a schedule rebuilt at step 4 from the saved optimizer state
    (last_epoch 3, as a resumed GanTrainer builds it) continues the same."""
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((5, 4)).astype(np.float32)
    grads = [rng.standard_normal((5, 4)).astype(np.float32) for _ in range(7)]
    sched = optax.exponential_decay(LR, transition_steps=3, decay_rate=0.9)
    jopt = optax.adamw(sched, b1=0.8, b2=0.99)
    jp, jst = jnp.asarray(p0), jopt.init(jnp.asarray(p0))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))

    def make(last_epoch=-1, state=None):
        opt = torch.optim.AdamW([p], lr=LR, betas=(0.8, 0.99), eps=1e-8,
                                weight_decay=tloop.WEIGHT_DECAY)
        if state is not None:
            opt.load_state_dict(state)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, tloop.lr_lambda(3, 0.9),
                                                      last_epoch=last_epoch)

    opt, lr_sched = make()
    for i, g in enumerate(grads):
        if i == 4:
            opt, lr_sched = make(3, opt.state_dict())
        upd, jst = jopt.update(jnp.asarray(g), jst, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        lr_sched.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7,
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("logscale", [True, False])
def test_vocoder_init_matches_flax(tiny_cfg, logscale):
    """init_module on a BigVGAN, as GanTrainer draws its generator, against
    the JAX BigVGAN's `init`:
    the same keys and shapes; the snake alpha / beta zeros with
    snake_logscale, ones without; biases zeros; each kernel within the
    truncated normal's support with its mean and std within six standard
    errors of flax's draw. init_module gives the MPD and MRD flax's keys
    and shapes, and an unknown name still raises."""
    import dataclasses

    cfg = load_json(tiny_cfg)
    cfg = dataclasses.replace(cfg, vocoder=dataclasses.replace(cfg.vocoder,
                                                               snake_logscale=logscale))
    jgen = JBigVGAN.from_config(dataclasses.replace(jload_json(tiny_cfg).vocoder,
                                                    snake_logscale=logscale))
    want = params_from_jax(jax.device_get(jgen.init(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 8, 16)))))
    with torch.device("meta"):
        gen = BigVGAN.from_config(cfg.vocoder)
    got = init_module(gen, torch.Generator().manual_seed(0), logscale)
    assert set(got) == set(want)
    snakes = 0
    for k, v in want.items():
        g, v = got[k].numpy(), v.numpy()
        assert g.shape == v.shape, k
        leaf = k.rsplit(".", 1)[-1]
        if leaf in ("alpha", "beta"):
            np.testing.assert_array_equal(g, np.full(v.shape, 0.0 if logscale else 1.0))
            np.testing.assert_array_equal(g, v)
            snakes += 1
        elif leaf == "bias":
            assert not g.any() and not v.any(), k
        else:
            cap = 2 * np.sqrt(1 / np.prod(v.shape[:-1])) / 0.87962566103423978
            assert np.abs(g).max() <= cap * (1 + 1e-6), k
            if v.size >= 200:
                n, sd = v.size, v.std()
                assert abs(g.mean() - v.mean()) <= 6 * sd * np.sqrt(2 / n), k
                assert abs(g.std() - sd) <= 6 * sd * np.sqrt(1 / n), k
    assert snakes > 4
    w = jnp.zeros((1, SEGMENT))
    for jm, tm in ((jd.MultiPeriodDiscriminator(PERIODS, channel_mult=MULT),
                    td.MultiPeriodDiscriminator(PERIODS, channel_mult=MULT)),
                   (jd.MultiResolutionDiscriminator(RES, channel_mult=MULT),
                    td.MultiResolutionDiscriminator(RES, channel_mult=MULT))):
        want = params_from_jax(jax.device_get(jm.init(jax.random.PRNGKey(0), w, w)))
        got = init_module(tm, torch.Generator().manual_seed(1))
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert all(not got[k].any() for k in got if k.endswith(".bias"))
    with pytest.raises(ValueError, match="no flax initializer"):
        _flax_init_(torch.empty(3), "act.gamma_not_known", torch.Generator())


# --- the CLI ------------------------------------------------------------------


def test_cli_train_vocoder_resume_then_inference(tiny_cfg, tmp_path, monkeypatch):
    """`cli train-vocoder --device cpu` (the full MPD and MRD, 2048-sample
    segments): two steps saving each, --resume to three (it starts at step
    2), --resume again returns already_complete; resume without a
    checkpoint directory and a wav at another rate are refused; the
    checkpoint holds the generator, both discriminators, both optimizers
    and the step, load_vocoder_params reads the generator, and `cli
    inference --vocoder` serves it on the kernel route (plain versions on
    the CPU)."""
    from unitspeech_tpu_torch.tools import synthetic_corpus

    # the TensorBoard writer left out, as on a machine without tensorboardX
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    cfg = load_json(tiny_cfg)
    corp = synthetic_corpus(str(tmp_path / "c"), cfg, ["ðə kwɪk.", "bɹaʊn fɑks.", "dɑɡ."],
                            n_speakers=1, seconds=(1.4, 2.0), seed=8)
    ck = str(tmp_path / "voc")
    flags = ["--filelist", corp["filelist"], "--batch-size", "2", "--segment-size", "2048",
             "--checkpoint-dir", ck, "--save-every", "1", "--config", tiny_cfg, "--device",
             "cpu", "--log-dir", str(tmp_path / "log")]
    first = cli.main_train_vocoder(flags + ["--steps", "2"])
    assert first["steps"] == 2 and sorted(os.listdir(ck)) == ["step_1", "step_2"]
    # one interval between the two steps' ends, and its median
    assert len(first["step_seconds"]) == 1
    assert first["ms_per_step"] == first["step_seconds"][0] * 1e3 > 0
    assert all(np.isfinite(v) for v in first["final_metrics"].values())
    assert set(first["final_metrics"]) == {"disc_loss", "disc_mpd", "disc_mrd",
                                           "disc_grad_norm", "gen_loss", "gen_adv", "gen_fm",
                                           "gen_mel_l1", "gen_grad_norm"}
    again = cli.main_train_vocoder(flags + ["--steps", "3", "--resume"])
    assert again["steps"] == 3 and "already_complete" not in again["final_metrics"]
    done = cli.main_train_vocoder(flags + ["--steps", "3", "--resume"])
    assert done["final_metrics"] == {"already_complete": 1.0, "restored_step": 3.0}
    assert done["step_seconds"] == [] and done["ms_per_step"] is None
    with pytest.raises(ValueError, match="checkpoint_dir"):
        tloop.train_vocoder(cfg, [np.zeros(4096, np.float32)], tloop.VocoderTrainConfig(),
                            resume=True, device="cpu")
    import dataclasses

    other = tmp_path / "other.json"
    other.write_text(json.dumps(dict(TINY_TRAIN, data=dict(TINY_TRAIN["data"],
                                                           sampling_rate=3200))))
    with pytest.raises(SystemExit, match="1600 != 3200"):
        cli.main_train_vocoder(["--filelist", corp["filelist"], "--config", str(other),
                                "--device", "cpu"])
    tree = torch.load(os.path.join(ck, "step_3"), weights_only=True)
    assert set(tree) == {"vocoder", "mpd", "mrd", "gen_opt", "disc_opt", "step", "config"}
    assert tree["step"] == 3 and tree["config"] == dataclasses.asdict(cfg)
    sd = artifacts.load_vocoder_params(os.path.join(ck, "step_3"), cfg.vocoder)
    assert all(torch.equal(sd[k], v) for k, v in tree["vocoder"].items())
    rand = str(tmp_path / "rand.pt")
    cli.main_make_random_checkpoint(["--config", tiny_cfg, "--output", rand])
    stats = cli.main_inference(["--ipa", "--text", "ðə kwɪk.", "--checkpoint", rand,
                                "--vocoder", os.path.join(ck, "step_3"), "--output",
                                str(tmp_path / "o.wav"), "--device", "cpu",
                                "--diffusion-steps", "2"])
    assert stats["frames"] > 0 and stats["kernels"]
