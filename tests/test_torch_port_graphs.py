"""The sampler and the fine-tune as one dispatch a step (models/diffusion.py
sampler_step, infer/graphs.py SamplerGraphs, train/finetune.py
FinetuneLoop) on the CPU: the graph-safe step driven by a plain loop and
through the graph cache (with a stand-in capturer: the CPU has no CUDA
graphs) bit-equal in f32 to the sampler loop as it was before the step read
its numbers from device tables (kept here as the reference) and within the
sampler tests' tolerance of JAX's reverse_diffusion / reverse_diffusion_ode
with JAX's draws; the up-front noise equal to the per-step draws; the
fine-tune with its draws up front equal to the loop as it was and to JAX's
at the fine-tune tests' tolerance; the cache's key, its pack-generation
invalidation, its launch counts and its step tables; the Synthesizer, voice
conversion and the serving warm-up on the cache; and the world > 1 branch,
which stays eager. The card's own graphs: tests/test_torch_port_cuda_graphs.py.

The estimator is the 2-stage one at dim 8 (tests/test_torch_port_sampler.py),
f32."""

import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from tests._torch_port import randomize, scale_gates
from tests.test_torch_port_finetune import (  # noqa: F401 (setup, jax_finetune: fixtures)
    ITERS,
    LR,
    SEG,
    _assert_adapted_like_jax,
    _jax_draws,
    _port_inputs,
    jax_finetune,
    setup,
)
from tests.test_torch_port_finetune import DEC as FT_DEC
from tests.test_torch_port_tts import TINY
from unitspeech_tpu.config import DecoderConfig
from unitspeech_tpu.models import diffusion as jdiff
from unitspeech_tpu_torch.config import config_from_dict
from unitspeech_tpu_torch.infer import graphs as tgraphs
from unitspeech_tpu_torch.infer import tts as ttts
from unitspeech_tpu_torch.infer import vc as tvc
from unitspeech_tpu_torch.models import diffusion as tdiff
from unitspeech_tpu_torch.models import unet
from unitspeech_tpu_torch.ops import fused_resnet
from unitspeech_tpu_torch.ops.schedule import (
    forward_diffusion_coefficients,
    make_ode_schedule,
    make_reverse_schedule,
)
from unitspeech_tpu_torch.parallel.mesh import SINGLE
from unitspeech_tpu_torch.serve import DynamicBatcher
from unitspeech_tpu_torch.train import finetune as tft
from unitspeech_tpu_torch.train.steps import clip_by_global_norm
from unitspeech_tpu_torch.utils.params import params_from_jax, random_params

# one intra-op thread: the suite's pytest workers share the CPU's cores
torch.set_num_threads(1)

DEC = dict(n_feats=16, dim=8, dim_mults=(1, 2), groups=4, spk_emb_dim=8)
ATOL, RTOL = 1e-5, 1e-4  # tests/test_torch_port_sampler.py's
SPECS = ["ddpm", "dpm2", "ddpm:cs2", "dpm2:cs2"]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=ATOL + RTOL * np.abs(want).max())


class StubCapture:
    """CudaCapture's stand-in on the CPU: the warm-up runs the step; the
    capture keeps the step without running it, as a CUDA capture records
    it, and counts `launches` launches of K1 as a wrapper would count them
    while captured; a replay runs the step."""

    def __init__(self, launches=0):
        self.launches, self.warms, self.captures = launches, 0, 0

    def takes(self, x):
        return True

    def pool(self):
        return object()

    def warm(self, fn, device):
        self.warms += 1
        fn()

    def capture(self, fn, pool):
        self.captures += 1
        fused_resnet.fused_resnet_block.launches += self.launches
        return SimpleNamespace(replay=fn)


# --- the sampler loop as it was: the reference --------------------------


@torch.no_grad()
def _todays_sampler(model, spec, z, mask, cond, spk, n, tg, sg, generator=None, noises=None):
    """The port's reverse_diffusion / reverse_diffusion_ode before the step
    read its numbers from device tables: Python floats a step, the noise
    drawn each step, the guidance delta in a dict."""
    name, stride = tdiff.parse_sampler_spec(spec)
    cond_c, spk_c, mask_c, n_rows, combine = tdiff.build_cfg_rows(model, mask, cond, spk, tg, sg)
    b = mask.shape[0]
    stride = min(stride, n) if n_rows > 1 else 1
    n_grouped = (n // stride) * stride
    cache = {}
    if name == "ddpm":
        sched = make_reverse_schedule(n, model.beta_min, model.beta_max)
        stds = forward_diffusion_coefficients(torch.from_numpy(sched.t_cont), model.beta_min,
                                              model.beta_max)[1].tolist()
    else:
        co = make_ode_schedule(n, model.beta_min, model.beta_max, t_end=0.01).stacked()
        stds = torch.sqrt(torch.from_numpy(co[:, 6])).tolist()

    def score_fn(xt, t, i):
        if stride > 1 and i < n_grouped and i % stride:
            s = model(xt, mask, cond, torch.full((b,), t), spk)
            return s + cache["delta_eps"] / stds[i]
        xt_c = torch.cat([xt] * n_rows) if n_rows > 1 else xt
        s_all = model(xt_c, mask_c, cond_c, torch.full((xt_c.shape[0],), t), spk_c)
        guided = combine(s_all)
        if stride > 1:
            cache["delta_eps"] = (guided - s_all[-b:]) * stds[i]
        return guided

    mask3 = mask[:, :, None]
    xt = z * mask3
    if name == "ddpm":
        for i in range(n):
            noise = torch.randn(xt.shape, generator=generator) if noises is None else noises[i]
            score = score_fn(xt, float(sched.t_cont[i]), i)
            xt = (float(sched.c_x[i]) * xt + float(sched.c_score[i]) * score
                  + float(sched.c_noise[i]) * noise) * mask3
        return xt * mask3
    x0_prev = torch.zeros_like(xt)
    for i in range(n):
        t_eval, a, bb, c1, c2, inv_alpha, sigma2 = (float(v) for v in co[i])
        x0 = (xt + sigma2 * score_fn(xt, t_eval, i)) * inv_alpha
        xt = (a * xt + bb * (c1 * x0 + c2 * x0_prev)) * mask3
        x0_prev = x0
    return xt * mask3


@pytest.fixture(scope="module")
def pair():
    """(JAX UnitSpeech, its params, the port decoder with the same weights,
    inputs z, mask (one padded row), cond, spk) as numpy."""
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


@pytest.mark.parametrize("tg,sg", [(1.0, 1.0), (1.3, 0.0), (0.0, 0.0)])
@pytest.mark.parametrize("spec", SPECS)
def test_step_loop_and_graphs_equal_todays_sampler(pair, spec, tg, sg):
    """sample() through sampler_step, eagerly and through SamplerGraphs (the
    stand-in capturer: one warm-up step and one capture a step kind, the
    other steps replays), bit-equal to the loop as it was, on one
    generator seed; 7 steps, so a stride of 2 leaves a trailing full step."""
    *_, port, z, mask, cond, spk = pair
    n = 7
    args = _t(z, mask, cond, spk)
    kw = dict(text_gradient_scale=tg, spk_gradient_scale=sg)
    want = _todays_sampler(port, spec, *args, n, tg, sg, torch.Generator().manual_seed(5))
    eager = tdiff.sample(port, spec, *args, n, generator=torch.Generator().manual_seed(5), **kw)
    cap = StubCapture()
    cache = tgraphs.SamplerGraphs(cap)
    graphed = tdiff.sample(port, spec, *args, n, generator=torch.Generator().manual_seed(5),
                           graphs=cache, **kw)
    assert torch.equal(eager, want) and torch.equal(graphed, want)
    kinds = 2 if spec.endswith(":cs2") and (tg or sg) else 1
    assert cap.captures == cap.warms == cache.captures == kinds
    assert cache.replays == n - kinds
    again = tdiff.sample(port, spec, *args, n, generator=torch.Generator().manual_seed(5),
                         graphs=cache, **kw)
    assert torch.equal(again, want)
    assert cache.captures == kinds and cache.replays == 2 * n - kinds


@pytest.mark.parametrize("graphed", [False, True], ids=["loop", "graphs"])
@pytest.mark.parametrize("spec", SPECS)
def test_step_matches_jax(pair, spec, graphed):
    """The graph-safe step on the estimator, dual guidance 1.0 / 1.0,
    against JAX's samplers: ddpm with JAX's draws injected (at stride 1
    JAX's `noises`, at a stride its fold_in draws), dpm2 deterministic;
    the sampler tests' tolerance; the padded frames zero."""
    jm, params, port, z, mask, cond, spk = pair
    name, stride = tdiff.parse_sampler_spec(spec)
    n = 6
    kw = dict(n_timesteps=n, text_gradient_scale=1.0, spk_gradient_scale=1.0, cfg_stride=stride)
    graphs = tgraphs.SamplerGraphs(StubCapture()) if graphed else None
    if name == "dpm2":
        want = jdiff.reverse_diffusion_ode(jm.apply, params, z, mask, cond, spk, **kw)
        got = tdiff.reverse_diffusion_ode(port, *_t(z, mask, cond, spk), graphs=graphs, **kw)
    else:
        key = jax.random.PRNGKey(10)
        noises = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), z.shape))
                           for i in range(n)])
        want = jdiff.reverse_diffusion(jm.apply, params, z, mask, cond, spk, key,
                                       noises=noises if stride == 1 else None, **kw)
        got = tdiff.reverse_diffusion(port, *_t(z, mask, cond, spk),
                                      noises=torch.from_numpy(noises), graphs=graphs, **kw)
    assert np.isfinite(np.asarray(want)).all()
    _close(got, want)
    np.testing.assert_array_equal(got[1, 11:].numpy(), 0.0)


def test_noise_up_front_equals_per_step_draws():
    """draw_noises: the n per-step draws of a CPU generator, in order,
    equal to drawing each step (and the data shard's global draws)."""
    shape, n = (3, 24, 16), 5
    g1, g2 = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    up_front = tdiff.draw_noises(shape, n, g1, "cpu")
    each = [torch.randn(shape, generator=g2) for _ in range(n)]
    assert up_front.shape == (n, *shape)
    assert all(torch.equal(up_front[i], each[i]) for i in range(n))
    g3 = torch.Generator().manual_seed(11)
    assert torch.equal(tdiff.draw_noises(shape, n, g3, "cpu", SINGLE), up_front)


def test_step_tables_are_the_schedules():
    """sampler_tables: the schedules' float32 columns, std_t as the loop
    computed it, read by the step counter."""
    tab = tdiff.sampler_tables("ddpm", 9, 0.05, 20.0)
    s = make_reverse_schedule(9, 0.05, 20.0)
    for j, col in enumerate((s.t_cont, s.c_x, s.c_score, s.c_noise)):
        np.testing.assert_array_equal(tab[:, j].numpy(), col)
    std = forward_diffusion_coefficients(torch.from_numpy(s.t_cont), 0.05, 20.0)[1]
    assert tab.dtype == torch.float32 and torch.equal(tab[:, 4], std)
    ode = tdiff.sampler_tables("dpm2", 9, 0.05, 20.0)
    co = make_ode_schedule(9, 0.05, 20.0).stacked()
    np.testing.assert_array_equal(ode[:, :7].numpy(), co)
    assert torch.equal(ode[:, 7], torch.sqrt(torch.from_numpy(co[:, 6])))
    assert tdiff.step_kinds(7, 2, 3) == ["full", "cheap"] * 3 + ["full"]
    assert tdiff.step_kinds(7, 2, 1) == ["full"] * 7
    assert tdiff.step_kinds(2, 8, 3) == ["full", "cheap"]


# --- the graph cache --------------------------------------------------------


def _sample(port, args, n, cache, spec="ddpm:cs2", seed=5):
    return tdiff.sample(port, spec, *args, n, text_gradient_scale=1.0, spk_gradient_scale=1.0,
                        generator=torch.Generator().manual_seed(seed), graphs=cache)


def test_cache_keys_and_pack_generation(pair):
    """One entry a (sampler, guidance, shape, routes): the same shape
    replays, another bucket or sampler captures; load_state_dict and pack()
    move the pack generation on and the cache drops every graph (a graph
    captured before a pack reads freed tensors), then captures anew and
    still gives the eager result."""
    *_, port, z, mask, cond, spk = pair
    args = _t(z, mask, cond, spk)
    cache = tgraphs.SamplerGraphs(StubCapture())
    want = _sample(port, args, 5, None)
    assert torch.equal(_sample(port, args, 5, cache), want)
    assert cache.captures == 2 and len(cache.entries) == 1
    _sample(port, args, 5, cache)
    assert cache.captures == 2
    wider = [torch.cat([a, a[:, :8]], 1) if a.dim() > 1 and a.shape[1] == 16 else a for a in args]
    _sample(port, wider, 5, cache)
    assert cache.captures == 4 and len(cache.entries) == 2
    _sample(port, args, 5, cache, spec="dpm2:cs2")
    assert cache.captures == 6 and len(cache.entries) == 3
    gen = port.estimator.pack_generation
    port.load_state_dict(port.state_dict())
    assert port.estimator.pack_generation == gen + 1
    assert torch.equal(_sample(port, args, 5, cache), want)
    assert cache.captures == 8 and len(cache.entries) == 1 and cache.generation == gen + 1
    port.estimator.pack()
    assert port.estimator.pack_generation == gen + 2
    _sample(port, args, 5, cache)
    assert cache.captures == 10 and len(cache.entries) == 1


def test_cache_counts_launches_and_replays(pair):
    """A capture takes back the launches its wrappers counted (it ran
    nothing) and each replay adds them: the counters count what ran; a
    replay hook sees each replay's estimator rows (3B full, B cheap) in
    order, until removed."""
    *_, port, z, mask, cond, spk = pair
    args = _t(z, mask, cond, spk)
    cache = tgraphs.SamplerGraphs(StubCapture(launches=7))
    fused_resnet.fused_resnet_block.launches = 0
    rows = []
    handle = tgraphs.register_replay_hook(rows.append)
    try:
        _sample(port, args, 5, cache)  # kinds full, cheap, full, cheap, full
        # full and cheap each warmed and captured once: 3 replays of 7 launches
        assert fused_resnet.fused_resnet_block.launches == 3 * 7
        assert rows == [6, 2, 6]
        _sample(port, args, 5, cache)
        assert fused_resnet.fused_resnet_block.launches == 8 * 7
        assert rows == [6, 2, 6] + [6, 2, 6, 2, 6]
    finally:
        handle.remove()
    _sample(port, args, 5, cache)
    assert len(rows) == 8


def test_reserve_sizes_the_step_tables(pair):
    """reserve(n): an entry captured by a 2-step run holds tables for n
    steps, so an n-step request replays it; a longer one captures anew."""
    *_, port, z, mask, cond, spk = pair
    args = _t(z, mask, cond, spk)
    cache = tgraphs.SamplerGraphs(StubCapture())
    cache.reserve(6)
    _sample(port, args, 2, cache)
    assert cache.captures == 2
    (entry,) = cache.entries.values()
    assert entry.steps == 6 and entry.state.tables.shape[0] == 6
    assert torch.equal(_sample(port, args, 6, cache), _sample(port, args, 6, None))
    assert cache.captures == 2
    _sample(port, args, 9, cache)
    assert cache.captures == 4 and next(iter(cache.entries.values())).steps == 9


def test_spot_pack_is_made_once_and_never_inside_a_capture(monkeypatch):
    """A ResnetBlock route other than the packed one packs at its first
    call on the card and keeps it until pack(); inside a CUDA graph capture
    it raises (the warm-up step packs); on the CPU nothing is packed."""
    block = unet.ResnetBlock(64, 64, 16, 8)
    for prm in block.parameters():
        torch.nn.init.normal_(prm)
    x = torch.zeros(1)
    assert block.spot_pack("k1", x) is None and block.spot_packs == {}
    card = SimpleNamespace(is_cuda=True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        block.spot_pack("k1", card)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    packed = block.spot_pack("k1", card)
    assert packed is not None and block.spot_pack("k1", card) is packed
    block.pack(80, True)
    assert block.packed_for == "k1"
    assert block.spot_packs == {}


def test_world_above_one_stays_eager(pair, monkeypatch):
    """graphs_for: the decoder's cache on the card at world 1; None (the
    eager steps) on the CPU, with a data or seq shard, with a decoder
    sharded over the model axis and in a process group of more than one
    rank."""
    port = pair[2]
    x = torch.zeros(1)
    port.__dict__["_sampler_graphs"] = cache = tgraphs.SamplerGraphs(StubCapture())
    try:
        assert tgraphs.graphs_for(port, x) is cache
        assert tgraphs.graphs_for(port, x, shard=SINGLE) is None
        assert tgraphs.graphs_for(port, x, seq_shard=object()) is None
        monkeypatch.setattr(port.estimator, "tp", object())
        assert tgraphs.graphs_for(port, x) is None
        monkeypatch.setattr(port.estimator, "tp", None)
        monkeypatch.setattr(tgraphs, "world_size", lambda: 2)
        assert tgraphs.graphs_for(port, x) is None
    finally:
        del port.__dict__["_sampler_graphs"]
    monkeypatch.setattr(tgraphs, "world_size", lambda: 1)
    assert tgraphs.graphs_for(port, x) is None  # the CPU: CudaCapture takes no CPU tensor
    assert isinstance(port.__dict__.pop("_sampler_graphs"), tgraphs.SamplerGraphs)


def _tiny_synth(**kw):
    cfg = config_from_dict(dict(TINY, text_encoder=dict(TINY["text_encoder"], n_vocab=40)))
    return ttts.Synthesizer(ttts.TTSModels.from_checkpoint(random_params(cfg, 0), device="cpu",
                                                           dtype=torch.float32), **kw)


@pytest.mark.parametrize("spec", ["ddpm", "dpm2:cs2"])
def test_synthesizer_and_vc_replay_the_decoders_graphs(spec):
    """The Synthesizer (a forced request and a batch of 2) and voice
    conversion take the decoder's graphs where graphs_for gives them
    (here the stand-in capturer), bit-equal to the eager steps
    (graphs=False, or a cache that takes no CPU tensor); the batch's second
    request of the same shape replays only."""
    synth = _tiny_synth()
    eager = dataclasses.replace(synth, graphs=False)
    dec = synth.models.decoder
    dec.__dict__["_sampler_graphs"] = cache = tgraphs.SamplerGraphs(StubCapture())
    kw = dict(diffusion_steps=4, text_gradient_scale=1.0, spk_gradient_scale=1.0, sampler=spec)
    ids = [1, 5, 9, 3, 7, 2]
    got = synth(ids, torch.Generator().manual_seed(3), forced_total_frames=40, **kw)[2]
    want = eager(ids, torch.Generator().manual_seed(3), forced_total_frames=40, **kw)[2]
    assert torch.equal(got, want)
    kinds = 2 if spec.endswith(":cs2") else 1
    assert cache.captures == kinds and cache.replays == 4 - kinds
    seqs, dur = [ids, ids[:4]], [[6] * 6, [8] * 4]
    got = synth.synthesize_mel_batch(seqs, torch.Generator().manual_seed(4), durations=dur,
                                     **kw)[0]
    want = eager.synthesize_mel_batch(seqs, torch.Generator().manual_seed(4), durations=dur,
                                      **kw)[0]
    assert torch.equal(got, want)
    before = cache.captures
    synth.synthesize_mel_batch(seqs, torch.Generator().manual_seed(4), durations=dur, **kw)
    assert cache.captures == before
    m = synth.models
    content = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 9, 16))
                               .astype(np.float32))

    def convert():
        return tvc.voice_conversion(lambda c, n: (c, None, None), dec, content, 30, m.spk_emb,
                                    m.mel_min, m.mel_max, n_timesteps=4, sampler=spec,
                                    generator=torch.Generator().manual_seed(6))

    before = cache.captures
    got = convert()
    assert cache.captures == before + kinds
    dec.__dict__["_sampler_graphs"] = tgraphs.SamplerGraphs()  # the card's: eager on the CPU
    assert torch.equal(got, convert())


def test_serving_warmup_captures_each_step_kind_once():
    """DynamicBatcher.warmup at the default 4 steps of ddpm:cs2: each grid
    point runs k = 2 steps (a full one and a cheap one, each captured once
    a point) into tables reserved for 4, and a 4-step dispatch at a grid
    point then replays only."""
    synth = dataclasses.replace(_tiny_synth(), switch_buckets=(48, 96))
    synth.models.decoder.__dict__["_sampler_graphs"] = cache = tgraphs.SamplerGraphs(StubCapture())
    b = DynamicBatcher(synth, max_batch=2, default_steps=4, default_sampler="ddpm:cs2",
                       text_gradient_scale=1.0, spk_gradient_scale=1.0)
    try:
        b.warmup((8,))
    finally:
        b.shutdown()
    points = 2 * 2  # ladder {1, 2} x the window's 2 buckets (one token bucket, 16)
    assert cache.captures == 2 * points and cache.replays == 0
    assert {e.steps for e in cache.entries.values()} == {4}
    d = synth._single_dispatch(np.ones((2, 16), np.int64), np.full((2,), 16, np.int64),
                               np.repeat(ttts.forced_durations(16, 96), 2, axis=0), 96,
                               torch.Generator().manual_seed(0), 4, 1.0, 1.0, 1.0, "ddpm:cs2")
    assert np.isfinite(d.wav.numpy()).all()
    assert cache.captures == 2 * points and cache.replays == 4


# --- the fine-tune ----------------------------------------------------------


def _todays_finetune(cfg, state_dict, cond_x, y, y_lengths, attn, spk, n_iters, generator):
    """finetune_decoder's loop as it was: each step draws its own u, t and
    z, the gradients set to None, Adam as constructed before."""
    model = tdiff.UnitSpeech.from_config(cfg, dtype=torch.float32)
    model.load_state_dict({k: v.to(torch.float32) for k, v in state_dict.items()})
    model.train().requires_grad_(True)
    params = list(model.parameters())
    opt = torch.optim.Adam(params, lr=LR, betas=(0.9, 0.999), eps=1e-8)
    losses = torch.empty(n_iters)
    for i in range(n_iters):
        opt.zero_grad(set_to_none=True)
        loss = tdiff.fine_tune_loss(model, cond_x, y, y_lengths, attn, spk, SEG, generator)
        loss.backward()
        clip_by_global_norm([p.grad for p in params], 1.0)
        opt.step()
        losses[i] = loss.detach()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}, losses.numpy()


def test_finetune_draws_up_front_equal_todays_loop(setup):
    """finetune_decoder with its draws up front (draw_finetune), zeroed
    gradients and the device counter, on one generator seed: the losses and
    the adapted weights bit-equal to the loop as it was, and the batched
    form's rows (one FinetuneLoop for both speakers) to single runs."""
    cfg = DecoderConfig(**FT_DEC)
    base = params_from_jax(setup["dparams"])
    c, yy, yl, a = _port_inputs(setup)
    spk = torch.from_numpy(setup["spk"])
    want, want_losses = _todays_finetune(cfg, base, c, yy, yl, a, spk, 4,
                                         torch.Generator().manual_seed(8))
    got, losses = tft.finetune_decoder(cfg, base, c, yy, yl, a, spk, dtype=torch.float32,
                                       segment_size=SEG, n_iters=4, learning_rate=LR,
                                       generator=torch.Generator().manual_seed(8))
    np.testing.assert_array_equal(losses, want_losses)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    stack = {k: torch.stack([v, v * 0.5]) for k, v in base.items()}
    rows = [x[None].repeat(2, *([1] * x.dim())) for x in (c, yy, yl, a, spk)]
    gens = [torch.Generator().manual_seed(8), torch.Generator().manual_seed(9)]
    got_b, losses_b = tft.finetune_decoder_batched(cfg, stack, *rows, dtype=torch.float32,
                                                   segment_size=SEG, n_iters=4,
                                                   learning_rate=LR, generators=gens)
    np.testing.assert_array_equal(losses_b[0], want_losses)
    one, one_losses = tft.finetune_decoder(
        cfg, {k: v[1] for k, v in stack.items()}, c, yy, yl, a, spk, dtype=torch.float32,
        segment_size=SEG, n_iters=4, learning_rate=LR, generator=torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(losses_b[1], one_losses)
    assert all(torch.equal(got_b[k][0], want[k]) and torch.equal(got_b[k][1], one[k])
               for k in want)


def test_finetune_draw_order():
    """draw_finetune draws each step's u, t, z in fine_tune_loss's order."""
    g = torch.Generator().manual_seed(4)
    d = tft.draw_finetune(3, 1, 5, 4, g)
    g2 = torch.Generator().manual_seed(4)
    for i in range(3):
        assert torch.equal(d["u"][i], torch.rand((1,), generator=g2))
        assert torch.equal(d["t"][i], torch.rand((1,), generator=g2))
        assert torch.equal(d["z"][i], torch.randn((1, 5, 4), generator=g2))


def test_finetune_loop_matches_jax(setup, jax_finetune):
    """FinetuneLoop's steps with JAX's draws injected (the device counter
    reading them) against JAX's 3-iteration fine-tune, at the fine-tune
    tests' tolerance (tests/test_torch_port_finetune.py)."""
    want_params, want_losses = jax_finetune
    key = jax.random.PRNGKey(11)
    c, yy, yl, a = _port_inputs(setup)
    spk = torch.from_numpy(setup["spk"])
    draws = [_jax_draws(key, i, yy.shape) for i in range(ITERS)]
    base = params_from_jax(setup["dparams"])
    loop = tft.FinetuneLoop(DecoderConfig(**FT_DEC), "cpu", torch.float32, SEG, ITERS, LR, 1.0)
    loop.start(base, c, yy, yl, a, spk, draws=draws)
    got, losses = loop.run()
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    _assert_adapted_like_jax(setup, got, want_params, base, (c, yy, yl, a), spk, draws[0])
    # a second speaker on the same loop: the weights and Adam's state reset
    loop.start(base, c, yy, yl, a, spk, draws=draws)
    again, losses2 = loop.run()
    np.testing.assert_array_equal(losses2, losses)
    assert all(torch.equal(again[k], got[k]) for k in got)
