"""Tensor parallelism in the port against the JAX package on the CPU: the
spec rule and the spec trees at full width (leaf by leaf against JAX's
tp_spec_tree at model = 2, 4 and 8); shard_params_tp and gather_params_tp
round-tripping bit for bit; every site's model form at world 2 against the
same site whole (the layers and a Dense under autograd, K3's statistics on
whole and straddling groups, the flat bf16 and int8 convs, K1's and K2's
chains, K4 whole on every rank, the plain attention, the route
estimator's kernel sites through their CUDA branches against the stub
library); the samplers (ddpm with dual guidance and injected noise,
ddpm:cs2 with JAX's fold_in draws, dpm2, dpm2:cs2; plain and kernel paths)
with a model-sharded decoder at (data 1, seq 1, model 2) and (data 1, seq
2, model 2) against the port at world 1 and JAX's reverse_diffusion with
shard_params_tp on the matching meshes of the virtual devices; the
Synthesizer with a sharded decoder on both layouts; one DP x TP STEP1 step
at (data 2, seq 1, model 2) against the port at world 1 and JAX's step on
(4, 1, 2) with JAX's draws; the fused deep configuration on a column
slice: K8's, K9's and K11's model forms, the quantized weights equal to
the whole's columns bit for bit, the route estimator's deep sites, ddpm
and dpm2 on both deep paths at (1, 1, 2) against JAX's with
shard_params_tp and the port at world 1, and ddpm on the int8 deep path at
(1, 2, 2); the spec that still refuses.

Each multi-rank case runs gloo ranks on the CPU in spawned processes
(parallel.run_group; their code is tests/_parallel_workers.py, which
imports only the port), one torch thread each; the JAX side runs here.
The sampler decoder is the seq tests' (dim 64, 4 stages, F = 16, T = 64,
beta_max 2, f32). Tolerance: 1e-5 absolute plus 1e-4 of the largest
magnitude (the seq tests'; f32 sums in another order: a column slice's products
and the ranks' partial dots of K2), the layers and the gathered int8
products bit for bit where the arithmetic is the same, the int8 deep path
(K9) by the seq tests' int8 bounds (_int8_close, _int8_sampler_close)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tests import _parallel_workers as workers
from tests._torch_port import randomize, scale_gates
from tests.test_torch_port_parallel import _held_like_jax
from tests.test_torch_port_seq import (
    JAX_DEEP,
    ROUTE_EST,
    _deep_site_inputs,
    _int8_close,
    _int8_sampler_close,
    _jax_noises,
    _mask,
    _route_case,
)
from tests.test_torch_port_train import DEC as TRAIN_DEC
from tests.test_torch_port_train import DP as TRAIN_DP
from tests.test_torch_port_train import LR, SEG, _masked
from tests.test_torch_port_train import TE as TRAIN_TE
from tests.test_torch_port_tts import STEPS, TOKENS, _mel_tol, tiny_config
from unitspeech_tpu.config import MainConfig as JMainConfig
from unitspeech_tpu.models import diffusion as jdiff
from unitspeech_tpu.models.duration import DurationPredictor as JDurationPredictor
from unitspeech_tpu.models.encoder import Encoder as JEncoder
from unitspeech_tpu.parallel import make_mesh as jmake_mesh
from unitspeech_tpu.parallel import shard_batch as jshard_batch
from unitspeech_tpu.parallel import shard_params_tp as jshard_params_tp
from unitspeech_tpu.parallel import tp_spec as jtp_spec
from unitspeech_tpu.parallel import tp_spec_tree as jtp_spec_tree
from unitspeech_tpu.train import steps as jsteps
from unitspeech_tpu_torch.config import MainConfig
from unitspeech_tpu_torch.infer import tts as ttts
from unitspeech_tpu_torch.models import diffusion as tdiff
from unitspeech_tpu_torch.models.duration import DurationPredictor
from unitspeech_tpu_torch.models.encoder import Encoder
from unitspeech_tpu_torch.models.unet import GradLogPEstimator2d
from unitspeech_tpu_torch.ops.masking import (
    choose_bucket,
    default_frame_buckets,
    fix_len_compatibility,
)
from unitspeech_tpu_torch.ops import fused_resnet_deep as frd
from unitspeech_tpu_torch.ops import resample
from unitspeech_tpu_torch.parallel import Group, ModelShard, sample_shard, tp_spec, tp_spec_tree
from unitspeech_tpu_torch.parallel.tp import is_sharded, shard_params_tp
from unitspeech_tpu_torch.train import steps as tsteps
from unitspeech_tpu_torch.utils.params import _random_state_dict, params_from_jax, random_params

# one intra-op thread: the suite's pytest workers share the CPU's cores
torch.set_num_threads(1)

TIMEOUT = 240.0  # a case's ranks, start to join (the JAX side runs meanwhile)
ATOL, RTOL = 1e-5, 1e-4
DEC = dict(n_feats=16, dim=64, dim_mults=(1, 2, 4, 8), groups=8, spk_emb_dim=8, beta_max=2.0)
B, T, STEPS_TP = 2, 64, 3
SAMPLERS = ("ddpm", "ddpm:cs2", "dpm2", "dpm2:cs2")
LAYOUTS = {"model 2": ((1, 1, 2), None), "seq 2 x model 2": ((1, 2, 2), (None, "seq", None))}
# the fused deep paths' samplers each layout runs: every path and sampler on
# model 2, one int8 case on seq 2 x model 2
DEEP_RUNS = {"model 2": (("deep", "deep_i8"), ("ddpm", "dpm2")),
             "seq 2 x model 2": (("deep_i8",), ("ddpm",))}
# JAX's samplers by layout (its compiles are most of the file's time; the
# port's world-1 samplers meet JAX's unsharded ones in the sampler and seq
# tests)
JAX_SAMPLERS = {"model 2": ("ddpm", "ddpm:cs2", "dpm2"), "seq 2 x model 2": ("ddpm",)}
# JAX's mesh for each: the same for model 2; for seq x model JAX's own
# layout (tests/test_tp.py, __graft_entry__'s sampler_tp_x_seq), (1, 4, 2):
# GSPMD's (1, 2, 2) placement of this decoder on the CPU's virtual devices
# misses JAX's own replicated sample by 0.127 of a largest 5.99 (ddpm, 3
# steps), where (1, 4, 2), (1, 1, 2) and the replicated (1, 2, 2) meet it
# within 6.2e-6, so it cannot stand as the reference
JAX_LAYOUTS = {"model 2": (1, 1, 2), "seq 2 x model 2": (1, 4, 2)}
STEP_LAYOUT = (2, 1, 2)  # the port's DP x TP step; JAX's on (4, 1, 2)
SEQS = [TOKENS, TOKENS[:7], TOKENS[3:7], TOKENS[2:11]]


def _close(got, want, atol=ATOL, rtol=RTOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=atol + rtol * np.abs(want).max())


def _start(tmp_path, world, inputs):
    """workers.tp_case started as `world` ranks over tmp_path after its
    inputs.pt; returns outs(), which joins them and checks that no rank
    imported JAX."""
    torch.save(inputs, tmp_path / "inputs.pt")
    group = Group(workers.tp_case, world, (str(tmp_path),), timeout=TIMEOUT)
    got = []

    def outs():
        if not got:
            group.join()
            got.extend(torch.load(tmp_path / f"out{r}.pt", weights_only=False)
                       for r in range(world))
            assert all(o.pop("jax_free") for o in got), "a rank imported jax or unitspeech_tpu"
        return got

    return outs


# --- the spec rule and the trees ------------------------------------------------


@pytest.mark.parametrize("shape,n,min_per_shard,want", [
    ((3, 3, 4, 16), 8, 1, (None, None, None, "model")),  # conv kernel: last dim sharded
    ((4, 16), 8, 1, (None, "model")),  # dense
    ((16,), 8, 1, ()),  # bias / norm scale: replicated
    ((4, 6), 8, 1, ()),  # last dim not divisible
    ((4, 16), 8, 4, ()),  # the min_per_shard gate
    ((4, 16), 1, 1, ()),  # a model axis of one rank
])
def test_tp_spec_rule(shape, n, min_per_shard, want):
    """The cases of tests/test_tp.py's spec rule, equal to JAX's tp_spec."""
    assert tp_spec(shape, n, min_per_shard=min_per_shard) == want
    assert tuple(jtp_spec(jnp.zeros(shape), n, min_per_shard=min_per_shard)) == want


def _jax_full_width_shapes():
    """JAX's full-width MainConfig decoder, text encoder and duration
    predictor parameter shapes (jax.eval_shape of their inits)."""
    cfg = JMainConfig()
    te = JEncoder.from_config(cfg.text_encoder)
    dpc = cfg.duration_predictor
    dp = JDurationPredictor(in_channels=dpc.in_channels, filter_channels=dpc.filter_channels,
                            kernel_size=dpc.kernel_size, p_dropout=dpc.p_dropout,
                            spk_emb_dim=dpc.spk_emb_dim)
    dec = jdiff.UnitSpeech.from_config(cfg.decoder)
    key = jax.random.PRNGKey(0)
    t8, f = 8, cfg.decoder.n_feats
    return {
        "text_encoder": jax.eval_shape(te.init, key, jnp.zeros((1, 8), jnp.int32),
                                       jnp.array([8])),
        "duration_predictor": jax.eval_shape(
            lambda k: dp.init(k, jnp.zeros((1, 8, cfg.text_encoder.n_channels)),
                              jnp.ones((1, 8, 1)), g=jnp.zeros((1, dpc.spk_emb_dim)),
                              reverse=True), key),
        "decoder": jax.eval_shape(dec.init, key, jnp.zeros((1, t8, f)), jnp.ones((1, t8)),
                                  jnp.zeros((1, t8, f)), jnp.zeros((1,)),
                                  jnp.zeros((1, cfg.decoder.spk_emb_dim)))}


@pytest.fixture(scope="module")
def full_width():
    cfg = MainConfig()
    port = {"text_encoder": Encoder.from_config(cfg.text_encoder),
            "duration_predictor": DurationPredictor.from_config(cfg.duration_predictor),
            "decoder": tdiff.UnitSpeech.from_config(cfg.decoder)}
    return port, _jax_full_width_shapes()


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("module", ["decoder", "text_encoder", "duration_predictor"])
def test_tp_spec_tree_matches_jax_full_width(full_width, module, n):
    """The port's tp_spec_tree of each full-width STEP1 module, keyed by its
    parameter names, equals JAX's tp_spec_tree of the same module's
    parameters (their flax paths joined with '.') leaf by leaf, on a
    (8 / n, 1, n) mesh of the virtual devices; some leaves are sharded."""
    port, shapes = full_width
    mesh = jmake_mesh(data=8 // n, seq=1, model=n)
    jspecs = jtp_spec_tree(shapes[module], mesh)
    flat = jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda v: isinstance(v, P))[0]
    want = {}
    for path, spec in flat:
        keys = [str(getattr(k, "key", k)) for k in path]
        want[".".join(keys[1:] if keys[0] == "params" else keys)] = tuple(spec)
    got = tp_spec_tree(port[module], n)
    assert got == want
    assert sum(bool(s) for s in got.values()) >= 2


def test_model_shard_columns_and_refusals():
    """A ModelShard's columns, its refusal of widths the axis does not
    divide, the specs that name 'model' (ValueError: the axis shards
    parameters, not the sample), and K1's route on a slice it refuses: at
    model = 4 the 128-wide stage's slice is 32 columns, short of K1's
    64-column tile, so that site takes the plain Blocks (JAX's route when
    its gate fails), while the 256-wide stage keeps K1 (64 a rank) and the
    unsharded estimator takes K1 at both. The fused deep configuration,
    which a model-sharded estimator refused before it had sharded forms,
    keeps its kernels at model = 4 at full width: K9 and K8 at the deep
    sites of the unsharded routes (128 and 256 columns a rank, two groups),
    K11a at the 256-wide F = 40 downsample (64 a rank), and the library
    resample at the 128-wide F = 80 downsample and F = 40 upsample, whose
    32-column slices K11 does not take."""
    ms = ModelShard(1, 4)
    assert ms.cols(16) == slice(4, 8)
    assert torch.equal(ms.take(torch.arange(16.0)), torch.arange(4.0, 8.0))
    with pytest.raises(ValueError, match="do not split over the model axis"):
        ms.cols(6)
    for spec in (("data", "model", None), (None, "seq", "model"), ("model", None, None)):
        with pytest.raises(ValueError, match="shards the parameters"):
            sample_shard(object(), spec)
    est = GradLogPEstimator2d(dim=128, dim_mults=(1, 2, 4, 8), groups=8, spk_emb_dim=8,
                              n_feats=80)
    whole = {name: est.get_submodule(name).route(344 >> lvl, 80 >> lvl, True)
             for name, lvl in (("down_0_res2", 0), ("down_1_res2", 1))}
    shard_params_tp(est, ModelShard(0, 4))
    assert est.down_0_res2.block1.conv.kernel.shape == (3, 3, 128, 32)
    assert est.down_0_res2.widths() == (128, 128)
    sliced = {name: est.get_submodule(name).route(344 >> lvl, 80 >> lvl, True)
              for name, lvl in (("down_0_res2", 0), ("down_1_res2", 1))}
    assert whole == {"down_0_res2": "k1", "down_1_res2": "k1"}
    assert sliced == {"down_0_res2": "blocks", "down_1_res2": "k1"}
    deep = {name: (lvl, est.get_submodule(name)) for name, lvl in (
        ("down_2_res1", 2), ("down_3_res1", 3), ("mid_res1", 3), ("up_2_res1", 3),
        ("up_1_res1", 2))}
    routes = {name: b.route(344 >> lvl, 80 >> lvl, True, True, True, True)
              for name, (lvl, b) in deep.items()}
    assert routes == {"down_2_res1": "k9", "down_3_res1": "k8", "mid_res1": "k8",
                      "up_2_res1": "k9", "up_1_res1": "k9"}
    est.use_resample = True
    h = torch.zeros(1, 344, 80, 1)
    assert [est.resamples(est.get_submodule(n), h[:, :344 >> lvl, :80 >> lvl], i, None, gate)
            for n, i, lvl, gate in (("down_0_down", 0, 0, resample.supports_downsample),
                                    ("down_1_down", 1, 1, resample.supports_downsample),
                                    ("up_0_up", 0, 1, resample.supports_upsample))] == [
        False, True, False]


# --- the multi-rank cases --------------------------------------------------------


def _site_inputs():
    rng = np.random.default_rng(24)
    t, f, c = 24, 8, 32
    lens = np.array([t, 11, t - 5])

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    def block(cin, cout, groups):
        return {"t_bias": r(3, cout), "w1": r(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
                "b1": r(cout, scale=0.1), "gn1_scale": 1 + r(cout, scale=0.1),
                "gn1_bias": r(cout, scale=0.1),
                "w2": r(3, 3, cout, cout, scale=(9 * cout) ** -0.5), "b2": r(cout, scale=0.1),
                "gn2_scale": 1 + r(cout, scale=0.1), "gn2_bias": r(cout, scale=0.1),
                "wres": None if cin == cout else r(1, 1, cin, cout, scale=cin ** -0.5),
                "bres": None if cin == cout else r(cout, scale=0.1), "groups": groups}

    mods = {}
    for name, cls, kw in (("decoder", tdiff.UnitSpeech, {k: v for k, v in DEC.items()
                                                         if k != "beta_max"}),
                          ("text_encoder", Encoder, TRAIN_TE),
                          ("duration_predictor", DurationPredictor, TRAIN_DP)):
        m = cls(**kw)
        sd = {k: v.to(torch.float32) for k, v in _random_state_dict(rng, m).items()}
        mods[name] = (cls, kw, sd)
    route_sd, route_args = _route_case(np.random.default_rng(128))
    out = {"z": r(3, t, f, c), "mask": torch.from_numpy(_mask(t, lens)),
            "lens": torch.from_numpy(lens), "w": r(3, 3, c, 48, scale=(9 * c) ** -0.5),
            "blocks": {"Cin 2": block(2, c, 4), "Cin 32": block(c, c, 4),
                       "one group over both ranks": block(c, c, 1)},
            "final": {"w1": r(3, 3, c, c, scale=(9 * c) ** -0.5), "b1": r(c, scale=0.1),
                      "s1": 1 + r(c, scale=0.1), "be1": r(c, scale=0.1),
                      "wo": r(1, 1, c, 1, scale=c ** -0.5), "bo": r(1, scale=0.1)},
            "attn": (r(128, 384, scale=128 ** -0.5), r(128, 128, scale=128 ** -0.5),
                     r(128, scale=0.1), torch.tensor([0.7])),
            "xa": r(2, 32, 32, 128), "modules": mods, "ROUTE_EST": ROUTE_EST,
            "route_state": route_sd, "route_args": route_args}
    return {**out, **_deep_site_inputs(rng, t, f, c)}


def _step1_case():
    """JAX's STEP1 step jitted on a (4, 1, 2) mesh with every module's
    parameters placed by shard_params_tp, its draws from the same key in
    the same program (tests/test_torch_port_parallel.py's _dp_step1 with
    TP placement), and what the port needs to replay it."""
    import optax

    from tests.test_torch_port_parallel import O0

    n_feats, spk, b, tx, ty = 16, 8, 4, 8, 24
    te, dp, dec = JEncoder(**TRAIN_TE), JDurationPredictor(**TRAIN_DP), jdiff.UnitSpeech(
        **TRAIN_DEC)

    def init_all(key):
        k1, k2, k3 = jax.random.split(key, 3)
        return {"text_encoder": te.init(k1, jnp.zeros((1, 6), jnp.int32), jnp.array([6])),
                "duration_predictor": dp.init(k2, jnp.zeros((1, 6, 16)), jnp.ones((1, 6, 1)),
                                              g=jnp.zeros((1, spk)), reverse=True),
                "decoder": dec.init(k3, jnp.zeros((1, 8, n_feats)), jnp.ones((1, 8)),
                                    jnp.zeros((1, 8, n_feats)), jnp.zeros((1,)),
                                    jnp.zeros((1, spk)))}

    key = jax.random.PRNGKey(0)
    init = jax.jit(init_all).lower(key).compile(**O0)(key)
    params = {k: jax.device_get(randomize(v, i + 21)) for i, (k, v) in enumerate(init.items())}
    params["decoder"] = jax.device_get(scale_gates(params["decoder"], 0.1))
    rng = np.random.default_rng(24)
    # the port's data ranks hold rows {0, 2} and {1, 3}: lengths differ
    batch = {"tokens": rng.integers(1, 40, (b, tx)).astype(np.int32),
             "token_lengths": np.array([tx, tx - 2, tx - 1, tx - 3], np.int32),
             "mel": rng.uniform(-1, 1, (b, ty, n_feats)).astype(np.float32),
             "mel_lengths": np.array([ty, 20, 22, 17], np.int32),
             "spk_emb": rng.standard_normal((b, spk)).astype(np.float32)}
    spk_uncond = rng.standard_normal(spk).astype(np.float32)

    def draws(p, bt, k):
        k_cfg, k_te, k_dp, k_crop, k_diff = jax.random.split(k, 5)
        key_t, key_z = jax.random.split(k_diff)
        te_masks, (_, hidden, x_mask) = _masked(te, p["text_encoder"], bt["tokens"],
                                                bt["token_lengths"], key=k_te)
        dp_masks, _ = _masked(dp, p["duration_predictor"], hidden, x_mask, g=bt["spk_emb"],
                              reverse=True, key=k_dp)
        return {"perm": jax.random.permutation(k_cfg, b), "te": te_masks, "dp": dp_masks,
                "u": jax.random.uniform(k_crop, (b,)), "t": jax.random.uniform(key_t, (b,)),
                "z": jax.random.normal(key_z, (b, SEG, n_feats))}

    mesh = jmake_mesh(data=4, seq=1, model=2)
    opt = optax.adam(LR)
    step = jsteps.make_step1_train_step(te, dp, dec, opt, out_size=SEG,
                                        spk_uncond=jnp.asarray(spk_uncond))
    placed = jshard_params_tp(jax.tree_util.tree_map(jnp.asarray, params), mesh)
    n_sharded = sum(any(a == "model" for a in tuple(x.sharding.spec or ()))
                    for x in jax.tree_util.tree_leaves(placed))
    state = jsteps.TrainState(placed, opt.init(placed), jnp.array(0))
    jb = jshard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    key = jax.random.PRNGKey(33)
    run = jax.jit(lambda st, bt, k: (draws(st.params, bt, k), step(st, bt, k)))
    d, (state, metrics) = run.lower(state, jb, key).compile(**O0)(state, jb, key)
    d = jax.device_get(d)

    def t_(x):
        x = np.asarray(x)
        t = torch.from_numpy(np.array(x))
        return t.long() if x.dtype.kind == "i" else t

    port_draws = {k: t_(v) for k, v in d.items() if k not in ("te", "dp")}
    port_draws.update(te=[t_(m) for m in d["te"]], dp=[t_(m) for m in d["dp"]])
    names = ("text_encoder", "duration_predictor", "decoder")
    return {"state": [params_from_jax(params[k]) for k in names],
            "after": [params_from_jax(jax.device_get(state.params[k])) for k in names],
            "metrics": {k: float(v) for k, v in metrics.items()}, "n_sharded": n_sharded,
            "batch": {k: t_(v) for k, v in batch.items()}, "draws": port_draws,
            "spk_uncond": torch.from_numpy(spk_uncond), "TE": TRAIN_TE, "DP": TRAIN_DP,
            "DEC": TRAIN_DEC, "lr": LR, "seg": SEG, "layout": STEP_LAYOUT}


def _step1_port(s):
    mods = [Encoder(**s["TE"]), DurationPredictor(**s["DP"]), tdiff.UnitSpeech(**s["DEC"])]
    for m, sd in zip(mods, s["state"]):
        m.load_state_dict(sd)
    return mods


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """The world-2 ranks ((1, 1, 2): the sites, the samplers unsharded and
    sharded, the Synthesizer) and the world-4 ranks ((1, 2, 2): the
    samplers and the Synthesizer; then (2, 1, 2): the STEP1 step), started
    first (the world-4 ranks after JAX's STEP1 step, whose draws they
    replay); then JAX's samplers with shard_params_tp, and the port's
    Synthesizer and STEP1 step at world 1, on the same weights and
    inputs."""
    rng = np.random.default_rng(7)
    z = rng.standard_normal((B, T, 16)).astype(np.float32)
    mask = _mask(T, [T, 41])
    cond = rng.standard_normal((B, T, 16)).astype(np.float32)
    spk = rng.standard_normal((B, 8)).astype(np.float32)
    noises = rng.standard_normal((STEPS_TP, B, T, 16)).astype(np.float32)
    jm = jdiff.UnitSpeech(**{k: v for k, v in DEC.items() if k != "beta_max"})
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), z, mask, cond,
                            np.zeros(B, np.float32), spk)
    params = jax.device_get(scale_gates(randomize(shapes, 5), 0.003))
    key = jax.random.PRNGKey(12)
    fold_in = _jax_noises(key, STEPS_TP, z.shape)
    args = [torch.from_numpy(a) for a in (z, mask, cond, spk)]
    kw = dict(n_timesteps=STEPS_TP, text_gradient_scale=1.0, spk_gradient_scale=1.0)
    dec_state = params_from_jax(params)
    ckpt = random_params(tiny_config(), 24)
    voices = rng.standard_normal((len(SEQS), 8)).astype(np.float32)
    voices /= np.linalg.norm(voices, axis=1, keepdims=True)
    frames = [2 * len(q) for q in SEQS]
    y_pad = choose_bucket(fix_len_compatibility(max(frames), 1), default_frame_buckets(4096))
    assert y_pad % 8 == 0 and y_pad >= 16
    synth_kw = {"diffusion_steps": STEPS, "spk": voices,
                "durations": [np.full(len(q), 2.0, np.float32) for q in SEQS],
                "noise_z": torch.from_numpy(rng.standard_normal(
                    (len(SEQS), y_pad, 16)).astype(np.float32)),
                "noises": torch.from_numpy(rng.standard_normal(
                    (STEPS, len(SEQS), y_pad, 16)).astype(np.float32)),
                "text_gradient_scale": 1.0, "spk_gradient_scale": 1.0}
    common = {"DEC": DEC, "dec_state": dec_state, "sampler_args": args, "sampler_kw": kw,
              "noises": torch.from_numpy(noises), "fold_in_noises": torch.from_numpy(fold_in),
              "ckpt": ckpt, "seqs": SEQS, "synth_kw": synth_kw}
    outs, step1 = {}, None
    for name, (layout, spec) in LAYOUTS.items():
        if layout == (1, 1, 2):
            extra = {"sites": _site_inputs(), "world1": True}
        else:
            step1 = _step1_case()
            extra = {"step1": step1}
        extra["deep"] = DEEP_RUNS[name]
        outs[name] = _start(tmp_path_factory.mktemp("tp"), int(np.prod(layout)),
                            {**common, **extra, "layout": layout, "spec": spec})
    jax_mels = {}
    for name, (_, spec) in LAYOUTS.items():
        layout = JAX_LAYOUTS[name]
        mesh = jmake_mesh(data=layout[0], seq=layout[1], model=layout[2],
                          devices=jax.devices()[:int(np.prod(layout))])
        tp_params = jshard_params_tp(params, mesh)
        jkw = dict(kw, beta_max=DEC["beta_max"])
        if spec is not None:
            jkw.update(mesh=mesh, sample_spec=P(*spec))
        run = {"ddpm": lambda: jdiff.reverse_diffusion(jm.apply, tp_params, z, mask, cond, spk,
                                                      key, noises=jnp.asarray(noises), **jkw),
               "ddpm:cs2": lambda: jdiff.reverse_diffusion(jm.apply, tp_params, z, mask, cond,
                                                          spk, key, cfg_stride=2, **jkw),
               "dpm2": lambda: jdiff.reverse_diffusion_ode(jm.apply, tp_params, z, mask, cond,
                                                          spk, **jkw)}
        jax_mels[name] = {k: np.asarray(run[k]()) for k in JAX_SAMPLERS[name]}
    # the fused deep paths, with JAX's TP placement on the model = 2 mesh
    mesh = jmake_mesh(data=1, seq=1, model=2, devices=jax.devices()[:2])
    tp_params = jshard_params_tp(params, mesh)
    jkw = dict(kw, beta_max=DEC["beta_max"])
    jax_mels["deep"] = {}
    for path, flags in JAX_DEEP.items():
        jd = jdiff.UnitSpeech(**{k: v for k, v in DEC.items() if k != "beta_max"}, **flags)
        jax_mels["deep"][f"{path} ddpm"] = np.asarray(jdiff.reverse_diffusion(
            jd.apply, tp_params, z, mask, cond, spk, key, noises=jnp.asarray(noises), **jkw))
        jax_mels["deep"][f"{path} dpm2"] = np.asarray(jdiff.reverse_diffusion_ode(
            jd.apply, tp_params, z, mask, cond, spk, **jkw))
    single = ttts.Synthesizer(ttts.TTSModels.from_checkpoint(ckpt, device="cpu",
                                                             dtype=torch.float32))
    synth_mel, synth_len = single.synthesize_mel_batch(SEQS, **synth_kw)
    mods = _step1_port(step1)
    opt = torch.optim.Adam([p for m in mods for p in m.parameters()], lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    one = tsteps.make_step1_train_step(*mods, opt, SEG, step1["spk_uncond"])(
        step1["batch"], draws=step1["draws"])
    first = _step1_port(step1)
    tsteps.step1_loss(*first, step1["batch"], SEG, step1["spk_uncond"],
                      draws=step1["draws"])[0].backward()
    ranks = {name: o() for name, o in outs.items()}
    return {"ranks": ranks, "jax": jax_mels, "world1": ranks["model 2"][0]["world1"],
            "synth": (synth_mel, synth_len), "ckpt": ckpt,
            "step1": {"case": step1, "one": {k: v.item() for k, v in one.items()},
                      "after": [{k: p.detach() for k, p in m.named_parameters()} for m in mods],
                      "grads": [{k: p.grad for k, p in m.named_parameters()} for m in first]}}


SITES = ("layer Dense", "layer Conv1d", "layer Conv1d ncw", "layer Conv2d", "layer Conv2d stride 2",
         "layer ConvTranspose2d", "layer ConvTranspose1d", "Dense grad input", "Dense grad kernel",
         "Dense grad bias", "group_mean_inv groups 4", "group_mean_inv groups 3",
         "conv3x3_rows bf16", "conv3x3_int8", "K1 chain Cin 2", "K1 chain Cin 32",
         "K1 chain one group over both ranks", "K2 chain", "attention K4 whole",
         "attention plain", "flat block", "flat block grad input",
         "flat block grad GroupNorm scale", "flat block grad conv2 kernel",
         "flat block grad FiLM kernel")
# equal bit for bit: the int8 conv's slice (identical int8 operands, exact
# int32 products, the same scales)
EXACT = ("conv3x3_int8",)


@pytest.mark.parametrize("site", SITES)
def test_tp_site_matches_whole(tp_runs, site):
    """Each site's model form on both ranks of (1, 1, 2) against the site
    whole (the rank's columns where the form returns them): every layer
    gathered; a Dense under autograd (the input's gradient summed over the
    axis by enter's backward, the kernel's and bias's the rank's columns of
    the whole ones); K3's statistics of whole groups (2 a rank) and of
    groups of 4 over 6-channel slices (the sums gathered before the fold);
    the flat convs on a Cout slice; K1's chain with the 1x1 residual, the
    identity (x's own columns) and one group over both ranks; K2's partial
    dots summed; K4 whole on every rank from weights gathered at pack, and
    the plain attention's two gathered projections; a flat (deep-stage)
    block as training runs it, under autograd: its output, the input's
    gradient and the replicated GroupNorm scale's (every rank's share
    summed by enter's backward), conv2's and the FiLM kernel's the rank's
    columns of the whole ones. The stated tolerance, EXACT bit for bit."""
    for o in tp_runs["ranks"]["model 2"]:
        got, want = o["sites"]["pairs"][site]
        assert got.shape == want.shape, site
        if site in EXACT:
            assert torch.equal(got, want), site
        else:
            _close(got.float(), want.float())


def test_tp_site_collectives(tp_runs):
    """The sites' model collectives on every rank, exactly: 1 the
    straddling groups' statistics (their sums gathered; whole groups none),
    2 each K1 chain (h and the output) and 2 more for the one whose group
    straddles the ranks (each statistics' sums), 1 K2's partial dots, 3 a
    K4 site's pack (its three weights gathered once; the call none) and 3
    + 2 the plain attention's (its pack, then its two projections)."""
    for o in tp_runs["ranks"]["model 2"]:
        assert o["sites"]["collectives"] == 1 + (2 + 2 + 4) + 1 + 3 + (3 + 2)


@pytest.mark.parametrize("module", ["decoder", "text_encoder", "duration_predictor"])
def test_tp_round_trip_bit_for_bit(tp_runs, module):
    """shard_params_tp then gather_params_tp gives every parameter back bit
    for bit, on both ranks, with the kernels and their biases sharded."""
    for o in tp_runs["ranks"]["model 2"]:
        same, n_sharded = o["sites"]["round_trip"][module]
        assert same and n_sharded > 2


def test_tp_estimator_routes_keep_their_kernels(tp_runs):
    """One call of the dim-128 route estimator (kernels, int8 deep convs,
    bf16) sharded over model = 2, under the route stand-ins (each
    wrapper's CUDA branch against the stub library, then its plain
    version): K1 at the six sites of the unsharded call (every slice of 64
    or 128 columns takes it), K2, K4 at its one site, the flat int8 blocks'
    18 convs and every GroupNorm's statistics (K3); the model collectives
    chip_smoke.model_collectives_per_call's plus each stand-in's CUDA
    branch (2 a K1 call, 1 a K2); the score against the unsharded call
    within bf16's and int8's steps (tests/test_torch_port_seq.py's bound:
    largest difference 2^-4 and mean 2^-8 of the largest magnitude)."""
    import chip_smoke

    est = GradLogPEstimator2d(**ROUTE_EST)
    shard_params_tp(est, ModelShard(0, 2))  # the routes read the slice's widths alone
    est.use_kernels = est.use_int8_deep = True
    want = chip_smoke.model_collectives_per_call(est, T)
    for o in tp_runs["ranks"]["model 2"]:
        s = o["sites"]
        names = [n for n, _, _ in s["calls"]]
        assert [w for n, w, _ in s["calls"] if n == "fused_resnet_block"] == [2, 128, 128, 256,
                                                                               512, 128]
        assert names.count("fused_final_block") == 1
        assert [w for n, w, _ in s["calls"] if n == "fused_rezero_attention"] == [128]
        assert names.count("conv3x3_int8") == 2 * 9
        assert names.count("group_mean_inv") == 2 * 9 + 2
        assert s["route_collectives"] == want + 2 * 6 + 1
        assert s["routes"] == {"down_0_res1": "k1", "down_1_res1": "k1", "down_2_res1": "flat",
                               "up_0_res1": "k1"}
        score, whole = s["score"].float(), s["whole"].float()
        err, top = (score - whole).abs(), whole.abs().max()
        assert torch.isfinite(score).all() and score.shape == whole.shape
        assert err.max() <= 2.0 ** -4 * top and err.mean() <= 2.0 ** -8 * top


CASES = [(layout, path, sampler) for layout in LAYOUTS for path in ("plain", "kernels")
         for sampler in SAMPLERS]


@pytest.mark.parametrize("layout,path,sampler", CASES)
def test_tp_sampler_matches_world_1(tp_runs, layout, path, sampler):
    """Every rank's sample with the model-sharded decoder against the
    port's unsharded one (the same path and injected draws), the stated
    tolerance; the padded frames zero."""
    want = tp_runs["world1"][path][sampler]
    assert torch.isfinite(want).all()
    for o in tp_runs["ranks"][layout]:
        got = o["mels"][path][sampler]
        _close(got, want)
        np.testing.assert_array_equal(got[1, 41:].numpy(), 0.0)


@pytest.mark.parametrize("layout,path,sampler", [
    (layout, path, sampler) for layout in LAYOUTS for path in ("plain", "kernels")
    for sampler in JAX_SAMPLERS[layout]])
def test_tp_sampler_matches_jax_tp(tp_runs, layout, path, sampler):
    """The port's model-sharded sampler against JAX's reverse_diffusion
    with shard_params_tp on JAX_LAYOUTS' mesh of the virtual devices ((1,
    1, 2); (1, 4, 2) with P(None, "seq", None)), the stated tolerance."""
    want = tp_runs["jax"][layout][sampler]
    assert np.isfinite(want).all() and np.abs(want).max() > 1.0
    for o in tp_runs["ranks"][layout]:
        _close(o["mels"][path][sampler], want)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_synthesizer_matches_world_1(tp_runs, layout):
    """The Synthesizer's batch path (4 requests, per-row voices, forced
    durations, injected noise) with a model-sharded decoder ((1, 1, 2) with
    no spec; (1, 2, 2) with (None, "seq", None)) against the port at world
    1: the lengths equal, the mel within the mel tolerance."""
    want, want_len = tp_runs["synth"]
    tol = _mel_tol(tp_runs["ckpt"])
    for o in tp_runs["ranks"][layout]:
        np.testing.assert_array_equal(o["y_lengths"], want_len)
        np.testing.assert_allclose(o["mel"].numpy(), want.numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_refusals(tp_runs, layout):
    """On every rank: a spec naming 'model' raises ValueError. The bf16 deep
    configuration (use_deep) on a model-sharded decoder, which raised
    before the deep kernels had model forms, runs: the decoder's call takes
    K8's model form at its six deep sites (down_3 res1/res2, mid res1/res2,
    up_2_res1, up_1_res1: max(Cin, Cout) >= 512; 256, 128 or 64 columns a
    rank, four groups)."""
    for o in tp_runs["ranks"][layout]:
        deep, spec = o["refused"]
        assert deep is None  # the deep decoder's call ran
        assert o["deep_calls"] == [(w, True) for w in (256, 512, 512, 512, 1024, 512)]
        assert spec is not None and spec.startswith("ValueError") and "parameters" in spec


DEEP_SITES = ("K8 Cin 32", "K9 Cin 32", "K9 Cin 64, conv1 bf16", "K9 zero-length row, max 1e-3",
              "K11a", "K11b")


@pytest.mark.parametrize("site", DEEP_SITES)
def test_tp_deep_site_matches_whole(tp_runs, site):
    """The fused deep configuration's model forms on both ranks of (1, 1, 2)
    (each rank's Cout columns of the weights, quant_w of its columns, the
    output gathered) against the unsharded plain forms on the whole input:
    K8 (K1's chain), K9's chain (Cin = Cout; Cin > Cout with conv1 in bf16;
    a zero-length row with max|x| = 1e-3), K11a and K11b. The stated
    tolerance, K9's chains the int8 bound (_int8_close). Model collectives
    of the six: K8 2 (h, output), K9 3 each (h's maxima, h8, output), K11
    1 each."""
    for o in tp_runs["ranks"]["model 2"]:
        got, want = o["sites"]["deep_pairs"][site]
        assert got.shape == want.shape, site
        if site.startswith("K9"):
            _int8_close(got, want)
        else:
            _close(got.float(), want.float())
        assert o["sites"]["deep_pairs_collectives"] == 2 + 3 * 3 + 2


def test_tp_deep_estimator_routes_keep_their_kernels(tp_runs):
    """One call of the dim-128 route estimator on the fused deep
    configuration (kernels, int8, use_deep, use_resample, use_i8pre_deep,
    bf16) sharded over model = 2, under the route stand-ins: K9's model
    form at the five deep sites with Cout <= 512, K8's at the four 1
    024-wide ones, K11a at F = 16 and 8 and K11b at F = 8 (64 or 128
    columns a rank), K1 at its six sites, K2, K4; no flat block. The model
    collectives are chip_smoke.model_collectives_per_call's plus each
    stand-in's CUDA branch (2 a K1 or K8 call, 3 a K9 call, 1 a K11 call, 1
    a K2); the score against the unsharded call within the route tests'
    bf16 and int8 bound."""
    import chip_smoke

    est = GradLogPEstimator2d(**ROUTE_EST)
    shard_params_tp(est, ModelShard(0, 2))  # the routes read the slice's widths alone
    est.use_kernels = est.use_int8_deep = est.use_deep = est.use_resample = True
    est.use_i8pre_deep = True
    want = chip_smoke.model_collectives_per_call(est, T)
    for o in tp_runs["ranks"]["model 2"]:
        d = o["sites"]["deep_i8"]
        widths = {n: [w for m, w, _ in d["calls"] if m == n] for n, _, _ in d["calls"]}
        # every kernel call got the model shard but K4 (whole on every rank)
        # and the plain Blocks' statistics (their conv gathered its columns)
        assert all(sharded for n, _, sharded in d["calls"]
                   if n not in ("fused_rezero_attention", "group_mean_inv"))
        assert widths["fused_resnet_block_deep_i8"] == [256, 512, 2048, 512, 1024]
        assert widths["fused_resnet_block_deep"] == [512, 1024, 1024, 1024]
        assert widths["fused_downsample_conv"] == [128, 256]
        assert widths["fused_upsample_conv"] == [128]
        assert widths["fused_resnet_block"] == [2, 128, 128, 256, 512, 128]
        assert "conv3x3_int8" not in widths
        branch = 2 * 6 + 1 + 2 * 4 + 3 * 5 + 3
        assert d["collectives"] == (0, want + branch)
        score, whole = d["score"].float(), d["whole"].float()
        err, top = (score - whole).abs(), whole.abs().max()
        assert torch.isfinite(score).all() and score.shape == whole.shape
        assert err.max() <= 2.0 ** -4 * top and err.mean() <= 2.0 ** -8 * top


@pytest.mark.parametrize("layout,path,sampler", [
    (layout, path, sampler) for layout, (paths, samplers) in DEEP_RUNS.items()
    for path in paths for sampler in samplers])
def test_tp_deep_sampler_matches_jax_and_world_1(tp_runs, layout, path, sampler):
    """ddpm and dpm2 on the fused deep configuration with a model-sharded
    decoder ((1, 1, 2) both paths; (1, 2, 2) with (None, "seq", None) the
    int8 path's ddpm) against JAX's reverse_diffusion with use_pallas_deep,
    use_pallas_resample (and use_int8_deep, use_i8pre_deep) and
    shard_params_tp on its (1, 1, 2) mesh (its Pallas kernels in interpret
    mode; for (1, 2, 2) the same JAX run: its TP sample is the replicated
    program's) and against the port's unsharded sample (computed on the
    (1, 1, 2) ranks): the bf16 route (K8, f32 here) within the stated
    tolerance, the int8 one (K9) within _int8_sampler_close of the int8
    sample, the deep bf16-route sample of the same side the f32 reference;
    the padded frames zero."""
    key = f"{path} {sampler}"
    jax_want, jax_ref = (tp_runs["jax"]["deep"][f"{p} {sampler}"] for p in (path, "deep"))
    w1 = tp_runs["world1"]["deep"]
    assert np.isfinite(jax_want).all() and np.abs(jax_want).max() > 1.0
    for o in tp_runs["ranks"][layout]:
        got = o["mels"]["deep"][key]
        if path == "deep":
            _close(got, jax_want)
            _close(got, w1[key])
        else:
            _int8_sampler_close(got, jax_want, jax_ref)
            _int8_sampler_close(got, w1[key], w1[f"deep {sampler}"])
        np.testing.assert_array_equal(got[1, 41:].numpy(), 0.0)


def test_tp_int8_weights_are_the_whole_columns():
    """quant_w's per-output-channel scales are column-local: after
    shard_params_tp at model = 2 every K9 block's int8 weights and
    reciprocal scales on each rank equal the whole block's columns bit for
    bit, its packed tiles are pack_block_weights_i8 of those columns (conv1
    in bf16 by the block's global widths), and K11's packed kernels are the
    pack of the rank's columns, where K11 takes them (the 64-wide F = 16
    stage's 32 columns it does not: None)."""
    from tests.test_torch_port_deep import DIM64, PORT_FLAGS

    rng = np.random.default_rng(25)
    make = lambda: GradLogPEstimator2d(**DIM64, n_feats=16, **PORT_FLAGS["deep_i8"])  # noqa
    sd = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.1)
          for k, v in make().state_dict().items()}
    whole = make()
    whole.load_state_dict(sd)
    k9 = [n for n, m in whole.named_modules() if getattr(m, "packed_for", None) == "k9"]
    assert len(k9) == 6
    for rank in range(2):
        ms = ModelShard(rank, 2)
        est = make()
        est.load_state_dict(sd)
        shard_params_tp(est, ms)
        for name in k9:
            w, m = whole.get_submodule(name), est.get_submodule(name)
            assert m.packed_for == "k9"
            for (w8, rsw), (w8w, rsww) in zip(m.i8pre_weights, w.i8pre_weights):
                assert torch.equal(w8, ms.take(w8w, 0)) and torch.equal(rsw, ms.take(rsww, 0))
            cin, cout = w.widths()
            want = frd.pack_block_weights_i8(m.block1.conv.kernel, m.i8pre_weights,
                                             None if m.res_conv is None else m.res_conv.kernel,
                                             cin > cout)
            assert all(torch.equal(a, b) for a, b in zip(m.packed, want) if b is not None)
        for name, pack in (("down_0_down", None), ("down_1_down", resample.pack_downsample_weight),
                           ("up_0_up", None)):
            m = est.get_submodule(name)
            assert (m.packed is None) if pack is None else torch.equal(
                m.packed, pack(m.conv.kernel))


def test_tp_step1_matches_jax_and_world_1(tp_runs):
    """One DP x TP STEP1 step at (data 2, seq 1, model 2) (rows {0, 2} and
    {1, 3}, every module sharded) against JAX's step on (4, 1, 2) with
    shard_params_tp and JAX's draws, and against the port at world 1: the
    losses within 1e-5 relative and the pre-clip norms within 1e-4 (every
    rank reports the global batch's), every rank's gathered parameters
    equal bit for bit and held to JAX's and to the world-1 step's by the
    port's Adam rule (tests/test_torch_port_parallel.py)."""
    s = tp_runs["step1"]
    case = s["case"]
    assert case["n_sharded"] > 10
    outs = [o["step1"] for o in tp_runs["ranks"]["seq 2 x model 2"]]
    assert sorted(o["at"] for o in outs) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for k, v in case["metrics"].items():
        tol = 1e-4 if k.startswith("grad_norm") else 1e-5
        for o in outs:
            np.testing.assert_allclose(o["metrics"][k], v, rtol=tol, err_msg=k)
            np.testing.assert_allclose(o["metrics"][k], s["one"][k], rtol=tol, err_msg=k)
    names = ("text_encoder", "duration_predictor", "decoder")
    for i, name in enumerate(names):
        a = outs[0]["params"][i]
        assert all(torch.equal(a[k], o["params"][i][k]) for o in outs[1:] for k in a), name
        _held_like_jax(a, case["after"][i], case["state"][i], s["grads"][i], 1, name)
        _held_like_jax(a, s["after"][i], case["state"][i], s["grads"][i], 1,
                       f"{name} at world 1")


def test_tp_clip_counts_sharded_squares_once():
    """clip_params_by_global_norm: a sharded parameter's squares summed over
    its model axis (p.tp; one rank here: its own), a replicated one's once;
    without a sharded parameter clip_by_global_norm, the one norm of the
    old code; the step finds the axis on the parameters."""
    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
    ps = [torch.nn.Parameter(torch.zeros(t.shape)) for t in g]
    for p, t in zip(ps, g):
        p.grad = t.clone()
    assert not is_sharded(ps[0])
    ps[0].tp = ModelShard()
    assert is_sharded(ps[0]) and not is_sharded(ps[1])
    n = tsteps.clip_params_by_global_norm(ps + [torch.nn.Parameter(torch.zeros(1))], 1e9)
    assert n.item() == 13.0 and torch.equal(ps[0].grad, g[0])
    assert tsteps.clip_by_global_norm([t.clone() for t in g], 1e9).item() == 13.0
    ps[0].tp = None
    assert tsteps.clip_params_by_global_norm(ps, 1.0).item() == 13.0
    assert torch.allclose(ps[1].grad, g[1] / (13.0 + 1e-6))
    assert dataclasses.is_dataclass(ModelShard)
