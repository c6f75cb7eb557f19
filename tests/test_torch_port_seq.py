"""The sequence-sharded sampler in the port against the JAX package on the
CPU: the seq axis's split, halos, gather and draws; each sharded form
(K3's statistics summed over the axis, the halo'd flat convs with K7's
global int8 scale, K4's merged partials, K1's and K2's host chains in the
card's launch order) against the same function unsharded; the samplers
(ddpm with dual guidance and injected noise, ddpm:cs2 with JAX's fold_in
draws, dpm2, dpm2:cs2) through a (data 1, seq 2) mesh at world 2 against
JAX's on make_mesh(data=1, seq=2) with P(None, "seq", None) and against
the port at world 1; the same for ddpm and dpm2 on the fused deep
configuration (use_deep and use_resample, bf16 K8; with use_int8_deep and
use_i8pre_deep, K9), JAX's with use_pallas_deep, use_pallas_resample and
use_i8pre_deep (its Pallas kernels in interpret mode under GSPMD on the
virtual devices); K8's, K9's and K11's sharded plain forms; the
estimator's routes on a seq slice (every kernel site's sharded form, the
gates at the global frames), the fused deep configuration's too; the
Synthesizer on a (data 2, seq 2) mesh at world 4, with and without the
fused deep configuration; and the spec that still refuses.

Each multi-rank case runs gloo ranks on the CPU in spawned processes
(parallel.run_group; their code is tests/_parallel_workers.py, which
imports only the port), joined through a file under the case's directory,
one torch thread each, killed and failed at the case's time limit. The
JAX side runs here on the virtual devices of tests/conftest.py.

The sampler estimator is the 4-stage one at dim 64, F = 16, T = 64 (slices
32 + 32) with small rezero gates, f32, on the kernel routes (the kernels'
plain versions on the CPU), with beta_max = 2: with random weights the
score does not cancel the state, which DPM-Solver's x0 = x / alpha grows by
1 / alpha of the first step (e^5 at beta_max 20, enough to overflow the
linear attentions within four steps). Tolerance: 1e-5 absolute plus 1e-4
of the largest magnitude (the unsharded sampler tests'; f32 sums in
another order). The int8 deep path (K9) is held statistically
(`_int8_close`, `_int8_sampler_close`): a value within f32 round-off of a
.5 int8 boundary may take the other step, so two int8 runs whose f32 sums
run in another order agree only as tests/test_torch_port_int8.py and
tests/test_torch_port_deep.py hold them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tests import _parallel_workers as workers
from tests._torch_port import randomize, scale_gates
from tests.test_torch_port_tts import (  # noqa: F401 (slice_pair is a fixture)
    STEPS,
    TOKENS,
    _mel_tol,
    slice_pair,
)
from unitspeech_tpu.infer import tts as jtts
from unitspeech_tpu.models import diffusion as jdiff
from unitspeech_tpu.parallel import make_mesh as jmake_mesh
from unitspeech_tpu_torch.infer import tts as ttts
from unitspeech_tpu_torch.models import diffusion as tdiff
from unitspeech_tpu_torch.models.unet import GradLogPEstimator2d
from unitspeech_tpu_torch.ops.masking import choose_bucket, fix_len_compatibility
from unitspeech_tpu_torch.parallel import FrameSlice, Group, SeqShard, sample_shard
from unitspeech_tpu_torch.utils.params import _random_leaf, params_from_jax

# one intra-op thread: the suite's pytest workers share the CPU's cores
torch.set_num_threads(1)

TIMEOUT = 240.0  # a case's ranks, start to join (the JAX side runs meanwhile)
ATOL, RTOL = 1e-5, 1e-4
DEC = dict(n_feats=16, dim=64, dim_mults=(1, 2, 4, 8), groups=8, spk_emb_dim=8, beta_max=2.0)
B, T, STEPS_SEQ = 2, 64, 3
# the route estimator: dim 128, so that the 128-wide F = 16 stage passes
# K4's widths and its 1 024-token gate at 64 frames (not at a 32-frame slice)
ROUTE_EST = dict(dim=128, dim_mults=(1, 2, 4, 8), groups=8, spk_emb_dim=8, n_feats=16,
                 dtype=torch.bfloat16)
SAMPLERS = ("ddpm", "ddpm:cs2", "dpm2", "dpm2:cs2")
JAX_SAMPLERS = ("ddpm", "ddpm:cs2", "dpm2")
SEQS = [TOKENS, TOKENS[:7], TOKENS[3:7], TOKENS[2:11]]
# the fused deep configuration: JAX's switches and the port's, by path
JAX_DEEP = {"deep": dict(use_pallas_deep=True, use_pallas_resample=True),
            "deep_i8": dict(use_pallas_deep=True, use_pallas_resample=True, use_int8_deep=True,
                            use_i8pre_deep=True)}
DEEP_CASES = [(path, sampler) for path in JAX_DEEP for sampler in ("ddpm", "dpm2")]


def _close(got, want, atol=ATOL, rtol=RTOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=atol + rtol * np.abs(want).max())


def _int8_close(got, want):
    """An int8 block's sharded form against its unsharded one (K9's chains):
    their GroupNorm sums run in another order, so an h value within f32
    round-off of a .5 boundary may take the other int8 step, moving the
    conv2 outputs it reaches by max|w| max|h| / 127 before GroupNorm
    (tests/test_torch_port_int8.py's bound): the largest difference within
    1e-2 and the mean within 1e-4, each of max(1, max|want|); the elements
    beyond the f32 tolerance are counted and at most 1% of them."""
    got, want = (np.asarray(v, np.float64) for v in (got, want))
    err, top = np.abs(got - want), max(1.0, np.abs(want).max())
    assert err.max() <= 1e-2 * top and err.mean() <= 1e-4 * top, (err.max(), err.mean())
    assert (err > ATOL + RTOL * top).sum() <= 0.01 * err.size


def _int8_sampler_close(got, want, ref):
    """A sample on the int8 deep path (K9) against another int8 run `want`
    of the same function, ref the f32 (deep bf16-route) run of it: int8
    roundings flip where f32 sums run in another order and the sampler
    carries each flip on, so two int8 runs agree only statistically (JAX's
    own int8 samples on two meshes differ by half their distance to the f32
    one): `got` lies closer to `want` than `want` to ref (mean), its own
    distance to ref within 25% of want's (tests/test_torch_port_deep.py's
    bound), and no element off `want` by more than 1e-2 of max(1,
    max|want|)."""
    got, want, ref = (np.asarray(v, np.float64) for v in (got, want, ref))
    d_ref = np.abs(want - ref).mean()
    assert d_ref > 0 and np.abs(got - want).mean() < d_ref, (np.abs(got - want).mean(), d_ref)
    assert abs(np.abs(got - ref).mean() - d_ref) <= 0.25 * d_ref, (np.abs(got - ref).mean(),
                                                                   d_ref)
    assert np.abs(got - want).max() <= 1e-2 * max(1.0, np.abs(want).max())


def _deep_site_inputs(rng, t, f, c):
    """The fused deep configuration's sites at a primitives case's size (T,
    F, C; groups 4): K8 and K9 blocks on (3, T, F, C) inputs with lengths
    T, 11 and T - 5 (K9 also Cin = 2 C, conv1 in bf16, and max|x| = 1e-3 with
    a zero-length row), K11a's and K11b's kernels."""
    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    def block(cin, cout, x, lens):
        return {"x": x, "lens": torch.tensor(lens), "t_bias": r(3, cout),
                "w1": r(3, 3, cin, cout, scale=(9 * cin) ** -0.5), "b1": r(cout, scale=0.1),
                "s1": 1 + r(cout, scale=0.1), "be1": r(cout, scale=0.1),
                "w2": r(3, 3, cout, cout, scale=(9 * cout) ** -0.5), "b2": r(cout, scale=0.1),
                "s2": 1 + r(cout, scale=0.1), "be2": r(cout, scale=0.1),
                "wres": None if cin == cout else r(1, 1, cin, cout, scale=cin ** -0.5),
                "bres": None if cin == cout else r(cout, scale=0.1)}

    lens = [t, 11, t - 5]
    x, x2, small = r(3, t, f, c), r(3, t, f, 2 * c), r(3, t, f, c)
    small = small * (1e-3 / small.abs().max())
    return {"deep": {"K8 Cin 32": block(c, c, x, lens), "K9 Cin 32": block(c, c, x, lens),
                     "K9 Cin 64, conv1 bf16": block(2 * c, c, x2, lens),
                     "K9 zero-length row, max 1e-3": block(c, c, small, [t, 0, t - 5])},
            "down": (r(3, 3, c, c, scale=(9 * c) ** -0.5), r(c, scale=0.1)),
            "up": (r(4, 4, c, c, scale=(16 * c) ** -0.5), r(c, scale=0.1))}


def _start(fn, tmp_path, world, inputs):
    """fn started as `world` ranks over tmp_path after its inputs.pt; returns
    outs(), which joins them and checks that no rank imported JAX."""
    torch.save(inputs, tmp_path / "inputs.pt")
    group = Group(fn, world, (str(tmp_path),), timeout=TIMEOUT)
    got = []

    def outs():
        if not got:
            group.join()
            got.extend(torch.load(tmp_path / f"out{r}.pt", weights_only=False)
                       for r in range(world))
            assert all(o.pop("jax_free") for o in got), "a rank imported jax or unitspeech_tpu"
        return got

    return outs


def _mask(t, lens):
    return (np.arange(t)[None, :] < np.asarray(lens)[:, None]).astype(np.float32)


# --- the split ----------------------------------------------------------------


@pytest.mark.parametrize("t,size,want", [
    (344, 2, ((0, 176), (176, 168))),
    (344, 4, ((0, 88), (88, 88), (176, 88), (264, 80))),
    (64, 2, ((0, 32), (32, 32))),
    (24, 3, ((0, 8), (8, 8), (16, 8))),
])
def test_seq_split_whole_units(t, size, want):
    """Slices of whole 8-frame units, the first ranks one unit more; every
    level's slice is the one above halved, each level's slices tile it."""
    assert SeqShard(0, size).split(t) == want
    for r in range(size):
        fs = SeqShard(r, size).at(t)
        assert (fs.start, fs.length) == want[r]
        for level in range(1, 4):
            fs = fs.down()
            assert fs.t == t >> level and (fs.start, fs.length) == (
                want[r][0] >> level, want[r][1] >> level)
            assert sum(n for _, n in fs.bounds) == fs.t


@pytest.mark.parametrize("t,size", [(8, 2), (24, 4), (20, 2), (340, 2)])
def test_seq_split_refuses(t, size):
    """Fewer than 8 frames a rank, or T off the 8-frame grid, raise (T is
    never padded: GroupNorm would pool the padding)."""
    with pytest.raises(ValueError, match="whole slices of 8 frames"):
        SeqShard(0, size).split(t)


# --- the pieces and the sharded plain forms -----------------------------------


def _primitive_inputs(world):
    rng = np.random.default_rng(world)
    t = {2: 24, 3: 40}[world]
    f, c = 8, 32
    lens = np.array([t, 11, t - 5])
    shard = SeqShard(0, world)

    def r(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    def block(cin, cout):
        return {"t_bias": r(3, cout), "w1": r(3, 3, cin, cout, scale=(9 * cin) ** -0.5),
                "b1": r(cout, scale=0.1), "s1": 1 + r(cout, scale=0.1),
                "be1": r(cout, scale=0.1), "w2": r(3, 3, cout, cout, scale=(9 * cout) ** -0.5),
                "b2": r(cout, scale=0.1), "s2": 1 + r(cout, scale=0.1),
                "be2": r(cout, scale=0.1),
                "wres": None if cin == cout else r(cin, cout, scale=cin ** -0.5),
                "bres": None if cin == cout else r(cout, scale=0.1)}

    out = {"T": t, "bounds": shard.split(t), "z": r(3, t, f, c),
           "mask": torch.from_numpy(_mask(t, lens)), "lens": torch.from_numpy(lens),
           "w": r(3, 3, c, 48, scale=(9 * c) ** -0.5),
           "attn": (r(c, 384, scale=c ** -0.5), r(128, c, scale=128 ** -0.5),
                    r(c, scale=0.1), torch.tensor([0.7])),
           "blocks": {"Cin 2": block(2, c), "Cin 32": block(c, c)},
           "final": {"w1": r(3, 3, c, c, scale=(9 * c) ** -0.5), "b1": r(c, scale=0.1),
                     "s1": 1 + r(c, scale=0.1), "be1": r(c, scale=0.1),
                     "wo": r(c, scale=c ** -0.5), "bo": r(1, scale=0.1)}}
    return {**out, **_deep_site_inputs(rng, t, f, c)}


# (got, want) pairs equal bit for bit: the collectives' zero-filled sums and
# the int8 conv (identical int8 operands, exact int32 products)
EXACT = ("split", "halo 1 1", "halo 1 0", "halo 2 1", "halo masked edges", "gather", "cat",
         "randn", "down", "conv3x3_int8", "int8 scale")
# K9's chains: the int8 bound (_int8_close)
INT8_PAIRS = ("K9 Cin 32", "K9 Cin 64, conv1 bf16", "K9 zero-length row, max 1e-3")


@pytest.mark.parametrize("world", [2, 3])
def test_seq_pieces_and_sharded_plain_forms(tmp_path, world):
    """Each rank's halos (zeros beyond the global ends; one or two frames
    a side; the sent frames masked), its gather, an uneven cat and the
    world-size-free draws, at world 2 and 3 (slices 16 + 8 and 16 + 16 +
    8). At world 2 the sharded plain forms against the unsharded functions
    on the whole tensor, lengths ending in either slice and at the end:
    group_mean_inv, the flat bf16 conv, the int8 conv and its one scale
    (bit for bit), K4's merged partials, K1's chain (Cin 2 with the 1x1
    residual, Cin 32 with the identity) and K2's; the fused deep
    configuration's: K8 (K1's chain), K9's chain (Cin = Cout; Cin > Cout
    with conv1 in bf16 on K8's halo'd kernel A; a zero-length row with
    max|x| = 1e-3: its scale from the global rows, its rows zero), K11a
    (the one frame before the slice) and K11b (one a side). Collectives: 6
    on every rank (4 halos, the gather, the cat) plus 39 at world 2 (the
    statistics' sums 1, the bf16 conv's halo 1, the int8 conv's maxima and
    halo 2, the int8 scale's maxima 1, the partials 1, the two K1 chains 4
    each, K2's chain 2; K8's chain 4, K9's 6 + 5 + 6 (its input's maxima,
    the halos of x8 or x and h8, two tile-sum gathers, h's maxima; no input
    maxima where conv1 runs in bf16), K11a's and K11b's halos 1 each). The
    stated tolerance, EXACT bit for bit, K9's chains the int8 bound
    (_int8_close)."""
    outs = _start(workers.seq_primitives, tmp_path, world, _primitive_inputs(world))()
    for o in outs:
        pairs = o["pairs"]
        n_coll = pairs.pop("collectives")[0].item()
        assert n_coll == 6 + (39 if world == 2 else 0)
        if world == 2:
            assert {"group_mean_inv", "K4 merged partials", "K1 chain Cin 2", "K2 chain",
                    "K8 Cin 32", "K11a", "K11b", *INT8_PAIRS} <= set(pairs)
        for name, (got, want) in pairs.items():
            assert got.shape == want.shape, name
            if name in EXACT:
                assert torch.equal(got, want), name
            elif name in INT8_PAIRS:
                _int8_close(got, want)
            else:
                _close(got.float(), want.float())


def test_k4_partials_merge_in_any_grouping():
    """K4's plain twins keep the card's layout: partials over 128-row tiles
    q, q + p, ... (an empty one included, p > tiles) merge into the
    unsharded context, and merging the partials of two token ranges gives
    the whole sequence's."""
    from unitspeech_tpu_torch.ops import fused_attention as fa

    rng = np.random.default_rng(7)
    b, n, c = 2, 300, 128
    x = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    w_qkv = torch.from_numpy((rng.standard_normal((c, 384)) / c ** 0.5).astype(np.float32))
    w_out = torch.from_numpy((rng.standard_normal((128, c)) / 128 ** 0.5).astype(np.float32))
    b_out = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    g, lens = torch.tensor([0.7]), torch.tensor([n, 201])
    want = fa.rezero_attention_plain(x, w_qkv, w_out, b_out, g, lens, 4, 32)
    for p in (1, 2, 4):
        parts = fa.attn_kv_plain(x, w_qkv, p)
        assert parts[0].shape == (b, 2, p, 64) and parts[2].shape == (b, 2, p, 2, 32, 32)
        _close(fa.attn_merge_out_plain(x, w_qkv, w_out, b_out, g, lens, parts), want)
    assert torch.isinf(fa.attn_kv_plain(x, w_qkv, 4)[0][:, :, 3]).all()  # 3 tiles, 4 partials
    halves = [fa.attn_kv_plain(x[:, s], w_qkv, 1) for s in (slice(0, 160), slice(160, n))]
    parts = tuple(torch.cat([h[i] for h in halves], dim=2) for i in range(3))
    for rows, ln in ((slice(0, 160), [160, 160]), (slice(160, n), [140, 41])):
        _close(fa.attn_merge_out_plain(x[:, rows], w_qkv, w_out, b_out, g, torch.tensor(ln),
                                       parts), want[:, rows])


# --- the samplers and the estimator's routes at world 2 -----------------------


def _jax_noises(key, n, shape):
    """The strided DDPM's draws: normal(fold_in(key, i)) at step i."""
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i), shape))
                     for i in range(n)])


def _route_case(rng):
    est = GradLogPEstimator2d(**ROUTE_EST, use_kernels=True, use_int8_deep=True)
    sd = {k: torch.from_numpy(_random_leaf(rng, k, tuple(v.shape)).astype(np.float32))
          for k, v in est.state_dict().items()}
    for k in sd:
        if k.endswith(".g"):
            sd[k] *= 0.1
    x, mu = (torch.from_numpy(rng.standard_normal((2, T, 16)).astype(np.float32))
             for _ in range(2))
    mask = torch.from_numpy(_mask(T, [T, 41]))
    return sd, (x, mask, mu, torch.tensor([0.5, 0.2]), torch.zeros(2, 8))


@pytest.fixture(scope="module")
def seq_runs(tmp_path_factory):
    """The world-2 ranks' samplers (on the fused deep paths too) and route
    calls, the port at world 1 and JAX's samplers on its seq = 2 mesh, on
    the same weights and inputs."""
    rng = np.random.default_rng(3)
    z = rng.standard_normal((B, T, 16)).astype(np.float32)
    mask = _mask(T, [T, 41])
    cond = rng.standard_normal((B, T, 16)).astype(np.float32)
    spk = rng.standard_normal((B, 8)).astype(np.float32)
    noises = rng.standard_normal((STEPS_SEQ, B, T, 16)).astype(np.float32)
    jm = jdiff.UnitSpeech(**{k: v for k, v in DEC.items() if k != "beta_max"})
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), z, mask, cond,
                            np.zeros(B, np.float32), spk)
    params = jax.device_get(scale_gates(randomize(shapes, 4), 0.003))
    key = jax.random.PRNGKey(11)
    fold_in = _jax_noises(key, STEPS_SEQ, z.shape)
    route_sd, route_args = _route_case(np.random.default_rng(128))
    args = [torch.from_numpy(a) for a in (z, mask, cond, spk)]
    kw = dict(n_timesteps=STEPS_SEQ, text_gradient_scale=1.0, spk_gradient_scale=1.0)
    dec_state = params_from_jax(params)
    outs = _start(workers.seq_sampling, tmp_path_factory.mktemp("seq"), 2, {
        "DEC": DEC, "dec_state": dec_state, "sampler_args": args, "sampler_kw": kw,
        "noises": torch.from_numpy(noises), "fold_in_noises": torch.from_numpy(fold_in),
        "ROUTE_EST": ROUTE_EST, "route_state": route_sd, "route_args": route_args})
    port = tdiff.UnitSpeech(**DEC, use_kernels=True)
    port.load_state_dict(dec_state)
    port.eval()
    world1 = {
        "ddpm": tdiff.reverse_diffusion(port, *args, noises=torch.from_numpy(noises), **kw),
        "ddpm:cs2": tdiff.reverse_diffusion(port, *args, noises=torch.from_numpy(fold_in),
                                            cfg_stride=2, **kw),
        "dpm2": tdiff.reverse_diffusion_ode(port, *args, **kw),
        "dpm2:cs2": tdiff.reverse_diffusion_ode(port, *args, cfg_stride=2, **kw)}
    world1.update(workers._deep_samplers({"DEC": DEC, "dec_state": dec_state,
                                          "sampler_args": args, "sampler_kw": kw,
                                          "noises": torch.from_numpy(noises)}))
    mesh = jmake_mesh(data=1, seq=2, devices=jax.devices()[:2])
    jkw = dict(kw, beta_max=DEC["beta_max"], mesh=mesh, sample_spec=P(None, "seq", None))
    want = {
        "ddpm": jdiff.reverse_diffusion(jm.apply, params, z, mask, cond, spk, key,
                                        noises=jnp.asarray(noises), **jkw),
        "ddpm:cs2": jdiff.reverse_diffusion(jm.apply, params, z, mask, cond, spk, key,
                                            cfg_stride=2, **jkw),
        "dpm2": jdiff.reverse_diffusion_ode(jm.apply, params, z, mask, cond, spk, **jkw)}
    for path, flags in JAX_DEEP.items():
        jd = jdiff.UnitSpeech(**{k: v for k, v in DEC.items() if k != "beta_max"}, **flags)
        want[f"{path} ddpm"] = jdiff.reverse_diffusion(jd.apply, params, z, mask, cond, spk, key,
                                                       noises=jnp.asarray(noises), **jkw)
        want[f"{path} dpm2"] = jdiff.reverse_diffusion_ode(jd.apply, params, z, mask, cond, spk,
                                                           **jkw)
    return {"ranks": outs(), "world1": world1, "jax": {k: np.asarray(v) for k, v in want.items()}}


@pytest.mark.parametrize("sampler", JAX_SAMPLERS)
def test_seq_sampler_matches_jax_seq_mesh(seq_runs, sampler):
    """The port's sampler through a (data 1, seq 2) mesh, every rank's
    gathered result, against JAX's on its seq = 2 mesh with P(None, "seq",
    None): within 1e-5 plus 1e-4 of the largest magnitude; the padded
    frames zero."""
    want = seq_runs["jax"][sampler]
    assert np.isfinite(want).all() and np.abs(want).max() > 1.0
    for o in seq_runs["ranks"]:
        _close(o["mels"][sampler], want)
        np.testing.assert_array_equal(o["mels"][sampler][1, 41:].numpy(), 0.0)


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_seq_sampler_matches_world_1(seq_runs, sampler):
    """Every rank's gathered seq-sharded sample against the port's unsharded
    one (the same routes, the same injected draws), the stated tolerance."""
    want = seq_runs["world1"][sampler]
    assert torch.isfinite(want).all()
    for o in seq_runs["ranks"]:
        _close(o["mels"][sampler], want)


def test_seq_estimator_routes_take_their_sharded_forms(seq_runs):
    """One call of the dim-128 estimator (kernels, int8 deep convs, bf16) on
    a 32-frame slice of 64 frames under the route stand-ins (each wrapper's
    CUDA branch against a stub library, then its plain version): on both
    ranks every K1, K2 and K4 call, every GroupNorm's statistics (K3) and
    every int8 conv (K7's scale) got the frame slice, at the sites the
    unsharded routes take (K1 at F = 16 and 8, K4 at the 128-wide F = 16
    stage, the flat int8 blocks at F = 4 and 2, K2); the seq axis's
    collectives are chip_smoke.seq_collectives_per_call's plus those of
    each stand-in's CUDA branch (4 a K1 call, 2 a K2, 1 a K4, 1 a
    GroupNorm's statistics); the gathered
    score against the unsharded call within bf16's and int8's steps: the
    activations are bf16 (one ulp 2^-8 of a value) and one int8 step moves
    a deep conv's outputs by max|w| max|h| / 127 before GroupNorm, so the
    largest difference within 2^-4 of the largest magnitude and the mean
    within one ulp of it."""
    import chip_smoke

    est = GradLogPEstimator2d(**ROUTE_EST, use_kernels=True, use_int8_deep=True)
    want_calls = chip_smoke.seq_collectives_per_call(est, T)
    outs = seq_runs["ranks"]
    for o in outs:
        calls = o["calls"]
        assert all(sharded for _, _, sharded in calls)
        names = [n for n, _, _ in calls]
        assert [w for n, w, _ in calls if n == "fused_resnet_block"] == [2, 128, 128, 256, 512,
                                                                          128]
        assert names.count("fused_final_block") == 1
        assert [w for n, w, _ in calls if n == "fused_rezero_attention"] == [128]
        assert names.count("conv3x3_int8") == 2 * 9  # the 9 flat blocks
        assert names.count("group_mean_inv") == 2 * 9 + 2  # and the plain Blocks' two
        branch = (4 * names.count("fused_resnet_block") + 2 * names.count("fused_final_block")
                  + names.count("fused_rezero_attention") + names.count("group_mean_inv"))
        assert o["collectives"] == want_calls + branch
    whole, score = outs[0]["whole"].float(), outs[0]["score"].float()
    assert torch.equal(outs[1]["score"], outs[0]["score"])
    err = (score - whole).abs()
    assert torch.isfinite(score).all() and score.shape == whole.shape
    top = whole.abs().max()
    assert err.max() <= 2.0 ** -4 * top and err.mean() <= 2.0 ** -8 * top


@pytest.mark.parametrize("path,sampler", DEEP_CASES)
def test_seq_deep_sampler_matches_jax_seq_mesh(seq_runs, path, sampler):
    """ddpm and dpm2 on the fused deep configuration through a (data 1, seq
    2) mesh, every rank's gathered result, against JAX's sampler with
    use_pallas_deep, use_pallas_resample (and use_int8_deep, use_i8pre_deep)
    on its seq = 2 mesh with P(None, "seq", None): the bf16 route (K8, f32
    here) within the stated tolerance, the int8 one (K9) within
    _int8_sampler_close of JAX's int8 sample, JAX's deep bf16-route sample
    the f32 reference; the padded frames zero."""
    want = seq_runs["jax"][f"{path} {sampler}"]
    assert np.isfinite(want).all() and np.abs(want).max() > 1.0
    for o in seq_runs["ranks"]:
        got = o["mels"][f"{path} {sampler}"]
        if path == "deep":
            _close(got, want)
        else:
            _int8_sampler_close(got, want, seq_runs["jax"][f"deep {sampler}"])
        np.testing.assert_array_equal(got[1, 41:].numpy(), 0.0)


@pytest.mark.parametrize("path,sampler", DEEP_CASES)
def test_seq_deep_sampler_matches_world_1(seq_runs, path, sampler):
    """Every rank's gathered seq-sharded sample on the fused deep
    configuration against the port's unsharded one (the same routes and
    draws): the bf16 route within the stated tolerance, the int8 one within
    _int8_sampler_close of the world-1 int8 sample (the world-1 deep
    bf16-route sample the f32 reference)."""
    want = seq_runs["world1"][f"{path} {sampler}"]
    assert torch.isfinite(want).all()
    for o in seq_runs["ranks"]:
        got = o["mels"][f"{path} {sampler}"]
        if path == "deep":
            _close(got, want)
        else:
            _int8_sampler_close(got, want, seq_runs["world1"][f"deep {sampler}"])


def test_seq_deep_estimator_routes_take_their_sharded_forms(seq_runs):
    """One call of the dim-128 route estimator on the fused deep
    configuration (kernels, int8, use_deep, use_resample, use_i8pre_deep,
    bf16) on a 32-frame slice of 64 frames under the route stand-ins (each
    wrapper's CUDA branch against the stub library, then its plain version):
    on both ranks every call got the frame slice; K9 at the five deep sites
    with Cout <= 512 (down_2 res1/res2 at F = 4, up_2 res1/res2 at F = 2,
    up_1_res1 at F = 4; the 2 048- and 1 024-wide inputs run conv1 in bf16),
    K8 at the four 1 024-wide ones (down_3 res1/res2, mid res1/res2), K11a
    at F = 16 and 8, K11b at F = 8 (the gates at the global frames), K1 at
    its six sites, K2, K4 at its one; no flat block. The seq collectives are
    chip_smoke.seq_collectives_per_call's plus each stand-in's CUDA branch
    (4 a K1 or K8 call, 6 a K9 call with an int8 conv1 and 5 with a bf16
    one, 1 a K11 call, 2 a K2, 1 a K4, 1 a GroupNorm's statistics); the
    score against the unsharded call within the route
    test's bf16 and int8 bound (largest difference 2^-4 and mean 2^-8 of
    the largest magnitude)."""
    import chip_smoke

    est = GradLogPEstimator2d(**ROUTE_EST, use_kernels=True, **workers.DEEP_FLAGS["deep_i8"])
    want_calls = chip_smoke.seq_collectives_per_call(est, T)
    outs = seq_runs["ranks"]
    for o in outs:
        calls = o["deep_i8"]["calls"]
        assert all(sharded for _, _, sharded in calls)
        widths = {n: [w for m, w, _ in calls if m == n] for n, _, _ in calls}
        assert widths["fused_resnet_block_deep_i8"] == [256, 512, 2048, 512, 1024]
        assert widths["fused_resnet_block_deep"] == [512, 1024, 1024, 1024]
        assert widths["fused_downsample_conv"] == [128, 256]
        assert widths["fused_upsample_conv"] == [128]
        assert widths["fused_resnet_block"] == [2, 128, 128, 256, 512, 128]
        assert len(widths["fused_final_block"]) == 1
        assert widths["fused_rezero_attention"] == [128]
        assert "conv3x3_int8" not in widths  # no flat block
        k9 = widths["fused_resnet_block_deep_i8"]
        branch = (4 * len(widths["fused_resnet_block"]) + 2 + 1 + len(widths["group_mean_inv"])
                  + 4 * 4 + sum(5 if w > 512 else 6 for w in k9) + 3)
        assert o["deep_i8"]["collectives"] == (want_calls + branch, 0)
    whole, score = outs[0]["deep_i8"]["whole"].float(), outs[0]["deep_i8"]["score"].float()
    assert torch.equal(outs[1]["deep_i8"]["score"], outs[0]["deep_i8"]["score"])
    err, top = (score - whole).abs(), whole.abs().max()
    assert torch.isfinite(score).all() and score.shape == whole.shape
    assert err.max() <= 2.0 ** -4 * top and err.mean() <= 2.0 ** -8 * top


def test_seq_attention_gate_reads_global_tokens(seq_runs):
    """At 64 frames and F = 16 the 128-wide attention passes K4's 1 024-token
    gate; a rank's 32-frame slice (512 tokens) would fail it locally, and
    still takes K4 on both ranks (the gate reads seq.t)."""
    for o in seq_runs["ranks"]:
        assert o["gate"] == {"global": True, "local": False, "local_tokens": 512}
        assert ("fused_rezero_attention", 128, True) in o["calls"]


class _Axis:
    """A mesh axis of two ranks, this process rank 0, no process group."""

    def size(self):
        return 2

    def get_local_rank(self):
        return 0

    def get_group(self):
        return None


def test_seq_refusals(seq_runs, slice_pair, monkeypatch):
    """A spec naming 'model' raises ValueError (the model axis shards the
    parameters, not the sample), on every rank and in one process. The
    fused deep configuration, which the seq axis refused before it had
    sharded forms, now runs there: on every rank the bf16 deep estimator
    (use_deep) on a seq slice runs and takes K8's sharded form at all nine
    deep sites; in one process (a seq axis of two ranks without a
    process group) the use_resample estimator runs on a slice and its
    F = 16 and 8 downsamples and F = 8 upsample take K11's sharded forms,
    and the Synthesizer with use_deep takes the seq slice at its
    construction. A seq axis of one rank is the unsharded program."""
    from unitspeech_tpu_torch.models import unet

    for o in seq_runs["ranks"]:
        assert o["refused"][0] is not None and o["refused"][0].startswith("ValueError") and \
            "shards the parameters" in o["refused"][0]
        assert o["refused"][1] is None  # the deep estimator on a seq slice ran
        assert [(n, w) for n, w, sharded in o["deep_calls"]
                if n == "fused_resnet_block_deep" and sharded] == [
                    ("fused_resnet_block_deep", w)
                    for w in (256, 512, 512, 1024, 1024, 1024, 2048, 512, 1024)]
    with pytest.raises(ValueError, match="shards the parameters"):
        sample_shard(object(), ("data", "model", None))
    with pytest.raises(ValueError, match="frame axis only"):
        sample_shard(object(), ("seq", None, None))
    est = GradLogPEstimator2d(**{k: v for k, v in ROUTE_EST.items() if k != "dtype"},
                              use_kernels=True, use_resample=True)
    est.load_state_dict(_route_case(np.random.default_rng(128))[0])
    fs = SeqShard(0, 2).at(T)
    calls = []
    for name in ("fused_downsample_conv", "fused_upsample_conv"):
        real = getattr(unet, name)
        monkeypatch.setattr(unet, name, lambda x, *a, _real=real, _name=name, **kw: (
            calls.append((_name, tuple(x.shape), kw["seq"].t)), _real(x, *a, **kw))[1])
    with torch.no_grad():
        out = est(torch.zeros(1, 32, 16), torch.ones(1, 32), torch.zeros(1, 32, 16),
                  torch.zeros(1), torch.zeros(1, 8), seq=fs)
    assert out.shape == (1, 32, 16) and torch.isfinite(out).all()
    assert calls == [("fused_downsample_conv", (1, 32, 16, 128), 64),
                     ("fused_downsample_conv", (1, 16, 8, 256), 32),
                     ("fused_upsample_conv", (1, 16, 8, 128), 32)]
    assert isinstance(fs, FrameSlice)
    mesh = {"data": _Axis(), "seq": _Axis()}
    assert sample_shard(mesh, (None, "seq", None))[1] == SeqShard(0, 2, None)
    deep = ttts.TTSModels.from_checkpoint(slice_pair[1], device="cpu", dtype=torch.float32,
                                          use_kernels=True, use_deep=True)
    synth = ttts.Synthesizer(deep, mesh=mesh, sample_spec=(None, "seq", None))
    assert synth._seq == SeqShard(0, 2, None)
    one = {"data": _Axis(), "seq": type("One", (_Axis,), {"size": lambda self: 1})()}
    assert sample_shard(one, ("data", "seq", None))[1] is None


# --- the Synthesizer on a (data 2, seq 2) mesh ---------------------------------


def test_seq_synthesizer_data2_seq2_matches_jax_and_world_1(slice_pair, tmp_path):
    """The Synthesizer's batch paths on a (data 2, seq 2) mesh at world 4
    (sample_spec ("data", "seq", None)): 4 requests with per-row voices and
    injected noise, each rank its 2 rows' frames in two slices. Against
    JAX's batched encode + _align_and_sample on its (data 2, seq 2) mesh +
    the vocoder (the form of tests/test_sharded_inference.py's (data 2, seq
    4) batch test): the lengths equal, the mel within the mel tolerance,
    each waveform within 5e-3; against the port at world 1 the mel within
    the mel tolerance too (the frames' statistics and contexts are summed
    in another order: f32 differences, not the bit-equal rows of the
    data-sharded batch). The same batch with the fused deep configuration
    (use_deep, use_resample) on the same mesh against the port's at world
    1 with those switches, within the mel tolerance."""
    jsynth, ckpt = slice_pair
    rng = np.random.default_rng(5)
    b, f = len(SEQS), ckpt["mel_min"].shape[0]
    voices = rng.standard_normal((b, 8)).astype(np.float32)
    voices /= np.linalg.norm(voices, axis=1, keepdims=True)
    m = jsynth.models
    tb = choose_bucket(max(len(q) for q in SEQS), jsynth.token_buckets)
    packed = np.zeros((b, tb + 1), np.int32)
    for i, q in enumerate(SEQS):
        packed[i, :len(q)], packed[i, -1] = q, len(q)
    mu_x, x_mask, w_ceil = jtts._encode_and_duration(
        m.text_encoder, m.text_encoder_params, m.duration_predictor,
        m.duration_predictor_params, jnp.asarray(packed), jnp.asarray(voices))
    y_lengths = np.maximum(np.asarray(jnp.sum(w_ceil, axis=1)).astype(np.int64), 1)
    y_pad = choose_bucket(fix_len_compatibility(int(y_lengths.max()), 1), jsynth.frame_buckets)
    assert y_pad % 8 == 0 and y_pad >= 16
    noise_z = rng.standard_normal((b, y_pad, f)).astype(np.float32)
    step_noise = rng.standard_normal((STEPS, b, y_pad, f)).astype(np.float32)
    synth_kw = {"diffusion_steps": STEPS, "spk": voices, "noise_z": torch.from_numpy(noise_z),
                "noises": torch.from_numpy(step_noise), "text_gradient_scale": 1.0,
                "spk_gradient_scale": 1.0}
    outs = _start(workers.seq_synthesis, tmp_path, 4, {"ckpt": ckpt, "seqs": SEQS,
                                                       "synth_kw": synth_kw})
    mesh = jmake_mesh(data=2, seq=2, devices=jax.devices()[:4])
    want_mel, _ = jtts._align_and_sample(
        m.decoder.apply, m.decoder_params, mu_x, x_mask, w_ceil, None, jnp.asarray(voices),
        jax.random.PRNGKey(0), m.mel_min, m.mel_max, n_timesteps=STEPS,
        text_gradient_scale=1.0, spk_gradient_scale=1.0, beta_min=m.cfg.decoder.beta_min,
        beta_max=m.cfg.decoder.beta_max, y_pad=y_pad, mesh=mesh,
        sample_spec=P("data", "seq", None), noise_z=jnp.asarray(noise_z),
        noises=jnp.asarray(step_noise))
    want_mel = np.asarray(want_mel)
    want_wav = np.asarray(jsynth.vocode(jnp.asarray(want_mel)))
    single = ttts.Synthesizer(ttts.TTSModels.from_checkpoint(ckpt, device="cpu",
                                                             dtype=torch.float32))
    single_mel, single_len = single.synthesize_mel_batch(SEQS, **synth_kw)
    deep = ttts.Synthesizer(ttts.TTSModels.from_checkpoint(
        ckpt, device="cpu", dtype=torch.float32, use_kernels=True, **workers.DEEP_FLAGS["deep"]))
    deep_mel = deep.synthesize_mel_batch(SEQS, **synth_kw)[0]
    tol = _mel_tol(ckpt)
    assert np.isfinite(want_mel).all() and np.ptp(want_mel) > 1.0
    np.testing.assert_array_equal(single_len, y_lengths)
    for o in outs():
        np.testing.assert_array_equal(o["y_lengths"], y_lengths)
        assert o["mel"].shape == want_mel.shape == (b, y_pad, f)
        np.testing.assert_allclose(o["mel"].numpy(), want_mel, rtol=0, atol=tol)
        np.testing.assert_allclose(o["mel"].numpy(), single_mel.numpy(), rtol=0, atol=tol)
        np.testing.assert_allclose(o["deep_mel"].numpy(), deep_mel.numpy(), rtol=0, atol=tol)
        for i, w in enumerate(o["wavs"]):
            n = int(y_lengths[i]) * m.cfg.data.hop_length
            assert w.shape == (n,)
            np.testing.assert_allclose(w, want_wav[i, :n], rtol=0, atol=5e-3)
