"""Several ranks in the port against the JAX package on the CPU: the
sharded epoch iterator, the launcher's topology and the mesh, a
data-parallel STEP1 and STEP2 step, TrainLoop with checkpoints and resume
across ranks, speaker-per-rank fine-tuning, data-sharded sampling and
batched synthesis, and distributed transcription.

Each multi-rank case runs two ranks of a gloo process group on the CPU in
spawned processes (parallel.run_group; their code is tests/_parallel_workers.py,
which imports only the port), joined through a file under the case's
tmp_path, so that test workers never fight over a port, each on one torch
thread, within a 120 s limit that kills them and fails the test, so that a
hung collective cannot stall the suite. The JAX side runs here on the
virtual 8-device mesh of tests/conftest.py, on a 2-device mesh where the
case is the mesh form. Weights cross with params_from_jax and JAX's draws
are injected (the global batch's: each rank keeps its rows). The modules
are the 2-stage ones of the other port tests, in f32."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from tests import _parallel_workers as workers
from tests._torch_port import randomize, scale_gates
from tests.test_torch_port_train import DEC, DP, TE, TINY_TRAIN, _masked, _texts
from tests.test_torch_port_train2 import UE, VOCAB
from tests.test_torch_port_tts import (  # noqa: F401 (slice_pair is a fixture)
    GUIDANCE,
    STEPS,
    TOKENS,
    _mel_tol,
    slice_pair,
)
from unitspeech_tpu.data import dataset as jdata
from unitspeech_tpu.infer import tts as jtts
from unitspeech_tpu.models.diffusion import UnitSpeech as JUnitSpeech
from unitspeech_tpu.models.diffusion import reverse_diffusion as jreverse_diffusion
from unitspeech_tpu.models.duration import DurationPredictor as JDurationPredictor
from unitspeech_tpu.models.encoder import Encoder as JEncoder
from unitspeech_tpu.parallel import make_mesh as jmake_mesh
from unitspeech_tpu.parallel import replicate_tree as jreplicate_tree
from unitspeech_tpu.parallel import shard_batch as jshard_batch
from unitspeech_tpu.tools import distributed_transcribe as jdt
from unitspeech_tpu.train import finetune as jft
from unitspeech_tpu.train import steps as jsteps
from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch.config import DecoderConfig, load_json
from unitspeech_tpu_torch.data import dataset as tdata
from unitspeech_tpu_torch.infer import tts as ttts
from unitspeech_tpu_torch.models.diffusion import UnitSpeech, fine_tune_loss, reverse_diffusion
from unitspeech_tpu_torch.models.duration import DurationPredictor
from unitspeech_tpu_torch.models.encoder import Encoder
from unitspeech_tpu_torch.ops.masking import choose_bucket, fix_len_compatibility
from unitspeech_tpu_torch.parallel import (
    DataShard,
    Group,
    make_mesh,
    maybe_initialize_distributed,
    resolve_topology,
)
from unitspeech_tpu_torch.tools import distributed_transcribe as tdt
from unitspeech_tpu_torch.tools import ssl_reference, synthetic_corpus
from unitspeech_tpu_torch.train import finetune as tft
from unitspeech_tpu_torch.train import steps as tsteps
from unitspeech_tpu_torch.utils.audio import write_wav
from unitspeech_tpu_torch.utils.params import params_from_jax

# one intra-op thread: the suite's pytest workers share the CPU's cores, and
# torch's default of one thread a core oversubscribes them
torch.set_num_threads(1)

WORLD, TIMEOUT = 2, 120.0
N_FEATS, SPK, B, TX, TY, SEG, LR = 16, 8, 4, 8, 24, 16, 1e-3
# the XLA backend's optimization off for the JAX side's large compiles
O0 = {"compiler_options": {"xla_backend_optimization_level": 0}}


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """The train loop's TensorBoard writer, made only when tensorboardX
    imports, left out, as on a machine without it (its import takes 4 s)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorboardX", None)
        yield


def _start(fn, tmp_path, *args):
    """fn started as WORLD ranks over tmp_path (its inputs.pt written
    first), so that this process's own work (JAX's side, the port at world
    1) overlaps theirs. Returns outs(): the join, then each rank's output,
    checked to have imported nothing of JAX."""
    group = Group(fn, WORLD, (str(tmp_path), *args), timeout=TIMEOUT)

    got = []

    def outs():
        if not got:
            group.join()
            got.extend(torch.load(tmp_path / f"out{r}.pt", weights_only=False)
                       for r in range(WORLD))
            assert all(o.pop("jax_free") for o in got), "a rank imported jax or unitspeech_tpu"
        return got

    return outs


def _t(x):
    x = np.asarray(x)
    t = torch.from_numpy(np.array(x))
    return t.long() if x.dtype.kind == "i" else t


def _held_like_jax(got, want, base, grads, steps, what):
    """The port's rule for Adam against optax (tests/test_torch_port_train.py):
    each parameter within 2e-3 * lr * steps of `want` plus one f32 rounding
    of its value; an entry whose first gradient is below 1e-3 of the RMS
    gradient within 2 * lr * steps (its sign a rounding coin toss); a
    parameter with no gradient unmoved."""
    live = [g.numpy().ravel() for g in grads.values() if g is not None]
    rms = np.sqrt(np.mean(np.concatenate(live) ** 2))
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        if grads.get(k) is None:
            np.testing.assert_array_equal(g, base[k].numpy(), err_msg=f"{what} {k}")
            continue
        tol = np.full(g.shape, 2e-3 * LR * steps) + np.spacing(np.abs(w))
        tol[np.abs(grads[k].numpy()) < 1e-3 * rms] = 2 * LR * steps
        assert np.all(np.abs(g - w) <= tol), (what, k, np.abs(g - w).max())


# --- 1. the sharded epoch iterator -----------------------------------------


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("n,world,bs,drop_last", [
    (64, 4, 4, True), (61, 4, 4, True), (61, 4, 4, False), (33, 2, 5, True),
    (10, 3, 2, False), (16, 1, 4, True), (17, 1, 4, False), (7, 2, 4, True)])
def test_iterate_batches_matches_jax(n, world, bs, drop_last):
    """Every rank's batches (its strided slice of one seeded permutation)
    equal JAX's per-host iterator's, uneven epochs included: with
    drop_last and several ranks, each yields the smallest slice's count."""
    for rank in range(world):
        kw = dict(shuffle=True, drop_last=drop_last, process_index=rank, process_count=world)
        got = list(tdata.iterate_batches(_Indices(n), list, bs, key=np.random.default_rng(3),
                                         **kw))
        want = list(jdata.iterate_batches(_Indices(n), list, bs, key=np.random.default_rng(3),
                                          **kw))
        assert got == want, rank
    if drop_last and world > 1:
        assert len(got) == n // world // bs


# --- 2. the launcher and the mesh --------------------------------------------


def test_topology_resolution_order(monkeypatch):
    """Explicit arguments, then UNITSPEECH_*, then torchrun's variables (JAX's
    order, torchrun standing for its auto-detection); host:port becomes a
    tcp:// URL, file:// stays; the local rank is LOCAL_RANK, else the rank;
    nothing set raises."""
    for k in ("UNITSPEECH_COORDINATOR", "UNITSPEECH_NUM_PROCESSES", "UNITSPEECH_PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="no process topology"):
        resolve_topology()
    monkeypatch.setenv("MASTER_ADDR", "node0")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("LOCAL_RANK", "1")
    t = resolve_topology()
    assert (t.init_method, t.world, t.rank, t.local_rank) == ("tcp://node0:29500", 8, 5, 1)
    monkeypatch.setenv("UNITSPEECH_COORDINATOR", "file:///tmp/x")
    monkeypatch.setenv("UNITSPEECH_NUM_PROCESSES", "4")
    monkeypatch.setenv("UNITSPEECH_PROCESS_ID", "3")
    t = resolve_topology()
    assert (t.init_method, t.world, t.rank) == ("file:///tmp/x", 4, 3)
    t = resolve_topology("host:1234", 2, 0)
    assert (t.init_method, t.world, t.rank, t.local_rank) == ("tcp://host:1234", 2, 0, 1)
    monkeypatch.delenv("LOCAL_RANK")
    assert resolve_topology(num_processes=2, process_id=1).local_rank == 1


def test_world1_gloo_init_is_idempotent_and_the_mesh(tmp_path):
    """A world-1 gloo group from explicit arguments, twice (True both
    times, one group); make_mesh's (data, seq, model) axes and JAX's
    assertion that their product is the world; the DataShard of a group of
    one sums through the group and takes every row."""
    assert not dist.is_initialized()
    try:
        init = f"file://{tmp_path}/init"
        assert maybe_initialize_distributed(init, 1, 0, cpu=True)
        assert maybe_initialize_distributed(init, 1, 0, cpu=True)
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        mesh = make_mesh()
        assert mesh.mesh_dim_names == ("data", "seq", "model") and tuple(mesh.shape) == (1, 1, 1)
        with pytest.raises(AssertionError, match="mesh 2x1x1 != 1"):
            make_mesh(data=2)
        shard = DataShard.of(mesh)
        assert (shard.rank, shard.size) == (0, 1) and shard.group is not None
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(shard.all_sum(x), x) and shard.take(x) is x
        assert torch.equal(shard.gather(x, 3), x)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_distributed_without_cuda_or_cpu_raises(tmp_path, monkeypatch):
    """`cli train-step1 --distributed` with no CUDA device and no --cpu
    raises before joining any group (no fallback to gloo)."""
    assert not torch.cuda.is_available()
    monkeypatch.setenv("UNITSPEECH_COORDINATOR", f"file://{tmp_path}/init")
    monkeypatch.setenv("UNITSPEECH_NUM_PROCESSES", "1")
    monkeypatch.setenv("UNITSPEECH_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        cli.main_train_step1(["--filelist", "f", "--spk-embs", "s", "--mel-stats", "m",
                              "--distributed"])
    assert not dist.is_initialized()


# --- 3. one data-parallel STEP1 and STEP2 step -------------------------------


def _jax_mesh2():
    return jmake_mesh(devices=jax.devices()[:2])


def _dp_step1(mesh):
    """JAX's STEP1 step jitted on `mesh` (the batch sharded on data, the
    parameters replicated), its draws from the same key in the same
    program, and what the port needs to replay it."""
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
    params["decoder"] = jax.device_get(scale_gates(params["decoder"], 0.1))
    rng = np.random.default_rng(0)
    # shards {0, 2} and {1, 3}: token lengths 8 + 7 and 6 + 5, frames 24 + 22 and 20 + 17
    batch = {"tokens": rng.integers(1, 40, (B, TX)).astype(np.int32),
             "token_lengths": np.array([TX, TX - 2, TX - 1, TX - 3], np.int32),
             "mel": rng.uniform(-1, 1, (B, TY, N_FEATS)).astype(np.float32),
             "mel_lengths": np.array([TY, 20, 22, 17], np.int32),
             "spk_emb": rng.standard_normal((B, SPK)).astype(np.float32)}
    spk_uncond = rng.standard_normal(SPK).astype(np.float32)

    def draws(p, bt, k):
        k_cfg, k_te, k_dp, k_crop, k_diff = jax.random.split(k, 5)
        key_t, key_z = jax.random.split(k_diff)
        te_masks, (_, hidden, x_mask) = _masked(te, p["text_encoder"], bt["tokens"],
                                                bt["token_lengths"], key=k_te)
        dp_masks, _ = _masked(dp, p["duration_predictor"], hidden, x_mask, g=bt["spk_emb"],
                              reverse=True, key=k_dp)
        return {"perm": jax.random.permutation(k_cfg, B), "te": te_masks, "dp": dp_masks,
                "u": jax.random.uniform(k_crop, (B,)), "t": jax.random.uniform(key_t, (B,)),
                "z": jax.random.normal(key_z, (B, SEG, N_FEATS))}

    import optax

    opt = optax.adam(LR)
    step = jsteps.make_step1_train_step(te, dp, dec, opt, out_size=SEG,
                                        spk_uncond=jnp.asarray(spk_uncond))
    rep = jreplicate_tree(jax.tree_util.tree_map(jnp.asarray, params), mesh)
    state = jsteps.TrainState(rep, jreplicate_tree(opt.init(rep), mesh), jnp.array(0))
    jb = jshard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    key = jax.random.PRNGKey(31)
    run = jax.jit(lambda st, b, k: (draws(st.params, b, k), step(st, b, k)))
    d, (state, metrics) = run.lower(state, jb, key).compile(**O0)(state, jb, key)
    d = jax.device_get(d)
    port_draws = {k: _t(v) for k, v in d.items() if k not in ("te", "dp")}
    port_draws.update(te=[_t(m) for m in d["te"]], dp=[_t(m) for m in d["dp"]])
    names = ("text_encoder", "duration_predictor", "decoder")
    return {"state": [params_from_jax(jax.device_get(params[k])) for k in names],
            "after": [params_from_jax(jax.device_get(state.params[k])) for k in names],
            "metrics": {k: float(v) for k, v in metrics.items()},
            "batch": {k: _t(v) for k, v in batch.items()}, "draws": port_draws,
            "spk_uncond": torch.from_numpy(spk_uncond), "TE": TE, "DP": DP, "DEC": DEC,
            "lr": LR, "seg": SEG}


def _dp_step2(mesh):
    """JAX's STEP2 step jitted on `mesh`, as _dp_step1."""
    ue, dec = JEncoder(**UE), JUnitSpeech(**DEC)

    def init_all(key):
        k1, k2 = jax.random.split(key)
        return {"unit_encoder": ue.init(k1, jnp.zeros((1, 6), jnp.int32), jnp.array([6])),
                "decoder": dec.init(k2, jnp.zeros((1, 8, N_FEATS)), jnp.ones((1, 8)),
                                    jnp.zeros((1, 8, N_FEATS)), jnp.zeros((1,)),
                                    jnp.zeros((1, SPK)))}

    key = jax.random.PRNGKey(0)
    init = jax.jit(init_all).lower(key).compile(**O0)(key)
    params = {k: randomize(v, i + 11) for i, (k, v) in enumerate(init.items())}
    params["decoder"] = jax.device_get(scale_gates(params["decoder"], 0.1))
    rng = np.random.default_rng(1)
    lengths = np.array([TX, TX - 2, TX - 1, TX - 3], np.int32)
    durations = rng.integers(1, 4, (B, TX)).astype(np.float32)
    durations[np.arange(TX)[None, :] >= lengths[:, None]] = 0
    batch = {"units": rng.integers(0, VOCAB, (B, TX)).astype(np.int32),
             "unit_lengths": lengths, "durations": durations,
             "mel": rng.uniform(-1, 1, (B, TY, N_FEATS)).astype(np.float32),
             "mel_lengths": np.minimum(durations.sum(1), TY).astype(np.int32),
             "spk_emb": rng.standard_normal((B, SPK)).astype(np.float32)}

    def draws(p, bt, k):
        k_drop, k_crop, k_diff = jax.random.split(k, 3)
        key_t, key_z = jax.random.split(k_diff)
        masks, _ = _masked(ue, p, bt["units"], bt["unit_lengths"], key=k_drop)
        return {"ue": masks, "u": jax.random.uniform(k_crop, (B,)),
                "t": jax.random.uniform(key_t, (B,)),
                "z": jax.random.normal(key_z, (B, SEG, N_FEATS))}

    import optax

    opt = optax.adam(LR)
    step = jsteps.make_step2_train_step(ue, dec, opt, out_size=SEG)
    p = jreplicate_tree(jax.tree_util.tree_map(jnp.asarray, params), mesh)
    state = jsteps.TrainState(p["unit_encoder"], jreplicate_tree(opt.init(p["unit_encoder"]),
                                                                 mesh), jnp.array(0))
    jb = jshard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    key = jax.random.PRNGKey(32)
    run = jax.jit(lambda st, dp_, b, k: (draws(st.params, b, k), step(st, dp_, b, k)))
    d, (state, metrics) = run.lower(state, p["decoder"], jb, key).compile(**O0)(
        state, p["decoder"], jb, key)
    d = jax.device_get(d)
    port_draws = {k: _t(v) for k, v in d.items() if k != "ue"}
    port_draws["ue"] = [_t(m) for m in d["ue"]]
    return {"state": [params_from_jax(jax.device_get(params[k]))
                      for k in ("unit_encoder", "decoder")],
            "after": params_from_jax(jax.device_get(state.params)),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "batch": {k: _t(v) for k, v in batch.items()}, "draws": port_draws,
            "UE": UE, "DEC": DEC, "lr": LR, "seg": SEG}


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """JAX's STEP1 and STEP2 steps on a 2-device mesh, and the port's steps
    at world 2 (two ranks of rows {0, 2} and {1, 3}) on the same inputs,
    STEP1's ranks started before JAX's STEP2 step runs."""
    mesh = _jax_mesh2()
    jx, outs = {}, {}
    for name, make, worker in (("step1", _dp_step1, workers.dp_step1),
                               ("step2", _dp_step2, workers.dp_step2)):
        jx[name] = make(mesh)
        d = tmp_path_factory.mktemp(f"dp_{name}")
        torch.save(jx[name], d / "inputs.pt")
        outs[name] = _start(worker, d)
    return jx, outs


def _step1_port(s, shard=None):
    mods = [Encoder(**s["TE"]), DurationPredictor(**s["DP"]), UnitSpeech(**s["DEC"])]
    for m, sd in zip(mods, s["state"]):
        m.load_state_dict(sd)
    return mods


def test_dp_step1_matches_jax_two_device_mesh(dp_run):
    """One STEP1 step at world 2 against JAX's step jitted on a 2-device mesh
    and against the port's at world 1: the three losses and the total
    within 1e-5 relative and the pre-clip norms within 1e-4 (both ranks
    report the global batch's), every parameter after the step equal on
    both ranks and held to JAX's and to the world-1 step's by the port's
    Adam rule. The shards' token and frame lengths differ, so
    the loss normalizers must be the global batch's: a DDP mean of each
    rank's own losses (the same step with no process group, each rank
    normalizing by its rows) misses JAX's total by far more than the
    tolerance, and would fail this test."""
    jx, outs = dp_run
    s = jx["step1"]
    names = ("text_encoder", "duration_predictor", "decoder")
    mods = _step1_port(s)
    opt = torch.optim.Adam([p for m in mods for p in m.parameters()], lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    one = tsteps.make_step1_train_step(*mods, opt, SEG, s["spk_uncond"])(s["batch"],
                                                                        draws=s["draws"])
    first = _step1_port(s)
    tsteps.step1_loss(*first, s["batch"], SEG, s["spk_uncond"], draws=s["draws"])[0].backward()
    outs = outs["step1"]()
    for k, v in s["metrics"].items():
        tol = 1e-4 if k.startswith("grad_norm") else 1e-5
        for r, o in enumerate(outs):
            np.testing.assert_allclose(o["metrics"][k], v, rtol=tol, err_msg=(r, k))
        np.testing.assert_allclose(outs[0]["metrics"][k], one[k].item(), rtol=1e-6,
                                   err_msg=k)
    for i, name in enumerate(names):
        a, b = outs[0]["params"][i], outs[1]["params"][i]
        assert all(torch.equal(a[k], b[k]) for k in a), name
        grads = {k: p.grad for k, p in first[i].named_parameters()}
        _held_like_jax(a, s["after"][i], s["state"][i], grads, 1, name)
        _held_like_jax(a, {k: p.detach() for k, p in mods[i].named_parameters()},
                       s["state"][i], grads, 1, f"{name} at world 1")
    ddp = np.mean([tsteps.step1_loss(*_step1_port(s), {k: v[r::2] for k, v in s["batch"].items()},
                                     SEG, s["spk_uncond"], draws=s["draws"],
                                     shard=DataShard(r, 2))[0].item() for r in range(2)])
    assert abs(ddp - s["metrics"]["total_loss"]) > 1e-4 * abs(s["metrics"]["total_loss"])


def test_dp_step2_matches_jax_two_device_mesh(dp_run):
    """One STEP2 step at world 2 against JAX's on a 2-device mesh and the
    port's at world 1, as the STEP1 test (the unit encoder trains, the
    decoder frozen); a DDP mean of the ranks' own losses misses JAX's."""
    jx, outs = dp_run
    s = jx["step2"]

    def port():
        ue, dec = Encoder(**s["UE"]), UnitSpeech(**s["DEC"])
        ue.load_state_dict(s["state"][0])
        dec.load_state_dict(s["state"][1])
        return ue, dec

    ue, dec = port()
    opt = torch.optim.Adam(ue.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    one = tsteps.make_step2_train_step(ue, dec, opt, SEG)(s["batch"], draws=s["draws"])
    ue0, dec0 = port()
    dec0.requires_grad_(False)
    tsteps.step2_loss(ue0, dec0, s["batch"], SEG, draws=s["draws"])[0].backward()
    outs = outs["step2"]()
    for k, v in s["metrics"].items():
        tol = 1e-4 if k == "grad_norm" else 1e-5
        for r, o in enumerate(outs):
            np.testing.assert_allclose(o["metrics"][k], v, rtol=tol, err_msg=(r, k))
        np.testing.assert_allclose(outs[0]["metrics"][k], one[k].item(), rtol=1e-6,
                                   err_msg=k)
    a, b = outs[0]["params"], outs[1]["params"]
    assert all(torch.equal(a[k], b[k]) for k in a)
    _held_like_jax(a, s["after"], s["state"][0], {k: p.grad for k, p in ue0.named_parameters()},
                   1, "unit_encoder")
    _held_like_jax(a, {k: p.detach() for k, p in ue.named_parameters()}, s["state"][0],
                   {k: p.grad for k, p in ue0.named_parameters()}, 1, "unit_encoder at world 1")
    ddp = np.mean([tsteps.step2_loss(*port(), {k: v[r::2] for k, v in s["batch"].items()}, SEG,
                                     draws=s["draws"], shard=DataShard(r, 2))[0].item()
                   for r in range(2)])
    assert abs(ddp - s["metrics"]["total_loss"]) > 1e-4 * abs(s["metrics"]["total_loss"])


# --- 4. TrainLoop across ranks -----------------------------------------------


def test_train_loop_world2_checkpoints_on_rank0_and_resumes(tmp_path):
    """`cli train-step1 --distributed --cpu` at world 2 (each rank given its
    own checkpoint and log directories): 8 utterances at batch 4 are two
    steps an epoch of 2 rows a rank; both ranks report the world-1 run's
    losses (the same global batches, padded alike, the same draws); only
    rank 0 writes a checkpoint and train.log. Then a fresh loop resumes at
    world 2 in the same group: rank 0 reads its checkpoint and rank 1, whose
    directory is empty, receives it, so both hold the saved parameters,
    Adam moments and step, and after one more epoch their parameters are
    equal."""
    cfg = json.loads(json.dumps(TINY_TRAIN))
    cfg["train"]["use_bf16"] = False  # f32, so that the two worlds' sums agree to 1e-5
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    corp = synthetic_corpus(str(tmp_path / "corpus"), load_json(str(tmp_path / "tiny.json")),
                            _texts(8, seed=4), n_speakers=2, seconds=(0.4, 0.9), seed=5)
    ms = str(tmp_path / "ms.npz")
    cli.main(["preprocess-mel-stats", "--filelist", corp["filelist"], "--out", ms, "--config",
              str(tmp_path / "tiny.json"), "--device", "cpu"])
    argv = ["--filelist", corp["filelist"], "--spk-embs", corp["spk_embs"], "--mel-stats", ms,
            "--config", str(tmp_path / "tiny.json"), "--n-epochs", "1", "--distributed",
            "--cpu"]
    d1 = tmp_path / "run"
    d1.mkdir()
    outs = _start(workers.train_loop, d1, argv)
    single = cli.main_train_step1(argv[:-2] + ["--cpu", "--checkpoint-dir", str(tmp_path / "ck"),
                                               "--log-dir", str(tmp_path / "log")])
    outs = outs()
    assert [o["main"] for o in outs] == [True, False]
    assert [o["shard"] for o in outs] == [(0, 2), (1, 2)]
    assert all(o["steps"] == 2 for o in outs)
    assert sorted(os.listdir(d1 / "ck0")) == ["step_1", "step_2"]
    assert not os.path.exists(d1 / "ck1")
    assert (d1 / "log0" / "train.log").exists() and not (d1 / "log1" / "train.log").exists()
    assert len(single["metrics"]) == 2
    for o in outs:
        for got, want in zip(o["metrics"], single["metrics"]):
            for k, v in want.items():
                np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=k)

    saved = torch.load(d1 / "ck0" / "step_1", weights_only=True)
    for o in outs:
        assert o["start"] == 1 and o["resumed"]["step"] == 2 and o["resumed_steps"] == 4
        for k, sd in o["resumed"]["modules"].items():
            for n in sd:
                assert torch.equal(sd[n], saved[k][n]), (k, n, (sd[n] - saved[k][n]).abs().max())
        sa, sb = o["resumed"]["opt"]["state"], saved["opt_state"]["state"]
        assert sa.keys() == sb.keys() and len(sa) > 50
        assert all(torch.equal(sa[i][m], sb[i][m]) for i in sa
                   for m in ("exp_avg", "exp_avg_sq", "step"))
    a, b = (o["final"]["modules"] for o in outs)
    assert all(torch.equal(a[k][n], b[k][n]) for k in a for n in a[k])


# --- 5. speaker-per-rank fine-tuning -----------------------------------------


def test_finetune_speaker_per_rank_matches_jax_mesh(tmp_path):
    """finetune_decoder_batched with the mesh at world 2, S = 8 (four
    speakers a rank), against JAX's mesh form (shard_map over a 2-device
    mesh; tests/test_train_steps.py's setup, 3 iterations at lr 1e-3):
    speakers 0, 3 and 7's losses within 1e-5 relative and parameters by
    the port's Adam rule; bit-equal to finetune_decoder at world 1 for
    speaker 3, both ranks holding the whole stack; S = 5
    raises ValueError as JAX does."""
    dec = JUnitSpeech(**{**DEC, "dim_mults": (1, 2)})
    dparams = jax.jit(dec.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, N_FEATS)),
                                jnp.ones((1, 8)), jnp.zeros((1, 8, N_FEATS)), jnp.zeros((1,)),
                                jnp.zeros((1, SPK)))
    rng = np.random.default_rng(9)
    s, t_x, t_y, seg, iters = 8, 4, 16, 8, 3
    cond_x = (rng.standard_normal((s, 1, t_x, N_FEATS)) * 0.1).astype(np.float32)
    y = rng.uniform(-1, 1, (s, 1, t_y, N_FEATS)).astype(np.float32)
    attn = np.broadcast_to(np.repeat(np.eye(t_x), t_y // t_x, axis=1)[None, None],
                           (s, 1, t_x, t_y)).astype(np.float32)
    y_lengths = np.full((s, 1), t_y)
    spk = (rng.standard_normal((s, 1, SPK)) * 0.1).astype(np.float32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(s))
    base = params_from_jax(jax.device_get(dparams))
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (cond_x, y, y_lengths, attn, spk)]
    draws = _finetune_draws(keys, iters, seg)
    x = {"DEC": {**DEC, "dim_mults": (1, 2)}, "stacked": {k: v.expand((s,) + v.shape).clone()
                                                         for k, v in base.items()},
         "args": args, "draws": draws, "seg": seg, "iters": iters, "lr": LR}
    torch.save(x, tmp_path / "inputs.pt")
    outs = _start(workers.finetune, tmp_path)
    stacked = jax.tree_util.tree_map(lambda x: np.broadcast_to(x[None], (s,) + x.shape),
                                     jax.device_get(dparams))
    want_params, want_losses = jft.finetune_decoder_batched(
        dec.apply, stacked, cond_x, y, y_lengths, attn, spk, keys, mesh=_jax_mesh2(),
        segment_size=seg, n_iters=iters, learning_rate=LR)
    want_params = params_from_jax(jax.device_get(want_params))
    one_state, one_losses = tft.finetune_decoder(
        DecoderConfig(**x["DEC"]), base, *(a[3] for a in args), dtype=torch.float32,
        segment_size=seg, n_iters=iters, learning_rate=LR, grad_clip=1.0, draws=draws[3])
    outs = outs()
    for o in outs:
        assert o["refused"] is not None and "must divide by the mesh data axis (2)" in o["refused"]
        assert all(torch.equal(o["state"][k], outs[0]["state"][k]) for k in one_state)
        np.testing.assert_array_equal(o["losses"], outs[0]["losses"])
    got = outs[0]
    np.testing.assert_array_equal(got["losses"][3], one_losses)
    assert all(torch.equal(got["state"][k][3], v) for k, v in one_state.items())
    for i in (0, 3, 7):
        np.testing.assert_allclose(got["losses"][i], np.asarray(want_losses[i]), rtol=1e-5)
        model = UnitSpeech(**x["DEC"])
        model.load_state_dict(base)
        fine_tune_loss(model, args[0][i], args[1][i], args[2][i], args[3][i], args[4][i], seg,
                       draws=draws[i][0]).backward()
        _held_like_jax({k: v[i] for k, v in got["state"].items()},
                       {k: v[i] for k, v in want_params.items()}, base,
                       {k: p.grad for k, p in model.named_parameters()}, iters, f"speaker {i}")


def _finetune_draws(keys, iters, seg):
    """JAX's fine-tune draws of every speaker's every step (its key folded
    with the step: the crop's u, then t, then z), in one jitted call;
    tests/test_torch_port_finetune.py's _jax_draws for a batch of one."""
    def one(key, i):
        key_seg, key_loss = jax.random.split(jax.random.fold_in(key, i))
        key_t, key_z = jax.random.split(key_loss)
        return (jax.random.uniform(key_seg, (1,)), jax.random.uniform(key_t, (1,)),
                jax.random.normal(key_z, (1, seg, N_FEATS)))

    u, t, z = jax.device_get(jax.jit(jax.vmap(jax.vmap(one, (None, 0)), (0, None)))(
        keys, jnp.arange(iters)))
    return [[{"u": _t(u[s, i]), "t": _t(t[s, i]), "z": _t(z[s, i])} for i in range(iters)]
            for s in range(len(keys))]


# --- 6. data-sharded sampling and batched synthesis --------------------------


SEQS = [TOKENS, TOKENS[:7], TOKENS[3:7], TOKENS[2:11]]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-5 + 1e-4 * np.abs(want).max())


def test_data_sharded_sampling_and_synthesize_batch_match_jax(slice_pair, tmp_path):
    """reverse_diffusion at world 2 with sample_spec ("data", None, None)
    against JAX's with P("data", None, None) on a 2-device mesh, b = 4 (one
    padded row), 3 steps of dual guidance, the same z and per-step noise:
    within 1e-5 plus 1e-4 of the largest magnitude, as the unsharded
    sampler tests, on both ranks, and so the port at world 1. Then the
    Synthesizer with the mesh: synthesize_mel_batch and synthesize_batch of
    4 requests with per-row voices and injected noise against JAX's batched
    encode + _align_and_sample on the data = 2 mesh + vocoder (JAX's
    synthesize_batch takes no noise): the lengths equal, the mel within
    the mel tolerance and each waveform within 5e-3; the port at world 1
    gives the same rows. A spec naming 'model' raises ValueError (the model
    axis shards the parameters: tests/test_torch_port_tp.py; the seq axis
    has its own cases: tests/test_torch_port_seq.py)."""
    jsynth, ckpt = slice_pair
    rng = np.random.default_rng(3)
    b, t, f = 4, 16, N_FEATS
    z = rng.standard_normal((b, t, f)).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[2, 11:] = 0
    cond = rng.standard_normal((b, t, f)).astype(np.float32)
    spk = rng.standard_normal((b, SPK)).astype(np.float32)
    noises = rng.standard_normal((3, b, t, f)).astype(np.float32)
    jm = JUnitSpeech(**DEC)
    init = jax.jit(jm.init)(jax.random.PRNGKey(0), z, mask, cond, np.zeros(b, np.float32), spk)
    params = jax.device_get(scale_gates(randomize(init, 4), 0.003))
    kw = dict(n_timesteps=3, text_gradient_scale=1.0, spk_gradient_scale=1.0)
    voices = rng.standard_normal((b, SPK)).astype(np.float32)
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
    noise_z = rng.standard_normal((b, y_pad, f)).astype(np.float32)
    step_noise = rng.standard_normal((STEPS, b, y_pad, f)).astype(np.float32)
    sampler_args = [torch.from_numpy(a) for a in (z, mask, cond, spk)]
    sampler_kw = {**kw, "noises": torch.from_numpy(noises)}
    synth_kw = {"diffusion_steps": STEPS, "spk": voices, "noise_z": torch.from_numpy(noise_z),
                "noises": torch.from_numpy(step_noise), **GUIDANCE}
    dec_state = params_from_jax(params)
    torch.save({"DEC": DEC, "dec_state": dec_state, "sampler_args": sampler_args,
                "sampler_kw": sampler_kw, "ckpt": ckpt, "seqs": SEQS, "synth_kw": synth_kw},
               tmp_path / "inputs.pt")
    outs = _start(workers.sampling, tmp_path)

    mesh = _jax_mesh2()
    want = np.asarray(jreverse_diffusion(jm.apply, params, z, mask, cond, spk,
                                         jax.random.PRNGKey(1), mesh=mesh,
                                         sample_spec=P("data", None, None),
                                         noises=jnp.asarray(noises), **kw))
    want_mel, _ = jtts._align_and_sample(
        m.decoder.apply, m.decoder_params, mu_x, x_mask, w_ceil, None, jnp.asarray(voices),
        jax.random.PRNGKey(0), m.mel_min, m.mel_max, n_timesteps=STEPS,
        text_gradient_scale=1.0, spk_gradient_scale=1.0, beta_min=m.cfg.decoder.beta_min,
        beta_max=m.cfg.decoder.beta_max, y_pad=y_pad, mesh=mesh,
        sample_spec=P("data", None, None), noise_z=jnp.asarray(noise_z),
        noises=jnp.asarray(step_noise))
    want_mel = np.asarray(want_mel)
    want_wav = np.asarray(jsynth.vocode(jnp.asarray(want_mel)))
    port = UnitSpeech(**DEC)
    port.load_state_dict(dec_state)
    single = reverse_diffusion(port.eval(), *sampler_args, **sampler_kw)
    synth = ttts.Synthesizer(ttts.TTSModels.from_checkpoint(ckpt, device="cpu",
                                                            dtype=torch.float32))
    single_mel, single_len = synth.synthesize_mel_batch(SEQS, **synth_kw)
    tol = _mel_tol(ckpt)
    outs = outs()
    assert np.isfinite(want).all() and np.isfinite(want_mel).all() and np.ptp(want_mel) > 1.0
    _close(single, want)
    for o in outs:
        _close(o["mel"], want)
        np.testing.assert_array_equal(o["mel"][2, 11:].numpy(), 0.0)
        np.testing.assert_array_equal(o["y_lengths"], y_lengths)
        np.testing.assert_array_equal(single_len, y_lengths)
        assert o["batch_mel"].shape == want_mel.shape == (b, y_pad, f)
        np.testing.assert_allclose(o["batch_mel"].numpy(), want_mel, rtol=0, atol=tol)
        np.testing.assert_allclose(o["batch_mel"].numpy(), single_mel.numpy(), rtol=0,
                                   atol=1e-3 * tol)
        for i, w in enumerate(o["wavs"]):
            n = int(y_lengths[i]) * m.cfg.data.hop_length
            assert w.shape == (n,)
            np.testing.assert_allclose(w, want_wav[i, :n], rtol=0, atol=5e-3)
        assert all(r is not None and "shards the parameters" in r for r in o["refused"])


# --- 7. distributed transcription ---------------------------------------------


def test_shard_indices_and_merge_match_jax(tmp_path):
    """shard_indices equal JAX's at uneven splits; merge_shards writes JAX's
    file from the same shards and raises where an index is missing."""
    for n, world in ((10, 3), (4, 2), (3, 4), (0, 2)):
        for rank in range(world):
            assert tdt.shard_indices(n, rank, world) == jdt.shard_indices(n, rank, world)
    shards = []
    for r in range(3):
        p = tmp_path / f"s{r}"
        p.write_text("".join(f"{i}\t{i} {i + 1}\n" for i in tdt.shard_indices(7, r, 3)))
        shards.append(str(p))
    tdt.merge_shards(shards, str(tmp_path / "port.txt"), 7)
    jdt.merge_shards(shards, str(tmp_path / "jax.txt"), 7)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    with pytest.raises(RuntimeError, match="missing transcriptions"):
        tdt.merge_shards(shards[:2], str(tmp_path / "x.txt"), 7)


def test_two_rank_transcription_equals_one_rank(tmp_path, monkeypatch):
    """tools.distributed_transcribe at world 2 over a gloo group (each rank
    its strided share, a barrier, rank 0's merge) writes the file the
    single-process run writes, for 4 short wavs through a tiny
    random-weight HuBERT (hubert-test, layer 2) and 50 centroids."""
    from unitspeech_tpu_torch.config import config_from_dict

    ov = {"unit_extractor": {"dense_model_name": "hubert-test", "vocab_size": 50,
                             "hubert_layer": 2}}
    (tmp_path / "cfg.json").write_text(json.dumps(ov))
    cfg = config_from_dict(ov)
    torch.save({"model": ssl_reference.hubert_sd(cfg, 1)}, tmp_path / "hubert.pt")
    from unitspeech_tpu_torch.models.ssl.hubert import hubert_config_by_name

    dim = hubert_config_by_name("hubert-test").embed_dim
    np.savez(tmp_path / "km.npz", centroids=np.random.default_rng(2).standard_normal(
        (50, dim)).astype(np.float32))
    rng = np.random.default_rng(4)
    paths = []
    for i in range(4):
        p = str(tmp_path / f"w{i}.wav")
        write_wav(p, 0.3 * rng.standard_normal(int(16000 * (0.3 + 0.1 * i))), 16000)
        paths.append(p)
    (tmp_path / "manifest.txt").write_text("\n".join(paths) + "\n")

    def argv(out):
        return ["--manifest", str(tmp_path / "manifest.txt"), "--output", str(out), "--hubert",
                str(tmp_path / "hubert.pt"), "--kmeans", str(tmp_path / "km.npz"), "--config",
                str(tmp_path / "cfg.json"), "--device", "cpu"]

    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    d = tmp_path / "group"
    d.mkdir()
    outs = _start(workers.transcribe, d, argv(tmp_path / "two.txt"))
    assert tdt.main(argv(tmp_path / "one.txt")) == 0
    outs = outs()
    assert [o["topology"] for o in outs] == [(0, 2), (1, 2)] and all(o["rc"] == 0 for o in outs)
    one = (tmp_path / "one.txt").read_text()
    assert one == (tmp_path / "two.txt").read_text()
    assert len(one.splitlines()) == 4 and all(line.split() for line in one.splitlines())
    shard1 = (tmp_path / "two.txt.shard1").read_text().splitlines()
    assert [int(line.split("\t")[0]) for line in shard1] == [1, 3]
