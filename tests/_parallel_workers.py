"""The ranks of tests/test_torch_port_parallel.py's and
tests/test_torch_port_seq.py's multi-rank cases. Each
function runs in a spawned process (parallel.run_group) as one rank of a
gloo process group on the CPU, joined through a file under the case's
directory (no port to fight over between test workers), on one torch
thread. It imports only the port, reads the case's inputs.pt, and saves
what it computed to out<rank>.pt beside them, with whether any module of
jax, flax or unitspeech_tpu was imported."""

import copy
import os
import sys

import torch


def _join(rank, world, d, data=None):
    """This process as rank `rank`; the mesh: every rank on data, or `data`
    ranks on data and the rest of the world on seq."""
    torch.set_num_threads(1)
    from unitspeech_tpu_torch.parallel import make_mesh, maybe_initialize_distributed

    assert maybe_initialize_distributed(f"file://{d}/init", world, rank, cpu=True)
    return make_mesh() if data is None else make_mesh(data=data, seq=world // data)


def _done(rank, d, out):
    import torch.distributed as dist

    out["jax_free"] = not any(m.split(".")[0] in ("jax", "jaxlib", "flax", "unitspeech_tpu")
                              for m in sys.modules)
    torch.save(out, os.path.join(d, f"out{rank}.pt"))
    dist.destroy_process_group()


def _inputs(d):
    return torch.load(os.path.join(d, "inputs.pt"), weights_only=False)


def dp_step1(rank, world, d):
    """One data-parallel STEP1 step on this rank's rows, the draws the
    global batch's: the metrics and the parameters after."""
    from unitspeech_tpu_torch.models.diffusion import UnitSpeech
    from unitspeech_tpu_torch.models.duration import DurationPredictor
    from unitspeech_tpu_torch.models.encoder import Encoder
    from unitspeech_tpu_torch.parallel import DataShard, shard_batch
    from unitspeech_tpu_torch.train import steps

    shard = DataShard.of(_join(rank, world, d))
    s = _inputs(d)
    mods = [Encoder(**s["TE"]), DurationPredictor(**s["DP"]), UnitSpeech(**s["DEC"])]
    for m, sd in zip(mods, s["state"]):
        m.load_state_dict(sd)
    opt = torch.optim.Adam([p for m in mods for p in m.parameters()], lr=s["lr"],
                           betas=(0.9, 0.999), eps=1e-8)
    step = steps.make_step1_train_step(*mods, opt, s["seg"], s["spk_uncond"], shard=shard)
    metrics = step(shard_batch(s["batch"], shard), draws=s["draws"])
    _done(rank, d, {"metrics": {k: v.item() for k, v in metrics.items()},
                    "params": [m.state_dict() for m in mods]})


def dp_step2(rank, world, d):
    """One data-parallel STEP2 step, as dp_step1."""
    from unitspeech_tpu_torch.models.diffusion import UnitSpeech
    from unitspeech_tpu_torch.models.encoder import Encoder
    from unitspeech_tpu_torch.parallel import DataShard, shard_batch
    from unitspeech_tpu_torch.train import steps

    shard = DataShard.of(_join(rank, world, d))
    s = _inputs(d)
    ue, dec = Encoder(**s["UE"]), UnitSpeech(**s["DEC"])
    ue.load_state_dict(s["state"][0])
    dec.load_state_dict(s["state"][1])
    opt = torch.optim.Adam(ue.parameters(), lr=s["lr"], betas=(0.9, 0.999), eps=1e-8)
    step = steps.make_step2_train_step(ue, dec, opt, s["seg"], shard=shard)
    metrics = step(shard_batch(s["batch"], shard), draws=s["draws"])
    _done(rank, d, {"metrics": {k: v.item() for k, v in metrics.items()},
                    "params": ue.state_dict()})


def train_loop(rank, world, d, argv):
    """`cli train-step1 --distributed --cpu` (argv: one epoch) as rank
    `rank`, joined by the UNITSPEECH_* variables, each rank its own
    checkpoint and log directories; then a second loop, built afresh,
    resumes (rank 0 reads its checkpoint, rank 1's directory is empty) and
    runs a second epoch. Saves each step's metrics, the state right after
    the resume and the state after the second epoch."""
    torch.set_num_threads(1)
    sys.modules["tensorboardX"] = None  # no TensorBoard writer, as the test's own process
    os.environ.update(UNITSPEECH_COORDINATOR=f"file://{d}/init",
                      UNITSPEECH_NUM_PROCESSES=str(world), UNITSPEECH_PROCESS_ID=str(rank))
    from unitspeech_tpu_torch import cli

    own = ["--checkpoint-dir", os.path.join(d, f"ck{rank}"), "--log-dir",
           os.path.join(d, f"log{rank}")]
    args = cli.step1_parser().parse_args(argv + own)
    _, loop = cli.build_step1(args)
    out = {"main": loop.main, "shard": (loop.shard.rank, loop.shard.size), "metrics": []}
    loop.step_hook = lambda step, m: out["metrics"].append(m)
    out["steps"] = loop.run(args.n_epochs)

    _, loop = cli.build_step1(args)

    def state():  # a copy: the loop updates the parameters in place
        return copy.deepcopy({"modules": {k: m.state_dict() for k, m in loop.modules.items()},
                              "opt": loop.optimizer.state_dict(), "step": loop.step})

    out["start"] = loop.resume()
    out["resumed"] = state()
    out["resumed_steps"] = loop.run(args.n_epochs + 1, out["start"])
    out["final"] = state()
    _done(rank, d, out)


def finetune(rank, world, d):
    """finetune_decoder_batched with the mesh (speaker per rank), and its
    ValueError at a speaker count the data axis does not divide."""
    from unitspeech_tpu_torch.config import DecoderConfig
    from unitspeech_tpu_torch.train.finetune import finetune_decoder_batched

    mesh = _join(rank, world, d)
    x = _inputs(d)
    kw = dict(dtype=torch.float32, segment_size=x["seg"], n_iters=x["iters"],
              learning_rate=x["lr"], grad_clip=1.0)
    state, losses = finetune_decoder_batched(DecoderConfig(**x["DEC"]), x["stacked"], *x["args"],
                                             draws=x["draws"], mesh=mesh, **kw)
    try:
        finetune_decoder_batched(DecoderConfig(**x["DEC"]),
                                 {k: v[:5] for k, v in x["stacked"].items()},
                                 *(a[:5] for a in x["args"]), draws=x["draws"][:5], mesh=mesh,
                                 **kw)
        refused = None
    except ValueError as e:
        refused = str(e)
    _done(rank, d, {"state": state, "losses": losses, "refused": refused})


def sampling(rank, world, d):
    """reverse_diffusion and the Synthesizer's batch paths, data-sharded
    over the mesh; a spec naming 'model' must raise."""
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels
    from unitspeech_tpu_torch.models.diffusion import UnitSpeech, reverse_diffusion

    mesh = _join(rank, world, d)
    x = _inputs(d)
    spec = ("data", None, None)
    dec = UnitSpeech(**x["DEC"])
    dec.load_state_dict(x["dec_state"])
    mel = reverse_diffusion(dec.eval(), *x["sampler_args"], mesh=mesh, sample_spec=spec,
                            **x["sampler_kw"])
    synth = Synthesizer(TTSModels.from_checkpoint(x["ckpt"], device="cpu", dtype=torch.float32,
                                                  use_kernels=True), mesh=mesh, sample_spec=spec)
    batch_mel, y_lengths = synth.synthesize_mel_batch(x["seqs"], **x["synth_kw"])
    wavs = synth.synthesize_batch(x["seqs"], **x["synth_kw"])
    refused = []
    for call in (lambda: Synthesizer(synth.models, mesh=mesh, sample_spec=(None, "model", None)),
                 lambda: reverse_diffusion(dec, *x["sampler_args"], mesh=mesh,
                                           sample_spec=("data", "model", None), **x["sampler_kw"])):
        try:
            call()
            refused.append(None)
        except NotImplementedError as e:
            refused.append(str(e))
    _done(rank, d, {"mel": mel, "batch_mel": batch_mel, "y_lengths": y_lengths,
                    "wavs": [w for w, _ in wavs], "refused": refused})


def seq_primitives(rank, world, d):
    """The seq axis's pieces on this rank's frames of the case's global
    tensors (every rank on seq): the split, halos (with and without a mask,
    one or both sides), the gather, an uneven cat and the draws; at world 2
    also the sharded plain forms (group_mean_inv, the flat bf16 and int8
    convs and the int8 scale, K4's merged partials, K1's and K2's chains),
    each beside the unsharded function on the whole tensor. Saves (got,
    want) pairs by name."""
    from unitspeech_tpu_torch.ops import conv_matmul, fused_attention, fused_resnet, row_stats
    from unitspeech_tpu_torch.parallel import SeqShard

    mesh = _join(rank, world, d, data=1)
    x = _inputs(d)
    shard = SeqShard.of(mesh)
    t = x["T"]
    fs = shard.at(t)
    z = x["z"]  # (B, T, F, C)
    b, _, f, c = z.shape
    m = x["mask"]  # (B, T)
    pad = torch.nn.functional.pad
    pairs = {"split": (torch.tensor(fs.bounds), torch.tensor(x["bounds"]))}
    for before, after in ((1, 1), (1, 0), (2, 1)):
        full = pad(z, (0, 0, 0, 0, before, after))
        pairs[f"halo {before} {after}"] = (
            fs.halo(fs.take(z), before, after),
            full[:, fs.start:fs.start + fs.length + before + after])
    zm = z * m[:, :, None, None]
    full = pad(zm, (0, 0, 0, 0, 1, 1))
    got = fs.halo(fs.take(z), mask=fs.take(m))
    pairs["halo masked edges"] = (got[:, [0, -1]],
                                  full[:, [fs.start, fs.start + fs.length + 1]])
    pairs["gather"] = (fs.gather(fs.take(z)), z)
    sizes = [r + 1 for r in range(world)]
    part = torch.full((2, sizes[rank], 3), float(rank + 1))
    pairs["cat"] = (fs.cat(part, sizes), torch.cat([torch.full((2, n, 3), float(r + 1))
                                                   for r, n in enumerate(sizes)], dim=1))
    g0, g1 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    pairs["randn"] = (fs.randn((b, fs.length, f), g0), fs.take(torch.randn((b, t, f),
                                                                           generator=g1)))
    pairs["down"] = (torch.tensor([fs.down().t, fs.down().start, fs.down().length]),
                     torch.tensor([t // 2, fs.start // 2, fs.length // 2]))
    if world == 2:
        rows = z.reshape(b, t * f, c)
        loc = fs.take(z).reshape(b, fs.length * f, c)
        pairs["group_mean_inv"] = (torch.stack(row_stats.group_mean_inv(loc, 4, seq=fs)),
                                   torch.stack(row_stats.group_mean_inv(rows, 4)))
        w = x["w"]
        want = conv_matmul.conv3x3_rows(rows.to(torch.bfloat16), w, f)
        pairs["conv3x3_rows bf16"] = (conv_matmul.conv3x3_rows(loc.to(torch.bfloat16), w, f,
                                                               seq=fs),
                                      fs.take(want.reshape(b, t, f, -1)).reshape(want.shape[0],
                                                                                -1, w.shape[-1]))
        want = conv_matmul.conv3x3_int8(rows, w, f)
        pairs["conv3x3_int8"] = (conv_matmul.conv3x3_int8(loc, w, f, seq=fs),
                                 fs.take(want.reshape(b, t, f, -1)).reshape(b, -1, w.shape[-1]))
        pairs["int8 scale"] = (conv_matmul.quantize_activation(loc, seq=fs)[1],
                               conv_matmul.quantize_activation(rows)[1])
        lens = x["lens"] * f  # valid rows of the whole sequence
        ll = torch.clamp(lens - fs.start * f, 0, fs.length * f).to(torch.int32)
        a = x["attn"]
        want = fused_attention.rezero_attention_plain(rows, *a, lens, 4, 32)
        pairs["K4 merged partials"] = (
            fused_attention.fused_rezero_attention(loc, *a, ll, seq=fs),
            fs.take(want.reshape(b, t, f, c)).reshape(b, -1, c))
        for name, p in x["blocks"].items():
            cin = p["w1"].shape[2]
            xin = z[..., :cin].reshape(b, t * f, cin)
            xl = fs.take(z[..., :cin]).reshape(b, fs.length * f, cin)
            args = (p["t_bias"], p["w1"].reshape(9 * cin, -1), p["b1"], p["s1"], p["be1"],
                    p["w2"].reshape(-1, p["w2"].shape[-1]), p["b2"], p["s2"], p["be2"],
                    p["wres"], p["bres"])
            want = fused_resnet.resnet_block_plain(xin, lens, *args, f=f, groups=4)
            got = fused_resnet.resnet_block_seq(xl, ll, *args, f=f, groups=4, seq=fs)
            pairs[f"K1 chain {name}"] = (got, fs.take(want.reshape(b, t, f, -1)).reshape(
                got.shape))
        p = x["final"]
        want = fused_resnet.final_block_plain(rows, lens, p["w1"].reshape(9 * c, -1), p["b1"],
                                              p["s1"], p["be1"], p["wo"], p["bo"], f=f, groups=4)
        got = fused_resnet.final_block_seq(loc, ll, p["w1"].reshape(9 * c, -1), p["b1"],
                                           p["s1"], p["be1"], p["wo"], p["bo"], f=f, groups=4,
                                           seq=fs)
        pairs["K2 chain"] = (got, fs.take(want.reshape(b, t, f)).reshape(got.shape))
    pairs["collectives"] = (torch.tensor(SeqShard.collectives), torch.tensor(-1))
    _done(rank, d, {"pairs": pairs})


class _StubLib:
    """The CUDA library's stand-in: every launch returns 0 (success); the
    tile and chunk counts the wrappers allocate by are 1."""

    def __getattr__(self, name):
        return lambda *a: 1 if name.endswith(("_chunks", "_tiles")) else 0


def _route_stand_ins(calls):
    """Each kernel wrapper, the K3 statistics and the int8 conv the
    estimator calls run their CUDA branch first against the stub library
    (their argument checks raise on what the kernels do not take; the seq
    collectives run as on the card), then their plain version, whose result
    they return; calls logs (name, input width, whether it was given a
    frame slice). Returns the undo function."""
    from unitspeech_tpu_torch.models import unet
    from unitspeech_tpu_torch.ops import _cuda

    saved = []

    def patch(mod, name, value):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    def launch_branch():
        def require(t, what, dtype=None, shape=None, device=None):
            if dtype is not None and t.dtype != dtype:
                raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
            if shape is not None and tuple(t.shape) != tuple(shape):
                raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
            return t

        old = {k: getattr(_cuda, k) for k in ("route", "lib", "require", "stream")}
        _cuda.route, _cuda.lib = (lambda x, what: True), (lambda: _StubLib())
        _cuda.require, _cuda.stream = require, (lambda x: None)
        return lambda: [setattr(_cuda, k, v) for k, v in old.items()]

    for name in ("fused_resnet_block", "fused_final_block", "fused_rezero_attention",
                 "group_mean_inv", "conv3x3_int8"):
        real = getattr(unet, name)

        def stand_in(x, *a, _real=real, _name=name, **kw):
            if _name in ("fused_resnet_block", "fused_final_block", "fused_rezero_attention",
                         "group_mean_inv"):
                undo = launch_branch()
                try:
                    _real(x, *a, **kw)
                finally:
                    undo()
            calls.append((_name, x.shape[-1], kw.get("seq") is not None))
            return _real(x, *a, **kw)

        patch(unet, name, stand_in)
    return lambda: [setattr(m, n, v) for m, n, v in reversed(saved)]


def seq_sampling(rank, world, d):
    """Every rank on seq: reverse_diffusion (dual guidance, injected noise;
    and at the guidance stride with JAX's fold_in draws) and
    reverse_diffusion_ode (with and without the stride) through the mesh
    with sample_spec (None, "seq", None); then one call of the case's
    route estimator (every kernel switch that takes a seq slice, int8 on)
    on this rank's frames under the route stand-ins, rank 0 also without a
    slice; the rezero attention's gate at the global tokens; the spec naming
    'model' and a seq slice on the fused deep configuration must raise."""
    from unitspeech_tpu_torch.models.diffusion import (
        UnitSpeech,
        reverse_diffusion,
        reverse_diffusion_ode,
    )
    from unitspeech_tpu_torch.models.unet import GradLogPEstimator2d
    from unitspeech_tpu_torch.parallel import SeqShard

    mesh = _join(rank, world, d, data=1)
    x = _inputs(d)
    dec = UnitSpeech(**x["DEC"], use_kernels=True)
    dec.load_state_dict(x["dec_state"])
    dec.eval()
    args, kw = x["sampler_args"], x["sampler_kw"]
    spec = (None, "seq", None)
    mels = {
        "ddpm": reverse_diffusion(dec, *args, noises=x["noises"], mesh=mesh, sample_spec=spec,
                                  **kw),
        "ddpm:cs2": reverse_diffusion(dec, *args, noises=x["fold_in_noises"], cfg_stride=2,
                                      mesh=mesh, sample_spec=spec, **kw),
        "dpm2": reverse_diffusion_ode(dec, *args, mesh=mesh, sample_spec=spec, **kw),
        "dpm2:cs2": reverse_diffusion_ode(dec, *args, cfg_stride=2, mesh=mesh,
                                          sample_spec=spec, **kw)}
    est = GradLogPEstimator2d(**x["ROUTE_EST"], use_kernels=True, use_int8_deep=True)
    est.load_state_dict(x["route_state"])
    xs, mask, mu, t, spk = x["route_args"]
    fs = SeqShard.of(mesh).at(xs.shape[1])
    calls = []
    undo = _route_stand_ins(calls)
    try:
        with torch.no_grad():
            SeqShard.collectives = 0
            local = est(fs.take(xs), fs.take(mask), fs.take(mu), t, spk, seq=fs)
            n_coll = SeqShard.collectives
            score = fs.gather(local)
    finally:
        undo()
    whole = None
    if rank == 0:
        with torch.no_grad():
            whole = est(xs, mask, mu, t, spk)
    attn = est.down_0_attn
    h = xs.new_zeros((1, fs.length, xs.shape[2], est.dims[0]))
    gate = {"global": attn.uses_kernel(h, True, fs), "local": attn.uses_kernel(h, True),
            "local_tokens": h.shape[1] * h.shape[2]}
    refused = []
    deep = GradLogPEstimator2d(**x["ROUTE_EST"], use_kernels=True, use_deep=True)
    for call in (lambda: reverse_diffusion(dec, *args, mesh=mesh, sample_spec=(None, "model",
                                                                               None), **kw),
                 lambda: deep(fs.take(xs), fs.take(mask), fs.take(mu), t, spk, seq=fs)):
        try:
            call()
            refused.append(None)
        except NotImplementedError as e:
            refused.append(str(e))
    _done(rank, d, {"mels": mels, "calls": calls, "score": score, "whole": whole,
                    "collectives": n_coll, "gate": gate, "refused": refused})


def seq_synthesis(rank, world, d):
    """A (data 2, seq world / 2) mesh: the Synthesizer's batch paths with
    sample_spec ("data", "seq", None)."""
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels

    mesh = _join(rank, world, d, data=2)
    x = _inputs(d)
    synth = Synthesizer(TTSModels.from_checkpoint(x["ckpt"], device="cpu", dtype=torch.float32,
                                                  use_kernels=True), mesh=mesh,
                        sample_spec=("data", "seq", None))
    mel, y_lengths = synth.synthesize_mel_batch(x["seqs"], **x["synth_kw"])
    wavs = synth.synthesize_batch(x["seqs"], **x["synth_kw"])
    _done(rank, d, {"mel": mel, "y_lengths": y_lengths, "wavs": [w for w, _ in wavs]})


def transcribe(rank, world, d, argv):
    """tools.distributed_transcribe's main as rank `rank` of the group."""
    from unitspeech_tpu_torch.tools import distributed_transcribe

    _join(rank, world, d)
    _done(rank, d, {"rc": distributed_transcribe.main(argv),
                    "topology": distributed_transcribe.process_topology()})
