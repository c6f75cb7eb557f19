"""The ranks of tests/test_torch_port_parallel.py's,
tests/test_torch_port_seq.py's and tests/test_torch_port_tp.py's
multi-rank cases. Each
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


def _join(rank, world, d, data=None, model=1):
    """This process as rank `rank`; the mesh: every rank on data, or `data`
    ranks on data, `model` on model and the rest of the world on seq."""
    torch.set_num_threads(1)
    from unitspeech_tpu_torch.parallel import make_mesh, maybe_initialize_distributed

    assert maybe_initialize_distributed(f"file://{d}/init", world, rank, cpu=True)
    if data is None:
        return make_mesh()
    return make_mesh(data=data, seq=world // (data * model), model=model)


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
        except ValueError as e:
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
            got = fused_resnet.resnet_block_sharded(xl, ll, *args, f=f, groups=4, seq=fs)
            pairs[f"K1 chain {name}"] = (got, fs.take(want.reshape(b, t, f, -1)).reshape(
                got.shape))
        p = x["final"]
        want = fused_resnet.final_block_plain(rows, lens, p["w1"].reshape(9 * c, -1), p["b1"],
                                              p["s1"], p["be1"], p["wo"], p["bo"], f=f, groups=4)
        got = fused_resnet.final_block_sharded(loc, ll, p["w1"].reshape(9 * c, -1), p["b1"],
                                           p["s1"], p["be1"], p["wo"], p["bo"], f=f, groups=4,
                                           seq=fs)
        pairs["K2 chain"] = (got, fs.take(want.reshape(b, t, f)).reshape(got.shape))
        pairs.update(_deep_site_pairs(x, lambda v: fs.take(v), seq=fs))
    pairs["collectives"] = (torch.tensor(SeqShard.collectives), torch.tensor(-1))
    _done(rank, d, {"pairs": pairs})


def _deep_site_pairs(x, local, seq=None, ms=None):
    """The fused deep configuration's sharded forms on this rank's slice
    (seq: frames, `local` takes a (B, T, ...) tensor's; ms: columns of the
    weights) against the unsharded plain forms on the whole input, the
    rank's part kept: K8 (K1's chain), K9's chain (Cin = Cout, Cin > Cout
    with conv1 in bf16, a zero-length row with max|x| = 1e-3), K11a and
    K11b. -> {name: (got, want)}."""
    from unitspeech_tpu_torch.ops import fused_resnet, fused_resnet_deep as frd, resample

    cols = (lambda v: v) if ms is None else (lambda v: None if v is None else ms.take(v))
    mask = x["mask"]
    pairs = {}
    for name, p in x["deep"].items():
        xz, lens_f = p["x"], p["lens"]
        b, t, f, cin = xz.shape
        cout = p["w1"].shape[-1]
        m = (torch.arange(t)[None, :] < lens_f[:, None]).float()
        lens = (lens_f * f).to(torch.int32)
        ll = lens if seq is None else torch.clamp(lens - seq.start * f, 0,
                                                  seq.length * f).to(torch.int32)
        rows = xz.reshape(b, t * f, cin)
        xl = local(xz).reshape(b, -1, cin)
        w1r, w2r = p["w1"].reshape(9 * cin, cout), p["w2"].reshape(9 * cout, cout)
        wres = None if p["wres"] is None else p["wres"].reshape(cin, cout)

        def kept(v):
            return local(v.reshape(b, t, f, -1)).reshape(b, -1, v.shape[-1])

        if name.startswith("K8"):
            want = fused_resnet.resnet_block_plain(rows, lens, p["t_bias"], w1r, p["b1"], p["s1"],
                                                   p["be1"], w2r, p["b2"], p["s2"], p["be2"],
                                                   wres, p["bres"], f=f, groups=4)
            got = frd.fused_resnet_block_deep(
                local(xz), local(m)[:, :, None, None], cols(p["t_bias"]), cols(p["w1"]),
                cols(p["b1"]), p["s1"], p["be1"], cols(p["w2"]), cols(p["b2"]), p["s2"],
                p["be2"], cols(p["wres"]), cols(p["bres"]), groups=4, seq=seq, model=ms)
            pairs[name] = (got.reshape(b, -1, cout), kept(want))
            continue
        want = frd.resnet_block_deep_i8_plain(
            rows, lens, p["t_bias"], w1r, frd.quant_w(w1r), p["b1"], p["s1"], p["be1"],
            frd.quant_w(w2r), p["b2"], p["s2"], p["be2"], wres, p["bres"], f=f, groups=4)
        got = frd.resnet_block_deep_i8_sharded(
            xl, ll, cols(p["t_bias"]), cols(w1r), frd.quant_w(cols(w1r)), cols(p["b1"]), p["s1"],
            p["be1"], frd.quant_w(cols(w2r)), cols(p["b2"]), p["s2"], p["be2"], cols(wres),
            cols(p["bres"]), f=f, groups=4, seq=seq, model=ms)
        pairs[name] = (got, kept(want))
    z, (wd, bd), (wu, bu) = x["z"], x["down"], x["up"]
    mz = mask[:, :, None, None]
    want = resample.downsample_conv_plain(z, mz, wd, bd)
    got = resample.fused_downsample_conv(local(z), local(mz), cols(wd), cols(bd), seq=seq,
                                         model=ms)
    pairs["K11a"] = (got, want if seq is None else seq.down().take(want))
    want = resample.upsample_conv_plain(z, mz, wu, bu)
    got = resample.fused_upsample_conv(local(z), local(mz), cols(wu), cols(bu), seq=seq,
                                       model=ms)
    if seq is not None:
        want = want.narrow(1, 2 * seq.start, 2 * seq.length)
    pairs["K11b"] = (got, want)
    return pairs


class _StubLib:
    """The CUDA library's stand-in: every launch returns 0 (success); the
    tile, chunk and block counts the wrappers allocate by are 1."""

    def __getattr__(self, name):
        return lambda *a: 1 if name.endswith(("_chunks", "_tiles", "_blocks")) else 0


# the kernel wrappers the estimator calls, whose CUDA branch the route
# stand-ins run against the stub library
LAUNCHED = ("fused_resnet_block", "fused_final_block", "fused_rezero_attention",
            "group_mean_inv", "fused_resnet_block_deep", "fused_resnet_block_deep_i8",
            "fused_downsample_conv", "fused_upsample_conv")


def _route_stand_ins(calls):
    """Each kernel wrapper, the K3 statistics and the int8 conv the
    estimator calls run their CUDA branch first against the stub library
    (their argument checks raise on what the kernels do not take; the seq
    and model collectives run as on the card), then their plain version,
    whose result they return; calls logs (name, input width, whether it was
    given a frame slice or a model shard). Returns the undo function."""
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

    for name in LAUNCHED + ("conv3x3_int8",):
        real = getattr(unet, name)

        def stand_in(x, *a, _real=real, _name=name, **kw):
            if _name in LAUNCHED:
                undo = launch_branch()
                try:
                    _real(x, *a, **kw)
                finally:
                    undo()
            calls.append((_name, x.shape[-1],
                          kw.get("seq") is not None or kw.get("model") is not None))
            return _real(x, *a, **kw)

        patch(unet, name, stand_in)
    return lambda: [setattr(m, n, v) for m, n, v in reversed(saved)]


# the fused deep-stage configuration's switches, by path
DEEP_FLAGS = {"deep": dict(use_deep=True, use_resample=True),
              "deep_i8": dict(use_deep=True, use_resample=True, use_int8_deep=True,
                              use_i8pre_deep=True)}


def _routed_call(est, args, seq=None, ms=None):
    """One call of `est` under the route stand-ins, no gradients: the seq
    and model collectives counted from 0; on a frame slice `seq` the inputs'
    frames taken and the score gathered. -> (score, calls, (seq, model)
    collectives)."""
    from unitspeech_tpu_torch.parallel import ModelShard, SeqShard

    xs, mask, mu, t, spk = args
    calls = []
    undo = _route_stand_ins(calls)
    try:
        with torch.no_grad():
            SeqShard.collectives = ModelShard.collectives = 0
            if seq is None:
                score = est(xs, mask, mu, t, spk)
            else:
                score = est(seq.take(xs), seq.take(mask), seq.take(mu), t, spk, seq=seq)
            coll = (SeqShard.collectives, ModelShard.collectives)
            if seq is not None:
                score = seq.gather(score)
    finally:
        undo()
    return score, calls, coll


def _deep_samplers(x, mesh=None, spec=None, tp=False, paths=DEEP_FLAGS,
                   samplers=("ddpm", "dpm2")):
    """The case's decoder on each fused deep path (kernels on), its weights
    sharded over the mesh's model axis with tp: ddpm (injected noise) and
    dpm2 through the mesh with `spec`. -> {"<path> <sampler>": mel}."""
    from unitspeech_tpu_torch.models.diffusion import (
        UnitSpeech,
        reverse_diffusion,
        reverse_diffusion_ode,
    )
    from unitspeech_tpu_torch.parallel.tp import shard_params_tp

    args, kw = x["sampler_args"], x["sampler_kw"]
    common = {} if spec is None else {"mesh": mesh, "sample_spec": spec}
    out = {}
    for path in paths:
        dec = UnitSpeech(**x["DEC"], use_kernels=True, **DEEP_FLAGS[path])
        dec.load_state_dict(x["dec_state"])
        dec.eval()
        if tp:
            shard_params_tp(dec, mesh)
        for sampler in samplers:
            if sampler == "ddpm":
                out[f"{path} ddpm"] = reverse_diffusion(dec, *args, noises=x["noises"], **common,
                                                        **kw)
            else:
                out[f"{path} dpm2"] = reverse_diffusion_ode(dec, *args, **common, **kw)
    return out


def seq_sampling(rank, world, d):
    """Every rank on seq: reverse_diffusion (dual guidance, injected noise;
    and at the guidance stride with JAX's fold_in draws) and
    reverse_diffusion_ode (with and without the stride) through the mesh
    with sample_spec (None, "seq", None), and ddpm and dpm2 on the fused
    deep paths; then one call of the case's route estimator (every kernel
    switch that takes a seq slice, int8 on) on this rank's frames under the
    route stand-ins, and one of the route estimator with the fused deep
    configuration (K8, K9, K11), rank 0 also each without a slice; the
    rezero attention's gate at the global tokens; the spec naming 'model'
    must raise, and a seq slice on the fused deep configuration (bf16)
    runs."""
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
    mels.update(_deep_samplers(x, mesh, spec))
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
    est = GradLogPEstimator2d(**x["ROUTE_EST"], use_kernels=True, **DEEP_FLAGS["deep_i8"])
    est.load_state_dict(x["route_state"])
    deep_i8 = dict(zip(("score", "calls", "collectives"), _routed_call(est, x["route_args"], fs)))
    deep_i8["whole"] = _routed_call(est, x["route_args"])[0] if rank == 0 else None
    refused = []
    deep = GradLogPEstimator2d(**x["ROUTE_EST"], use_kernels=True, use_deep=True)
    deep.load_state_dict(x["route_state"])
    deep_calls = []
    for call in (lambda: reverse_diffusion(dec, *args, mesh=mesh, sample_spec=(None, "model",
                                                                               None), **kw),
                 lambda: deep_calls.extend(_routed_call(deep, x["route_args"], fs)[1])):
        try:
            call()
            refused.append(None)
        except (NotImplementedError, ValueError) as e:
            refused.append(f"{type(e).__name__}: {e}")
    _done(rank, d, {"mels": mels, "calls": calls, "score": score, "whole": whole,
                    "collectives": n_coll, "gate": gate, "refused": refused, "deep_i8": deep_i8,
                    "deep_calls": deep_calls})


def seq_synthesis(rank, world, d):
    """A (data 2, seq world / 2) mesh: the Synthesizer's batch paths with
    sample_spec ("data", "seq", None), then its batched mel with the fused
    deep configuration (use_deep, use_resample)."""
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels

    mesh = _join(rank, world, d, data=2)
    x = _inputs(d)
    synth = Synthesizer(TTSModels.from_checkpoint(x["ckpt"], device="cpu", dtype=torch.float32,
                                                  use_kernels=True), mesh=mesh,
                        sample_spec=("data", "seq", None))
    mel, y_lengths = synth.synthesize_mel_batch(x["seqs"], **x["synth_kw"])
    wavs = synth.synthesize_batch(x["seqs"], **x["synth_kw"])
    deep = Synthesizer(TTSModels.from_checkpoint(x["ckpt"], device="cpu", dtype=torch.float32,
                                                 use_kernels=True, **DEEP_FLAGS["deep"]),
                       mesh=mesh, sample_spec=("data", "seq", None))
    _done(rank, d, {"mel": mel, "y_lengths": y_lengths, "wavs": [w for w, _ in wavs],
                    "deep_mel": deep.synthesize_mel_batch(x["seqs"], **x["synth_kw"])[0]})


def transcribe(rank, world, d, argv):
    """tools.distributed_transcribe's main as rank `rank` of the group."""
    from unitspeech_tpu_torch.tools import distributed_transcribe

    _join(rank, world, d)
    _done(rank, d, {"rc": distributed_transcribe.main(argv),
                    "topology": distributed_transcribe.process_topology()})


def _tp_layer_pairs(ms, x):
    """Each layer's model form (a copy sharded with parallel.tp) against
    the layer itself: the forwards, and a Dense's input and kernel
    gradients under autograd (the gather's and enter's backwards)."""
    from unitspeech_tpu_torch.models.layers import (
        Conv1d,
        Conv2d,
        ConvTranspose1d,
        ConvTranspose2d,
        Dense,
    )
    from unitspeech_tpu_torch.parallel.tp import shard_params_tp

    g = torch.Generator().manual_seed(9)
    layers = {"Dense": (Dense(6, 8), lambda m, v: m(v[:, :, 0, :6])),
              "Conv1d": (Conv1d(6, 8, 3), lambda m, v: m(v[:, :, 0, :6])),
              "Conv1d ncw": (Conv1d(6, 8, 5), lambda m, v: m.ncw(v[:, :, 0, :6].transpose(1, 2),
                                                                 4, dilation=2)),
              "Conv2d": (Conv2d(6, 8, 3), lambda m, v: m(v[..., :6])),
              "Conv2d stride 2": (Conv2d(6, 8, 3), lambda m, v: m(v[..., :6], stride=2)),
              "ConvTranspose2d": (ConvTranspose2d(6, 8, 4, 2, 2), lambda m, v: m(v[..., :6])),
              "ConvTranspose1d": (ConvTranspose1d(6, 8, 4, 2, 2),
                                  lambda m, v: m.ncw(v[:, :, 0, :6].transpose(1, 2)))}
    pairs = {}
    for name, (layer, call) in layers.items():
        for p in layer.parameters():
            p.data = torch.randn(p.shape, generator=g) * 0.3
        sharded = shard_params_tp(copy.deepcopy(layer), ms)
        with torch.no_grad():
            pairs[f"layer {name}"] = (call(sharded, x), call(layer, x))
    dense = layers["Dense"][0]
    whole = copy.deepcopy(dense)
    sharded = shard_params_tp(copy.deepcopy(dense), ms)
    weight = torch.randn(x.shape[:2] + (8,), generator=g)
    grads = []
    for m in (whole, sharded):
        xin = x[:, :, 0, :6].clone().requires_grad_(True)
        (m(xin) * weight).sum().backward()
        grads.append((xin.grad, m.kernel.grad, m.bias.grad))
    pairs["Dense grad input"] = (grads[1][0], grads[0][0])
    pairs["Dense grad kernel"] = (grads[1][1], ms.take(grads[0][1]))
    pairs["Dense grad bias"] = (grads[1][2], ms.take(grads[0][2], 0))
    return pairs


def _tp_sites(mesh, x):
    """On a (data 1, seq 1, model n) mesh, every site's model form against
    the same site whole: the layers (and a Dense under autograd), K3's
    statistics on the slice's groups (whole and straddling), the flat bf16
    and int8 convs on a Cout slice, K1's chain (the 1x1 residual, the
    identity, one group straddling the ranks), K2's chain, K4 whole on
    every rank (design b) and the plain attention; the round trip of the
    case's modules through shard_params_tp and gather_params_tp; one call
    of the route estimator under the route stand-ins (the kernel sites'
    CUDA branches against the stub library) with the model axis's
    collectives counted. Returns (got, want) pairs by name and the rest."""
    from unitspeech_tpu_torch.models.unet import GradLogPEstimator2d, ResnetBlock, RezeroAttention
    from unitspeech_tpu_torch.ops import conv_matmul, fused_resnet, row_stats
    from unitspeech_tpu_torch.parallel import ModelShard
    from unitspeech_tpu_torch.parallel.tp import gather_params_tp, is_sharded, shard_params_tp

    ms = ModelShard.of(mesh)
    z = x["z"]  # (B, T, F, C)
    b, t, f, c = z.shape
    rows = z.reshape(b, t * f, c)
    lens = x["lens"] * f
    mask = x["mask"][:, :, None, None]
    pairs = _tp_layer_pairs(ms, z)
    ModelShard.collectives = 0
    for groups in (4, 3):  # 2 whole groups a rank; groups of 4 over 6-channel slices
        xs = rows[..., :12]
        got = row_stats.group_mean_inv(ms.take(xs), groups, model=ms)
        want = row_stats.group_mean_inv(xs, groups)
        pairs[f"group_mean_inv groups {groups}"] = (torch.stack(got),
                                                    torch.stack([ms.take(w) for w in want]))
    w = x["w"]
    pairs["conv3x3_rows bf16"] = (
        conv_matmul.conv3x3_rows(rows.to(torch.bfloat16), ms.take(w), f),
        ms.take(conv_matmul.conv3x3_rows(rows.to(torch.bfloat16), w, f)))
    pairs["conv3x3_int8"] = (conv_matmul.conv3x3_int8(rows, ms.take(w), f),
                             ms.take(conv_matmul.conv3x3_int8(rows, w, f)))
    for name, p in x["blocks"].items():
        cin = p["w1"].shape[2]
        xin = z[..., :cin]
        kw = {k: p[k] for k in ("t_bias", "w1", "b1", "gn1_scale", "gn1_bias", "w2", "b2",
                                "gn2_scale", "gn2_bias", "wres", "bres")}
        want = fused_resnet.fused_resnet_block(xin, mask, groups=p["groups"], **kw)
        for k in ("t_bias", "w1", "b1", "w2", "b2", "wres", "bres"):
            if kw[k] is not None:
                kw[k] = ms.take(kw[k], -1)
        got = fused_resnet.fused_resnet_block(xin, mask, groups=p["groups"], model=ms, **kw)
        pairs[f"K1 chain {name}"] = (got, want)
    p = x["final"]
    args = (p["b1"], p["s1"], p["be1"], p["wo"], p["bo"])
    want = fused_resnet.fused_final_block(z, mask, p["w1"], *args, groups=4)
    got = fused_resnet.fused_final_block(z, mask, ms.take(p["w1"]), ms.take(p["b1"]), *args[1:],
                                         groups=4, model=ms)
    pairs["K2 chain"] = (got, want)
    for kernel in (True, False):
        att = RezeroAttention(128)
        wq, wo, bo, gate = x["attn"]
        att.fn.to_qkv.kernel.data, att.fn.to_out.kernel.data = wq.clone(), wo.clone()
        att.fn.to_out.bias.data, att.g.data = bo.clone(), gate.clone()
        att.pack()
        xa = x["xa"]
        ma = torch.ones(xa.shape[:2] + (1, 1))
        with torch.no_grad():
            want = att(xa, ma, torch.float32, kernel)
            shard_params_tp(att, ms)
            att.pack()
            pairs[f"attention {'K4 whole' if kernel else 'plain'}"] = (
                att(xa, ma, torch.float32, kernel), want)
    n_coll = ModelShard.collectives
    blk = ResnetBlock(512, 512, 8, 8)  # a flat (deep-stage) block, as training runs it
    g = torch.Generator().manual_seed(11)
    for name, prm in blk.named_parameters():
        prm.data = (1.0 if name.endswith("scale") else 0.0) + torch.randn(
            prm.shape, generator=g) * (0.1 if prm.dim() == 1 else prm.shape[-2] ** -0.5 / 3)
    xb = torch.randn((2, 4, 2, 512), generator=g)
    mb, tb = x["mask"][:2, :4, None, None], torch.randn((2, 8), generator=g)
    weight = torch.randn((2, 4, 2, 512), generator=g)
    got = []
    for m in (blk, shard_params_tp(copy.deepcopy(blk), ms)):
        xin = xb.clone().requires_grad_(True)
        out = m(xin, mb, tb, torch.float32, False)
        (out * weight).sum().backward()
        got.append((out.detach(), xin.grad, m.block1.norm.scale.grad, m.block2.conv.kernel.grad,
                    m.mlp.kernel.grad))
    (o1, gx1, gs1, gk1, gm1), (o2, gx2, gs2, gk2, gm2) = got
    pairs["flat block"] = (o2, o1)
    pairs["flat block grad input"] = (gx2, gx1)
    pairs["flat block grad GroupNorm scale"] = (gs2, gs1)
    pairs["flat block grad conv2 kernel"] = (gk2, ms.take(gk1))
    pairs["flat block grad FiLM kernel"] = (gm2, ms.take(gm1))
    rt = {}
    for name, (cls, kw, sd) in x["modules"].items():
        m = cls(**kw)
        m.load_state_dict(sd)
        shard_params_tp(m, mesh)
        back = gather_params_tp(m)
        rt[name] = (sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd),
                    sum(int(is_sharded(q)) for q in m.parameters()))
    est = GradLogPEstimator2d(**x["ROUTE_EST"], use_kernels=True, use_int8_deep=True)
    est.load_state_dict(x["route_state"])
    xs, emask, mu, tt, spk = x["route_args"]
    with torch.no_grad():
        whole = est(xs, emask, mu, tt, spk)
    shard_params_tp(est, mesh)
    calls = []
    undo = _route_stand_ins(calls)
    try:
        with torch.no_grad():
            ModelShard.collectives = 0
            score = est(xs, emask, mu, tt, spk)
            route_coll = ModelShard.collectives
    finally:
        undo()
    routes = {name: est.get_submodule(name).route(xs.shape[1] >> lvl, 16 >> lvl, True, True)
              for name, lvl in (("down_0_res1", 0), ("down_1_res1", 1), ("down_2_res1", 2),
                                ("up_0_res1", 1))}
    ModelShard.collectives = 0
    deep_pairs = _deep_site_pairs(x, lambda v: v, ms=ms)
    deep_pairs_coll = ModelShard.collectives
    est = GradLogPEstimator2d(**x["ROUTE_EST"], use_kernels=True, **DEEP_FLAGS["deep_i8"])
    est.load_state_dict(x["route_state"])
    deep_whole = _routed_call(est, x["route_args"])[0]
    shard_params_tp(est, mesh)
    deep_i8 = dict(zip(("score", "calls", "collectives"), _routed_call(est, x["route_args"])),
                   whole=deep_whole)
    return {"pairs": pairs, "collectives": n_coll, "round_trip": rt, "calls": calls,
            "score": score, "whole": whole, "route_collectives": route_coll, "routes": routes,
            "deep_pairs": deep_pairs, "deep_pairs_collectives": deep_pairs_coll,
            "deep_i8": deep_i8}


def tp_case(rank, world, d):
    """The case's (data, seq, model) layout: with "sites" in the inputs
    first _tp_sites on it; with "world1" each path's samplers unsharded
    first; then the decoder sharded by
    shard_params_tp, reverse_diffusion (dual guidance, injected noise; the
    guidance stride with JAX's fold_in draws) and reverse_diffusion_ode
    (with and without the stride) on the plain and kernel paths, through
    the mesh with the case's sample spec (None: no spec), and the case's
    `deep` samplers on the fused deep paths (_deep_samplers; with "world1"
    also unsharded); the Synthesizer's batch paths with the sharded decoder;
    at a second layout, when the case has one, one DP x TP STEP1 step (the
    modules sharded, the rows of the mesh's data axis) with JAX's draws, its
    parameters gathered; the bf16 deep configuration on a model-sharded
    decoder runs (its kernel calls logged), and a spec naming 'model' must
    raise."""
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels
    from unitspeech_tpu_torch.models.diffusion import (
        UnitSpeech,
        reverse_diffusion,
        reverse_diffusion_ode,
    )
    from unitspeech_tpu_torch.parallel import DataShard, ModelShard, make_mesh, shard_batch
    from unitspeech_tpu_torch.parallel.tp import gather_params_tp, shard_params_tp

    x = _inputs(d)
    data, seq, model = x["layout"]
    mesh = _join(rank, world, d, data=data, model=model)
    assert (mesh["seq"].size(), mesh["model"].size()) == (seq, model)
    sites = _tp_sites(mesh, x["sites"]) if "sites" in x else None
    args, kw = x["sampler_args"], x["sampler_kw"]
    spec = x["spec"]
    def run(dec, **common):
        return {"ddpm": reverse_diffusion(dec, *args, noises=x["noises"], **common, **kw),
                "ddpm:cs2": reverse_diffusion(dec, *args, noises=x["fold_in_noises"],
                                              cfg_stride=2, **common, **kw),
                "dpm2": reverse_diffusion_ode(dec, *args, **common, **kw),
                "dpm2:cs2": reverse_diffusion_ode(dec, *args, cfg_stride=2, **common, **kw)}

    mels, world1 = {}, {}
    for path in ("plain", "kernels"):
        dec = UnitSpeech(**x["DEC"], use_kernels=path == "kernels")
        dec.load_state_dict(x["dec_state"])
        dec.eval()
        if x.get("world1"):  # the unsharded sampler, on these ranks' spare time
            world1[path] = run(dec)
        shard_params_tp(dec, mesh)
        mels[path] = run(dec, mesh=mesh if spec else None, sample_spec=spec)
    deep_paths, deep_samplers = x["deep"]
    if x.get("world1"):
        world1["deep"] = _deep_samplers(x, paths=deep_paths, samplers=deep_samplers)
    mels["deep"] = _deep_samplers(x, mesh, spec, tp=True, paths=deep_paths,
                                  samplers=deep_samplers)
    models = TTSModels.from_checkpoint(x["ckpt"], device="cpu", dtype=torch.float32,
                                       use_kernels=True)
    shard_params_tp(models.decoder, mesh)
    synth = Synthesizer(models, mesh=mesh if spec else None, sample_spec=spec)
    mel, y_lengths = synth.synthesize_mel_batch(x["seqs"], **x["synth_kw"])
    refused = []
    deep = UnitSpeech(**x["DEC"], use_kernels=True, use_deep=True)
    deep.load_state_dict(x["dec_state"])
    shard_params_tp(deep, mesh)
    deep_calls = []

    def deep_call():
        from unitspeech_tpu_torch.models import unet

        real = unet.fused_resnet_block_deep
        unet.fused_resnet_block_deep = lambda h, *a, **kw: (
            deep_calls.append((h.shape[-1], kw.get("model") is not None)), real(h, *a, **kw))[1]
        try:
            with torch.no_grad():
                deep(*args[:3], torch.zeros(args[0].shape[0]), args[3])
        finally:
            unet.fused_resnet_block_deep = real

    for call in (deep_call,
                 lambda: Synthesizer(models, mesh=mesh, sample_spec=(None, None, "model"))):
        try:
            call()
            refused.append(None)
        except (NotImplementedError, ValueError) as e:
            refused.append(f"{type(e).__name__}: {e}")
    out = {"mels": mels, "mel": mel, "y_lengths": y_lengths, "refused": refused,
           "deep_calls": deep_calls, "model_rank": ModelShard.of(mesh).rank, "sites": sites,
           "world1": world1}
    if "step1" in x:
        from unitspeech_tpu_torch.models.duration import DurationPredictor
        from unitspeech_tpu_torch.models.encoder import Encoder
        from unitspeech_tpu_torch.train import steps

        s = x["step1"]
        mesh2 = make_mesh(data=s["layout"][0], seq=s["layout"][1], model=s["layout"][2])
        shard, ms = DataShard.of(mesh2), ModelShard.of(mesh2)
        mods = [Encoder(**s["TE"]), DurationPredictor(**s["DP"]), UnitSpeech(**s["DEC"])]
        for m, sd in zip(mods, s["state"]):
            m.load_state_dict(sd)
            shard_params_tp(m, mesh2)
        opt = torch.optim.Adam([p for m in mods for p in m.parameters()], lr=s["lr"],
                               betas=(0.9, 0.999), eps=1e-8)
        step = steps.make_step1_train_step(*mods, opt, s["seg"], s["spk_uncond"], shard=shard)
        metrics = step(shard_batch(s["batch"], shard), draws=s["draws"])
        out["step1"] = {"metrics": {k: v.item() for k, v in metrics.items()},
                        "params": [gather_params_tp(m) for m in mods],
                        "at": (shard.rank, ms.rank)}
    _done(rank, d, out)
