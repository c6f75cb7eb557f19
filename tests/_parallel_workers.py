"""The ranks of tests/test_torch_port_parallel.py's multi-rank cases. Each
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


def _join(rank, world, d):
    torch.set_num_threads(1)
    from unitspeech_tpu_torch.parallel import make_mesh, maybe_initialize_distributed

    assert maybe_initialize_distributed(f"file://{d}/init", world, rank, cpu=True)
    return make_mesh()


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
    over the mesh; a spec naming 'seq' must raise."""
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
    for call in (lambda: Synthesizer(synth.models, mesh=mesh, sample_spec=(None, "seq", None)),
                 lambda: reverse_diffusion(dec, *x["sampler_args"], mesh=mesh,
                                           sample_spec=("data", "seq", None), **x["sampler_kw"])):
        try:
            call()
            refused.append(None)
        except NotImplementedError as e:
            refused.append(str(e))
    _done(rank, d, {"mel": mel, "batch_mel": batch_mel, "y_lengths": y_lengths,
                    "wavs": [w for w, _ in wavs], "refused": refused})


def transcribe(rank, world, d, argv):
    """tools.distributed_transcribe's main as rank `rank` of the group."""
    from unitspeech_tpu_torch.tools import distributed_transcribe

    _join(rank, world, d)
    _done(rank, d, {"rc": distributed_transcribe.main(argv),
                    "topology": distributed_transcribe.process_topology()})
