"""STEP1 (or STEP2) training throughput at the reference configuration on
one card (counterpart of the root tools/bench_train.py).

The reference trains on one GPU at batch 32 (hydra_config.py:135-150) and
publishes no steps a second. This times the port's `cli train-step1` step
(train/steps.make_step1_train_step: the text encoder, the duration
predictor, MAS on the card (kernel M1, csrc/mas.cu), the 2 s segment crop,
the plain estimator under autograd with bf16 activations on the card,
per-module clipping, Adam, 25% CFG speaker dropout) at full width, batch
32, token bucket --t-x 72, frame bucket --t-y 688 (fix_len_compatibility),
the batch drawn from numpy.random.default_rng(0) in the JAX tool's order,
the parameters from flax's initializers (utils/params.init_params, seed 0).
With --step2 it times the unit encoder's step against the frozen decoder.

Timing: k1 steps (the first call's cost: allocator, cuDNN plans), then k1
and k2 steps again under CUDA events; a step is (t_k2 - t_k1) / (k2 - k1).
Also the peak memory of those steps, the last loss, and M1's share of a
step: M1 alone at the step's (batch, t_x, t_y) under CUDA events.

    python -m unitspeech_tpu_torch.tools.bench_train [--batch 32] [--t-x 72] [--t-y 688]
    python -m unitspeech_tpu_torch.tools.bench_train --small --device cpu   # smoke run

Returns (and prints) one JSON object, JAX's keys plus `card`, `peak_gib`,
`loss`, `m1_ms` and `m1_share`; on the card it is also written to
chiprun_out/bench_train.json.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from unitspeech_tpu_torch.tools import _serving, device_line, median_ms, resolve_device


def _batch(cfg, b, t_x, t_y, dev, step2: bool) -> dict:
    """The JAX tool's random batch (default_rng(0), in its draw order)."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.text_encoder.n_vocab - 1, (b, t_x))
    token_lengths = rng.integers(t_x - 8, t_x + 1, (b,))
    mel = rng.uniform(-1, 1, (b, t_y, cfg.data.n_feats)).astype(np.float32)
    mel_lengths = rng.integers(t_y - 60, t_y + 1, (b,))
    spk = rng.standard_normal((b, cfg.decoder.spk_emb_dim)).astype(np.float32)
    batch = {"tokens": tokens, "token_lengths": token_lengths, "mel": mel,
             "mel_lengths": mel_lengths, "spk_emb": spk}
    if step2:
        batch = {"units": rng.integers(0, cfg.unit_encoder.n_vocab - 1, (b, t_x)),
                 "unit_lengths": token_lengths,
                 "durations": np.full((b, t_x), t_y // t_x, np.float32),
                 "mel": mel, "mel_lengths": mel_lengths, "spk_emb": spk}
    return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in batch.items()}


def run_bench(args, dev) -> dict:
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.models.diffusion import UnitSpeech
    from unitspeech_tpu_torch.models.duration import DurationPredictor
    from unitspeech_tpu_torch.models.encoder import Encoder
    from unitspeech_tpu_torch.ops.masking import fix_len_compatibility, sequence_mask
    from unitspeech_tpu_torch.ops.mas import maximum_path
    from unitspeech_tpu_torch.train.steps import (
        gaussian_log_prior,
        make_step1_train_step,
        make_step2_train_step,
    )
    from unitspeech_tpu_torch.utils.params import init_params

    cfg = _serving.small_config() if args.small else MainConfig()
    if args.small:
        args.batch, args.t_x, args.t_y = 2, 8, 64
    b, t_x = args.batch, args.t_x
    t_y = fix_len_compatibility(args.t_y, cfg.decoder.num_downsamplings)
    out_size = cfg.out_size
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    batch = _batch(cfg, b, t_x, t_y, dev, args.step2)
    names = ("unit_encoder",) if args.step2 else ("text_encoder", "duration_predictor",
                                                   "decoder")
    params = init_params(cfg, torch.Generator().manual_seed(0), names)
    with dev:
        dec = UnitSpeech.from_config(cfg.decoder, dtype=dtype)
        if args.step2:
            modules = {"unit_encoder": Encoder.from_config(cfg.unit_encoder)}
        else:
            modules = {"text_encoder": Encoder.from_config(cfg.text_encoder),
                       "duration_predictor": DurationPredictor.from_config(
                           cfg.duration_predictor), "decoder": dec}
    for name, mod in modules.items():
        mod.load_state_dict(params[name])
        mod.train().requires_grad_(True)
    opt = torch.optim.Adam([p for m in modules.values() for p in m.parameters()],
                           lr=cfg.train.learning_rate, betas=(0.9, 0.999), eps=1e-8)
    if args.step2:
        # the frozen decoder: the same random draw as STEP1's starting point
        dec.load_state_dict(init_params(cfg, torch.Generator().manual_seed(0),
                                        ("decoder",))["decoder"])
        step = make_step2_train_step(modules["unit_encoder"], dec, opt, out_size=out_size,
                                     beta_min=cfg.decoder.beta_min,
                                     beta_max=cfg.decoder.beta_max)
    else:
        step = make_step1_train_step(
            *modules.values(), opt, out_size=out_size,
            spk_uncond=torch.zeros(cfg.decoder.spk_emb_dim, device=dev),
            spk_dropout=cfg.train.spk_dropout, beta_min=cfg.decoder.beta_min,
            beta_max=cfg.decoder.beta_max)
    gen = torch.Generator(device=dev).manual_seed(0)
    losses = []

    def run_k(k):
        for _ in range(k):
            metrics = step(batch, gen)
        losses.append(float(metrics["total_loss"]))  # one scalar to the host: the steps ran

    def timed(k):
        if dev.type != "cuda":
            t0 = time.perf_counter()
            run_k(k)
            return time.perf_counter() - t0
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        run_k(k)
        e.record()
        e.synchronize()
        return a.elapsed_time(e) / 1e3

    t0 = time.perf_counter()
    run_k(args.k1)  # first calls: allocator, cuDNN plans, kernel build
    first_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_k1 = timed(args.k1)
    t_k2 = timed(args.k2)
    per_step = (t_k2 - t_k1) / (args.k2 - args.k1)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else None

    result = {
        "metric": ("step2" if args.step2 else "step1") + "_train_step_seconds",
        "value": round(per_step, 4), "unit": "s/step",
        "batch": b, "t_x": t_x, "t_y": int(t_y), "out_size": int(out_size),
        "steps_per_sec": round(1.0 / per_step, 3),
        "utterances_per_sec": round(b / per_step, 1),
        "compile_s": round(first_s, 1), "device": dev.type, "card": device_line(dev),
        "peak_gib": peak, "loss": losses[-1],
    }
    if not args.step2:
        # M1 alone at the step's shapes: the alignment search's share of a step
        with torch.no_grad():
            mu_x, _, x_mask = modules["text_encoder"](batch["tokens"], batch["token_lengths"])
            y_mask = sequence_mask(batch["mel_lengths"], t_y, dtype=x_mask.dtype)
            prior = gaussian_log_prior(mu_x, batch["mel"])
            mask = x_mask * y_mask[:, None, :]
            m1 = median_ms(lambda: maximum_path(prior, mask), dev, reps=5, warmup=1)
        result["m1_ms"] = m1
        result["m1_share"] = m1 / (per_step * 1e3)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("unitspeech_tpu_torch.tools.bench_train",
                                 description=__doc__.split("\n")[0])
    _serving.add_common(ap, "bench_train", checkpoint=False)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--t-x", type=int, default=72, help="token bucket")
    ap.add_argument("--t-y", type=int, default=688, help="mel frame bucket")
    ap.add_argument("--k1", type=int, default=2)
    ap.add_argument("--k2", type=int, default=6)
    ap.add_argument("--step2", action="store_true",
                    help="time the STEP2 unit-encoder step (frozen decoder) instead of STEP1")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    result = run_bench(args, dev)
    _serving.write_result(result, args, "bench_train", dev)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
