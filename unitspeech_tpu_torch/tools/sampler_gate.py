"""Quality gates of the sampler specs (the port's counterpart of the JAX
package's tools/dpm2_gate.py and tools/cfg_gate.py), at full width with
random weights from a seed and identical priors, on the card:

  * dpm2's discretization error: mel L1(dpm2@N, dpm2@200) for N = 25, 16,
    10 (the same deterministic flow from the same z; the 200-step run
    stands for the converged solution);
  * the guidance stride: mel L1(sampler@N:csK, sampler@N) for ddpm@50 and
    dpm2@25, K = 2, 3 (the same sampler, steps and noise at stride 1: the
    only difference is the cached guidance delta), on the bf16 kernel path
    and on the int8 serving default;
  * for scale, the bf16 kernel path's ddpm@50 against the plain f32 path's.

Each L1 is reported as a fraction of the f32 mel's dynamic range (max -
min), the JAX records' unit, against their gate of 2% (@25 for dpm2, :cs2
for the stride). These are numerics of the algorithm, not speeds; the
milliseconds beside them are the card's wall per request.

    python -m unitspeech_tpu_torch.tools.sampler_gate [--seeds 0 1] [--noise-keys 0 1 2]
        [--out FILE]

`--device cpu` runs the plain versions, its times the host's; `gate()`
takes smaller sizes (tests/test_torch_port_config.py runs it at test
widths).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from unitspeech_tpu_torch.tools import device_line, resolve_device
from unitspeech_tpu_torch.utils.precision import strict_f32

GATE = 0.02
DISC_STEPS, REF_STEPS = (25, 16, 10), 200
STRIDE_CONFIGS, STRIDES = (("ddpm", 50), ("dpm2", 25)), (2, 3)
FRAMES, N_TOK = 344, 140
# the paths: (name, dtype, kernels, int8 deep convs)
PATHS = (("bf16", torch.bfloat16, True, False), ("int8", torch.bfloat16, True, True),
         ("plain_f32", torch.float32, False, False))


def _synthesizers(cfg, seed, device):
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels
    from unitspeech_tpu_torch.utils.params import random_params

    ckpt = random_params(cfg, seed)
    return {name: Synthesizer(TTSModels.from_checkpoint(
        ckpt, device=device, dtype=dtype, use_kernels=kernels, use_int8_deep=int8,
        with_vocoder=False)) for name, dtype, kernels, int8 in PATHS}


def gate(cfg, seeds, noise_keys, device, frames=FRAMES, n_tok=N_TOK, disc_steps=DISC_STEPS,
         ref_steps=REF_STEPS, stride_configs=STRIDE_CONFIGS, strides=STRIDES) -> dict:
    """The measurements for each weight seed x noise key, and their maxima
    (`max_frac`) with the verdicts (`pass`)."""
    from unitspeech_tpu_torch.infer.tts import forced_durations
    from unitspeech_tpu_torch.ops.masking import (
        choose_bucket,
        default_frame_buckets,
        fix_len_compatibility,
    )

    ids = np.random.default_rng(0).integers(1, 179, n_tok).tolist()
    durations = forced_durations(n_tok, frames)
    n_feats = cfg.data.n_feats
    # the priors at the frame bucket the requests resolve
    pad = choose_bucket(fix_len_compatibility(frames, cfg.decoder.num_downsamplings),
                        default_frame_buckets(4096))
    max_steps = max(s for _, s in stride_configs)
    runs = []
    for ws in seeds:
        synths = _synthesizers(cfg, ws, device)
        for nk in noise_keys:
            g = torch.Generator(device=device).manual_seed(nk)
            z = torch.randn((1, pad, n_feats), generator=g, device=device)
            noises = torch.randn((max_steps, 1, pad, n_feats), generator=g, device=device)
            ms = {}

            def mel(path, sampler, steps):
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                out, y_len, _ = synths[path].synthesize_mel(
                    ids, diffusion_steps=steps, text_gradient_scale=1.0,
                    spk_gradient_scale=1.0, durations=durations, noise_z=z,
                    noises=noises[:steps], sampler=sampler)
                out = out[0, :y_len].float().cpu().numpy()
                ms[f"{path}/{sampler}@{steps}"] = (time.perf_counter() - t0) * 1e3
                if not np.isfinite(out).all():
                    raise AssertionError(f"{path} {sampler}@{steps}: non-finite mel")
                return out

            f32 = mel("plain_f32", "ddpm", max_steps)
            span = float(f32.max() - f32.min())
            frac = lambda a, b: float(np.abs(a - b).mean()) / span  # noqa: E731
            row = {"weight_seed": ws, "noise_key": nk, "mel_range": span}
            b16 = mel("bf16", "ddpm", max_steps)
            row["bf16_band_frac"] = frac(b16, f32)
            ref = mel("bf16", "dpm2", ref_steps)
            for n in disc_steps:
                row[f"disc_frac_@{n}"] = frac(mel("bf16", "dpm2", n), ref)
            for path in ("bf16", "int8"):
                for sampler, steps in stride_configs:
                    base = mel(path, sampler, steps)
                    for k in strides:
                        row[f"{path}_{sampler}@{steps}_cs{k}"] = frac(
                            mel(path, f"{sampler}:cs{k}", steps), base)
            row["ms"] = ms
            print(json.dumps(row), flush=True)
            runs.append(row)
    keys = [k for k in runs[0] if k.startswith(("disc_frac", "bf16_", "int8_"))]
    max_frac = {k: max(r[k] for r in runs) for k in keys}
    gated = [f"disc_frac_@{disc_steps[0]}"] + [
        f"{p}_{s}@{n}_cs{strides[0]}" for p in ("bf16", "int8") for s, n in stride_configs]
    return {"frames": frames, "ref_steps": ref_steps, "gate": GATE, "runs": runs,
            "max_frac": max_frac, "gated": gated,
            "pass": bool(all(max_frac[k] <= GATE for k in gated))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("unitspeech-tpu-torch sampler_gate")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1], help="weight seeds")
    ap.add_argument("--noise-keys", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the report here (JSON)")
    args = ap.parse_args(argv)
    from unitspeech_tpu_torch.config import MainConfig

    device = resolve_device(args.device)
    with strict_f32():  # the plain f32 path in full f32 on the card
        report = {"device": device_line(device),
                  **gate(MainConfig(), args.seeds, args.noise_keys, device)}
    print(json.dumps({k: report[k] for k in ("device", "max_frac", "gate", "pass")}),
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
