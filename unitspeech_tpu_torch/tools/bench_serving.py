"""Serving-path latency of one request alone (counterpart of the root
tools/bench_serving.py): the exact path (open-ended tokens with their
predicted durations: encode and duration, the lengths to the host, then
align -> sample -> vocode at their bucket; what `Synthesizer.__call__` runs
with no window and no calibrator) and the speculative single-dispatch mode
(`speculative_frames_per_token` = 2.6: one pass at the guessed bucket, the
exact path again on a miss), on 140 random tokens (seed 0), 50 DDPM steps
(2 with --small), dual CFG 1.0 / 1.0, on the serving default (every kernel,
int8 deep convs, bf16). Each mode: one first call, then the median of
--reps calls, each ending with the waveform on the host.

    python -m unitspeech_tpu_torch.tools.bench_serving [--reps 5] [--out FILE]
    python -m unitspeech_tpu_torch.tools.bench_serving --small --device cpu   # smoke run

Returns (and prints) {"exact": {...}, "speculative": {...}, "card"}; on the
card it is also written to chiprun_out/bench_serving.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from unitspeech_tpu_torch.tools import _serving, device_line, resolve_device

SPECULATIVE_FRAMES_PER_TOKEN = 2.6
STEPS = 50


def _mode(synth, tokens, steps, reps, dev) -> dict:
    """First call, then the median of `reps` calls (generator seeds 0..reps-1)."""
    kw = dict(diffusion_steps=steps, text_gradient_scale=1.0, spk_gradient_scale=1.0)
    t0 = time.perf_counter()
    wav, sr, _ = synth(tokens, torch.Generator(device=dev).manual_seed(42), **kw)
    first = time.perf_counter() - t0
    ts = []
    for i in range(reps):
        t0 = time.perf_counter()
        wav, sr, _ = synth(tokens, torch.Generator(device=dev).manual_seed(i), **kw)
        ts.append(time.perf_counter() - t0)
    proc = float(np.median(ts))
    speech = wav.shape[0] / sr
    return {"first_s": round(first, 3), "proc_s": round(proc, 4), "speech_s": round(speech, 3),
            "rtf": round(proc / speech, 4), "samples": int(wav.shape[0])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("unitspeech_tpu_torch.tools.bench_serving",
                                 description=__doc__.split("\n")[0])
    _serving.add_common(ap, "bench_serving")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    synth = _serving.build(_serving.checkpoint(args), dev)
    n_vocab = synth.models.cfg.text_encoder.n_vocab
    rng = np.random.default_rng(0)
    tokens = [int(t) for t in rng.integers(1, n_vocab - 1, (12 if args.small else 140,))]
    steps = 2 if args.small else STEPS
    out = {"steps": steps, "tokens": len(tokens), "card": device_line(dev)}
    out["exact"] = _mode(synth, tokens, steps, args.reps, dev)
    print(f"exact-path serving: proc {out['exact']['proc_s']:.3f} s, speech "
          f"{out['exact']['speech_s']:.2f} s, RTF {out['exact']['rtf']:.4f}", flush=True)
    spec = dataclasses.replace(synth, speculative_frames_per_token=SPECULATIVE_FRAMES_PER_TOKEN)
    out["speculative"] = _mode(spec, tokens, steps, args.reps, dev)
    print(f"speculative serving ({SPECULATIVE_FRAMES_PER_TOKEN} frames a token): proc "
          f"{out['speculative']['proc_s']:.3f} s, speech {out['speculative']['speech_s']:.2f} s, "
          f"RTF {out['speculative']['rtf']:.4f} ({out['card']})", flush=True)
    _serving.write_result(out, args, "bench_serving", dev)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
