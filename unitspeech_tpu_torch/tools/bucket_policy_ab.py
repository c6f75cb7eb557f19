"""The bucket-window policies A/B on long-tail traffic, on the card
(counterpart of the root tools/bucket_policy_ab.py).

The cost model (infer/bucket_cost.py, the card's anchors) predicts that on
long-tail traffic the quantile window, which keeps the largest ladder
buckets so that the short majority pads up to tail-sized branches, costs
more than the cost window. This tool measures both through the serving
switch path (`Synthesizer.__call__` with `switch_buckets`: the lengths to
the host, one align -> sample -> vocode at the window's bucket, the exact
bucket on an overflow):

  1. the serving default (every kernel, int8 deep convs, bf16);
  2. 27 short requests (~175 frames) and 3 long ones (~1 300 frames, so
     that K4 runs its C = 1024 stage: buckets from 880 frames), their
     token counts sized by the model's own frames a token (a calibrator on
     4 probes of 48 tokens), jittered +-12% and each class clamped into one
     token bucket, with their predicted durations;
  3. window A, the quantile policy's, and window B, the cost policy's, from
     the calibrated lengths of that traffic (two branches each);
  4. the same requests through both windows (a warm pass, then the timed
     pass), dpm2:cs2@16, dual CFG 1.0 / 1.0;
  5. measured mean ms a request and RTF a window beside the model's
     prediction (with the traffic's mean token cost): the ranking and the
     constants in one run.

Every request must come back with its waveform (y_length x hop samples) and
a finite mel, or the tool fails.

    python -m unitspeech_tpu_torch.tools.bucket_policy_ab [--out FILE]
    python -m unitspeech_tpu_torch.tools.bucket_policy_ab --small --device cpu   # smoke

Returns (and prints) one JSON object, JAX's keys plus `card`; on the card it
is also written to chiprun_out/bucket_policy_ab.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from unitspeech_tpu_torch.tools import _serving, device_line, resolve_device

# the traffic: 90% short conversational turns, 10% long-form
FULL = dict(n_short=27, n_long=3, short_frames=175, long_frames=1300, sampler="dpm2:cs2",
            steps=16, preset="dpm2_16_cs2", probe_tok=48)
SMALL = dict(n_short=6, n_long=2, short_frames=44, long_frames=140, sampler="ddpm", steps=2,
             preset="ddpm50", probe_tok=12)
MAX_BRANCHES = 2


def ab_windows(lengths, ladder, curve, num_down: int = 3, tok_ms: float = 0.0,
               top_pass_ms=None):
    """((quantile window, its cost row), (cost window, its cost row)) of
    MAX_BRANCHES branches on `lengths`, each row priced with tok_ms;
    top_pass_ms as bucket_cost's."""
    from unitspeech_tpu_torch.infer.bucket_cost import optimal_window, window_cost
    from unitspeech_tpu_torch.tools.analyze_buckets import policy_window

    win_q = policy_window(lengths, ladder, max_branches=MAX_BRANCHES, num_down=num_down)
    win_c, _ = optimal_window(lengths, ladder, curve, MAX_BRANCHES, num_down,
                              top_pass_ms=top_pass_ms)
    return tuple((w, window_cost(lengths, w, curve, ladder, num_down, tok_ms=tok_ms,
                                 top_pass_ms=top_pass_ms)) for w in (win_q, win_c))


def measure(synth, reqs, spec, label):
    """Serve every request through the switch window: a warm pass, then the
    timed pass (each call ends with the waveform on the host). Returns
    (mean ms, RTF)."""
    dev = synth.models.device
    hop = synth.models.cfg.data.hop_length
    kw = dict(diffusion_steps=spec["steps"], sampler=spec["sampler"], text_gradient_scale=1.0,
              spk_gradient_scale=1.0)
    procs, speech = [], []
    for warm in (True, False):
        for i, toks in enumerate(reqs):
            gen = torch.Generator(device=dev).manual_seed(500 + i if warm else i)
            t0 = time.perf_counter()
            wav, sr, mel = synth(toks, gen, **kw)
            if len(wav) != mel.shape[0] * hop or not bool(torch.isfinite(mel).all()):
                raise RuntimeError(f"{label} request {i}: {len(wav)} samples for "
                                   f"{mel.shape[0]} frames, finite {torch.isfinite(mel).all()}")
            if not warm:
                procs.append(time.perf_counter() - t0)
                speech.append(len(wav) / sr)
    mean_ms = float(np.mean(procs) * 1000.0)
    rtf = float(np.sum(procs) / np.sum(speech))
    print(f"# {label}: mean {mean_ms:.1f} ms, p95 {np.percentile(procs, 95) * 1000:.1f} ms, "
          f"RTF {rtf:.4f}", flush=True)
    return mean_ms, rtf


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("unitspeech_tpu_torch.tools.bucket_policy_ab",
                                 description=__doc__.split("\n")[0])
    _serving.add_common(ap, "bucket_policy_ab")
    args = ap.parse_args(argv)
    spec = SMALL if args.small else FULL

    from unitspeech_tpu_torch.infer.bucket_cost import frame_cost_curve, token_cost_ms
    from unitspeech_tpu_torch.infer.calibration import DurationCalibrator
    from unitspeech_tpu_torch.ops.masking import choose_bucket

    dev = resolve_device(args.device)
    synth = _serving.build(_serving.checkpoint(args), dev)
    num_down = synth.models.cfg.decoder.num_downsamplings
    ladder = synth.frame_buckets
    curve = frame_cost_curve(spec["sampler"], spec["steps"])
    rng = np.random.default_rng(0)
    n_vocab = synth.models.cfg.text_encoder.n_vocab

    def mk(n_tok):
        return [int(t) for t in rng.integers(1, n_vocab - 1, (int(n_tok),))]

    # the model's frames a token (encode and duration only)
    cal = DurationCalibrator(n_vocab=n_vocab, min_samples=2)
    probes = [mk(spec["probe_tok"]) for _ in range(4)]
    dataclasses.replace(synth, calibrator=cal).calibrate(probes)
    mu = float(np.mean(cal.observed_totals()[:len(probes)])) / spec["probe_tok"]
    print(f"# frames/token = {mu:.2f}", flush=True)

    # token counts for the frame targets, jittered +-12%, each class clamped
    # into one token bucket (capped by the largest)
    tb = sorted(synth.token_buckets)

    def clamp_to_bucket(n):
        n = min(int(n), tb[-1])
        b = next(x for x in tb if x >= n)
        lo = ([x for x in tb if x < b][-1] + 1) if b != tb[0] else 1
        return int(np.clip(n, lo, b))

    reqs = [mk(clamp_to_bucket(round(spec["short_frames"] / mu * rng.uniform(0.88, 1.12))))
            for _ in range(spec["n_short"])]
    reqs += [mk(clamp_to_bucket(round(spec["long_frames"] / mu * rng.uniform(0.88, 1.12))))
             for _ in range(spec["n_long"])]

    # the traffic's own predicted lengths: what both policies see
    cal2 = DurationCalibrator(n_vocab=n_vocab, min_samples=2)
    dataclasses.replace(synth, calibrator=cal2).calibrate(reqs)
    lengths = np.asarray(cal2.observed_totals()[-len(reqs):], np.float64)
    print(f"# traffic: {len(lengths)} requests, frames p50 {np.median(lengths):.0f}, max "
          f"{lengths.max():.0f}", flush=True)
    tok_ms = float(np.mean([token_cost_ms(choose_bucket(len(r), tb)) for r in reqs]))
    (win_q, row_q), (win_c, row_c) = ab_windows(lengths, ladder, curve, num_down, tok_ms)
    print(f"# quantile window {list(win_q)} predicted {row_q['mean_proc_ms']} ms | cost window "
          f"{list(win_c)} predicted {row_c['mean_proc_ms']} ms", flush=True)

    out = {"n_requests": len(reqs), "sampler": spec["sampler"], "steps": spec["steps"],
           "preset": spec["preset"], "smoke": args.small,
           "frames_p50": float(np.median(lengths)), "frames_max": float(lengths.max()),
           "token_cost_ms": round(tok_ms, 2), "device": dev.type, "card": device_line(dev)}
    for name, win, row in (("cost", win_c, row_c), ("quantile", win_q, row_q)):
        sw = dataclasses.replace(synth, switch_buckets=tuple(win), calibrator=None)
        mean_ms, rtf = measure(sw, reqs, spec, f"{name}{list(win)}")
        out[name] = {"window": list(win), "predicted_mean_ms": row["mean_proc_ms"],
                     "measured_mean_ms": round(mean_ms, 1),
                     "model_error_pct": round(100.0 * (row["mean_proc_ms"] / mean_ms - 1.0), 1),
                     "overflow_pct": row["overflow_pct"], "rtf": round(rtf, 4)}
    out["measured_speedup"] = round(out["quantile"]["measured_mean_ms"]
                                    / out["cost"]["measured_mean_ms"], 2)
    out["predicted_speedup"] = round(out["quantile"]["predicted_mean_ms"]
                                     / out["cost"]["predicted_mean_ms"], 2)
    _serving.write_result(out, args, "bucket_policy_ab", dev)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
