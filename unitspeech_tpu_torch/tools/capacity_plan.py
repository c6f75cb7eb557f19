"""Capacity planning for a serving deployment on the card's cost model
(counterpart of the root tools/capacity_plan.py):

  * "How many cards do I need for this traffic?" (--target-qps or
    --target-streams)
  * "What load can N cards sustain?" (--chips)

The per-request price is the port's cost model (infer/bucket_cost.py, the
window optimal_window picks, priced by window_cost with the served token
cost). Its curves are already per request in a batch: the anchors
(infer/cost_anchors_h100.json) time forced batches of A = `batch` requests
and divide by A, and their floor `fixed_ms` (ddpm@1 at 344 frames) is per
request in that batch too. A dispatch's floor is F = A * fixed_ms; a
request of a batch of B pays F / B of it and the rest of its curve price:

  per_request_ms(B) = (curve_ms - F / A) + F / B,    F = A * fixed_ms

which at A = 1 is the JAX tool's curve - FIXED + FIXED / B (its curves were
single requests, its FIXED_MS a v5e floor). At B = A it is the curve's own
price: the floor is never amortized twice. One card serializes dispatches,
so it serves utilization * 1000 / per_request_ms requests a second;
`utilization` discounts the closed loop's raggedness against that bound,
by default DEFAULT_UTILIZATION, the ratio that chip_smoke.py's
operator_tools phase measures (tools/bench_server.py's closed-loop
throughput over this plan's bound at utilization 1, on the card named
beside the constant).

Traffic inputs as tools/analyze_buckets.py's (--lengths / --stats /
--seconds / --filelist). Host-side numpy only: no device is used.

    python -m unitspeech_tpu_torch.tools.capacity_plan --stats stats.json --batch 8 \\
        --preset ddpm50 --chips 4 [--json] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np

from unitspeech_tpu_torch.infer.bucket_cost import (
    anchors,
    frame_cost_curve,
    optimal_window,
    token_cost_ms,
    window_cost,
)
from unitspeech_tpu_torch.ops.masking import default_frame_buckets
from unitspeech_tpu_torch.tools.analyze_buckets import (
    PRESET_SPECS,
    add_traffic_flags,
    load_lengths,
    load_tokens,
    served_tok_ms,
)

# closed-loop utilization: tools/bench_server.py's measured throughput over
# this plan's bound at utilization 1 (ddpm@50, --max-batch 8, 8 clients, 32
# ~344-frame requests: 10.654x realtime against 13.6 streams; chip_smoke.py's
# operator_tools phase)
DEFAULT_UTILIZATION = 0.7834
UTILIZATION_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def dispatch_floor():
    """(A, fixed_ms): the batch size the anchors were measured at and the
    per-request floor in such a batch (cost_anchors_h100.json)."""
    a = anchors()
    return int(a["batch"]), float(a["fixed_ms"])


def plan(lengths, curve, ladder, batch: int = 8, max_branches: int = 3, num_down: int = 3,
         tok_ms: float = 0.0, utilization: float = DEFAULT_UTILIZATION, hop: int = 256,
         sr: int = 22050, floor=None, top_pass_ms=None) -> dict:
    """Per-card capacity for `lengths` traffic under the cost `curve`: the
    window, the mean price of a request in a batch of `batch`, the QPS and
    realtime streams a card sustains. floor: (A, fixed_ms), by default
    dispatch_floor(); top_pass_ms: JAX's price of an overflow
    (bucket_cost.window_cost), None the port's."""
    a, fixed = floor or dispatch_floor()
    lengths = np.asarray(lengths, np.float64)
    window, _ = optimal_window(lengths, ladder, curve, max_branches=max_branches,
                               num_down=num_down, headroom=1, top_pass_ms=top_pass_ms)
    row = window_cost(lengths, window, curve, ladder, num_down, tok_ms=tok_ms,
                      top_pass_ms=top_pass_ms)
    mean_curve_ms = float(row["mean_proc_ms"])
    b = max(int(batch), 1)
    f = a * fixed  # one dispatch's floor
    mean_batched_ms = mean_curve_ms - f / a + f / b
    speech_s = float(lengths.mean()) * hop / sr
    qps = utilization * 1000.0 / mean_batched_ms
    streams = qps * speech_s  # concurrent realtime streams
    return {
        "window": list(window),
        "overflow_pct": row["overflow_pct"],
        "mean_speech_s": round(speech_s, 3),
        "mean_proc_ms_single": round(mean_curve_ms, 1),
        "mean_proc_ms_batched": round(mean_batched_ms, 1),
        "effective_batch": b,
        "utilization": utilization,
        "qps_per_chip": round(qps, 2),
        "streams_per_chip": round(streams, 1),
    }


def targets(cap: dict, target_qps=None, target_streams=None, chips=None) -> dict:
    """The cards a target needs, or what `chips` cards sustain."""
    out = {}
    if target_qps is not None:
        out["target_qps"] = target_qps
        out["chips_needed"] = math.ceil(target_qps / cap["qps_per_chip"])
    if target_streams is not None:
        out["target_streams"] = target_streams
        out["chips_needed_streams"] = math.ceil(target_streams / cap["streams_per_chip"])
    if chips is not None:
        out["chips"] = chips
        out["sustainable_qps"] = round(chips * cap["qps_per_chip"], 2)
        out["sustainable_streams"] = round(chips * cap["streams_per_chip"], 1)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("unitspeech_tpu_torch.tools.capacity_plan",
                                 description=__doc__.split("\n")[0])
    add_traffic_flags(ap)
    ap.add_argument("--preset", default="dpm2_16_cs2", choices=sorted(PRESET_SPECS),
                    help="sampler mode (the production fast default)")
    ap.add_argument("--batch", type=int, default=8,
                    help="effective dispatch batch size (`cli serve`'s default --max-batch)")
    ap.add_argument("--max-branches", type=int, default=3)
    ap.add_argument("--utilization", type=float, default=DEFAULT_UTILIZATION,
                    help="fraction of the saturated bound a closed-loop deployment sustains "
                         f"(default {DEFAULT_UTILIZATION}, measured on {UTILIZATION_CARD})")
    ap.add_argument("--tok-bucket", type=int, default=256,
                    help="typical token bucket (a --stats snapshot's recent_tokens override it)")
    ap.add_argument("--target-qps", type=float, default=None)
    ap.add_argument("--target-streams", type=float, default=None,
                    help="concurrent realtime listener streams to sustain")
    ap.add_argument("--chips", type=int, default=None,
                    help="instead of a target: report what N cards sustain")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    lengths = load_lengths(args)
    toks = load_tokens(args)
    tok_ms = served_tok_ms(toks) if toks is not None else token_cost_ms(args.tok_bucket)
    cap = plan(lengths, frame_cost_curve(*PRESET_SPECS[args.preset]),
               default_frame_buckets(args.ladder_max), batch=args.batch,
               max_branches=args.max_branches, tok_ms=tok_ms, utilization=args.utilization,
               hop=args.hop, sr=args.sr)
    result = {"preset": args.preset, "n_requests": int(len(lengths)), **cap,
              **targets(cap, args.target_qps, args.target_streams, args.chips),
              "card": anchors()["card"]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if args.json:
        print(json.dumps(result))
        return result
    a, fixed = dispatch_floor()
    print(f"traffic: {result['n_requests']} requests, mean speech {cap['mean_speech_s']} s | "
          f"preset {args.preset} | window {cap['window']} (overflow {cap['overflow_pct']}%)")
    print(f"per-request cost: {cap['mean_proc_ms_single']} ms in a batch of {a} (the anchors'), "
          f"{cap['mean_proc_ms_batched']} ms at batch {cap['effective_batch']} (floor "
          f"{a * fixed:.1f} ms a dispatch; {result['card']})")
    print(f"per card at {cap['utilization']:.0%} utilization: {cap['qps_per_chip']} QPS = "
          f"{cap['streams_per_chip']} concurrent realtime streams")
    for k in ("chips_needed", "chips_needed_streams", "sustainable_qps", "sustainable_streams"):
        if k in result:
            print(f"{k}: {result[k]}")
    return result


if __name__ == "__main__":
    main()
