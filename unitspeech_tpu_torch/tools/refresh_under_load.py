"""A live bucket-window refresh under load (counterpart of the root
tools/refresh_under_load.py).

The daemon comes up with a stale window, the cost window of traffic four
times longer than what arrives (e.g. yesterday's long-form load; the
dpm2:cs2@16 curve of the card's anchors, two branches and one of
headroom), while the live traffic is ~--frames-frame requests that all pad
to its bottom branch. K closed-loop clients (a spawned child process,
tools/_serving.Clients) drive steady load on the batch ladder (1, 4); after
--warmup-requests an admin POSTs /refresh_window {"policy": "cost",
"min_samples": 8}: the daemon re-derives the window from its served
lengths, warms the new window's grid on the admin thread while the
dispatcher keeps serving on the stale one (both on the card's default
stream, taking turns on the batcher's device lock; the warm-up draws from
generators of its own, not the dispatcher's), and swaps. Then
--tail-requests more are served. Reported: request p50 / p95 before, during
and after the refresh, and its wall: the value of the correction (after vs
before) and its cost (during vs before).

The tool fails if a request fails, if the swap did not happen, if a
dispatch ran on another stream than the default one, or if the dispatcher
drew other than one generator a served batch (its seeds from the batch
count, untouched by the warm-up).

    python -m unitspeech_tpu_torch.tools.refresh_under_load [--clients 8] [--out FILE]
    python -m unitspeech_tpu_torch.tools.refresh_under_load --small --device cpu  # smoke

Returns (and prints) one JSON object, JAX's keys plus `card`; on the card it
is also written to chiprun_out/refresh_under_load.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import threading
import time
import urllib.request

import numpy as np
import torch

from unitspeech_tpu_torch.tools import _serving, device_line, resolve_device

STALE_SPEC = ("dpm2:cs2", 16)  # the mode whose curve priced the stale window


def stale_window(frames: float, ladder, curve, num_down: int = 3, top_pass_ms=None):
    """The cost window (two branches and one of headroom) of 64 requests of
    4 x `frames` frames under `curve`; top_pass_ms as bucket_cost's."""
    from unitspeech_tpu_torch.infer.bucket_cost import optimal_window

    return optimal_window(np.full(64, frames * 4.0), ladder, curve, max_branches=2,
                          num_down=num_down, headroom=1, top_pass_ms=top_pass_ms)[0]


def _watch_streams(batcher, dev, seen: set):
    """Record the current stream of every thread that dispatches (the
    dispatcher's batches, the refresh's warm-up) in `seen`."""
    def record():
        if dev.type == "cuda":
            seen.add(torch.cuda.current_stream(dev).cuda_stream)

    run, warm = batcher._run, batcher._warm_grid
    batcher._run = lambda synth, batch: (record(), run(synth, batch))[1]
    batcher._warm_grid = lambda synth, buckets: (record(), warm(synth, buckets))[1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("unitspeech_tpu_torch.tools.refresh_under_load",
                                 description=__doc__.split("\n")[0])
    _serving.add_common(ap, "refresh_under_load")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--sampler", default="dpm2:cs2")
    ap.add_argument("--frames", type=int, default=344, help="the live traffic's frame target")
    ap.add_argument("--warmup-requests", type=int, default=24,
                    help="steady-state requests before the refresh fires")
    ap.add_argument("--tail-requests", type=int, default=24,
                    help="requests served after the refresh completes")
    args = ap.parse_args(argv)
    if args.small:
        args.steps, args.sampler, args.frames = 2, "ddpm", 48
        args.warmup_requests = args.tail_requests = 8
        args.clients = 3

    from unitspeech_tpu_torch.infer.bucket_cost import frame_cost_curve
    from unitspeech_tpu_torch.serve import build_batcher, make_http_server

    dev = resolve_device(args.device)
    synth = _serving.build(_serving.checkpoint(args), dev)
    n_tok = 12 if args.small else 140
    reqs = _serving.token_requests(synth.models.cfg.text_encoder.n_vocab, 16, n_tok)
    synth, lscale = _serving.calibrated(synth, reqs, args.frames)
    stale = stale_window(args.frames, synth.frame_buckets, frame_cost_curve(*STALE_SPEC),
                         synth.models.cfg.decoder.num_downsamplings)
    synth = dataclasses.replace(synth, switch_buckets=stale)
    print(f"# stale window {list(stale)} for ~{args.frames}-frame traffic", flush=True)

    batcher = build_batcher(synth, calibration_texts=None, max_batch=4, max_wait_ms=40.0,
                            warmup_token_lengths=(n_tok,), default_steps=args.steps,
                            default_sampler=args.sampler, length_scale=lscale,
                            batch_ladder=(1, 4))
    streams = set()
    _watch_streams(batcher, dev, streams)
    srv = make_http_server(batcher, port=0)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def wait_served(n, what, limit=1800.0):
        deadline = time.monotonic() + limit
        while batcher.stats.requests < n:
            if time.monotonic() > deadline or batcher.stats.errors:
                raise RuntimeError(f"{what}: {batcher.stats.requests} served, "
                                   f"{batcher.stats.errors} failed")
            time.sleep(0.05)

    clients = None
    try:
        clients = _serving.Clients(f"{base}/synthesize",
                                   [reqs[c:] + reqs[:c] for c in range(args.clients)], loop=True)
        try:
            wait_served(args.warmup_requests, "before the refresh")
            # the admin correction, timed: the new window warms on this
            # request's handler thread
            t_ref0 = time.time()
            req = urllib.request.Request(f"{base}/refresh_window",
                                         json.dumps({"policy": "cost", "min_samples": 8}).encode(),
                                         {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=3600) as r:
                decision = json.loads(r.read())
            t_ref1 = time.time()
            print(f"# refresh {t_ref1 - t_ref0:.1f} s -> {decision}", flush=True)
            wait_served(batcher.stats.requests + args.tail_requests, "after the refresh")
        finally:
            clients.stop.set()
        rows = clients.result()["rows"]
        errors, window = batcher.stats.errors, list(batcher.synth.switch_buckets)
        draws = (batcher._key_counter, batcher.stats.batches)
    finally:
        if clients is not None:
            clients.close()
        srv.shutdown()
        srv.server_close()
        server.join(60)
        batcher.shutdown()
    if errors:
        raise RuntimeError(f"{errors} requests failed in the dispatcher")
    if not decision.get("refreshed") or window == list(stale) or window != decision["window"]:
        raise RuntimeError(f"the window did not swap: {decision}, serving {window}")
    if len(streams) > 1:
        raise RuntimeError(f"dispatches ran on {len(streams)} streams: {sorted(streams)}")
    if draws[0] != draws[1]:  # one generator a served batch, none taken by the warm-up
        raise RuntimeError(f"{draws[0]} batch generators drawn for {draws[1]} batches")

    before = [t1 - t0 for t0, t1, _, _ in rows if t1 <= t_ref0]
    during = [t1 - t0 for t0, t1, _, _ in rows if t1 > t_ref0 and t0 < t_ref1]
    after = [t1 - t0 for t0, t1, _, _ in rows if t0 >= t_ref1]

    def pct(v, q):
        return round(float(np.percentile(v, q)), 3) if v else None

    out = {
        "metric": "refresh_under_load",
        "smoke": args.small,
        "sampler": args.sampler, "steps": args.steps,
        "clients": args.clients,
        "stale_window": list(stale),
        "decision": decision,
        "refresh_s": round(t_ref1 - t_ref0, 1),
        "n_before": len(before), "n_during": len(during), "n_after": len(after),
        "p50_before_s": pct(before, 50), "p95_before_s": pct(before, 95),
        "p50_during_s": pct(during, 50), "p95_during_s": pct(during, 95),
        "p50_after_s": pct(after, 50), "p95_after_s": pct(after, 95),
        "card": device_line(dev),
    }
    if out["p50_before_s"] and out["p50_after_s"]:
        out["p50_speedup"] = round(out["p50_before_s"] / out["p50_after_s"], 2)
    _serving.write_result(out, args, "refresh_under_load", dev)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
