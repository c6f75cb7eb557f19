"""Closed-loop load on the serving daemon (counterpart of the root
tools/bench_server.py): K clients POST {"token_ids"} requests back to back
to `make_http_server`, the dynamic batcher packs the concurrent ones into
batched bucket-switch dispatches, and the tool reports the throughput
(speech seconds synthesized a wall second on one card), the request
latency's p50 / p95, /stats' dispatch sizes and, with --ttfa-sentences, the
streaming endpoint's time to first audio on the quiet daemon.

The clients run in a child process (multiprocessing's spawn context,
tools/_serving.Clients), each a thread there: at B <= 2 the dispatcher is
host-bound (PERF.md section 5), and clients in the server's process would
take interpreter time from it. Requests: 140 random token IDs (seed 1), the
length scale bringing the calibrated median to --frames; the window the cost
policy's (infer/bucket_cost.py, the card's anchors); the serving default
(every kernel, int8 deep convs, bf16).

    python -m unitspeech_tpu_torch.tools.bench_server --clients 8 --requests 48 \\
        [--max-batch 8] [--stats-out stats.json] [--out FILE]
    python -m unitspeech_tpu_torch.tools.bench_server --small --device cpu \\
        --clients 3 --requests 6        # smoke run

Returns (and prints) one JSON object, JAX's keys plus `card`; on the card it
is also written to chiprun_out/bench_server.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import struct
import threading
import time
import urllib.request

import numpy as np

from unitspeech_tpu_torch.tools import _serving, device_line, resolve_device


def run_bench(args, dev) -> dict:
    """Build the serving synthesizer, bring up the daemon, drive it with
    closed-loop clients; returns the result dict. Fails unless every
    request was answered with its frames' samples. --stats-out: the
    daemon's /stats snapshot of the closed loop is written there."""
    from unitspeech_tpu_torch.serve import build_batcher, make_http_server

    if args.requests < args.clients:
        raise SystemExit(f"--requests {args.requests} < --clients {args.clients}: every "
                         "client must send at least one request")
    synth = _serving.build(_serving.checkpoint(args), dev)
    n_vocab = synth.models.cfg.text_encoder.n_vocab
    n_tok = 12 if args.small else 140
    reqs = _serving.token_requests(n_vocab, max(args.requests, 16), n_tok)
    synth, lscale = _serving.calibrated(synth, reqs, 48 if args.small else args.frames)
    synth = dataclasses.replace(synth, switch_buckets=synth.make_switch_buckets(
        length_scale=lscale))
    ladder = [int(b) for b in args.batch_ladder.split(",")] if args.batch_ladder else None
    batcher = build_batcher(synth, calibration_texts=None, max_batch=args.max_batch,
                            max_wait_ms=args.max_wait_ms, warmup_token_lengths=(n_tok,),
                            default_steps=args.steps, default_sampler=args.sampler,
                            length_scale=lscale, batch_ladder=ladder)
    # a deterministic char -> id frontend, so that the TTFA probe's text runs
    # the split / stream path
    srv = make_http_server(batcher, port=0,
                           text_to_ids=lambda s: [1 + (ord(c) % (n_vocab - 2))
                                                  for c in s.strip() or "a"])
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/synthesize"
    try:
        base, extra = divmod(args.requests, args.clients)
        per_client = [base + (1 if c < extra else 0) for c in range(args.clients)]
        offsets = np.cumsum([0] + per_client[:-1])
        clients = _serving.Clients(url, [[reqs[(o + i) % len(reqs)] for i in range(n)]
                                         for o, n in zip(offsets, per_client)])
        try:
            res = clients.result()
        finally:
            clients.close()
        stats = batcher.stats.snapshot()  # the closed loop's, before the probe
        if args.stats_out:
            with open(args.stats_out, "w") as f:
                json.dump({**stats, "switch_buckets": list(batcher.synth.switch_buckets)}, f)
        ttfa = _ttfa(url, n_tok, args.ttfa_sentences) if args.ttfa_sentences else None
    finally:
        srv.shutdown()
        srv.server_close()
        server.join(60)
        batcher.shutdown()

    # every request answered, with its y_length x hop samples (in sum: the
    # clients' replies against the lengths the dispatcher served)
    hop = synth.models.cfg.data.hop_length
    if (len(res["rows"]) != args.requests or stats["requests"] != args.requests
            or sum(r[2] for r in res["rows"]) != hop * sum(stats["recent_frames"])):
        raise RuntimeError(f"{len(res['rows'])} replies, {stats['requests']} served of "
                           f"{args.requests}: {sum(r[2] for r in res['rows'])} samples against "
                           f"{sum(stats['recent_frames'])} frames x {hop}")
    lat = np.asarray([t1 - t0 for t0, t1, _, _ in res["rows"]])
    total_speech = float(sum(n / sr for _, _, n, sr in res["rows"]))
    wall = res["wall_s"]
    result = {
        "metric": "server_throughput",
        "value": round(total_speech / wall, 3),
        "unit": "x_realtime_per_chip",
        "clients": args.clients,
        "requests": len(lat),
        "steps": args.steps,
        "sampler": args.sampler,
        "max_batch": args.max_batch,
        "max_wait_ms": args.max_wait_ms,
        "wall_s": round(wall, 2),
        "speech_s": round(total_speech, 2),
        "aggregate_rtf": round(wall / total_speech, 5),
        "p50_latency_s": round(float(np.percentile(lat, 50)), 3),
        "p95_latency_s": round(float(np.percentile(lat, 95)), 3),
        "switch_buckets": list(batcher.synth.switch_buckets),
        "batch_sizes": stats["batch_sizes"],
        "card": device_line(dev),
    }
    if ttfa:
        result.update(ttfa)
    return result


def _ttfa(url: str, n_tok: int, n_sent: int) -> dict:
    """One long text of n_sent sentences on the streaming endpoint of the
    quiet daemon: the first chunk's latency (a solo dispatch) against the
    whole."""
    word = "abcdef"
    sent = " ".join(word for _ in range(max((n_tok + 1) // (len(word) + 1), 1))) + "."
    body = json.dumps({"text": " ".join(sent for _ in range(n_sent)), "stream": True}).encode()
    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        head = r.read(45)  # the WAV header and the first PCM byte of chunk 0
        t_first = time.perf_counter() - t0
        rest = r.read()
        t_total = time.perf_counter() - t0
    sr = struct.unpack("<I", head[24:28])[0]
    return {"stream_sentences": n_sent, "stream_ttfa_s": round(t_first, 3),
            "stream_total_s": round(t_total, 3),
            "stream_speech_s": round((len(head) - 44 + len(rest)) / 2 / sr, 2)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("unitspeech_tpu_torch.tools.bench_server",
                                 description=__doc__.split("\n")[0])
    _serving.add_common(ap, "bench_server")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=48, help="total requests")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--batch-ladder", default=None,
                    help="comma list ending at max-batch (a smaller warm-up grid)")
    ap.add_argument("--max-wait-ms", type=float, default=40.0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--sampler", default="ddpm",
                    help="sampler spec ('ddpm' / 'dpm2', optional ':cs<k>')")
    ap.add_argument("--frames", type=int, default=344,
                    help="target mean synthesized frames (the baseline protocol)")
    ap.add_argument("--ttfa-sentences", type=int, default=0,
                    help="also time the streaming endpoint: one text of N sentences, time to "
                         "first audio vs total")
    ap.add_argument("--stats-out", default=None,
                    help="write the daemon's /stats snapshot here (the input of "
                         "capacity_plan / analyze_buckets --stats)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    result = run_bench(args, dev)
    _serving.write_result(result, args, "bench_server", dev)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
