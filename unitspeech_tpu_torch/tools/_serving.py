"""What the port's load tools share (bench_server, bench_serving,
refresh_under_load, bucket_policy_ab, bench_ssl): the serving default built
from a checkpoint (the counterpart of the root bench.py `build` and
tools/int8_gate.py `build`), the seeded random token requests, the
calibrated length scale, the closed-loop HTTP clients and where a result
is written.

The serving default is `cli serve`'s: every kernel, int8 deep-stage convs,
bf16 decoder and vocoder, from `--checkpoint` or random full-width weights
(utils/params.random_params(MainConfig(), 0)); `--small` is the tests' tiny
config (SMALL) for a smoke run on the CPU.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import threading
import time
import urllib.request
import wave

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ROUTES = dict(use_kernels=True, use_int8_deep=True)
# --small: the test widths (tests/test_torch_port_finetune.py's SSL_FT: 1.6 kHz, hop 16,
# the SSL models at their test widths)
SMALL = dict(
    data=dict(n_feats=16, n_fft=64, hop_length=16, win_length=64, sampling_rate=1600,
              mel_fmax=800.0),
    text_encoder=dict(n_vocab=180, n_feats=16, n_channels=16, filter_channels=32, n_layers=1,
                      n_heads=2),
    unit_encoder=dict(n_vocab=50, n_feats=16, n_channels=16, filter_channels=32, n_layers=1,
                      n_heads=2),
    duration_predictor=dict(in_channels=16, filter_channels=16, spk_emb_dim=8),
    decoder=dict(n_feats=16, dim=8, dim_mults=[1, 2], groups=4, spk_emb_dim=8),
    vocoder=dict(num_mels=16, upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
                 upsample_initial_channel=16, resblock_kernel_sizes=[3],
                 resblock_dilation_sizes=[[1, 3]], sampling_rate=1600),
    train=dict(out_size_second=1),
    spk_embedder=dict(sr=1600, feat_type="wavlm_test", channels=16, spk_emb_dim=8),
    unit_extractor=dict(dense_model_name="hubert-test", sr=1600, vocab_size=50, hubert_layer=2))


def small_config():
    from unitspeech_tpu_torch.config import config_from_dict

    return config_from_dict(SMALL)


def add_common(ap, name: str, checkpoint: bool = True):
    """--device, --small, --out and (for the tools that load weights)
    --checkpoint, as the tools take them."""
    ap.add_argument("--device", default="cuda")
    if checkpoint:
        ap.add_argument("--checkpoint", default=None,
                        help="the port's combined checkpoint (default: random full-width "
                             "weights, seed 0)")
    ap.add_argument("--small", action="store_true",
                    help="the tests' tiny config (a smoke run on the CPU)")
    ap.add_argument("--out", default=None,
                    help=f"where to write the JSON (default: chiprun_out/{name}.json on the "
                         "card; nothing on the CPU)")


def checkpoint(args) -> dict:
    """The checkpoint dict the tool serves: --checkpoint, else random
    weights from seed 0 at the full widths (the tiny ones with --small)."""
    from unitspeech_tpu_torch.config import MainConfig
    from unitspeech_tpu_torch.utils import artifacts
    from unitspeech_tpu_torch.utils.params import random_params

    if args.checkpoint:
        return artifacts.read(args.checkpoint)
    return random_params(small_config() if args.small else MainConfig(), 0)


def build(ckpt: dict, dev):
    """A Synthesizer on the serving default, on `dev`."""
    from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels

    return Synthesizer(TTSModels.from_checkpoint(ckpt, device=dev, **ROUTES))


def token_requests(n_vocab: int, n: int, n_tok: int, seed: int = 1) -> list:
    """n random requests of n_tok token IDs in [1, n_vocab - 1), seeded."""
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, n_vocab - 1, (n_tok,))] for _ in range(n)]


def calibrated(synth, reqs, frames: float, n: int = 16):
    """(synth with a DurationCalibrator fed the first n requests, the
    length_scale that brings their median predicted frames to `frames`)."""
    from unitspeech_tpu_torch.infer.calibration import DurationCalibrator

    cal = DurationCalibrator(n_vocab=synth.models.cfg.text_encoder.n_vocab, min_samples=4)
    synth = dataclasses.replace(synth, calibrator=cal)
    synth.calibrate(reqs[:n])
    med = float(np.median(np.asarray(cal.observed_totals()[:n])))
    return synth, max(frames / med, 1e-3)


def write_result(result: dict, args, name: str, dev):
    """Write the JSON to --out, by default chiprun_out/<name>.json on the
    card and nowhere on the CPU; returns the path or None."""
    path = args.out or (os.path.join(ROOT, "chiprun_out", f"{name}.json")
                        if dev.type == "cuda" else None)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    return path


def post(url: str, payload: dict, timeout: float = 600.0) -> bytes:
    """One JSON POST, retried twice on a connection reset (a thundering herd
    of clients; the retries stay inside the request's latency)."""
    body = json.dumps(payload).encode()
    for attempt in range(3):
        try:
            req = urllib.request.Request(url, data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.read()
        except ConnectionError:
            if attempt == 2:
                raise
            time.sleep(0.05 * (attempt + 1))


def run_clients(url: str, requests_by_client, loop: bool, stop, out):
    """The closed-loop clients, run in a child process (multiprocessing's
    spawn context) so that they take no interpreter time from the server's
    dispatcher thread: one thread per client, each POSTing {"token_ids"}
    requests back to back, its list once (loop False) or round and round
    until `stop` is set (loop True). Puts ({"rows": [(t0, t1, samples, sr)],
    "wall_s", "errors"}) on `out`; t0 / t1 are time.time() (one clock for
    every process)."""
    rows, errors, lock = [], [], threading.Lock()

    def client(reqs):
        i = 0
        while (i < len(reqs)) if not loop else not stop.is_set():
            t0 = time.time()
            try:
                blob = post(url, {"token_ids": reqs[i % len(reqs)]})
            except Exception as e:  # noqa: BLE001 — counted, reported by the parent
                if loop and stop.is_set():
                    return
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")
                return
            t1 = time.time()
            with wave.open(io.BytesIO(blob)) as w:
                n, sr = w.getnframes(), w.getframerate()
            with lock:
                rows.append((t0, t1, n, sr))
            i += 1

    threads = [threading.Thread(target=client, args=(r,)) for r in requests_by_client]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out.put({"rows": rows, "wall_s": time.perf_counter() - t_start, "errors": errors})


class Clients:
    """run_clients in a spawned child process; `result()` drains its queue,
    then joins it; `close()` ends the process if it still runs."""

    def __init__(self, url: str, requests_by_client, loop: bool = False):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.stop = ctx.Event()
        self._out = ctx.Queue()
        self._proc = ctx.Process(target=run_clients, daemon=True,
                                 args=(url, requests_by_client, loop, self.stop, self._out))
        self._proc.start()

    def result(self, timeout: float = 3600.0) -> dict:
        import queue

        deadline = time.monotonic() + timeout
        while True:
            try:
                res = self._out.get(timeout=1.0)
                break
            except queue.Empty:
                if not self._proc.is_alive():
                    raise RuntimeError(f"the client process ended ({self._proc.exitcode}) "
                                       "with no result") from None
                if time.monotonic() > deadline:
                    self._proc.kill()
                    raise TimeoutError(f"the clients took more than {timeout} s") from None
        self._proc.join(60)
        if res["errors"]:
            raise RuntimeError(f"{len(res['errors'])} requests failed: {res['errors'][:3]}")
        return res

    def close(self):
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join(10)
