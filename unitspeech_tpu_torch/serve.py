"""TTS serving: request queue + dynamic batching + HTTP front end
(counterpart of unitspeech_tpu/serve.py; `cli serve`).

  * Requests are packed onto a small grid of shapes: the batch size from a
    power-of-two ladder (padded with REPEATS of real rows, so the padding
    cannot change the batch's frame bucket), the token axis from the
    Synthesizer's token buckets, and the frame bucket from the bucket-switch
    window (infer/tts.py `_switch_dispatch`: the predicted lengths come to
    the host, then one align -> sample -> vocode at the window's bucket).
    `warmup` runs the whole (batch ladder x token bucket x window bucket)
    grid once before the port opens, so the kernels' builds, the weight
    packs and the allocator's blocks are paid before the first request, and
    a kernel that fails at any of those shapes fails startup.
  * One dispatcher thread owns the card: device work serializes on it
    anyway, so concurrency lives in the HTTP threads and the queue. Grad
    mode and the current CUDA device are per thread in PyTorch, so every
    thread that dispatches (the dispatcher, and a caller warming a new
    window) enters inference mode and sets the models' device itself, and
    takes the batcher's device lock; the kernels launch on that thread's
    current stream, the default stream.
  * Dynamic batching trades a bounded wait (`max_wait_ms`) for throughput:
    B requests run one 3B-row estimator call a step, one set of launches
    for all of them.

Synthesis semantics (samplers, CFG, calibration, overflow fallback) are the
Synthesizer's; this module only schedules. Noise is drawn per batch from a
generator seeded by the batch's count, and a request's mel depends on its
batch companions (the frame bucket of the longest row, and with int8 deep
convs one activation scale over the batch): per-request reproducibility is
deliberately NOT a serving guarantee (`cli inference` provides it).
"""

from __future__ import annotations

import base64
import contextlib
import io
import json
import threading
import time
import wave
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def device_scope(device: torch.device):
    """What a thread needs before it dispatches: inference mode and, on the
    card, the models' device as its current device (both are per thread)."""
    with torch.inference_mode():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        yield


def pcm16_bytes(wav: np.ndarray) -> bytes:
    """float32 [-1, 1] mono -> raw 16-bit little-endian PCM bytes."""
    return (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


def encode_wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    """float32 [-1, 1] mono -> 16-bit PCM RIFF bytes (data/dataset.write_wav
    semantics, in memory)."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sr))
        w.writeframes(pcm16_bytes(wav))
    return buf.getvalue()


def wav_stream_header(sr: int) -> bytes:
    """RIFF/WAVE header for 16-bit mono PCM of UNKNOWN length: the RIFF and
    data chunk sizes carry the live-stream convention 0xFFFFFFFF (what
    icecast/ffmpeg emit for wav streams; decoders read until EOF). The
    streaming endpoint sends this once, then appends raw PCM per resolved
    chunk."""
    import struct

    return (
        b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
        + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, int(sr),
                                int(sr) * 2, 2, 16)
        + b"data" + struct.pack("<I", 0xFFFFFFFF)
    )


def _normalize_sampler_spec(spec: str) -> str:
    """Canonical sampler-spec string ('ddpm:cs1' -> 'ddpm') so equivalent
    specs share one batch group; raises ValueError on malformed specs
    (client error)."""
    from unitspeech_tpu_torch.models.diffusion import parse_sampler_spec

    name, stride = parse_sampler_spec(spec)
    return name if stride == 1 else f"{name}:cs{stride}"


@dataclass
class _Request:
    token_ids: List[int]
    steps: int
    sampler: str
    future: "Future"
    enqueued_at: float
    # solo requests dispatch alone, never packed with others: the streaming
    # front-end marks a long text's FIRST chunk solo so time-to-first-audio
    # is single-utterance latency while the remaining chunks batch behind it
    solo: bool = False
    # multi-voice serving: name into the batcher's voice table (None = the
    # synthesizer's own spk_emb). Speakers are per-row conditioning of the
    # same decoder, so mixed-voice batches pack together freely
    speaker: Optional[str] = None

    @property
    def group_key(self) -> Tuple[int, str]:
        # one batch runs one sampler for one step count: steps and sampler
        # partition the queue
        return (self.steps, self.sampler)


class Future:
    """Minimal thread-safe future (concurrent.futures without the executor)."""

    def __init__(self):
        self._ev = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    def set_result(self, value):
        self._result = value
        self._ev.set()

    def set_exception(self, exc: BaseException):
        self._exc = exc
        self._ev.set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("request timed out")
        if self._exc is not None:
            raise self._exc
        return self._result


class Overloaded(RuntimeError):
    """The batcher queue is at max_queue: shed load instead of growing an
    unbounded backlog (the HTTP front-end maps this to 503)."""


@dataclass
class BatcherStats:
    requests: int = 0
    batches: int = 0
    overflows: int = 0
    errors: int = 0
    rejected: int = 0
    batch_sizes: Dict[int, int] = field(default_factory=dict)
    total_latency_s: float = 0.0
    total_speech_s: float = 0.0
    # batch-packing efficiency: real vs ladder-padded rows, and time spent
    # in device dispatches — the numbers that diagnose a mis-sized ladder
    real_rows: int = 0
    padded_rows: int = 0
    total_dispatch_s: float = 0.0
    window_refreshes: int = 0
    # per-request resolved frame lengths (bounded ring): the observed
    # traffic distribution refresh_window re-derives the frame-bucket
    # window from
    recent_frames: deque = field(default_factory=lambda: deque(maxlen=4096))
    # per-request token counts (same ring discipline): the encoder-side
    # traffic axis. The measured cost model is quadratic in the token
    # bucket too (bucket_cost.token_cost_ms), so refresh_window folds the
    # observed token distribution into its ABSOLUTE cost predictions (window ranking is unaffected: the token
    # cost is constant per request whatever frame window is chosen)
    recent_tokens: deque = field(default_factory=lambda: deque(maxlen=4096))

    def snapshot(self) -> Dict[str, Any]:
        mean_lat = self.total_latency_s / self.requests if self.requests else 0.0
        rtf = (self.total_latency_s / self.total_speech_s
               if self.total_speech_s else 0.0)
        return {
            "requests": self.requests,
            "batches": self.batches,
            "overflows": self.overflows,
            "errors": self.errors,
            "rejected": self.rejected,
            "batch_sizes": dict(sorted(self.batch_sizes.items())),
            "mean_latency_s": round(mean_lat, 4),
            "mean_request_rtf": round(rtf, 4),
            "padding_waste": round(
                self.padded_rows / (self.real_rows + self.padded_rows), 4
            ) if self.real_rows else 0.0,
            "mean_dispatch_s": round(
                self.total_dispatch_s / self.batches, 4
            ) if self.batches else 0.0,
            "window_refreshes": self.window_refreshes,
            "recent_frames": list(self.recent_frames),
            "recent_tokens": list(self.recent_tokens),
        }


class DynamicBatcher:
    """Collects requests for up to `max_wait_ms`, packs same-(steps, sampler)
    requests into one bucket-switch dispatch, and fans results back out.

    The synthesizer must have `switch_buckets` set (see `build_batcher` for
    the calibrate -> make_switch_buckets startup flow)."""

    def __init__(self, synth, max_batch: int = 8, max_wait_ms: float = 20.0,
                 default_steps: Optional[int] = None,
                 default_sampler: str = "ddpm",
                 length_scale: Optional[float] = None,
                 text_gradient_scale: Optional[float] = None,
                 spk_gradient_scale: Optional[float] = None,
                 batch_ladder: Optional[Sequence[int]] = None,
                 strict_grid: bool = False,
                 voices: Optional[Dict[str, Any]] = None,
                 max_queue: Optional[int] = None):
        if synth.switch_buckets is None:
            raise ValueError(
                "DynamicBatcher needs a bucket-switch synthesizer "
                "(set switch_buckets, e.g. via make_switch_buckets)"
            )
        icfg = synth.models.cfg.inference
        self.synth = synth
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.default_steps = int(default_steps if default_steps is not None
                                 else icfg.diffusion_steps)
        self.default_sampler = _normalize_sampler_spec(str(default_sampler))
        # strict_grid=True refuses anything the warmup did not run
        # (non-default steps/sampler, token lengths beyond the warmed
        # buckets, frame-window overflows) instead of serving it cold on
        # the single dispatcher thread, where a first-time shape (a kernel
        # build, an allocator miss) stalls all queued traffic
        self.strict_grid = bool(strict_grid)
        self._warmed_groups: set = set()
        self._warmed_max_tokens = 0
        self._warmed_token_buckets: set = set()
        # serializes refresh_window callers (one warm-up pass at a time)
        self._refresh_lock = threading.Lock()
        # held by every device dispatch, whichever thread makes it
        self._device = threading.Lock()
        self.length_scale = float(length_scale if length_scale is not None
                                  else icfg.length_scale)
        self.tg = float(text_gradient_scale if text_gradient_scale is not None
                        else icfg.text_gradient_scale)
        self.sg = float(spk_gradient_scale if spk_gradient_scale is not None
                        else icfg.spk_gradient_scale)
        # batch ladder: the batch sizes a dispatch pads to, so the grid
        # stays small and fully warmable. Default: powers of two up to
        # max_batch; override to trade padding waste for a smaller grid.
        if batch_ladder is not None:
            self.batch_ladder = sorted(int(b) for b in batch_ladder)
            if self.batch_ladder[-1] != self.max_batch:
                raise ValueError("batch_ladder must end at max_batch")
        else:
            self.batch_ladder = []
            b = 1
            while b < self.max_batch:
                self.batch_ladder.append(b)
                b *= 2
            self.batch_ladder.append(self.max_batch)

        # voice bank for multi-voice serving: speaker name -> unit-normalized
        # (spk_emb_dim,) embedding, conditioning the same decoder per row
        # (per-speaker fine-tuned decoders need one daemon per decoder,
        # since a batch shares the decoder's weights). Load with
        # utils.artifacts.load_speaker_embs(path, int_keys=False).
        self.voices: Dict[str, np.ndarray] = {}
        for name, v in (voices or {}).items():
            v = np.asarray(v, np.float32).reshape(-1)
            self.voices[str(name)] = v / max(float(np.linalg.norm(v)), 1e-12)

        # backpressure: at max_queue pending requests, submit() raises
        # Overloaded (HTTP 503) instead of growing an unbounded backlog
        # whose tail latency nobody will wait for. None = unbounded.
        self.max_queue = None if max_queue is None else int(max_queue)

        self.stats = BatcherStats()
        self._queue: deque = deque()
        self._lock = threading.Condition()
        self._stop = False
        self._key_counter = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tts-dispatcher")
        self._thread.start()

    # -- client side -----------------------------------------------------

    def submit(self, token_ids: Sequence[int], steps: Optional[int] = None,
               sampler: Optional[str] = None, solo: bool = False,
               speaker: Optional[str] = None) -> Future:
        """Enqueue one request; resolves to (wav float32 np.ndarray, sr).
        ValueError = the request itself is invalid (client error).

        solo=True: dispatch this request ALONE (no wait window, never packed
        with other requests) — latency-critical submissions like the
        streaming mode's first chunk use it; everything else should leave it
        off so the batcher can amortize.

        speaker: voice-bank name (see `voices`); None = the synthesizer's
        default spk_emb. Voices mix freely within a batch."""
        if not token_ids:
            raise ValueError("empty token sequence")
        if speaker is not None and speaker not in self.voices:
            raise ValueError(
                f"unknown speaker {speaker!r}; available: "
                f"{sorted(self.voices) or '(no voice bank configured)'}"
            )
        req = _Request(
            token_ids=list(int(t) for t in token_ids),
            steps=int(steps if steps is not None else self.default_steps),
            # normalized so equivalent specs ('ddpm' / 'ddpm:cs1') batch
            # together
            sampler=(_normalize_sampler_spec(str(sampler))
                     if sampler is not None else self.default_sampler),
            future=Future(),
            enqueued_at=time.monotonic(),
            solo=bool(solo),
            speaker=speaker,
        )
        if self.strict_grid:
            if req.group_key not in self._warmed_groups:
                raise ValueError(
                    f"(steps={req.steps}, sampler={req.sampler!r}) was not "
                    "warmed and strict_grid is on; use the defaults "
                    f"({self.default_steps}, {self.default_sampler!r}) or "
                    "warm this combination at startup"
                )
            if len(req.token_ids) > self._warmed_max_tokens:
                raise ValueError(
                    f"{len(req.token_ids)} tokens exceeds the warmed "
                    f"maximum ({self._warmed_max_tokens}) and strict_grid "
                    "is on; raise --warmup-token-lengths or use the exact "
                    "CLI path"
                )
        with self._lock:
            # checked under the lock: a submit racing shutdown's drain
            # would otherwise enqueue a Future nobody ever resolves
            if self._stop:
                raise RuntimeError("batcher is shut down")
            if (self.max_queue is not None
                    and len(self._queue) >= self.max_queue):
                self.stats.rejected += 1
                raise Overloaded(
                    f"queue full ({self.max_queue} pending requests); "
                    "retry later"
                )
            self._queue.append(req)
            self._lock.notify()
        return req.future

    def shutdown(self, timeout: float = 30.0):
        with self._lock:
            self._stop = True
            self._lock.notify()
        self._thread.join(timeout)
        # fail anything still queued rather than hanging its client (under
        # the lock: the dispatcher may still be draining if join timed out)
        with self._lock:
            while self._queue:
                req = self._queue.popleft()
                req.future.set_exception(RuntimeError("server shut down"))

    # -- dispatcher side ---------------------------------------------------

    def _take_batch(self) -> List[_Request]:
        """Block for the first request, then collect same-group requests
        until max_batch or the head request's wait budget runs out."""
        with self._lock:
            while not self._queue and not self._stop:
                self._lock.wait(timeout=0.1)
            if self._stop and not self._queue:
                return []
            head = self._queue.popleft()
        if head.solo:
            # no wait window, no companions: the caller asked for pure
            # single-request latency (streaming first chunk)
            return [head]
        batch = [head]
        deadline = head.enqueued_at + self.max_wait_s
        while len(batch) < self.max_batch and not self._stop:
            with self._lock:
                # take every compatible request already waiting
                taken, kept = [], deque()
                while self._queue and len(batch) + len(taken) < self.max_batch:
                    r = self._queue.popleft()
                    take = r.group_key == head.group_key and not r.solo
                    (taken if take else kept).append(r)
                for r in kept:
                    self._queue.append(r)
                batch.extend(taken)
                remaining = deadline - time.monotonic()
                if len(batch) >= self.max_batch or remaining <= 0:
                    return batch
                self._lock.wait(timeout=min(remaining, 0.005))
        return batch

    def _loop(self):
        while True:
            batch = self._take_batch()
            if not batch:
                return
            try:
                self._dispatch(batch)
            except BaseException as e:  # noqa: BLE001 — fan the error out
                self.stats.errors += len(batch)
                for req in batch:
                    req.future.set_exception(e)
                if not isinstance(e, Exception):  # interrupt or exit: end the thread
                    raise

    def _next_generator(self) -> torch.Generator:
        """The batch's noise: a generator on the models' device seeded by the
        batch's count (JAX draws from PRNGKey(count))."""
        self._key_counter += 1
        return torch.Generator(device=self.synth.models.device).manual_seed(self._key_counter)

    def _dispatch(self, batch: List[_Request]):
        synth = self.synth
        with self._device, device_scope(synth.models.device):
            self._run(synth, batch)

    def _run(self, synth, batch: List[_Request]):
        t_disp = time.monotonic()
        m = synth.models
        hop = m.cfg.data.hop_length
        sr = m.cfg.data.sampling_rate
        steps, sampler = batch[0].steps, batch[0].sampler

        n = len(batch)
        b = next(s for s in self.batch_ladder if s >= n)
        tokens, lengths = synth._pack([r.token_ids for r in batch])
        # pad rows REPEAT real requests (tokens, lengths and voices): a zero
        # row's unconstrained predicted duration could push the whole
        # batch into a larger frame bucket
        rep = [i % n for i in range(b)]
        tokens, lengths = tokens[rep], lengths[rep]

        # per-row voices (the same shapes as the broadcast default)
        spk_rows = None
        if any(r.speaker is not None for r in batch):
            default = m.spk_emb.reshape(-1).float().cpu().numpy()
            spk_rows = np.stack([self.voices[r.speaker] if r.speaker is not None
                                 else default for r in batch])[rep]

        gen = self._next_generator()
        d = synth._switch_dispatch(tokens, lengths, gen, steps, self.length_scale, self.tg,
                                   self.sg, sampler=sampler, spk=spk_rows)
        if not d.fits:
            # some row overflowed the switch window: one batched fallback at
            # the right bucket, reusing the encoder outputs (the same policy
            # as Synthesizer.__call__'s switch branch)
            self.stats.overflows += 1
            if self.strict_grid:
                raise RuntimeError(
                    "predicted length overflowed the switch window "
                    f"{list(synth.switch_buckets)} and strict_grid is on "
                    "(the fallback bucket was not warmed); widen the "
                    "window or serve this request via the exact CLI path"
                )
            d = synth._fallback(d, gen, steps, self.tg, self.sg, sampler)
        wav = d.wav.cpu().numpy()
        y_len = d.y_lengths

        now = time.monotonic()
        self.stats.batches += 1
        self.stats.requests += n
        self.stats.batch_sizes[n] = self.stats.batch_sizes.get(n, 0) + 1
        self.stats.real_rows += n
        self.stats.padded_rows += b - n
        self.stats.total_dispatch_s += now - t_disp
        for i, req in enumerate(batch):
            n_samples = max(int(y_len[i]), 1) * hop
            out = wav[i, :n_samples].astype(np.float32)
            self.stats.total_latency_s += now - req.enqueued_at
            self.stats.total_speech_s += n_samples / sr
            self.stats.recent_frames.append(int(y_len[i]))
            self.stats.recent_tokens.append(len(req.token_ids))
            if synth.calibrator is not None:
                synth.calibrator.observe_total(
                    req.token_ids, float(y_len[i]) / self.length_scale
                )
            req.future.set_result((out, sr))

    # -- startup ---------------------------------------------------------

    def warmup(self, token_lengths: Sequence[int] = (64,)):
        """Run the (batch ladder x token bucket x window bucket) serving grid
        once at the default (steps, sampler) before opening the port
        (_warm_grid): the kernels' builds, the weight packs and the
        allocator's blocks are paid here, and a kernel that fails to build
        or launch at any of those shapes fails startup.

        Coverage caveat: a live request OUTSIDE this grid (non-default
        steps/sampler, longer tokens, or a frame-window overflow hitting the
        fallback bucket) runs cold on the single dispatcher. Set
        strict_grid=True to refuse such requests instead."""
        from unitspeech_tpu_torch.ops.masking import choose_bucket

        buckets = sorted({
            choose_bucket(t, self.synth.token_buckets) for t in token_lengths
        })
        self._warm_grid(self.synth, buckets)
        self._warmed_groups.add((self.default_steps, self.default_sampler))
        self._warmed_max_tokens = max(self._warmed_max_tokens, max(buckets))
        self._warmed_token_buckets.update(buckets)
        # warmup traffic must not read as served load in /stats
        self.stats = BatcherStats()

    def _warm_grid(self, synth, token_buckets: Sequence[int]):
        """One dispatch of `synth` at every (batch ladder size x token bucket
        x switch-window bucket) with the default sampler, with durations
        forced to fill each row to the window bucket (_single_dispatch):
        every bucket of the window runs, not only the one that a warm
        batch's predicted lengths would land in. Every step of a sampler
        runs the same shapes, so a dispatch runs k steps (k the spec's
        guidance stride: a full step, then k - 1 cheap ones), not the
        default count: on the card each step kind's CUDA graph is captured
        once a point, its tables sized for the default count
        (Synthesizer.reserve_steps), as the JAX package compiles its grid
        before the port opens. Each dispatch takes the device lock in turn
        with the dispatcher's batches, and nothing reaches the calibrator
        or /stats."""
        from unitspeech_tpu_torch.infer.tts import forced_durations
        from unitspeech_tpu_torch.models.diffusion import parse_sampler_spec

        steps = min(self.default_steps, parse_sampler_spec(self.default_sampler)[1])
        synth.reserve_steps(self.default_steps)
        for bsz in self.batch_ladder:
            for tb in token_buckets:
                tokens = np.ones((bsz, tb), np.int64)
                lengths = np.full((bsz,), tb, np.int64)
                for fb in synth.switch_buckets:
                    w = np.repeat(forced_durations(tb, int(fb)), bsz, axis=0)
                    with self._device, device_scope(synth.models.device):
                        gen = torch.Generator(synth.models.device).manual_seed(0)
                        synth._single_dispatch(tokens, lengths, w, int(fb), gen, steps,
                                               self.length_scale, self.tg, self.sg,
                                               self.default_sampler)

    # -- live window refresh ----------------------------------------------

    def _warm_synth(self, synth):
        """Warm a NEW switch window on `synth` without touching the serving
        path: _warm_grid over the warmed token buckets."""
        self._warm_grid(synth, sorted(self._warmed_token_buckets)
                        or [int(self.synth.token_buckets[0])])

    def refresh_window(self, policy: str = "cost", min_gain: float = 0.0,
                       per_frame_ms: Optional[float] = None,
                       max_branches: Optional[int] = None,
                       min_samples: int = 32, warm: bool = True
                       ) -> Dict[str, Any]:
        """Re-derive the switch window from the SERVED length distribution
        (the stats recent_frames ring) and hot-swap it — the traffic-drift
        answer: the startup window reflects the calibration corpus, this
        reflects live load. An operator (or a cron hitting POST
        /refresh_window) gets self-tuning serving.

        Runs on the CALLER's thread: the new window's warm-up dispatches
        run here, taking turns with the dispatcher, which keeps serving on
        the OLD window; the swap is one attribute assignment picked up at
        the next batch. Concurrent refreshes are rejected, not queued.

        policy/min_gain: the new window comes from the cost model
        (infer/bucket_cost.py; "cost" = optimal_window, "quantile" = the
        startup heuristic) and is only adopted when its predicted mean
        per-request cost beats the CURRENT window's by at least `min_gain`
        (fraction, e.g. 0.1 = 10%). Returns a decision dict (refreshed:
        bool, windows, predicted gain)."""
        import dataclasses as dc

        from unitspeech_tpu_torch.infer.bucket_cost import (
            frame_cost_curve,
            optimal_window,
            quantile_window,
            token_cost_ms,
            window_cost,
        )
        from unitspeech_tpu_torch.ops.masking import choose_bucket

        if not self._refresh_lock.acquire(blocking=False):
            return {"refreshed": False,
                    "reason": "refresh already in progress"}
        try:
            cur = tuple(int(b) for b in self.synth.switch_buckets)
            frames = list(self.stats.recent_frames)
            if len(frames) < min_samples:
                return {"refreshed": False, "window": list(cur),
                        "reason": f"only {len(frames)} served lengths "
                                  f"observed (need {min_samples})"}
            num_down = self.synth.models.cfg.decoder.num_downsamplings
            ladder = self.synth.frame_buckets
            if per_frame_ms is None:
                # the measured quadratic curve for the daemon's default
                # sampler mode (an HTTP-supplied scalar override stays the
                # legacy linear model)
                per_frame_ms = frame_cost_curve(
                    self.default_sampler, self.default_steps
                )
            nb = int(max_branches) if max_branches is not None else len(cur)
            lengths = np.asarray(frames, np.float64)
            # fold the SERVED token distribution into the absolute cost
            # predictions (mean encoder delta vs the curves' tok256
            # anchor): constant per request, so it never changes which
            # window wins, but it keeps predicted ms honest and makes the
            # min_gain ratio appropriately more conservative
            tok_ms = 0.0
            toks = list(self.stats.recent_tokens)
            if toks and isinstance(per_frame_ms, (tuple, list)):
                tb = self.synth.token_buckets
                tok_ms = float(np.mean(
                    [token_cost_ms(choose_bucket(t, tb)) for t in toks]))
            if policy == "cost":
                new, _ = optimal_window(lengths, ladder, per_frame_ms,
                                        nb, num_down, headroom=1)
                row = window_cost(lengths, new, per_frame_ms, ladder,
                                  num_down, tok_ms=tok_ms)
            elif policy == "quantile":
                new = quantile_window(lengths, ladder, max_branches=nb,
                                      num_down=num_down)
                row = window_cost(lengths, new, per_frame_ms, ladder,
                                  num_down, tok_ms=tok_ms)
            else:
                raise ValueError(f"unknown bucket policy {policy!r}")
            cur_row = window_cost(lengths, cur, per_frame_ms, ladder,
                                  num_down, tok_ms=tok_ms)
            gain = 1.0 - row["mean_proc_ms"] / cur_row["mean_proc_ms"]
            decision = {
                "window": list(new), "current": list(cur),
                "policy": policy, "n_lengths": len(frames),
                "predicted_mean_ms": row["mean_proc_ms"],
                "current_mean_ms": cur_row["mean_proc_ms"],
                "predicted_gain_pct": round(100.0 * gain, 1),
                "token_cost_ms": round(tok_ms, 2),
            }
            if tuple(new) == cur:
                return {**decision, "refreshed": False,
                        "reason": "window unchanged"}
            if gain < min_gain:
                return {**decision, "refreshed": False,
                        "reason": f"predicted gain {100 * gain:.1f}% below "
                                  f"min_gain {100 * min_gain:.1f}%"}
            new_synth = dc.replace(self.synth, switch_buckets=tuple(new))
            if warm:
                self._warm_synth(new_synth)
            self.synth = new_synth
            self.stats.window_refreshes += 1
            return {**decision, "refreshed": True}
        finally:
            self._refresh_lock.release()


def build_batcher(
    synth,
    calibration_texts: Optional[Sequence[Sequence[int]]] = None,
    max_batch: int = 8,
    max_wait_ms: float = 20.0,
    warmup_token_lengths: Sequence[int] = (64,),
    bucket_policy: str = "cost",
    **batcher_kwargs,
) -> DynamicBatcher:
    """Startup flow: calibrate the duration surrogate on a token corpus,
    derive the bucket-switch window from the observed length distribution,
    then warm the serving grid. `synth.calibrator` is made when
    `calibration_texts` is given and none is attached; otherwise
    `synth.switch_buckets` must already be configured.

    `bucket_policy` selects how the frame window is derived from the
    calibrated lengths: "cost" (the default — minimize expected
    per-request cost under the card's measured cost model,
    infer/bucket_cost.py, priced for the batcher's default (sampler,
    steps); needs cost_anchors_h100.json) or "quantile" (the P5..max
    heuristic)."""
    import dataclasses as dc

    if calibration_texts is not None:
        if synth.calibrator is None:
            from unitspeech_tpu_torch.infer.calibration import DurationCalibrator

            synth = dc.replace(
                synth,
                calibrator=DurationCalibrator(
                    n_vocab=synth.models.cfg.text_encoder.n_vocab,
                    min_samples=4,
                ),
            )
        synth.calibrate(calibration_texts)
        icfg = synth.models.cfg.inference
        lscale = batcher_kwargs.get("length_scale", icfg.length_scale)
        mk_kw = {}
        if bucket_policy == "cost":
            from unitspeech_tpu_torch.infer.bucket_cost import frame_cost_curve

            mk_kw["per_frame_ms"] = frame_cost_curve(
                _normalize_sampler_spec(
                    str(batcher_kwargs.get("default_sampler", "ddpm"))),
                int(batcher_kwargs.get("default_steps",
                                       icfg.diffusion_steps)),
            )
        window = synth.make_switch_buckets(
            length_scale=float(lscale), policy=bucket_policy, **mk_kw)
        synth = dc.replace(synth, switch_buckets=window)
    batcher = DynamicBatcher(synth, max_batch=max_batch,
                             max_wait_ms=max_wait_ms, **batcher_kwargs)
    try:
        batcher.warmup(warmup_token_lengths)
    except BaseException:
        batcher.shutdown()
        raise
    return batcher


# -- HTTP front-end ----------------------------------------------------------


def make_http_server(
    batcher: DynamicBatcher,
    host: str = "127.0.0.1",
    port: int = 0,
    text_to_ids: Optional[Callable[[str], Sequence[int]]] = None,
    request_timeout_s: float = 300.0,
):
    """stdlib ThreadingHTTPServer over the batcher.

    Endpoints:
      POST /synthesize  {"token_ids": [...]} or {"text": "..."} (+ optional
                        "steps", "sampler", "format": "wav"|"json",
                        "speaker": "<name>" — multi-voice serving: condition
                        on the named voice-bank embedding (batcher `voices`);
                        unknown names are a 400,
                        "split": true — long-text mode: the text is split
                        into sentence chunks that ride the batcher as one
                        parallel batch and are concatenated in order, so
                        input length is not bounded by a frame bucket,
                        "stream": true — STREAMING long-text mode: chunked
                        audio/wav; the first sentence chunk is submitted
                        solo (dispatches immediately, never batched) and its
                        audio is on the wire while the remaining chunks
                        synthesize as one parallel batch, so
                        time-to-first-audio is single-sentence latency
                        instead of whole-text latency. Implies split for
                        text inputs; format is ignored (always wav))
                        -> audio/wav bytes, or JSON {sr, n_samples,
                        wav_base64} when format=json
      POST /refresh_window  admin: re-derive the frame-bucket window from
                        the served length distribution and hot-swap it
                        (DynamicBatcher.refresh_window; optional JSON
                        {"policy": "cost"|"quantile", "min_gain": 0.1,
                        "max_branches": N, "min_samples": N}) -> decision
      GET  /healthz     -> {"status": "ok"}
      GET  /stats       -> batcher statistics snapshot (+ the live
                        switch_buckets window)

    Concurrency: HTTP threads block on their request's Future; the batcher's
    single dispatcher thread is the only device user."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        # 1.1 for chunked streaming responses; every non-chunked path sets
        # Content-Length explicitly (required under keep-alive)
        protocol_version = "HTTP/1.1"
        # idle keep-alive connections release their handler thread instead
        # of lingering forever on a client that never closes
        timeout = 65

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, payload: Dict[str, Any]):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream_wav(self, futs):
            """Chunked audio/wav: emit each chunk's PCM as its Future
            resolves, in order. The first chunk resolves BEFORE the status
            line so a first-chunk failure still returns a clean JSON error;
            a later failure truncates the chunked body (no terminal
            0-chunk), which clients see as a protocol error."""
            deadline = time.monotonic() + request_timeout_s
            try:
                wav0, sr = futs[0].result(
                    timeout=max(deadline - time.monotonic(), 1e-3)
                )
            except TimeoutError:
                self._json(504, {"error": "synthesis timed out"})
                return
            except Exception as e:  # noqa: BLE001 — surface, don't crash
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: bytes):
                self.wfile.write(f"{len(data):X}\r\n".encode()
                                 + data + b"\r\n")
                self.wfile.flush()

            chunk(wav_stream_header(sr) + pcm16_bytes(wav0))
            for f in futs[1:]:
                try:
                    wav, _ = f.result(
                        timeout=max(deadline - time.monotonic(), 1e-3)
                    )
                except Exception:  # noqa: BLE001 — truncate, don't crash
                    self.close_connection = True
                    return
                chunk(pcm16_bytes(wav))
            chunk(b"")  # terminal 0-length chunk: stream complete

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path == "/stats":
                snap = batcher.stats.snapshot()
                # the LIVE window (refresh_window may have swapped it since
                # the startup config line was printed)
                snap["switch_buckets"] = [
                    int(b) for b in batcher.synth.switch_buckets
                ]
                self._json(200, snap)
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path == "/refresh_window":
                # admin op: re-derive the frame window from served traffic
                # and hot-swap it (DynamicBatcher.refresh_window). Runs on
                # THIS handler thread, its warm-up dispatches taking turns
                # with the dispatcher's; the client waits.
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    if not isinstance(req, dict):
                        raise ValueError("body must be a JSON object")
                    kw = {}
                    if "policy" in req:
                        kw["policy"] = str(req["policy"])
                    if "min_gain" in req:
                        kw["min_gain"] = float(req["min_gain"])
                    if "max_branches" in req:
                        kw["max_branches"] = int(req["max_branches"])
                    if "min_samples" in req:
                        kw["min_samples"] = int(req["min_samples"])
                    decision = batcher.refresh_window(**kw)
                except (ValueError, TypeError) as e:
                    self._json(400, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 — surface it
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                self._json(200, decision)
                return
            if self.path != "/synthesize":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            # request validation + submit: every failure here is the
            # CLIENT's (400) — malformed JSON/body shape, bad spec, bad
            # types, or a strict-grid rejection raised by submit()
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    self._json(400, {"error": "body must be a JSON object"})
                    return
                steps = req.get("steps")
                sampler = req.get("sampler")
                speaker = req.get("speaker")
                if speaker is not None and not isinstance(speaker, str):
                    self._json(400, {"error": "speaker must be a string"})
                    return
                stream = bool(req.get("stream"))
                if (req.get("split") or stream) and "text" in req:
                    # LONG-TEXT mode: split into sentence chunks, submit
                    # them all at once — they ride the dynamic batcher as
                    # ONE batch (parallel synthesis), so a long text is not
                    # bounded by any single frame bucket
                    if text_to_ids is None:
                        self._json(400, {"error": "server has no text "
                                                  "frontend; send token_ids"})
                        return
                    from unitspeech_tpu_torch.text import split_sentences

                    chunks = split_sentences(req["text"])
                    id_lists = [
                        ids for c in chunks if (ids := list(text_to_ids(c)))
                    ]
                    if not id_lists:
                        self._json(400, {"error": "text produced no tokens"})
                        return
                    # streaming: chunk 0 goes solo (single-utterance
                    # latency); the rest are submitted in the same breath so
                    # they pack into one batch right behind it
                    futs = [batcher.submit(ids, steps=steps, sampler=sampler,
                                           solo=(stream and i == 0),
                                           speaker=speaker)
                            for i, ids in enumerate(id_lists)]
                else:
                    token_ids = req.get("token_ids")
                    if token_ids is None and "text" in req:
                        if text_to_ids is None:
                            self._json(400, {"error": "server has no text "
                                                      "frontend; send "
                                                      "token_ids"})
                            return
                        token_ids = list(text_to_ids(req["text"]))
                    if (not token_ids
                            or not isinstance(token_ids, (list, tuple))):
                        self._json(400, {"error": "token_ids or text "
                                                  "required"})
                        return
                    futs = [batcher.submit(token_ids, steps=steps,
                                           sampler=sampler, speaker=speaker)]
            except Overloaded as e:
                # backpressure, not a client mistake: 503 + Retry-After so
                # well-behaved clients back off
                self.send_response(503)
                body = json.dumps({"error": str(e)}).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Retry-After", "1")
                self.end_headers()
                self.wfile.write(body)
                return
            except (ValueError, KeyError, TypeError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            if stream:
                self._stream_wav(futs)
                return
            # dispatch-side failures are the SERVER's (500/504): a
            # ValueError from inside the batcher must not masquerade as 400
            try:
                deadline = time.monotonic() + request_timeout_s
                outs = [f.result(timeout=max(deadline - time.monotonic(),
                                             1e-3))
                        for f in futs]
                sr = outs[0][1]
                wav = (outs[0][0] if len(outs) == 1
                       else np.concatenate([o[0] for o in outs]))
            except TimeoutError:
                self._json(504, {"error": "synthesis timed out"})
                return
            except Exception as e:  # noqa: BLE001 — surface, don't crash
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if req.get("format") == "json":
                self._json(200, {
                    "sr": sr,
                    "n_samples": int(wav.shape[0]),
                    "wav_base64": base64.b64encode(
                        encode_wav_bytes(wav, sr)
                    ).decode(),
                })
            else:
                body = encode_wav_bytes(wav, sr)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

    class Server(ThreadingHTTPServer):
        # the stdlib default listen backlog (5) resets connections when many
        # clients connect at once (observed at 24 concurrent closed-loop
        # clients); a serving daemon needs a real accept queue
        request_queue_size = 128

    return Server((host, port), Handler)
