"""The port's measurement tools, counterparts of the JAX package's
`tools/` scripts that hold Pallas kernels of their own or drive them:

  python -m unitspeech_tpu_torch.tools.bench_resnet_kernel [--int8] [--deep] [--i8pre]
  python -m unitspeech_tpu_torch.tools.bench_transcendental [--rows 4096 --k 64 --k0 8]
  python -m unitspeech_tpu_torch.tools.probe_stride
  python -m unitspeech_tpu_torch.tools.bisect_deep_compile [CASE ...]

Each runs on the card (`--device cuda`, the default) and times with CUDA
events; `--device cpu` runs the plain versions with the host's clock, as a
smoke run only (its times are not the card's).

The operator tools, counterparts of the JAX package's serving and timing
tools (`_serving.py` holds what the load tools share; `--small --device
cpu` is their smoke run):

  python -m unitspeech_tpu_torch.tools.bench_server / bench_serving / refresh_under_load
  python -m unitspeech_tpu_torch.tools.bucket_policy_ab / bench_train / bench_ssl
  python -m unitspeech_tpu_torch.tools.analyze_buckets / capacity_plan   # host, cost model
  python -m unitspeech_tpu_torch.tools.sv56 / validate_dataloader        # data
"""

from __future__ import annotations

import os
import statistics
import subprocess
import time

import numpy as np
import torch


# cycles the card spins before each timed call (about 1 ms at 2 GHz): the
# call's launches queue up behind it, so the events time the device's work
# and not the host's cost of launching it (20-40 us for a small kernel)
LEAD_CYCLES = 2_000_000


def median_ms(fn, device, reps: int = 20, warmup: int = 3,
              lead_cycles: int = LEAD_CYCLES) -> float:
    """Median milliseconds of one call of fn: on the card its device time
    under CUDA events, the events recorded behind `lead_cycles` of spinning
    (a call whose launches take the host longer than the spin is timed at
    the host's pace); on the CPU the host clock."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(lead_cycles)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(statistics.median(times))


def device_line(device) -> str:
    """What the numbers were taken on: the card's name and power limit as
    nvidia-smi reports them, or the CPU."""
    if device.type != "cuda":
        return "cpu (host clock; not a measurement of the card)"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def resolve_device(name: str) -> torch.device:
    """The device a tool runs on; a CUDA device must exist (no fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{name}: no CUDA device (pass --device cpu for a smoke run)")
    return dev


def synthetic_reference(directory: str, cfg, seconds: float = 6.0, seed: int = 0) -> list:
    """A fine-tune's inputs made from a seed, in `directory`: ref.wav (a
    voiced sound at cfg.data.sampling_rate, its pitch and loudness
    wandering, plus a little noise), units.npz (random units in runs of 1-4
    frames at 50 Hz covering the wav) and spk.npy (a speaker embedding).
    Returns `cli finetune`'s flags for them."""
    from unitspeech_tpu_torch.utils.audio import write_wav

    rng = np.random.default_rng(seed)
    sr = cfg.data.sampling_rate
    n = int(seconds * sr)
    t = np.arange(n) / sr
    phase = 2 * np.pi * np.cumsum(120.0 + 40.0 * np.sin(2 * np.pi * 0.7 * t)) / sr
    wav = sum(np.sin(k * phase) / k for k in range(1, 6))
    wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * 3.0 * t)) ** 2 + 0.01 * rng.standard_normal(n)
    paths = {k: os.path.join(directory, k) for k in ("ref.wav", "units.npz", "spk.npy")}
    write_wav(paths["ref.wav"], 0.9 * wav / np.abs(wav).max(), sr)
    n50 = int(seconds * 50)
    runs = rng.integers(1, 5, n50)
    runs = runs[: int(np.searchsorted(np.cumsum(runs), n50)) + 1]
    runs[-1] -= runs.sum() - n50
    np.savez(paths["units.npz"], units=rng.integers(0, cfg.unit_encoder.n_vocab, len(runs)),
             durations=runs)
    np.save(paths["spk.npy"], rng.standard_normal(cfg.decoder.spk_emb_dim).astype(np.float32))
    return ["--reference", paths["ref.wav"], "--units", paths["units.npz"],
            "--spk-emb", paths["spk.npy"]]


def synthetic_corpus(directory: str, cfg, texts, n_speakers: int = 4,
                     seconds=(1.5, 4.0), seed: int = 0) -> dict:
    """A STEP1 corpus made from a seed, in `directory`: one PCM wav at
    cfg.data.sampling_rate per (pre-phonemized IPA) text, of a length drawn
    from `seconds` (lo, hi), speaker i % n_speakers; each character of the
    text sounds in turn for an equal share of the wav as a tone whose pitch
    the character picks (between 2.5% and 22.5% of the rate), brightened by
    the speaker's own harmonics, with a little noise, so that text and
    audio align. Each wav is <speaker>/utt<i>.wav with its text beside it
    in <speaker>/utt<i>.txt (the generic layout of `cli make-filelist`).
    Writes filelist.txt (`path|text|speaker`) and spk_embs.npz (a random
    unit vector per speaker); returns their paths and the texts."""
    from unitspeech_tpu_torch.utils.audio import write_wav

    rng = np.random.default_rng(seed)
    sr = cfg.data.sampling_rate
    os.makedirs(directory, exist_ok=True)
    lines = []
    for i, text in enumerate(texts):
        spk = i % n_speakers
        n = int(rng.uniform(*seconds) * sr)
        chars = np.array([ord(c) for c in text])
        pitch = sr * (0.025 + 0.2 * ((chars * 7919) % 97) / 96.0)
        f = pitch[np.minimum(np.arange(n) * len(chars) // n, len(chars) - 1)]
        phase = 2 * np.pi * np.cumsum(f) / sr
        wav = sum(np.sin(k * phase) * (0.5 + 0.5 * np.cos(spk + k)) / k for k in (1, 2, 3))
        wav = wav + 0.02 * rng.standard_normal(n)
        stem = os.path.join(directory, str(spk), f"utt{i:03d}")
        os.makedirs(os.path.dirname(stem), exist_ok=True)
        path = stem + ".wav"
        write_wav(path, 0.8 * wav / np.abs(wav).max(), sr)
        with open(stem + ".txt", "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
        lines.append(f"{path}|{text}|{spk}")
    filelist = os.path.join(directory, "filelist.txt")
    with open(filelist, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")
    embs = rng.standard_normal((n_speakers, cfg.decoder.spk_emb_dim))
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    spk_path = os.path.join(directory, "spk_embs.npz")
    np.savez(spk_path, **{str(i): e.astype(np.float32) for i, e in enumerate(embs)})
    return {"filelist": filelist, "spk_embs": spk_path, "texts": list(texts)}
