"""Timing of the PyTorch port (`unitspeech_tpu_torch/`) on a CUDA card, at
full `MainConfig()` width with random weights from seed 0: the numbers
behind PERF.md sections 5 and 6. Imports no JAX.

    python3 -m unitspeech_tpu_torch.measure [--reps 3] [--out chiprun_out/measure_port.json]

Phases, all on the forced 344-frame request (50 DDPM steps, dual CFG
1.0/1.0) in five modes: "int8" (the CLI default: every kernel, int8
deep-stage convs), "bf16" (`--no-int8`), "deep_i8" (the fused deep-stage
configuration, `--deep --i8pre --resample`: K8, K9, K11), "deep"
(`--deep --resample --no-int8`: K8, K11) and "plain" (`--no-fast-kernels`),
the names chip_smoke.py gives these paths:

  build    the kernel library built twice each way, into empty
           directories, in the order single, parallel, parallel, single:
           one `nvcc -shared` over every source, as the first port slice
           built it, against `ops/_cuda.build` (one nvcc per source, all
           started together, then one link); wall seconds;
  rtf      `cli.main_inference` per mode: one warm-up round, then `--reps`
           rounds, the mode order rotating each round; wall s and RTF as
           the CLI reports them (host clock);
  phases   a Synthesizer per mode, one warm-up, then `--reps` requests
           timed on the host clock with a device sync after each phase:
           encode + sampler (`synthesize_mel`) and vocoder; then one
           estimator call (3 rows) 20 times back to back under CUDA
           events after 3 warm-up calls, reported per call;
  profile  one warm request per mode under `torch.profiler`: device time
           summed over every CUDA kernel, kernel count, idle share
           (1 - device time / profiled wall; profiler overhead included
           in the wall) and the 30 kernels with the most device time.

Writes one JSON object to --out and prints a summary.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from unitspeech_tpu_torch import cli
from unitspeech_tpu_torch.infer.tts import Synthesizer, TTSModels, forced_durations
from unitspeech_tpu_torch.ops import _cuda
from unitspeech_tpu_torch.text import phonemes_to_sequence

FRAMES, STEPS = 344, 50
TEXT = "ðɪs ɹɪkwɛst ɪz fɔɹst tə ðə θɹi hʌndɹəd ənd fɔɹti fɔɹ fɹeɪm bʌkɪt."
MODES = {"int8": [], "bf16": ["--no-int8"], "deep_i8": ["--deep", "--i8pre", "--resample"],
         "deep": ["--deep", "--resample", "--no-int8"], "plain": ["--no-fast-kernels"]}
# TTSModels.from_checkpoint's routes of each mode, as the CLI sets them
ROUTES = {"int8": dict(use_int8_deep=True), "bf16": {},
          "deep_i8": dict(use_int8_deep=True, use_deep=True, use_resample=True,
                          use_i8pre_deep=True),
          "deep": dict(use_deep=True, use_resample=True),
          "plain": dict(use_kernels=False)}


def measure_build():
    """Wall seconds of the two build schemes, each into an empty directory."""
    from torch.utils.cpp_extension import CUDA_HOME

    cu, _ = _cuda._sources()
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    saved = _cuda.BUILD_DIR
    out = {"single": [], "parallel": []}
    try:
        for scheme in ("single", "parallel", "parallel", "single"):
            with tempfile.TemporaryDirectory() as tmp:
                t0 = time.perf_counter()
                if scheme == "single":
                    subprocess.run(
                        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                         "-o", str(Path(tmp) / "lib.so"), *map(str, cu)],
                        capture_output=True, text=True, check=True)
                else:
                    _cuda.BUILD_DIR = Path(tmp)
                    _cuda.build()
                    _cuda.BUILD_DIR = saved
                out[scheme].append(time.perf_counter() - t0)
    finally:
        _cuda.BUILD_DIR = saved
    return out


def measure_rtf(ckpt, tmp, reps):
    out = {m: {"wall_s": [], "rtf": []} for m in MODES}
    order = list(MODES)
    for r in range(reps + 1):
        for mode in order[r % len(order):] + order[:r % len(order)]:
            stats = cli.main_inference(
                ["--ipa", "--text", TEXT, "--checkpoint", ckpt, "--device", "cuda",
                 "--output", os.path.join(tmp, "o.wav"), "--diffusion-steps", str(STEPS),
                 "--text-gradient-scale", "1.0", "--spk-gradient-scale", "1.0",
                 "--frames", str(FRAMES), *MODES[mode]])
            if r:  # round 0 is the warm-up
                out[mode]["wall_s"].append(stats["wall_s"])
                out[mode]["rtf"].append(stats["rtf"])
    for v in out.values():
        v["median_rtf"] = statistics.median(v["rtf"])
    return out


def _synth(ckpt, mode):
    return Synthesizer(TTSModels.from_checkpoint(ckpt, device="cuda", dtype=torch.bfloat16,
                                                 **ROUTES[mode]))


def _request(synth, ids, gen):
    mel, y_len, _ = synth.synthesize_mel(
        ids, gen, diffusion_steps=STEPS, text_gradient_scale=1.0, spk_gradient_scale=1.0,
        durations=forced_durations(len(ids), FRAMES))
    torch.cuda.synchronize()
    return mel, y_len


def measure_phases(ckpt, ids, reps):
    out = {}
    for mode in MODES:
        synth = _synth(ckpt, mode)
        gen = torch.Generator(device="cuda").manual_seed(0)
        rec = {"mel_s": [], "vocoder_s": []}
        for r in range(reps + 1):
            t0 = time.perf_counter()
            mel, _ = _request(synth, ids, gen)
            t1 = time.perf_counter()
            synth.vocode(mel)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if r:
                rec["mel_s"].append(t1 - t0)
                rec["vocoder_s"].append(t2 - t1)
        # one 3-row estimator call at the bucket, as the sampler makes it
        dec = synth.models.decoder
        g = torch.Generator(device="cuda").manual_seed(1)
        n_feats = synth.models.cfg.decoder.n_feats
        x, mu = (torch.randn(3, FRAMES, n_feats, generator=g, device="cuda") for _ in range(2))
        mask = torch.ones(3, FRAMES, device="cuda")
        mask[1, 301:] = 0
        t = torch.full((3,), 0.5, device="cuda")
        spk = synth.models.spk_emb.expand(3, -1).contiguous()
        with torch.no_grad():
            for _ in range(3):
                dec(x, mask, mu, t, spk)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(20):
                dec(x, mask, mu, t, spk)
            b.record()
            b.synchronize()
        rec["estimator_call_ms"] = a.elapsed_time(b) / 20
        out[mode] = rec
        del synth, dec
        torch.cuda.empty_cache()
    return out


def measure_profile(ckpt, ids):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for mode in MODES:
        synth = _synth(ckpt, mode)
        gen = torch.Generator(device="cuda").manual_seed(0)
        mel, _ = _request(synth, ids, gen)  # warm-up
        synth.vocode(mel)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mel, _ = _request(synth, ids, gen)
            synth.vocode(mel)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev_us = [e.self_device_time_total if hasattr(e, "self_device_time_total")
                  else e.self_cuda_time_total for e in kern]
        device_us = float(sum(dev_us))
        top = sorted(zip(dev_us, kern), key=lambda p: -p[0])[:30]
        out[mode] = {"wall_s": wall, "device_us": device_us,
                     "idle_share": 1.0 - device_us / (wall * 1e6),
                     "n_kernels": int(sum(e.count for e in kern)),
                     "top": [{"us": us, "count": e.count, "name": e.key} for us, e in top]}
        del synth
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("measure_port")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/measure_port.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_port: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "frames": FRAMES, "steps": STEPS, "reps": args.reps}
    result["build_s"] = measure_build()
    print("build s:", json.dumps(result["build_s"]), flush=True)
    _cuda.lib()
    ids = phonemes_to_sequence(TEXT)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.pt")
        cli.main_make_random_checkpoint(["--seed", "0", "--output", path])
        result["rtf"] = measure_rtf(path, tmp, args.reps)
        print("rtf:", json.dumps(result["rtf"]), flush=True)
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    result["phases"] = measure_phases(ckpt, ids, args.reps)
    print("phases:", json.dumps(result["phases"]), flush=True)
    result["profile"] = measure_profile(ckpt, ids)
    for mode, p in result["profile"].items():
        print(mode, json.dumps({k: v for k, v in p.items() if k != "top"}), flush=True)
        for t in p["top"]:
            print(f"  {t['us'] / 1e3:9.2f} ms {t['count']:7d}  {t['name'][:110]}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
