"""The port's measurement tools, counterparts of the JAX package's
`tools/` scripts that hold Pallas kernels of their own or drive them:

  python -m unitspeech_tpu_torch.tools.bench_resnet_kernel [--int8] [--deep] [--i8pre]
  python -m unitspeech_tpu_torch.tools.bench_transcendental [--rows 4096 --k 64 --k0 8]
  python -m unitspeech_tpu_torch.tools.probe_stride
  python -m unitspeech_tpu_torch.tools.bisect_deep_compile [CASE ...]

Each runs on the card (`--device cuda`, the default) and times with CUDA
events; `--device cpu` runs the plain versions with the host's clock, as a
smoke run only (its times are not the card's).
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch


# cycles the card spins before each timed call (about 1 ms at 2 GHz): the
# call's launches queue up behind it, so the events time the device's work
# and not the host's cost of launching it (20-40 us for a small kernel)
LEAD_CYCLES = 2_000_000


def median_ms(fn, device, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call of fn: on the card its device time
    under CUDA events, the events recorded behind LEAD_CYCLES of spinning;
    on the CPU the host clock."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(LEAD_CYCLES)
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
