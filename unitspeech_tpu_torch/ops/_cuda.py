"""Build and load the port's CUDA kernels.

All `.cu` sources under `unitspeech_tpu_torch/csrc/` compile with `nvcc`
for `sm_90a`, one process per source in parallel, and link into ONE shared
library with a plain C interface, loaded with `ctypes` (no PyTorch headers:
the build takes seconds, not minutes). The
library lands in `unitspeech_tpu_torch/_build/`, named by a digest of the
sources, so an edited source rebuilds and an unchanged one loads as is.

Nothing here runs at import: the first kernel launch builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argtypes of every exported function; pointers and the stream are void*
_SIGNATURES = {
    "us_error_string": ([_I], ctypes.c_char_p),
    "us_conv_n_tiles": ([_I] * 3, _I),
    "us_conv_plan": ([_I] * 7 + [_P], _I),
    "us_resnet_conv3x3": ([_P, _P, _I] + [_P] * 4 + [_I] * 6 + [_P], _I),
    "us_gn_finalize": ([_P, _I, _I, _I, _I, _I, _F, _P, _P, _I, _P], _I),
    "us_gn_film": ([_P, _I] + [_P] * 7 + [_I] * 4 + [_F, _P], _I),
    "us_resnet_out": ([_P] * 7 + [_I] + [_P] * 3 + [_I] * 5 + [_P], _I),
    "us_final_block": ([_P, _P, _I] + [_P] * 9 + [_I] * 6 + [_F, _P], _I),
    "us_row_stats": ([_P, _I, _P, _I, _I, _I, _P], _I),
    "us_group_mean_inv": ([_P, _I, _P, _P] + [_I] * 4 + [_F, _P], _I),
    "us_row_absmax": ([_P, _I, _P, _I, _I, _I, _P], _I),
    "us_rezero_attention": ([_P] * 12 + [_I] * 3 + [_P], _I),
    "us_attn_plan": ([_I, _I, _P], _I),
    "us_aa_offsets": ([_I], _I),
    "us_aa_snake": ([_P] * 5 + [_I] * 3 + [_P], _I),
    "us_aa_snake_conv": ([_P] * 6 + [_I] + [_P] * 3 + [_I] * 5 + [_P], _I),
    "us_aa_conv_plan": ([_I] * 6 + [_P], _I),
    "us_resnet_block": ([_P] * 21 + [_I] * 6 + [_F, _I, _P], _I),
    "us_i8_glue_blocks": ([_I, _I], _I),
    "us_i8_quantize_chunks": ([_I], _I),
    "us_i8_quantize_rows": ([_P] * 5 + [_I] * 4 + [_P], _I),
    "us_resnet_conv3x3_i8": ([_P, _P, _I] + [_P] * 6 + [_I] * 5 + [_P], _I),
    "us_i8_glue": ([_P, _P, _I, _I, _F] + [_P] * 8 + [_I] * 4 + [_P], _I),
    "us_downsample_conv": ([_P] * 5 + [_I] * 8 + [_P], _I),
    "us_upsample_conv": ([_P] * 5 + [_I] * 8 + [_P], _I),
    "us_resample_plan": ([_I] * 7 + [_P], _I),
    "us_i8_absmax": ([_P] * 3 + [_I] * 4 + [_P], _I),
    "us_i8_quantize_scaled": ([_P] * 3 + [_I] + [_P] * 2 + [_I] * 3 + [_P], _I),
    "us_i8_glue_h": ([_P, _P, _I, _I, _F] + [_P] * 6 + [_I] * 5 + [_P], _I),
    "us_i8_glue_q": ([_P, _P, _I, _P, _P] + [_I] * 3 + [_P], _I),
    "us_resnet_conv3x3_i8_halo": ([_P, _P, _I] + [_P] * 6 + [_I] * 5 + [_P], _I),
    "us_resnet_block_i8": ([_P] * 28 + [_I] * 7 + [_F, _I, _P], _I),
    "us_i8_tile_copy": ([_P] * 5 + [_I] * 5 + [_P], _I),
    "us_resnet_conv3x3_i8_tiles": ([_P, _P, _I] + [_P] * 5 + [_I] * 6 + [_P], _I),
    "us_conv_i8_tiles_n_tiles": ([_I] * 3, _I),
    "us_conv_plan_i8_tiles": ([_I] * 7 + [_P], _I),
    "us_resnet_out_none": ([_P] * 7 + [_I] * 3 + [_P], _I),
    "us_resnet_conv3x3_halo": ([_P, _P, _I] + [_P] * 4 + [_I] * 5 + [_P], _I),
    "us_gn_film_rows": ([_P, _I] + [_P] * 7 + [_I] * 5 + [_F, _P], _I),
    "us_final_tail": ([_P, _P, _I] + [_P] * 6 + [_I] * 5 + [_F, _P], _I),
    "us_attn_kv": ([_P] * 5 + [_I] * 3 + [_P], _I),
    "us_attn_merge_out": ([_P] * 10 + [_I, _P] + [_I] * 3 + [_P], _I),
    "us_transcendental_chain": ([_P] * 2 + [_I] * 3 + [_P], _I),
    "us_row_select": ([_P] * 2 + [_I] * 4 + [_P], _I),
    "us_interleave_rows": ([_P] * 2 + [_I] * 2 + [_P], _I),
    "us_selection_matmul": ([_P] * 2 + [_I] * 2 + [_P], _I),
    "us_maximum_path": ([_P] * 4 + [_I] * 3 + [_P], _I),
}

_lock = threading.Lock()
_lib = None
build_log = ""
build_seconds: dict = {}  # source file -> wall seconds of its nvcc, from the last build


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cu*"))


def library_path() -> Path:
    _, all_files = _sources()
    h = hashlib.sha256()
    for p in all_files:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libunitspeech_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the library for these sources is missing.
    Returns its path; raises RuntimeError with nvcc's output on failure."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
    def nvcc_one(src, obj):
        t0 = time.perf_counter()
        p = subprocess.run([nvcc, *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                            "-v", "-c", "-o", str(obj), str(src)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return src.name, p.stdout, p.returncode, time.perf_counter() - t0

    # one nvcc per source, all started together, then one link (about a
    # third of the wall time of one nvcc over every source)
    with ThreadPoolExecutor(len(cu)) as pool:
        logs = list(pool.map(nvcc_one, cu, objs))
    build_seconds = {name: secs for name, _, _, secs in logs}
    build_log = "".join(f"== {name} (nvcc {secs:.1f} s)\n{log}" for name, log, _, secs in logs)
    failed = [name for name, _, rc, _ in logs if rc != 0]
    if not failed:
        tmp = out.with_name(f"{tag}.so.tmp")
        link = subprocess.run([nvcc, *arch, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = cdll
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        msg = lib().us_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t):
    """Device pointer of a tensor, or NULL for None."""
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, what: str, dtype=None, shape=None, device=None):
    """Validate a kernel operand: CUDA, dtype, shape, contiguity and 16-byte
    alignment (the kernels use vector loads)."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: must be 16-byte aligned")
    return t


def route(x: torch.Tensor, what: str) -> bool:
    """True to launch the CUDA kernel, False for the plain version. The
    choice follows the tensor's device alone: CPU tensors take the plain
    version, CUDA tensors the kernel, anything else is refused."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for device {x.device}")
