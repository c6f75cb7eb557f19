"""The kernels of two measurement tools, with their plain versions (P1 and
P2; counterparts of the Pallas kernels in tools/bench_transcendental.py
`make_fn` and tools/probe_stride.py `run_case`). CUDA source:
csrc/probes.cu, which states what bounds them and how they are laid out.

P1, `transcendental_chain`: k rounds of acc = body(acc) * 0.5 + x over an
f32 array, for the eight bodies of BODIES (the cost of one elementwise op,
measured by unitspeech_tpu_torch/tools/bench_transcendental.py).

P2, the row-subsample forms of the stride-2 resample (measured by
unitspeech_tpu_torch/tools/probe_stride.py): `row_select` (keep the first
`keep` of every `period` rows: the strided slice, its reshape form and the
frame-block select), `selection_matmul` (a 0/1 selection matrix times x on
the tensor cores) and `interleave_rows` (rows x[i] and x[i] + 1 in turn).
"""

from __future__ import annotations

import torch

from unitspeech_tpu_torch.ops import _cuda
from unitspeech_tpu_torch.ops.fastmath import fast_exp, fast_sin

BODIES = {  # tools/bench_transcendental.py:51-60; a true division for "div"
    "mul": lambda x: x * 1.1,
    "jnp_sin": torch.sin,
    "fast_sin": fast_sin,
    "jnp_exp": lambda x: torch.exp(torch.clamp(x, max=8.0)),
    "fast_exp": lambda x: fast_exp(torch.clamp(x, max=8.0)),
    "jnp_tanh": torch.tanh,
    "div": lambda x: torch.full_like(x, 1.3) / (torch.abs(x) + 1.0),
    "rsqrt": lambda x: torch.rsqrt(torch.abs(x) + 1.0),
}
# f32 operations of one round per element, the body's own plus the chain's
# multiply and add; a transcendental or a division counts as one
ROUND_OPS = {"mul": 3, "jnp_sin": 3, "fast_sin": 14, "jnp_exp": 4, "fast_exp": 21,
             "jnp_tanh": 3, "div": 5, "rsqrt": 5}


def transcendental_chain_plain(x: torch.Tensor, k: int, body: str) -> torch.Tensor:
    """The P1 kernel's plain version: acc = x, then k times
    acc = BODIES[body](acc) * 0.5 + x, in f32."""
    fn = BODIES[body]
    acc = x
    for _ in range(k):
        acc = fn(acc) * 0.5 + x
    return acc


def transcendental_chain(x: torch.Tensor, k: int, body: str) -> torch.Tensor:
    """P1 on an f32 array of any shape. CUDA tensors launch the kernel, CPU
    tensors take transcendental_chain_plain."""
    if body not in BODIES:
        raise ValueError(f"transcendental_chain: body {body!r}, expected one of {list(BODIES)}")
    if not _cuda.route(x, "transcendental_chain"):
        return transcendental_chain_plain(x, k, body)
    _cuda.require(x, "x", dtype=torch.float32)
    out = torch.empty_like(x)
    lib = _cuda.lib()
    _cuda.check(lib.us_transcendental_chain(x.data_ptr(), out.data_ptr(), x.numel(), k,
                                            list(BODIES).index(body), _cuda.stream(x)),
                "transcendental_chain")
    transcendental_chain.launches += 1
    return out


transcendental_chain.launches = 0


def _rows(x: torch.Tensor, what: str, c_multiple: int = 8):
    if x.dim() != 2 or x.dtype != torch.bfloat16 or x.shape[1] % c_multiple:
        raise ValueError(f"{what}: expected (R, C) bf16 with C % {c_multiple} == 0, "
                         f"got {x.dtype} {tuple(x.shape)}")
    return _cuda.require(x, f"{what} x")


def row_select_plain(x: torch.Tensor, period: int, keep: int) -> torch.Tensor:
    """The first `keep` of every `period` rows of x (R, C), R % period == 0."""
    r, c = x.shape
    return x.reshape(r // period, period, c)[:, :keep].reshape(-1, c)


def row_select(x: torch.Tensor, period: int, keep: int) -> torch.Tensor:
    """P2's gather: period 2, keep 1 is x[::2]; period 2F, keep F keeps
    the first frame of every two. CUDA tensors launch the kernel, CPU
    tensors take row_select_plain."""
    if x.shape[0] % period or not 0 < keep <= period:
        raise ValueError(f"row_select: {x.shape[0]} rows, period {period}, keep {keep}")
    if not _cuda.route(x, "row_select"):
        return row_select_plain(x, period, keep)
    _rows(x, "row_select")
    rows = x.shape[0] // period * keep
    out = torch.empty((rows, x.shape[1]), dtype=x.dtype, device=x.device)
    _cuda.check(_cuda.lib().us_row_select(x.data_ptr(), out.data_ptr(), rows, x.shape[1],
                                          period, keep, _cuda.stream(x)), "row_select")
    row_select.launches += 1
    return out


row_select.launches = 0


def selection_matrix(r: int, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """S (r/2, r) with S[i, 2i] = 1, else 0."""
    s = torch.zeros((r // 2, r), dtype=dtype, device=device)
    s[torch.arange(r // 2), 2 * torch.arange(r // 2)] = 1
    return s


def selection_matmul_plain(x: torch.Tensor) -> torch.Tensor:
    """S @ x with selection_matrix(R), accumulated in f32, in x's dtype."""
    s = selection_matrix(x.shape[0], torch.float32, x.device)
    return (s @ x.to(torch.float32)).to(x.dtype)


SEL_BAND = 128  # x rows a warpgroup of the band product reads: its 64 outputs' ones
SEL_MAX_ROWS = 1024  # one thread a row, in one block a column strip


def selection_matmul(x: torch.Tensor) -> torch.Tensor:
    """P2's selection product on the tensor cores, the band form (each 64
    output rows take only the 128 rows of x their ones reach; a column with
    an inf or NaN in a skipped row comes out NaN, as the full product's
    0 * inf gives): x (R, C) bf16, C % 8 == 0 -> (R/2, C). CUDA tensors
    launch the kernel (R % 128 == 0, R <= 1024), CPU tensors take
    selection_matmul_plain."""
    if x.shape[0] % 2:
        raise ValueError(f"selection_matmul: {x.shape[0]} rows, expected an even count")
    if not _cuda.route(x, "selection_matmul"):
        return selection_matmul_plain(x)
    _rows(x, "selection_matmul")
    r, c = x.shape
    if r % SEL_BAND or r > SEL_MAX_ROWS:
        raise ValueError(f"selection_matmul: {r} rows, the kernel takes a multiple of "
                         f"{SEL_BAND} up to {SEL_MAX_ROWS}")
    out = torch.empty((r // 2, c), dtype=x.dtype, device=x.device)
    _cuda.check(_cuda.lib().us_selection_matmul(x.data_ptr(), out.data_ptr(), r, c,
                                                _cuda.stream(x)), "selection_matmul")
    selection_matmul.launches += 1
    return out


selection_matmul.launches = 0


def interleave_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Rows half[i] and half[i] + 1 in turn, half = the first R/2 rows of x;
    the sum rounded to x's dtype. -> (R, C)."""
    half = x[: x.shape[0] // 2]
    return torch.stack([half, half + 1.0], dim=1).reshape(x.shape)


def interleave_rows(x: torch.Tensor) -> torch.Tensor:
    """P2's interleave (the upsample form). CUDA tensors launch the
    kernel, CPU tensors take interleave_rows_plain."""
    if x.shape[0] % 2:
        raise ValueError(f"interleave_rows: {x.shape[0]} rows, expected an even count")
    if not _cuda.route(x, "interleave_rows"):
        return interleave_rows_plain(x)
    _rows(x, "interleave_rows")
    out = torch.empty_like(x)
    _cuda.check(_cuda.lib().us_interleave_rows(x.data_ptr(), out.data_ptr(), x.shape[0],
                                               x.shape[1], _cuda.stream(x)), "interleave_rows")
    interleave_rows.launches += 1
    return out


interleave_rows.launches = 0
