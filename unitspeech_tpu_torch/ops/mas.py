"""Monotonic alignment search (counterpart of unitspeech_tpu/ops/mas.py;
reference monotonic_align, called per batch at train_STEP1.py:344): the
Viterbi max-path through the (token, frame) log-prior, each frame staying
on its token or advancing by one.

    forward:  value[x] at frame y = lp[x, y] + max(value[x], value[x-1]),
              value at frame 0 = lp[0, 0] at x = 0, -1e9 elsewhere;
              decision[y, x] = (value[x-1] >= value[x]) (the Cython tie
              rule: advance on a tie)
    backward: from x = t_x - 1 at y = t_y - 1 down to frame 0, step back a
              token where the decision says so or where x == y

Per-sample lengths come from the mask (at least 1 each); rows past a
sample's t_y keep their value, and the path is multiplied by the mask.

The JAX package runs this as a `lax.scan` on the device so that the STEP1
step never syncs the host; the port runs it as CUDA kernel M1
(csrc/mas.cu: one block per batch row, the value row in shared memory,
one barrier per frame, decisions as bytes, one thread backtracking), the
port's only kernel with no Pallas counterpart. `maximum_path_plain` is its
plain version, the same f32 add and max in the same order, so the two are
equal bit for bit; CPU tensors take it.
"""

from __future__ import annotations

import torch

from unitspeech_tpu_torch.ops import _cuda

NEG_INF = -1e9


def maximum_path_plain(log_prior: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """log_prior (B, Tx, Ty), mask (B, Tx, Ty) 0/1 -> (B, Tx, Ty) 0/1 path in
    mask's dtype: for each sample a monotonic staircase from (0, 0) to
    (t_x - 1, t_y - 1), zero outside the mask (the kernel's plain version)."""
    b, t_x, t_y = log_prior.shape
    dev = log_prior.device
    lp = log_prior.to(torch.float32) * mask.to(torch.float32)
    # lengths: the mask's first frame summed over tokens, its first token
    # over frames, at least 1 each
    x_len = torch.clamp(mask[:, :, 0].sum(dim=1).to(torch.int32), min=1).long()
    y_len = torch.clamp(mask[:, 0, :].sum(dim=1).to(torch.int32), min=1).long()
    x_idx = torch.arange(t_x, device=dev)
    neg = torch.full((b, 1), NEG_INF, dtype=torch.float32, device=dev)
    value = torch.where(x_idx[None, :] == 0, lp[:, 0, 0][:, None], neg)
    decisions = torch.empty((t_y, b, t_x), dtype=torch.bool, device=dev)
    for y in range(t_y):
        advance = torch.cat([neg, value[:, :-1]], dim=1)
        decisions[y] = advance >= value
        new = lp[:, :, y] + torch.maximum(value, advance)
        active = ((y < y_len) & (y > 0))[:, None]
        value = torch.where(active, new, value)
    index = x_len - 1
    rows = torch.empty((t_y, b, t_x), dtype=torch.bool, device=dev)
    for y in range(t_y - 1, -1, -1):
        active = y < y_len
        rows[y] = (x_idx[None, :] == index[:, None]) & active[:, None]
        dec_at = decisions[y].gather(1, index[:, None])[:, 0]
        step = active & (index > 0) & ((index == y) | dec_at)
        index = index - step.long()
    return rows.permute(1, 2, 0).to(mask.dtype) * mask


def _maximum_path_cuda(log_prior: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    if log_prior.dim() != 3 or mask.shape != log_prior.shape:
        raise ValueError(f"maximum_path: log_prior {tuple(log_prior.shape)} and mask "
                         f"{tuple(mask.shape)} must both be (B, Tx, Ty)")
    b, t_x, t_y = log_prior.shape
    lp = _cuda.require(log_prior.to(torch.float32).contiguous(), "maximum_path log_prior")
    m = _cuda.require(mask.to(torch.float32).contiguous(), "maximum_path mask",
                      device=lp.device)
    path = torch.empty((b, t_x, t_y), dtype=torch.float32, device=lp.device)
    decisions = torch.empty((b, t_y, t_x), dtype=torch.uint8, device=lp.device)
    _cuda.check(_cuda.lib().us_maximum_path(lp.data_ptr(), m.data_ptr(), path.data_ptr(),
                                            decisions.data_ptr(), b, t_x, t_y,
                                            _cuda.stream(lp)),
                "maximum_path")
    maximum_path.launches += 1
    return path.to(mask.dtype)


def maximum_path(log_prior: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The most likely monotonic alignment, (B, Tx, Ty) 0/1 in mask's dtype.
    CUDA tensors launch M1, CPU tensors take maximum_path_plain; the two are
    equal bit for bit. No gradient flows through it (it is a search)."""
    with torch.no_grad():
        if _cuda.route(log_prior, "maximum_path"):
            return _maximum_path_cuda(log_prior, mask)
        return maximum_path_plain(log_prior, mask)


maximum_path.launches = 0


def work(b: int, t_x: int, t_y: int) -> dict:
    """M1's least work on a (B, Tx, Ty) f32 problem: the log-prior and the
    mask read once and the path written once, and three f32 operations a
    cell (the mask multiply, the max, the add)."""
    cells = b * t_x * t_y
    return {"bytes": 12 * cells, "f32": 3 * cells}
