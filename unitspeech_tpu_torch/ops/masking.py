"""Mask / alignment-path primitives (counterpart of
unitspeech_tpu/ops/masking.py; reference util.py:20-66).

Time-major channels-last like the JAX package: sequences are
(batch, time, channels), masks (batch, time).
"""

from __future__ import annotations

import torch


def sequence_mask(length: torch.Tensor, max_length: int, dtype=torch.float32):
    """(B,) lengths -> (B, max_length) mask; 1.0 inside, 0.0 in padding."""
    pos = torch.arange(max_length, device=length.device)
    return (pos[None, :] < length[:, None]).to(dtype)


def frames_from_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) prefix mask -> (B,) int32 valid frames. The sum runs in
    f32: a bf16 sum rounds odd lengths above 256."""
    return mask.reshape(mask.shape[0], -1).to(torch.float32).sum(dim=1).to(torch.int32)


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, Tx) integer-valued durations, (B, Tx, Ty) mask -> (B, Tx, Ty)
    monotonic 0/1 path; row x covers frames [cum(d)_{x-1}, cum(d)_x)."""
    t_y = mask.shape[2]
    cum = torch.cumsum(duration.to(torch.float32), dim=1)
    pos = torch.arange(t_y, dtype=torch.float32, device=mask.device)
    step = (pos[None, None, :] < cum[:, :, None]).to(mask.dtype)
    prev = torch.nn.functional.pad(step, (0, 0, 1, 0))[:, :-1]
    return (step - prev) * mask


def fix_len_compatibility(length: int, num_downsamplings_in_unet: int = 3) -> int:
    """Round a frame count up to a multiple of 2**num_downsamplings."""
    m = 2 ** num_downsamplings_in_unet
    return int(-(-length // m) * m)


def intersperse(lst, item):
    """Insert `item` between every element and at both ends (blank tokens)."""
    result = [item] * (len(lst) * 2 + 1)
    result[1::2] = lst
    return result


def choose_bucket(length: int, buckets) -> int:
    """Smallest bucket >= length (past the ladder: the next multiple of 8).

    The port pads frames exactly as the JAX Synthesizer does: GroupNorm
    statistics and the attention keys pool over the padded rows, so the
    padded length is part of the function computed."""
    for b in buckets:
        if b >= length:
            return int(b)
    return fix_len_compatibility(length, 3)


def default_frame_buckets(max_frames: int = 4096, num_down: int = 3):
    """Geometric-ish ladder of mel-frame counts, multiples of 2**num_down."""
    buckets = []
    b = 2 ** num_down * 4
    while b < max_frames:
        buckets.append(fix_len_compatibility(b, num_down))
        b = int(b * 1.125) + 1
    buckets.append(fix_len_compatibility(max_frames, num_down))
    return tuple(sorted(set(buckets)))
