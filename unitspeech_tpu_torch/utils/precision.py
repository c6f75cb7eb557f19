"""The port's f32 policy: f32 means f32. PyTorch on the card may run f32
matmuls and cuDNN convolutions in TF32 (10-bit mantissa products); the
port's f32 paths are held to the JAX package's f32 numbers, so the CLI's
entry points run inside `strict_f32`, which turns TF32 off for both and
gives the caller's settings back on exit. bf16 work is unaffected: its
products are bf16 either way."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def strict_f32():
    """Context manager (and decorator): torch.backends.cuda.matmul.allow_tf32
    and torch.backends.cudnn.allow_tf32 False inside, the caller's values
    restored on exit. Only these two flags are read and set (PyTorch
    refuses to report a precision that the legacy and the newer
    fp32_precision settings were mixed to give)."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
