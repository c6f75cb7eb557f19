"""The deep-stage conv3x3 over flattened rows (counterpart of
unitspeech_tpu/ops/conv_matmul.py `conv3x3_taps` / `conv3x3_im2col` and
`choose_conv_impl`).

JAX computes the deep-stage convs as matmuls outside any Pallas kernel
(unet.py `_flat_matmul_block`); here they are plain PyTorch convs on the
same (B, T*F, C) rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def choose_conv_impl(cin: int, cout: int) -> str:
    """Which ResnetBlocks run on flattened rows: the deep stages
    (max(cin, cout) >= 512, where the JAX package picks a matmul conv)
    take "flat", the others "conv"."""
    return "flat" if max(cin, cout) >= 512 else "conv"


def conv3x3_rows(xf: torch.Tensor, w: torch.Tensor, f: int) -> torch.Tensor:
    """SAME conv3x3 over (B, T*F, Cin) rows with a flax (3, 3, Cin, Cout)
    kernel (spatial (t, f)), or that kernel as the kernels read it,
    (9*Cin, Cout) -> (B, T*F, Cout) f32. The conv runs in the
    input's dtype: in bf16 its output is rounded to bf16 once, where the JAX
    matmul keeps the f32 accumulator."""
    b, n, cin = xf.shape
    x4 = xf.reshape(b, n // f, f, cin).permute(0, 3, 1, 2)
    w = w.reshape(3, 3, cin, -1).to(xf.dtype)
    y = F.conv2d(x4, w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1).reshape(b, n, -1).to(torch.float32)
