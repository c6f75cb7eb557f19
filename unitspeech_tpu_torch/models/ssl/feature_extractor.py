"""Waveform conv feature extractor shared by HuBERT and WavLM (counterpart
of unitspeech_tpu/models/ssl/feature_extractor.py; fairseq
ConvFeatureExtractionModel). Two normalization modes:

  * "group_norm" (mHuBERT): GroupNorm with one group per channel after the
    first conv only, no conv bias;
  * "layer_norm" (WavLM-Large): a LayerNorm after every conv, conv bias.

The GELU is the exact (erf) form, as JAX calls it (approximate=False).
Strides multiply to 320: 50 Hz frames at 16 kHz. (B, samples) ->
(B, frames, C).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unitspeech_tpu_torch.models.layers import Affine, Conv1d

# (dim, kernel, stride): the standard 7-layer stack
DEFAULT_CONV_LAYERS: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
    (512, 3, 2), (512, 2, 2), (512, 2, 2),
)


def conv_frames(n_samples: int, conv_layers) -> int:
    """Frames the VALID conv stack makes of n_samples (0 when too short)."""
    n = n_samples
    for _, k, s in conv_layers:
        if n < k:
            return 0
        n = (n - k) // s + 1
    return n


class ConvFeatureExtractor(nn.Module):
    def __init__(self, conv_layers=DEFAULT_CONV_LAYERS, mode: str = "group_norm",
                 conv_bias: bool = False):
        super().__init__()
        if mode not in ("group_norm", "layer_norm"):
            raise ValueError(f"unknown extractor mode {mode!r}")
        self.conv_layers, self.mode = tuple(conv_layers), mode
        cin, bias = 1, conv_bias or mode == "layer_norm"
        for i, (dim, k, _) in enumerate(self.conv_layers):
            self.add_module(f"conv_{i}", Conv1d(cin, dim, k, bias=bias))
            if mode == "layer_norm" or i == 0:
                self.add_module(f"norm_{i}", Affine(dim))
            cin = dim

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav.to(torch.float32)[:, None, :]  # (B, 1, samples)
        for i, (dim, _, stride) in enumerate(self.conv_layers):
            conv = getattr(self, f"conv_{i}")
            x = F.conv1d(x, conv.kernel.permute(2, 1, 0), conv.bias, stride=stride)
            if self.mode == "group_norm" and i == 0:
                x = F.group_norm(x, dim, *getattr(self, f"norm_{i}").params(), eps=1e-5)
            elif self.mode == "layer_norm":
                x = F.layer_norm(x.transpose(1, 2), (dim,), *getattr(self, f"norm_{i}").params(),
                                 eps=1e-5).transpose(1, 2)
            x = F.gelu(x)
        return x.transpose(1, 2)
