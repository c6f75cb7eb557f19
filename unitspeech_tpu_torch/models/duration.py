"""Duration predictor (counterpart of unitspeech_tpu/models/duration.py;
reference duration_predictor.py:24-63), inference direction: encoder
hiddens + speaker embedding -> log-durations. LayerNorm eps is 1e-5 (torch
F.layer_norm default), unlike the encoder's 1e-4."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from unitspeech_tpu_torch.models.layers import Affine, Conv1d, Dense


class DurationPredictor(nn.Module):
    def __init__(self, in_channels=192, filter_channels=256, kernel_size=3, spk_emb_dim=256):
        super().__init__()
        self.conv_1 = Conv1d(in_channels + spk_emb_dim, filter_channels, kernel_size)
        self.norm_1 = Affine(filter_channels)
        self.conv_2 = Conv1d(filter_channels, filter_channels, kernel_size)
        self.norm_2 = Affine(filter_channels)
        self.proj = Dense(filter_channels, 1)

    @staticmethod
    def _ln(x, norm):
        scale, bias = norm.params()
        return F.layer_norm(x, (x.shape[-1],), scale, bias, eps=1e-5)

    def forward(self, x, x_mask, g):
        """x (B, T, C) hiddens, x_mask (B, T, 1), g (B, spk_emb_dim) ->
        logw (B, T)."""
        x = torch.cat([x, g[:, None, :].expand(x.shape[0], x.shape[1], g.shape[-1])], dim=-1)
        x = self._ln(F.relu(self.conv_1(x * x_mask)), self.norm_1)
        x = self._ln(F.relu(self.conv_2(x * x_mask)), self.norm_2)
        return (self.proj(x * x_mask) * x_mask)[..., 0]

    @classmethod
    def from_config(cls, cfg):
        return cls(cfg.in_channels, cfg.filter_channels, cfg.kernel_size, cfg.spk_emb_dim)
