"""ECAPA-TDNN speaker embedder on WavLM features (counterpart of
unitspeech_tpu/models/speaker.py; reference ecapa_tdnn.py:164-298
ECAPA_TDNN_SMALL):

  wav 16 kHz -> WavLM-Large hidden states (25) -> softmax layer-weighted
  sum -> InstanceNorm over time -> TDNN layer1 + 3 SE-Res2Blocks
  (dilations 2/3/4, scale 8) -> cat(out2, out3, out4) -> 1x1 conv 1536 ->
  attentive statistics pooling -> BatchNorm -> Linear -> 256-d.

As the reference: the Res2 blocks run conv -> ReLU -> BN in that order, the
pooling's attention uses tanh, and callers unit-normalize the embedding.
The BatchNorms use their running statistics (the embedder is frozen in
every path). Channels-last (B, T, C); parameters under flax's names, the
BatchNorm statistics as buffers `mean` / `var` beside `scale` / `bias`.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from unitspeech_tpu_torch.models.layers import Conv1d, Dense
from unitspeech_tpu_torch.models.ssl.wavlm import (
    WavLMConfig,
    WavLMModel,
    wavlm_base_config,
    wavlm_large_config,
    wavlm_test_config,
)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(use_running_average=True, epsilon=1e-5) over the
    last axis: (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        return (x - self.mean) * (torch.rsqrt(self.var + 1e-5) * self.scale) + self.bias


def _conv(conv: Conv1d, x, dilation: int = 1):
    """SAME dilated conv of a (B, T, C) tensor."""
    k = conv.kernel.shape[0]
    return conv.ncw(x.transpose(1, 2), (k * dilation - dilation) // 2,
                    dilation).transpose(1, 2)


class Conv1dReluBn(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int = 1, dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.conv = Conv1d(cin, cout, kernel_size)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return self.bn(F.relu(_conv(self.conv, x, self.dilation)))


class Res2Conv1dReluBn(nn.Module):
    """Res2Net split conv: the channels split into `scale` groups; group i
    (1 .. scale - 2) convolves (previous output + group), the last group
    passes through."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1, scale: int = 8):
        super().__init__()
        self.scale, self.dilation = scale, dilation
        self.width = channels // scale
        self.nums = scale if scale == 1 else scale - 1
        for i in range(self.nums):
            self.add_module(f"conv_{i}", Conv1d(self.width, self.width, kernel_size))
            self.add_module(f"bn_{i}", BatchNorm(self.width))

    def forward(self, x):
        splits = torch.split(x, self.width, dim=-1)
        out: List[torch.Tensor] = []
        sp = None
        for i in range(self.nums):
            sp = splits[i] if i == 0 else sp + splits[i]
            sp = getattr(self, f"bn_{i}")(F.relu(_conv(getattr(self, f"conv_{i}"), sp,
                                                       self.dilation)))
            out.append(sp)
        if self.scale != 1:
            out.append(splits[self.nums])
        return torch.cat(out, dim=-1)


class SEConnect(nn.Module):
    """Squeeze-excite over time."""

    def __init__(self, channels: int, bottleneck: int = 128):
        super().__init__()
        self.linear1 = Dense(channels, bottleneck)
        self.linear2 = Dense(bottleneck, channels)

    def forward(self, x):
        s = torch.sigmoid(self.linear2(F.relu(self.linear1(x.mean(dim=1)))))
        return x * s[:, None, :]


class SERes2Block(nn.Module):
    """1x1 conv -> Res2 conv -> 1x1 conv -> SE, residual."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: int = 1, scale: int = 8):
        super().__init__()
        self.conv1 = Conv1dReluBn(channels, channels, 1)
        self.res2 = Res2Conv1dReluBn(channels, kernel_size, dilation, scale)
        self.conv2 = Conv1dReluBn(channels, channels, 1)
        self.se = SEConnect(channels)

    def forward(self, x):
        return self.se(self.conv2(self.res2(self.conv1(x)))) + x


class AttentiveStatsPool(nn.Module):
    """tanh-attention weighted mean and standard deviation over time."""

    def __init__(self, in_dim: int, attention_channels: int = 128):
        super().__init__()
        self.linear1 = Dense(in_dim, attention_channels)
        self.linear2 = Dense(attention_channels, in_dim)

    def forward(self, x):
        alpha = torch.softmax(self.linear2(torch.tanh(self.linear1(x))), dim=1)
        mean = (alpha * x).sum(dim=1)
        var = (alpha * x ** 2).sum(dim=1) - mean ** 2
        return torch.cat([mean, torch.sqrt(torch.clamp(var, min=1e-9))], dim=-1)


class EcapaTdnn(nn.Module):
    """Hidden states (L, B, T, D) -> (B, emb_dim): everything after the SSL
    backbone."""

    def __init__(self, feat_dim: int = 1024, channels: int = 512, emb_dim: int = 256,
                 n_hidden_states: int = 25):
        super().__init__()
        self.feature_weight = nn.Parameter(torch.empty(n_hidden_states))
        self.layer1 = Conv1dReluBn(feat_dim, channels, 5)
        for name, d in (("layer2", 2), ("layer3", 3), ("layer4", 4)):
            self.add_module(name, SERes2Block(channels, 3, d, 8))
        self.conv = Dense(3 * channels, 1536)
        self.pooling = AttentiveStatsPool(1536, 128)
        self.bn = BatchNorm(3072)
        self.linear = Dense(3072, emb_dim)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        w = torch.softmax(self.feature_weight, dim=0)
        x = torch.einsum("l,lbtd->btd", w, hidden_states) + 1e-6
        # InstanceNorm1d: per (sample, channel) over time, no affine
        mean = x.mean(dim=1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
        x = (x - mean) / torch.sqrt(var + 1e-5)
        out1 = self.layer1(x)
        out2 = self.layer2(out1)
        out3 = self.layer3(out2)
        out4 = self.layer4(out3)
        out = F.relu(self.conv(torch.cat([out2, out3, out4], dim=-1)))
        return self.linear(self.bn(self.pooling(out)))


WAVLM_CONFIGS = {"wavlm_large": wavlm_large_config, "wavlm_base": wavlm_base_config,
                 "wavlm_test": wavlm_test_config}


class SpeakerEmbedder(nn.Module):
    """wav (B, samples) at 16 kHz -> (B, emb_dim) speaker embedding
    (WavLM + ECAPA)."""

    def __init__(self, wavlm_config: WavLMConfig = WavLMConfig(), channels: int = 512,
                 emb_dim: int = 256):
        super().__init__()
        self.wavlm = WavLMModel(wavlm_config)
        self.ecapa = EcapaTdnn(wavlm_config.embed_dim, channels, emb_dim,
                               wavlm_config.num_layers + 1)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        _, hidden = self.wavlm(wav)
        return self.ecapa(torch.stack(hidden, dim=0))

    @classmethod
    def from_config(cls, cfg) -> "SpeakerEmbedder":
        """From a SpeakerEmbedderConfig: feat_type names the WavLM
        (wavlm_large in the reference; wavlm_test for smoke runs)."""
        if cfg.feat_type not in WAVLM_CONFIGS:
            raise KeyError(f"unknown feat_type {cfg.feat_type!r}; known: {sorted(WAVLM_CONFIGS)}")
        return cls(WAVLM_CONFIGS[cfg.feat_type](), cfg.channels, cfg.spk_emb_dim)
