"""WavLM encoder, the speaker embedder's backbone (counterpart of
unitspeech_tpu/models/ssl/wavlm.py; microsoft/unilm WavLM as the reference
loads it through s3prl): layer-norm conv extractor -> 1024-d pre-LN
transformer of 24 layers with the gated relative position bias. Returns
all 25 hidden states (the embedding and each layer's output) for ECAPA's
layer-weighted sum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from unitspeech_tpu_torch.models.layers import Affine, Dense
from unitspeech_tpu_torch.models.ssl.feature_extractor import (
    DEFAULT_CONV_LAYERS,
    ConvFeatureExtractor,
)
from unitspeech_tpu_torch.models.ssl.transformer import SSLTransformerEncoder, _layer_norm


@dataclass(frozen=True)
class WavLMConfig:
    extractor_mode: str = "layer_norm"
    conv_layers: Tuple[Tuple[int, int, int], ...] = DEFAULT_CONV_LAYERS
    conv_bias: bool = True
    embed_dim: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    layer_norm_first: bool = True
    relative_position_embedding: bool = True
    gru_rel_pos: bool = True
    num_buckets: int = 320
    max_distance: int = 800
    conv_pos: int = 128
    conv_pos_groups: int = 16


def wavlm_large_config() -> WavLMConfig:
    return WavLMConfig()


def wavlm_base_config() -> WavLMConfig:
    return WavLMConfig(extractor_mode="group_norm", conv_bias=False, embed_dim=768,
                       num_layers=12, num_heads=12, ffn_dim=3072, layer_norm_first=False)


def wavlm_test_config() -> WavLMConfig:
    """A tiny WavLM for tests and smoke runs."""
    return WavLMConfig(conv_layers=((8, 10, 5), (8, 3, 2), (8, 2, 2)), embed_dim=16,
                       num_layers=2, num_heads=2, ffn_dim=32, num_buckets=16, max_distance=64,
                       conv_pos=8, conv_pos_groups=2)


class SSLModel(nn.Module):
    """Conv extractor -> LayerNorm -> projection to the model width (when
    they differ) -> transformer encoder: the stack WavLM and HuBERT share."""

    def __init__(self, c, relative_position_embedding: bool = False, gru_rel_pos: bool = False,
                 num_buckets: int = 320, max_distance: int = 800):
        super().__init__()
        self.feature_extractor = ConvFeatureExtractor(c.conv_layers, c.extractor_mode,
                                                      c.conv_bias)
        width = c.conv_layers[-1][0]
        self.layer_norm = Affine(width)
        if width != c.embed_dim:
            self.post_extract_proj = Dense(width, c.embed_dim)
        self.encoder = SSLTransformerEncoder(
            c.embed_dim, c.num_layers, c.num_heads, c.ffn_dim, c.layer_norm_first,
            relative_position_embedding, gru_rel_pos, num_buckets, max_distance, c.conv_pos,
            c.conv_pos_groups)

    def forward(self, wav: torch.Tensor, output_layer=None):
        """wav (B, samples) at 16 kHz -> (final (B, T, D), hidden states)."""
        x = _layer_norm(self.feature_extractor(wav), self.layer_norm)
        if hasattr(self, "post_extract_proj"):
            x = self.post_extract_proj(x)
        return self.encoder(x, output_layer)


class WavLMModel(SSLModel):
    def __init__(self, config: WavLMConfig = WavLMConfig()):
        super().__init__(config, config.relative_position_embedding, config.gru_rel_pos,
                         config.num_buckets, config.max_distance)
        self.config = config
