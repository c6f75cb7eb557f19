"""HuBERT encoder (mHuBERT), the unit extractor's dense model (counterpart
of unitspeech_tpu/models/ssl/hubert.py; fairseq HubertModel as textlesslib
loads it): conv extractor -> LayerNorm -> 512 -> 768 projection -> 12-layer
post-LN transformer; units read layer 6 (hop 320: 50 Hz).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from unitspeech_tpu_torch.models.ssl.feature_extractor import DEFAULT_CONV_LAYERS, conv_frames
from unitspeech_tpu_torch.models.ssl.wavlm import SSLModel


@dataclass(frozen=True)
class HubertConfig:
    extractor_mode: str = "group_norm"
    conv_layers: Tuple[Tuple[int, int, int], ...] = DEFAULT_CONV_LAYERS
    conv_bias: bool = False
    embed_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    layer_norm_first: bool = False
    conv_pos: int = 128
    conv_pos_groups: int = 16


def mhubert_base_config() -> HubertConfig:
    """mhubert-base-vp_en_es_fr (the textless registry)."""
    return HubertConfig()


def hubert_test_config() -> HubertConfig:
    """A tiny HuBERT for tests and smoke runs."""
    return HubertConfig(conv_layers=((8, 10, 5), (8, 3, 2), (8, 2, 2)), embed_dim=16,
                        num_layers=3, num_heads=2, ffn_dim=32, conv_pos=8, conv_pos_groups=2)


def hubert_config_by_name(name: str) -> HubertConfig:
    """The dense-model registry (reference textless/__init__.py:12-34).
    hubert-base-ls960 (the resynthesis example's default) has HuBERT Base's
    shapes, as mHuBERT-base does; the JAX registry lacks it, so that its
    example's checkpoint mode stops with a KeyError."""
    table = {"mhubert-base-vp_en_es_fr": mhubert_base_config,
             "hubert-base-ls960": mhubert_base_config, "hubert-test": hubert_test_config}
    if name not in table:
        raise KeyError(f"unknown dense model {name!r}; known: {sorted(table)}")
    return table[name]()


class HubertModel(SSLModel):
    def __init__(self, config: HubertConfig = HubertConfig()):
        super().__init__(config)
        self.config = config

    def forward(self, wav: torch.Tensor, output_layer: Optional[int] = None):
        """wav (B, samples) at 16 kHz in [-1, 1] -> (features (B, frames, D)
        f32, hidden states). Layer 6 is the output of the 6th layer
        (hidden_states[6]), as fairseq counts."""
        x, hidden = super().forward(wav, output_layer)
        return (hidden[output_layer] if output_layer is not None else x), hidden


class HubertFeatureReader:
    """A wav's features at one layer, as the JAX package computes them: each
    chunk of at most max_chunk samples (the reference's 100 s) is
    zero-padded to a sample bucket, a multiple of hop * 64, and run with
    no padding mask, so the padded zeros reach the true frames through
    attention; the true frames of each chunk are kept."""

    def __init__(self, model: HubertModel, layer: int = 6, max_chunk: int = 1_600_000,
                 hop: int = 320):
        self.model, self.layer, self.max_chunk, self.hop = model, layer, max_chunk, hop
        step = hop * 64
        self.buckets = [step * i for i in range(1, max(max_chunk // step, 1) + 1)]
        if self.buckets[-1] < max_chunk:
            self.buckets.append(self.buckets[-1] + step)

    def _bucket(self, n: int) -> int:
        return next((b for b in self.buckets if b >= n), self.buckets[-1])

    def _n_frames(self, n_samples: int) -> int:
        return conv_frames(n_samples, self.model.config.conv_layers)

    @torch.no_grad()
    def features(self, wav) -> torch.Tensor:
        """wav (samples,) -> (frames, D) f32 on the model's device."""
        wav = np.asarray(wav, np.float32)
        device = next(self.model.parameters()).device
        outs = []
        for start in range(0, len(wav), self.max_chunk):
            chunk = wav[start:start + self.max_chunk]
            n_frames = self._n_frames(len(chunk))
            if n_frames <= 0:
                continue
            padded = np.zeros((1, self._bucket(len(chunk))), np.float32)
            padded[0, :len(chunk)] = chunk
            feats, _ = self.model(torch.from_numpy(padded).to(device), self.layer)
            outs.append(feats[0, :n_frames])
        if outs:
            return torch.cat(outs)
        return torch.zeros((0, self.model.config.embed_dim), device=device)

    def __call__(self, wav) -> np.ndarray:
        """wav (samples,) -> (frames, D) float32 numpy."""
        return self.features(wav).cpu().numpy()
