"""The port's configuration: the sections of unitspeech_tpu/config.py that
the adaptive-TTS slice reads, as frozen dataclasses with the same fields,
the same defaults (the reference's numbers) and the same dict form, so a
checkpoint's `config` dict and a JSON overlay read the same in both
packages. Sections the slice does not read (the unit and contentvec
encoders, training, fine-tuning, the speaker embedder, the unit
extractor, the device mesh) are left out; a dict that carries them loads
with them ignored.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _tuple(*xs):
    return field(default_factory=lambda: tuple(xs))


@dataclass(frozen=True)
class DataConfig:
    """Audio/feature-frontend numbers (reference conf/hydra_config.py:33-44)."""

    n_units: int = 1000
    n_feats: int = 80
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    sampling_rate: int = 22050
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0
    add_blank: bool = True


@dataclass(frozen=True)
class EncoderConfig:
    """Text/unit/contentvec encoder (reference conf/hydra_config.py:84-107)."""

    n_vocab: int = 180
    n_feats: int = 80
    n_channels: int = 192
    filter_channels: int = 768
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    n_heads: int = 2
    window_size: Optional[int] = 4
    n_contentvec: int = 0
    prenet_kernel_size: int = 5
    prenet_layers: int = 3
    prenet_dropout: float = 0.5


@dataclass(frozen=True)
class DurationPredictorConfig:
    """Reference conf/hydra_config.py:111-118."""

    in_channels: int = 192
    filter_channels: int = 256
    kernel_size: int = 3
    p_dropout: float = 0.1
    spk_emb_dim: int = 256


@dataclass(frozen=True)
class DecoderConfig:
    """Diffusion decoder / U-Net score estimator
    (reference conf/hydra_config.py:122-131)."""

    n_feats: int = 80
    dim: int = 128
    dim_mults: Tuple[int, ...] = _tuple(1, 2, 4, 8)
    groups: int = 8
    pe_scale: int = 1000
    beta_min: float = 0.05
    beta_max: float = 20.0
    spk_emb_dim: int = 256
    diffusion_steps: int = 50

    @property
    def num_downsamplings(self) -> int:
        # the last resolution keeps an identity downsample
        # (reference unitspeech.py:142-148)
        return len(self.dim_mults) - 1


@dataclass(frozen=True)
class VocoderConfig:
    """BigVGAN generator, the published bigvgan_22khz_80band configuration
    (reference unitspeech/vocoder/models.py:121-201)."""

    num_mels: int = 80
    upsample_rates: Tuple[int, ...] = _tuple(8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = _tuple(16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock: str = "1"
    resblock_kernel_sizes: Tuple[int, ...] = _tuple(3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = _tuple(
        (1, 3, 5), (1, 3, 5), (1, 3, 5)
    )
    activation: str = "snakebeta"
    snake_logscale: bool = True
    sampling_rate: int = 22050


@dataclass(frozen=True)
class InferenceConfig:
    """Reference conf/hydra_config.py:8-20."""

    diffusion_steps: int = 50
    length_scale: float = 1.0
    text_gradient_scale: float = 1.0
    spk_gradient_scale: float = 1.0
    language: str = "en-us"
    with_sv56_normalization: bool = True


@dataclass(frozen=True)
class MainConfig:
    data: DataConfig = DataConfig()
    text_encoder: EncoderConfig = EncoderConfig()
    duration_predictor: DurationPredictorConfig = DurationPredictorConfig()
    decoder: DecoderConfig = DecoderConfig()
    vocoder: VocoderConfig = VocoderConfig()
    inference: InferenceConfig = InferenceConfig()


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, (list, tuple)) else v


def config_from_dict(d: dict) -> MainConfig:
    """MainConfig from a dict of sections (dataclasses.asdict output, as
    stored in checkpoints, or a JSON overlay): each section present
    overrides its defaults field by field; lists become tuples; sections
    and fields this config does not have are ignored."""
    base = MainConfig()
    updates = {}
    for f in dataclasses.fields(MainConfig):
        if f.name in d:
            sub = getattr(base, f.name)
            names = {g.name for g in dataclasses.fields(sub)}
            updates[f.name] = dataclasses.replace(
                sub, **{k: _tuples(v) for k, v in d[f.name].items() if k in names})
    return dataclasses.replace(base, **updates)


def load_json(path: str) -> MainConfig:
    """MainConfig overlay from a JSON file."""
    with open(path) as f:
        return config_from_dict(json.load(f))
