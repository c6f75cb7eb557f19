"""Adaptive text-to-speech pipeline (counterpart of
unitspeech_tpu/infer/tts.py `TTSModels` and `Synthesizer`; reference
unitspeech.py:413-450 driven by inference.py:34-160):

  phoneme IDs -> text encoder -> duration predictor -> generate_path ->
  aligned conditioning -> 50-step reverse DDPM with dual CFG ->
  denormalize -> BigVGAN -> waveform

The mel-frame axis is padded to a bucket of the same ladder as the JAX
Synthesizer (tts.py:516-518). PyTorch needs no static shapes, but the
padding is part of the function: GroupNorm statistics and the attention
keys pool over the padded frames. The exact mode (predicted durations) and
the forced-duration mode are ported; the bucket-switch, speculative and
calibrated modes belong to the serving slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from unitspeech_tpu_torch.config import MainConfig
from unitspeech_tpu_torch.models.diffusion import UnitSpeech, reverse_diffusion
from unitspeech_tpu_torch.models.duration import DurationPredictor
from unitspeech_tpu_torch.models.encoder import Encoder
from unitspeech_tpu_torch.models.vocoder import BigVGAN
from unitspeech_tpu_torch.ops.masking import (
    choose_bucket,
    default_frame_buckets,
    fix_len_compatibility,
    generate_path,
    sequence_mask,
)
from unitspeech_tpu_torch.ops.mel import denormalize_mel
from unitspeech_tpu_torch.utils.params import build_modules, config_from_dict


@dataclass
class TTSModels:
    """The synthesis path's modules (eval mode, on one device)."""

    cfg: MainConfig
    text_encoder: Encoder
    duration_predictor: DurationPredictor
    decoder: UnitSpeech
    vocoder: Optional[BigVGAN]
    spk_emb: torch.Tensor  # (1, spk_emb_dim), unit-normalized
    mel_min: torch.Tensor  # (n_feats,)
    mel_max: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.spk_emb.device

    @classmethod
    def from_checkpoint(cls, ckpt: dict, device="cuda", dtype=torch.bfloat16,
                        use_kernels: bool = True, use_int8_deep: bool = False,
                        use_deep: bool = False, use_resample: bool = False,
                        use_i8pre_deep: bool = False, with_vocoder: bool = True):
        """ckpt: the dict utils.params.random_params returns (or one loaded
        from a file that `cli make-random-checkpoint` wrote). The modules go
        to `device`, the card unless the caller asks for the CPU (no CUDA
        device raises). The encoder and duration predictor run in f32; the
        decoder and vocoder in `dtype`, with the estimator and vocoder
        kernels when `use_kernels`, and int8 deep-stage convs when
        `use_int8_deep`. use_deep, use_resample and use_i8pre_deep are the
        JAX package's use_pallas_deep, use_pallas_resample and
        use_i8pre_deep: the fused deep-stage configuration (models/unet.py)."""
        cfg = config_from_dict(ckpt["config"])
        mods = build_modules(cfg, device=device, dtype=dtype, use_kernels=use_kernels,
                             use_int8_deep=use_int8_deep, use_deep=use_deep,
                             use_resample=use_resample, use_i8pre_deep=use_i8pre_deep,
                             with_vocoder=with_vocoder)
        for name, mod in mods.items():
            mod.load_state_dict(ckpt[name])
            mod.eval().requires_grad_(False)
        spk = ckpt["spk_emb"].to(device, torch.float32).reshape(1, -1)
        return cls(cfg=cfg, text_encoder=mods["text_encoder"],
                   duration_predictor=mods["duration_predictor"], decoder=mods["decoder"],
                   vocoder=mods.get("vocoder"), spk_emb=spk / torch.linalg.vector_norm(spk),
                   mel_min=ckpt["mel_min"].to(device, torch.float32),
                   mel_max=ckpt["mel_max"].to(device, torch.float32))


def forced_durations(n_tok: int, frames: int) -> np.ndarray:
    """(1, n_tok) durations summing to `frames`, the remainder on the first
    token (the JAX Synthesizer's _forced_total_frames rule)."""
    w = np.full((1, n_tok), frames // n_tok, np.float32)
    w[0, 0] += frames - (frames // n_tok) * n_tok
    return w


@dataclass
class Synthesizer:
    models: TTSModels
    frame_buckets: Sequence[int] = field(default_factory=lambda: default_frame_buckets(4096))

    def _scales(self, diffusion_steps, length_scale, text_gradient_scale, spk_gradient_scale):
        icfg = self.models.cfg.inference
        pick = lambda v, d: d if v is None else v  # noqa: E731
        return (int(pick(diffusion_steps, icfg.diffusion_steps)),
                float(pick(length_scale, icfg.length_scale)),
                float(pick(text_gradient_scale, icfg.text_gradient_scale)),
                float(pick(spk_gradient_scale, icfg.spk_gradient_scale)))

    @torch.no_grad()
    def encode(self, token_ids: Sequence[int]):
        """Token IDs -> (mu_x (1, Tx, F), x_mask (1, Tx, 1), w_ceil (1, Tx)),
        with durations ceil(exp(logw)) before any length scale (reference
        unitspeech.py:424-425)."""
        m = self.models
        tokens = torch.tensor([list(token_ids)], dtype=torch.long, device=m.device)
        lengths = torch.tensor([len(token_ids)], device=m.device)
        mu_x, hidden, x_mask = m.text_encoder(tokens, lengths)
        logw = m.duration_predictor(hidden, x_mask, m.spk_emb)
        return mu_x, x_mask, torch.ceil(torch.exp(logw) * x_mask[..., 0])

    @torch.no_grad()
    def _align_and_sample(self, mu_x, x_mask, w_ceil, y_pad, steps, tg, sg, generator,
                          noise_z, noises):
        m = self.models
        y_lengths = torch.clamp(w_ceil.sum(dim=1), min=1.0)
        y_mask = sequence_mask(torch.clamp(y_lengths, max=y_pad).to(torch.int32), y_pad)
        attn = generate_path(w_ceil, x_mask * y_mask[:, None, :])
        cond_y = torch.einsum("bxy,bxf->byf", attn, mu_x)
        z = noise_z if noise_z is not None else torch.randn(
            cond_y.shape, generator=generator, device=cond_y.device)
        mel = reverse_diffusion(m.decoder, z, y_mask, cond_y, m.spk_emb, n_timesteps=steps,
                                text_gradient_scale=tg, spk_gradient_scale=sg,
                                generator=generator, noises=noises)
        return denormalize_mel(mel, m.mel_min, m.mel_max), attn

    def synthesize_mel(self, token_ids: Sequence[int], generator=None, diffusion_steps=None,
                       length_scale=None, text_gradient_scale=None, spk_gradient_scale=None,
                       noise_z=None, noises=None, durations=None):
        """Token IDs -> (denormalized log-mel (1, Ty_pad, F), y_length, attn).

        durations: optional (1, n_tok) forced per-token durations. noise_z
        (1, Ty_pad, F) / noises (steps, 1, Ty_pad, F): injected prior and
        per-step noise (shapes at the frame bucket the call resolves);
        otherwise drawn from `generator`."""
        steps, lscale, tg, sg = self._scales(diffusion_steps, length_scale,
                                             text_gradient_scale, spk_gradient_scale)
        mu_x, x_mask, w_ceil = self.encode(token_ids)
        w_ceil = w_ceil * lscale
        if durations is not None:
            w_ceil = torch.as_tensor(np.asarray(durations, np.float32), device=w_ceil.device)
        # the one host sync for the data-dependent length (reference
        # unitspeech.py:427-429)
        y_length = max(int(w_ceil.sum().item()), 1)
        num_down = self.models.cfg.decoder.num_downsamplings
        y_pad = choose_bucket(fix_len_compatibility(y_length, num_down), self.frame_buckets)
        mel, attn = self._align_and_sample(mu_x, x_mask, w_ceil, y_pad, steps, tg, sg,
                                           generator, noise_z, noises)
        return mel, y_length, attn

    @torch.no_grad()
    def vocode(self, mel: torch.Tensor) -> torch.Tensor:
        if self.models.vocoder is None:
            raise ValueError("Synthesizer built without a vocoder.")
        return self.models.vocoder(mel)

    def __call__(self, token_ids: Sequence[int], generator=None, forced_total_frames=None,
                 **kwargs):
        """Token IDs -> (waveform np.ndarray (n_samples,), sample_rate).

        forced_total_frames: durations forced to sum to this many frames
        (the forced-duration mode); otherwise predicted (the exact mode).
        Other keyword arguments go to synthesize_mel."""
        if self.models.vocoder is None:
            raise ValueError("Synthesizer built without a vocoder.")
        if forced_total_frames is not None:
            kwargs["durations"] = forced_durations(len(token_ids), int(forced_total_frames))
        mel, y_length, _ = self.synthesize_mel(token_ids, generator, **kwargs)
        hop = self.models.cfg.data.hop_length
        wav = self.vocode(mel)[0, : y_length * hop]
        return wav.cpu().numpy(), self.models.cfg.data.sampling_rate
