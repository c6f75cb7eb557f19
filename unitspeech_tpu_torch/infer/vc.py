"""Voice conversion (counterpart of unitspeech_tpu/infer/vc.py; reference
scripts/voice_conversion.py:18-43): speaker-invariant content features
(contentvec, 768-d, or unit IDs) -> the contentvec (or unit) encoder ->
linear time interpolation of the conditioning to the source's mel length
-> padding to a frame bucket -> the sampler a spec names, with dual CFG
-> denormalize. The waveform is BigVGAN's (cli voice-conversion).

The content extractor (models/ssl/contentvec.py) runs before this; the
features are an input, so unit-based conversion takes the same path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from unitspeech_tpu_torch.models.diffusion import parse_sampler_spec, sample
from unitspeech_tpu_torch.ops.masking import (
    choose_bucket,
    default_frame_buckets,
    fix_len_compatibility,
    sequence_mask,
)
from unitspeech_tpu_torch.ops.mel import denormalize_mel


def interpolate_linear(x, new_len: int):
    """(B, T, C) -> (B, new_len, C), linear with half-pixel centers and no
    low-pass on downscaling: F.interpolate(mode="linear",
    align_corners=False), as the reference calls it
    (voice_conversion.py:26-31)."""
    return F.interpolate(x.transpose(1, 2), size=int(new_len), mode="linear",
                         align_corners=False).transpose(1, 2)


def vc_frames(mel_len: int, num_downsamplings: int = 3, frame_buckets=None) -> int:
    """The frame bucket a conversion of mel_len frames pads to."""
    return choose_bucket(fix_len_compatibility(mel_len, num_downsamplings),
                         frame_buckets or default_frame_buckets(4096))


@torch.no_grad()
def voice_conversion(encoder, decoder, content, mel_len: int, spk_emb, mel_min, mel_max,
                     n_timesteps: int = 50, text_gradient_scale: float = 1.0,
                     spk_gradient_scale: float = 1.0, num_downsamplings: int = 3,
                     frame_buckets=None, sampler: str = "ddpm",
                     generator: torch.Generator | None = None, noise_z=None, noises=None):
    """content: (B, Tc, n_contentvec) features, or (B, Tc) int unit IDs for
    a unit encoder, on the modules' device; spk_emb (B, S) unit-normalized.
    Returns the denormalized mel (B, pad_len, F) f32, its first mel_len
    frames valid. The prior z and the DDPM's per-step noise come from
    `generator` (z first), or are injected: noise_z (B, pad_len, F),
    noises (n_timesteps, B, pad_len, F)."""
    parse_sampler_spec(sampler)
    pad_len = vc_frames(mel_len, num_downsamplings, frame_buckets)
    b, t_c = content.shape[:2]
    dev = content.device
    cond, _, _ = encoder(content, torch.full((b,), t_c, device=dev))
    cond = F.pad(interpolate_linear(cond, mel_len), (0, 0, 0, pad_len - mel_len))
    y_mask = sequence_mask(torch.full((b,), mel_len, device=dev), pad_len)
    z = noise_z if noise_z is not None else torch.randn(cond.shape, generator=generator,
                                                        device=dev)
    mel = sample(decoder, sampler, z, y_mask, cond, spk_emb, n_timesteps,
                 text_gradient_scale=text_gradient_scale,
                 spk_gradient_scale=spk_gradient_scale, generator=generator, noises=noises)
    return denormalize_mel(mel, mel_min, mel_max)
