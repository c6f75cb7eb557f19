"""Tacotron2 + WaveGlow unit vocoder: unit codes -> waveform (counterpart
of unitspeech_tpu/infer/unit_vocoder.py; textlesslib vocoders/tacotron2/
vocoder.py:18-139 and tts_data.py:20-52). A unit string goes through the
checkpoint's code dict (sos / eos / collapse options), Tacotron2 decodes
the mel, WaveGlow vocodes it at sigma 0.666 and the denoiser removes the
model's bias spectrum.

The shapes are the JAX program's: tokens pad to multiples of 32, and
WaveGlow and the denoiser run over the whole decoded buffer of
max_decoder_steps frames (WaveGlow's dilated convs and the STFT frames
near the end read the noise past the decoded rows, so a trimmed run would
differ at the tail); the waveform is cut to n_steps x upsample_stride on
the host. The vocoder draws its prenet masks and WaveGlow noise from its
own torch.Generator on the models' device, seeded at construction.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Union

import numpy as np
import torch

from unitspeech_tpu_torch.models.tacotron2 import (
    Tacotron2,
    Tacotron2Config,
    convert_tacotron2,
    tacotron2_infer,
)
from unitspeech_tpu_torch.models.waveglow import (
    WaveGlow,
    WaveGlowConfig,
    WaveGlowDenoiser,
    convert_waveglow,
    stft_inverse,
    stft_transform,
    waveglow_infer,
)
from unitspeech_tpu_torch.utils.params import params_from_jax

SOS_TOK = "<s>"
EOS_TOK = "</s>"


def load_code_dict(path: str, add_sos: bool = False, add_eos: bool = False) -> Dict[str, int]:
    """'_' (pad) then one unit code a line (reference utils.py:93-107)."""
    with open(path) as f:
        codes = ["_"] + [line.rstrip() for line in f]
    code_dict = {c: i for i, c in enumerate(codes)}
    if add_sos:
        code_dict[SOS_TOK] = len(code_dict)
    if add_eos:
        code_dict[EOS_TOK] = len(code_dict)
    return code_dict


def code_to_sequence(code: List[str], code_dict: Dict[str, int], collapse_code: bool) -> List[int]:
    """reference text.py code_to_sequence: codes missing from the dict are
    dropped; collapse_code run-length-collapses repeats."""
    if collapse_code:
        prev, seq = None, []
        for c in code:
            if c in code_dict and c != prev:
                seq.append(code_dict[c])
                prev = c
        return seq
    return [code_dict[c] for c in code if c in code_dict]


@dataclass
class TacotronInput:
    """tts_data.py:20-49, the code path."""

    code_dict: Dict[str, int]
    add_sos: bool = False
    add_eos: bool = False
    collapse_code: bool = False

    def get_ids(self, units_str: str) -> np.ndarray:
        toks = units_str.split()
        if self.add_sos:
            toks = [SOS_TOK] + toks
        if self.add_eos:
            toks = toks + [EOS_TOK]
        return np.asarray(code_to_sequence(toks, self.code_dict, self.collapse_code), np.int32)


def token_bucket(n: int, step: int = 32) -> int:
    return max(step, ((n + step - 1) // step) * step)


@torch.no_grad()
def synthesize(tacotron: Tacotron2, waveglow: WaveGlow, bias_spec, tokens, lengths,
               taco_cfg: Tacotron2Config, generator=None, prenet_dropout: bool = True,
               denoiser_strength: float = 0.1, n_fft: int = 1024, hop: int = 256,
               prenet_masks=None, noise=None):
    """Tacotron decode -> WaveGlow (sigma 0.666, vocoder.py:112) -> the
    denoiser (vocoder.py:113), as JAX's _synthesize_jit composes them.
    prenet_masks / noise: injected draws (else from `generator`). Returns
    (audio (B, samples) on the models' device, the denoised stream padded
    to WaveGlow's length; n_steps (B,); has_eos (B,))."""
    _, mel_post, _, _, n_steps, has_eos = tacotron2_infer(
        tacotron, tokens, lengths, generator=generator, prenet_dropout=prenet_dropout,
        prenet_masks=prenet_masks, cfg=taco_cfg)
    audio = waveglow_infer(waveglow, mel_post, sigma=0.666, generator=generator, noise=noise)
    mag, phase = stft_transform(audio, n_fft, hop, n_fft)
    mag = torch.clamp(mag - bias_spec * denoiser_strength, min=0.0)
    audio_dn = stft_inverse(mag, phase, n_fft, hop, n_fft)
    # the inverse trims n_fft // 2 off each end: re-pad, so that sample i
    # still belongs to decoder step i // stride
    pad = audio.shape[1] - audio_dn.shape[1]
    if pad > 0:
        audio_dn = torch.nn.functional.pad(audio_dn, (0, pad))
    return audio_dn, n_steps, has_eos


class TacotronVocoder:
    """units (str or array) -> waveform float32 numpy (vocoder.py:45-60),
    on the device of the two models."""

    def __init__(self, tacotron: Tacotron2, waveglow: WaveGlow, tts_input: TacotronInput,
                 sample_rate: int = 22050, max_decoder_steps: int = 2000,
                 denoiser_strength: float = 0.1, denoiser_n_fft: int = 1024, seed: int = 0):
        self.tacotron, self.waveglow = tacotron, waveglow
        self.taco_cfg = dataclasses.replace(tacotron.cfg, max_decoder_steps=max_decoder_steps)
        self.tts_input = tts_input
        self.sample_rate = sample_rate
        self.denoiser_strength = denoiser_strength
        self.denoiser_n_fft = denoiser_n_fft
        self.device = waveglow.upsample.kernel.device
        self.denoiser = WaveGlowDenoiser(waveglow, n_fft=denoiser_n_fft, win_length=denoiser_n_fft)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @property
    def output_sample_rate(self) -> int:
        return self.sample_rate

    def __call__(self, units: Union[str, np.ndarray]) -> np.ndarray:
        if not isinstance(units, str):
            units = " ".join(str(int(u)) for u in np.asarray(units).reshape(-1))
        ids = self.tts_input.get_ids(units)
        n = len(ids)
        tokens = torch.zeros((1, token_bucket(n)), dtype=torch.long)
        tokens[0, :n] = torch.from_numpy(ids.astype(np.int64))
        audio, n_steps, _ = synthesize(
            self.tacotron, self.waveglow, self.denoiser.bias_spec, tokens.to(self.device),
            torch.tensor([n], device=self.device), self.taco_cfg, self.generator,
            denoiser_strength=self.denoiser_strength, n_fft=self.denoiser_n_fft,
            hop=self.denoiser_n_fft // 4)
        steps = int(n_steps[0])
        per_step = self.waveglow.cfg.upsample_stride * self.taco_cfg.n_frames_per_step
        return audio[0, :steps * per_step].cpu().numpy()

    @classmethod
    def from_torch(cls, tacotron_path: str, code_dict_path: str, waveglow_path: str,
                   max_decoder_steps: int = 2000, denoiser_strength: float = 0.1,
                   device="cuda") -> "TacotronVocoder":
        """The published checkpoint pair (vocoder.py:117-139: each a
        {'model_dict', 'hparams'} file), the models on `device`."""
        ckpt = torch.load(tacotron_path, map_location="cpu", weights_only=False)
        hp = ckpt["hparams"]

        def get(k, d):
            return hp.get(k, d) if isinstance(hp, dict) else getattr(hp, k, d)

        taco_cfg = Tacotron2Config(**{
            f.name: get(f.name, f.default) for f in dataclasses.fields(Tacotron2Config)
            if f.name != "max_decoder_steps"}, max_decoder_steps=max_decoder_steps)
        sd = {k: v.numpy() for k, v in ckpt["model_dict"].items()}
        tacotron = Tacotron2(taco_cfg)
        tacotron.load_state_dict(params_from_jax(convert_tacotron2(sd, taco_cfg)))
        tts_input = TacotronInput(load_code_dict(code_dict_path), add_sos=get("add_sos", False),
                                  add_eos=get("add_eos", False),
                                  collapse_code=get("collapse_code", False))

        wg_ckpt = torch.load(waveglow_path, map_location="cpu", weights_only=False)
        wg_hp = wg_ckpt["hparams"]

        def wg_get(k, d=None):
            return wg_hp.get(k, d) if isinstance(wg_hp, dict) else getattr(wg_hp, k, d)

        wn = wg_get("WN_config", {})
        wg_cfg = WaveGlowConfig(
            n_mel_channels=wg_get("n_mel_channels", 80), n_flows=wg_get("n_flows", 12),
            n_group=wg_get("n_group", 8), n_early_every=wg_get("n_early_every", 4),
            n_early_size=wg_get("n_early_size", 2), n_layers=wn.get("n_layers", 8),
            n_channels=wn.get("n_channels", 256), kernel_size=wn.get("kernel_size", 3))
        waveglow = WaveGlow(wg_cfg)
        waveglow.load_state_dict(params_from_jax(convert_waveglow(
            {k: v.numpy() for k, v in wg_ckpt["model_dict"].items()}, wg_cfg)))
        return cls(tacotron.to(device).eval(), waveglow.to(device).eval(), tts_input,
                   sample_rate=get("sampling_rate", 22050), max_decoder_steps=max_decoder_steps,
                   denoiser_strength=denoiser_strength)
