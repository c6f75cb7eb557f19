"""WaveGlow mel -> waveform vocoder and its denoiser (counterpart of
unitspeech_tpu/models/waveglow.py; textlesslib vocoders/tacotron2/
glow.py:62-309 and waveglow_denoiser.py:32-67). Inference only: the flows
invert with W^-1 computed at conversion, weight norm is folded into plain
conv weights at conversion.

Parameters keep the JAX tree's layout and names (`upsample.kernel`,
`convinv<k>.w_inverse`, `wn<k>.start` / `in_layer<i>` / `res_skip<i>` /
`end` / `cond`, each `kernel` (K, Cin, Cout) and `bias`). The upsample
kernel is stored as JAX stores it, spatially flipped (K, Cin, Cout) for
lax.conv_transpose; it is flipped back at use for F.conv_transpose1d.

The flows run channels-first (B, C, T'); the grouped channels keep the
reference's (mel, group offset) interleave, so converted checkpoints match
sample for sample. Each flow's cond_layer output is computed inside its
flow (JAX precomputes all twelve at once; the same numbers, a twelfth of
the memory).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unitspeech_tpu_torch.models.layers import Conv1d, ConvTranspose1d


@dataclass(frozen=True)
class WaveGlowConfig:
    n_mel_channels: int = 80
    n_flows: int = 12
    n_group: int = 8
    n_early_every: int = 4
    n_early_size: int = 2
    # WN_config
    n_layers: int = 8
    n_channels: int = 256
    kernel_size: int = 3
    upsample_kernel: int = 1024
    upsample_stride: int = 256

    def flow_channels(self) -> List[int]:
        """Audio channels entering each flow (glow.py:196-205)."""
        out, rem = [], self.n_group
        for k in range(self.n_flows):
            if k % self.n_early_every == 0 and k > 0:
                rem -= self.n_early_size
            out.append(rem)
        return out

    def early_flows(self) -> List[int]:
        """The flows after which early outputs leave (forward order)."""
        return [k for k in range(self.n_flows) if k % self.n_early_every == 0 and k > 0]


def waveglow_test_config(**kw) -> WaveGlowConfig:
    base = dict(n_mel_channels=8, n_flows=5, n_group=8, n_early_every=2,
                n_early_size=2, n_layers=2, n_channels=16, kernel_size=3,
                upsample_kernel=32, upsample_stride=8)
    base.update(kw)
    return WaveGlowConfig(**base)


class _WN(nn.Module):
    """The WaveNet-like conditioner of one flow (glow.py:105-175)."""

    def __init__(self, cfg: WaveGlowConfig, n_half: int):
        super().__init__()
        self.cfg = cfg
        nc = cfg.n_channels
        self.start = Conv1d(n_half, nc, 1)
        self.end = Conv1d(nc, 2 * n_half, 1)
        self.cond = Conv1d(cfg.n_mel_channels * cfg.n_group, 2 * nc * cfg.n_layers, 1)
        for i in range(cfg.n_layers):
            self.add_module(f"in_layer{i}", Conv1d(nc, 2 * nc, cfg.kernel_size))
            self.add_module(f"res_skip{i}", Conv1d(nc, 2 * nc if i < cfg.n_layers - 1 else nc, 1))

    def forward(self, audio_half, spect_g):
        """(B, n_half, T'), grouped spect (B, n_mel * n_group, T') -> (B,
        2 n_half, T') = [b; log s]."""
        cfg, nc = self.cfg, self.cfg.n_channels
        cond = self.cond.ncw(spect_g, 0)
        audio = self.start.ncw(audio_half, 0)
        output = torch.zeros_like(audio)
        for i in range(cfg.n_layers):
            dilation = 2 ** i
            pad = (cfg.kernel_size * dilation - dilation) // 2
            acts = getattr(self, f"in_layer{i}").ncw(audio, pad, dilation)
            acts = acts + cond[:, i * 2 * nc:(i + 1) * 2 * nc]
            acts = torch.tanh(acts[:, :nc]) * torch.sigmoid(acts[:, nc:])
            res_skip = getattr(self, f"res_skip{i}").ncw(acts, 0)
            if i < cfg.n_layers - 1:
                audio = audio + res_skip[:, :nc]
                output = output + res_skip[:, nc:]
            else:
                output = output + res_skip
        return self.end.ncw(output, 0)


class WaveGlow(nn.Module):
    """The parameter tree of convert_waveglow / random_waveglow_params as a
    module; inference is waveglow_infer."""

    def __init__(self, cfg: WaveGlowConfig):
        super().__init__()
        self.cfg = cfg
        # flax's ConvTranspose layout with VALID padding (torch padding 0)
        self.upsample = ConvTranspose1d(cfg.n_mel_channels, cfg.n_mel_channels,
                                        cfg.upsample_kernel, cfg.upsample_stride,
                                        cfg.upsample_kernel - 1)
        for k, c_k in enumerate(cfg.flow_channels()):
            inv = nn.Module()
            inv.w_inverse = nn.Parameter(torch.zeros(c_k, c_k))
            self.add_module(f"convinv{k}", inv)
            self.add_module(f"wn{k}", _WN(cfg, c_k // 2))


def upsample_mel(model: WaveGlow, spect):
    """spect (B, T, n_mel) -> grouped (B, n_mel * n_group, T'):
    ConvTranspose1d(mel, mel, K, stride), the conv-artifact trim
    (glow.py:251-258), then the reference's (mel, offset)-major grouping."""
    cfg = model.cfg
    y = model.upsample.ncw(spect.transpose(1, 2))
    y = y[:, :, :y.shape[2] - (cfg.upsample_kernel - cfg.upsample_stride)]
    b, n_mel, t = y.shape
    g = cfg.n_group
    y = y[:, :, :(t // g) * g].reshape(b, n_mel, t // g, g)
    return y.permute(0, 1, 3, 2).reshape(b, n_mel * g, t // g)


def noise_shapes(cfg: WaveGlowConfig, b: int, t_g: int) -> List[Tuple[int, int, int]]:
    """The (B, T', C) shape of each noise draw, in the reference's order:
    the initial draw, then one per early output in reversed flow order."""
    return ([(b, t_g, cfg.flow_channels()[-1])]
            + [(b, t_g, cfg.n_early_size)] * len(cfg.early_flows()))


@torch.no_grad()
def waveglow_infer(model: WaveGlow, spect, sigma: float = 1.0, generator=None,
                   noise: Optional[List] = None):
    """spect (B, T, n_mel) -> audio (B, T' * n_group) (glow.py:251-299).
    The noise is `noise`, JAX's explicit list of (B, T', C) draws
    (noise_shapes), or drawn from `generator` in that order."""
    cfg = model.cfg
    spect_g = upsample_mel(model, spect)
    b, _, t_g = spect_g.shape
    dev = spect_g.device
    if noise is None:
        noise = [torch.randn(s, generator=generator, device=dev) for s in noise_shapes(cfg, b, t_g)]
    noise = [torch.as_tensor(z, dtype=torch.float32, device=dev).transpose(1, 2) for z in noise]
    chans = cfg.flow_channels()
    early = set(cfg.early_flows())
    audio = sigma * noise[0]
    early_i = 0
    for k in reversed(range(cfg.n_flows)):
        n_half = chans[k] // 2
        audio_0, audio_1 = audio[:, :n_half], audio[:, n_half:]
        out = getattr(model, f"wn{k}")(audio_0, spect_g)
        audio_1 = (audio_1 - out[:, :n_half]) / torch.exp(out[:, n_half:])
        audio = torch.cat([audio_0, audio_1], dim=1)
        audio = torch.matmul(getattr(model, f"convinv{k}").w_inverse, audio)
        if k in early:
            early_i += 1
            audio = torch.cat([sigma * noise[early_i], audio], dim=1)
    return audio.transpose(1, 2).reshape(b, -1)  # (B, T', n_group) row-major = samples


# ---------------------------------------------------------------------------
# denoiser (waveglow_denoiser.py): STFT-domain bias removal


def _hann(win_length: int, n_fft: int) -> np.ndarray:
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win_length) / win_length)
    pad = (n_fft - win_length) // 2
    return np.pad(w, (pad, n_fft - win_length - pad))


def stft_transform(audio, n_fft: int = 1024, hop: int = 256, win_length: int = 1024):
    """(B, samples) -> (magnitude, phase), each (B, bins, frames): the
    reference's STFT (stft.py:77-105: reflect pad n_fft // 2, windowed
    frames)."""
    win = torch.as_tensor(_hann(win_length, n_fft), dtype=torch.float32, device=audio.device)
    pad = n_fft // 2
    x = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop) * win  # (B, F, n_fft)
    spec = torch.fft.rfft(frames, dim=-1)
    return spec.abs().transpose(1, 2), torch.atan2(spec.imag, spec.real).transpose(1, 2)


def stft_inverse(magnitude, phase, n_fft: int = 1024, hop: int = 256, win_length: int = 1024):
    """Overlap-add inverse normalized by the window's sum of squares
    (stft.py:107-136; the reference's pinv(scale * DFT) and its final
    scale cancel, leaving the windowed irfft's OLA / sum(win^2)). The
    overlap-add is F.fold (deterministic on the card)."""
    win = torch.as_tensor(_hann(win_length, n_fft), dtype=torch.float32, device=magnitude.device)
    spec = torch.polar(magnitude, phase)  # (B, bins, F)
    frames = torch.fft.irfft(spec.transpose(1, 2), n=n_fft, dim=-1) * win  # (B, F, n_fft)
    n_frames = frames.shape[1]
    out_len = n_fft + hop * (n_frames - 1)

    def ola(x):  # (B, F, n_fft) -> (B, out_len)
        return F.fold(x.transpose(1, 2), (1, out_len), (1, n_fft), stride=(1, hop))[:, 0, 0]

    audio = ola(frames)
    wss = ola((win ** 2).expand(1, n_frames, n_fft))[0]
    audio = torch.where(wss > 1e-11, audio / torch.clamp(wss, min=1e-11), audio)
    pad = n_fft // 2
    return audio[:, pad:-pad]


class WaveGlowDenoiser:
    """Subtract the model's sigma = 0 bias spectrum (waveglow_denoiser.py:
    32-67), from one sigma = 0 pass over `bias_frames` zero mel frames at
    construction."""

    def __init__(self, model: WaveGlow, n_fft: int = 1024, hop: Optional[int] = None,
                 win_length: int = 1024, bias_frames: int = 88):
        self.n_fft, self.hop, self.win_length = n_fft, hop or n_fft // 4, win_length
        dev = model.upsample.kernel.device
        mel = torch.zeros((1, bias_frames, model.cfg.n_mel_channels), device=dev)
        t_g = upsample_mel(model, mel).shape[2]
        zeros = [torch.zeros(s, device=dev) for s in noise_shapes(model.cfg, 1, t_g)]
        bias_audio = waveglow_infer(model, mel, sigma=0.0, noise=zeros)
        bias_spec, _ = stft_transform(bias_audio, self.n_fft, self.hop, self.win_length)
        self.bias_spec = bias_spec[:, :, :1]  # (1, bins, 1)

    @torch.no_grad()
    def __call__(self, audio, strength: float = 0.1):
        mag, phase = stft_transform(audio, self.n_fft, self.hop, self.win_length)
        mag = torch.clamp(mag - self.bias_spec * strength, min=0.0)
        return stft_inverse(mag, phase, self.n_fft, self.hop, self.win_length)


# ---------------------------------------------------------------------------
# parameter trees (numpy, as the JAX package makes them)


def _t(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _fold_wn_conv(sd, prefix) -> Tuple[np.ndarray, np.ndarray]:
    """weight-normed torch Conv1d -> plain (K, Cin, Cout) kernel and bias:
    w = g v / max(||v||, 1e-12), the norm over (Cin, K) per output channel."""
    if f"{prefix}.weight_g" in sd:
        g = _t(sd[f"{prefix}.weight_g"])  # (Cout, 1, 1)
        v = _t(sd[f"{prefix}.weight_v"])  # (Cout, Cin, K)
        norm = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
        w = g * v / np.maximum(norm, 1e-12)
    else:
        w = _t(sd[f"{prefix}.weight"])
    return w.transpose(2, 1, 0), _t(sd[f"{prefix}.bias"])


def random_waveglow_params(cfg: WaveGlowConfig, seed: int = 0, scale: float = 0.1) -> Dict:
    """Random tree with convert_waveglow's structure and shapes, the JAX
    package's draws from numpy.random.default_rng(seed) in its order."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def conv(k, cin, cout):
        return {"kernel": w(k, cin, cout), "bias": w(cout)}

    p: Dict[str, Any] = {"upsample": conv(cfg.upsample_kernel, cfg.n_mel_channels,
                                          cfg.n_mel_channels)}
    nc = cfg.n_channels
    cond_in = cfg.n_mel_channels * cfg.n_group
    for k, c_k in enumerate(cfg.flow_channels()):
        n_half = c_k // 2
        p[f"convinv{k}"] = {"w_inverse": (np.eye(c_k) + w(c_k, c_k)).astype(np.float32)}
        wn: Dict[str, Any] = {"start": conv(1, n_half, nc), "end": conv(1, nc, 2 * n_half),
                              "cond": conv(1, cond_in, 2 * nc * cfg.n_layers)}
        for i in range(cfg.n_layers):
            wn[f"in_layer{i}"] = conv(cfg.kernel_size, nc, 2 * nc)
            wn[f"res_skip{i}"] = conv(1, nc, 2 * nc if i < cfg.n_layers - 1 else nc)
        p[f"wn{k}"] = wn
    return p


def convert_waveglow(sd: Dict[str, np.ndarray], cfg: WaveGlowConfig) -> Dict:
    """torch WaveGlow state dict -> the JAX tree: weight norm folded, the
    inverse 1x1 weights from np.linalg.inv in float32, the upsample kernel
    spatially flipped to (K, Cin, Cout)."""
    up_w = _t(sd["upsample.weight"])  # ConvTranspose1d (Cin, Cout, K)
    p: Dict[str, Any] = {"upsample": {"kernel": up_w.transpose(2, 0, 1)[::-1].copy(),
                                      "bias": _t(sd["upsample.bias"])}}
    for k in range(cfg.n_flows):
        w = _t(sd[f"convinv.{k}.conv.weight"])[:, :, 0]
        p[f"convinv{k}"] = {"w_inverse": np.linalg.inv(w).astype(np.float32)}
        wn: Dict[str, Any] = {}
        kker, kb = _fold_wn_conv(sd, f"WN.{k}.start")
        wn["start"] = {"kernel": kker, "bias": kb}
        wn["end"] = {"kernel": _t(sd[f"WN.{k}.end.weight"]).transpose(2, 1, 0),
                     "bias": _t(sd[f"WN.{k}.end.bias"])}
        for i in range(cfg.n_layers):
            kker, kb = _fold_wn_conv(sd, f"WN.{k}.in_layers.{i}")
            wn[f"in_layer{i}"] = {"kernel": kker, "bias": kb}
            kker, kb = _fold_wn_conv(sd, f"WN.{k}.res_skip_layers.{i}")
            wn[f"res_skip{i}"] = {"kernel": kker, "bias": kb}
        p[f"wn{k}"] = wn
    for k in range(cfg.n_flows):
        kker, kb = _fold_wn_conv(sd, f"WN.{k}.cond_layer")
        p[f"wn{k}"]["cond"] = {"kernel": kker, "bias": kb}
    return p
