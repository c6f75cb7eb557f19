"""BigVGAN's discriminators and GAN losses (counterpart of
unitspeech_tpu/models/discriminators.py; reference vocoder/models.py:204-376),
for training the vocoder:

  * MultiPeriodDiscriminator: per-period 2-D conv stacks over the (T / p, p)
    reshape of the wav (reflect-padded to a multiple of p), periods
    2, 3, 5, 7, 11;
  * MultiResolutionDiscriminator: 2-D conv stacks over |STFT| at three
    resolutions (n_fft, hop, win), a window shorter than n_fft centred in
    it as torch.stft centres it;
  * the least-squares GAN losses and the feature-matching loss (its x2
    inside).

Parameters keep flax's names and layout: `p{period}.conv_{i}` and
`r{n_fft}_{hop}.conv_{i}` (and `.conv_post`), conv kernels (kh, kw, in, out).
The convs run in torch's NCHW layout: H is the period's rows (the
frequency bins), W the period (the frames). Feature maps are NCHW; the
logits are flattened in the JAX order (C = 1). Weight norm is a plain
parameterization here, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unitspeech_tpu_torch.ops.mel import hann_window

LRELU_SLOPE = 0.1


class Conv2dHW(nn.Module):
    """flax nn.Conv over NHWC with kernel (kh, kw, in, out), a stride and a
    padding for each of H and W, applied to NCHW tensors."""

    def __init__(self, din: int, dout: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int] = (1, 1), padding: Tuple[int, int] = (0, 0)):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(*kernel, din, dout))
        self.bias = nn.Parameter(torch.empty(dout))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias, stride=self.stride,
                        padding=self.padding)


class DiscriminatorP(nn.Module):
    """One period discriminator (reference models.py:204-238)."""

    def __init__(self, period: int, channel_mult: float = 1.0):
        super().__init__()
        self.period = period
        cin = 1
        for i, ch in enumerate((32, 128, 512, 1024)):
            cout = int(ch * channel_mult)
            self.add_module(f"conv_{i}", Conv2dHW(cin, cout, (5, 1), (3, 1), (2, 0)))
            cin = cout
        self.conv_4 = Conv2dHW(cin, int(1024 * channel_mult), (5, 1), padding=(2, 0))
        self.conv_post = Conv2dHW(int(1024 * channel_mult), 1, (3, 1), padding=(1, 0))

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x: (B, T) wav -> (logits (B, N), feature maps)."""
        b, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x[:, None], (0, n_pad), mode="reflect")[:, 0]
            t += n_pad
        x = x.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for i in range(5):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11), channel_mult: float = 1.0):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"p{p}", DiscriminatorP(p, channel_mult=channel_mult))

    def forward(self, y, y_hat):
        """(outs_r, outs_g, fmaps_r, fmaps_g), one entry a period."""
        return _both(y, y_hat, [getattr(self, f"p{p}") for p in self.periods])


def _both(y, y_hat, discs):
    outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
    for d in discs:
        o_r, f_r = d(y)
        o_g, f_g = d(y_hat)
        outs_r.append(o_r)
        outs_g.append(o_g)
        fmaps_r.append(f_r)
        fmaps_g.append(f_g)
    return outs_r, outs_g, fmaps_r, fmaps_g


def stft_mag(x, n_fft: int, hop: int, win: int):
    """|STFT| (B, frames, n_fft // 2 + 1) with the reference's padding
    (models.py:307-315): reflect by (n_fft - hop) // 2 on each side, no
    centring, a periodic Hann window of `win` centred inside n_fft,
    sqrt(re^2 + im^2 + 1e-12)."""
    pad = (n_fft - hop) // 2
    x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)
    w = torch.from_numpy(hann_window(win)).to(x.device)
    if win < n_fft:
        left = (n_fft - win) // 2
        w = F.pad(w, (left, n_fft - win - left))
    spec = torch.fft.rfft(frames * w, n=n_fft, dim=-1)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-12)


# the MRD stack's convs: (kernel, stride, padding) over (frequency, frames)
_MRD_CONVS = (((3, 9), (1, 1), (1, 4)), ((3, 9), (1, 2), (1, 4)), ((3, 9), (1, 2), (1, 4)),
              ((3, 9), (1, 2), (1, 4)), ((3, 3), (1, 1), (1, 1)))


class DiscriminatorR(nn.Module):
    """One STFT-resolution discriminator (reference models.py:265-315)."""

    def __init__(self, resolution: Tuple[int, int, int], channel_mult: float = 1.0):
        super().__init__()
        self.resolution = tuple(resolution)
        ch = int(32 * channel_mult)
        cin = 1
        for i, (k, s, p) in enumerate(_MRD_CONVS):
            self.add_module(f"conv_{i}", Conv2dHW(cin, ch, k, s, p))
            cin = ch
        self.conv_post = Conv2dHW(ch, 1, (3, 3), padding=(1, 1))

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        h = stft_mag(x, *self.resolution).transpose(1, 2)[:, None]  # (B, 1, F, T)
        fmap = []
        for i in range(len(_MRD_CONVS)):
            h = F.leaky_relu(getattr(self, f"conv_{i}")(h), LRELU_SLOPE)
            fmap.append(h)
        h = self.conv_post(h)
        fmap.append(h)
        return h.reshape(h.shape[0], -1), fmap


class MultiResolutionDiscriminator(nn.Module):
    def __init__(self, resolutions=((1024, 120, 600), (2048, 240, 1200), (512, 50, 240)),
                 channel_mult: float = 1.0):
        super().__init__()
        self.names = [f"r{r[0]}_{r[1]}" for r in resolutions]
        for name, r in zip(self.names, resolutions):
            self.add_module(name, DiscriminatorR(r, channel_mult))

    def forward(self, y, y_hat):
        """(outs_r, outs_g, fmaps_r, fmaps_g), one entry a resolution."""
        return _both(y, y_hat, [getattr(self, n) for n in self.names])


def feature_loss(fmaps_r, fmaps_g):
    """Mean |real - generated| over every feature map, summed, x2
    (reference models.py:346-352)."""
    loss = 0.0
    for fr, fg in zip(fmaps_r, fmaps_g):
        for rl, gl in zip(fr, fg):
            loss = loss + torch.mean(torch.abs(rl.float() - gl.float()))
    return loss * 2.0


def discriminator_loss(real_outputs, generated_outputs):
    """LS-GAN discriminator loss (reference models.py:355-366): the sum over
    discriminators of mean (1 - D(y))^2 + mean D(y_hat)^2, and the two
    lists of terms."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(real_outputs, generated_outputs):
        r = torch.mean((1.0 - dr.float()) ** 2)
        g = torch.mean(dg.float() ** 2)
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    """LS-GAN generator loss (reference models.py:369-376): the sum of
    mean (1 - D(y_hat))^2, and its terms."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        term = torch.mean((1.0 - dg.float()) ** 2)
        gen_losses.append(term)
        loss = loss + term
    return loss, gen_losses
