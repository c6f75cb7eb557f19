"""BigVGAN's adversarial train step (counterpart of
unitspeech_tpu/train/vocoder_gan.py): alternating least-squares GAN
updates of the MPD + MRD discriminators and the generator, with feature
matching and the mel loss, L_G = L_adv + L_fm + 45 * L_mel (feature_loss
holds the x2 of L_fm).

Order and freezing, as JAX's: the discriminator step first, on a
generated wav that carries no gradient (JAX's stop_gradient: here the
generator runs under no_grad), then the generator step against the
updated discriminators, whose parameters stop requiring gradients for it,
so that none of the generator's loss lands in their `.grad`. Each side
clips its gradients to one global norm of 1000. The generator trains on
its plain path (no kernel has a backward); the trained weights are served
on K5 / K6.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Tuple

import torch

from unitspeech_tpu_torch.models.discriminators import (
    discriminator_loss,
    feature_loss,
    generator_loss,
)
from unitspeech_tpu_torch.ops.mel import mel_spectrogram
from unitspeech_tpu_torch.train.steps import clip_by_global_norm

MEL_LOSS_WEIGHT = 45.0
GRAD_CLIP = 1000.0  # one global norm a side


def _mel(wav, data_cfg):
    """The log-mel (B, T, n_feats) of wavs (B, L), not normalized."""
    return mel_spectrogram(wav, n_fft=data_cfg.n_fft, num_mels=data_cfg.n_feats,
                           sampling_rate=data_cfg.sampling_rate, hop_size=data_cfg.hop_length,
                           win_size=data_cfg.win_length, fmin=data_cfg.mel_fmin,
                           fmax=data_cfg.mel_fmax)


@contextlib.contextmanager
def _frozen(*modules):
    """The modules' parameters require no gradient inside, and require it
    again after."""
    for m in modules:
        m.requires_grad_(False)
    try:
        yield
    finally:
        for m in modules:
            m.requires_grad_(True)


def make_vocoder_gan_steps(generator, mpd, mrd, gen_opt, disc_opt,
                           data_cfg) -> Tuple[Callable, Callable]:
    """(disc_step, gen_step), each batch -> metrics (0-d device tensors);
    batch: {"mel": (B, T, n_mels) log-mel, "wav": (B, T * hop)}. disc_opt
    holds mpd's and mrd's parameters, gen_opt the generator's."""
    disc_params = list(mpd.parameters()) + list(mrd.parameters())
    gen_params = list(generator.parameters())

    def disc_step(batch):
        y = batch["wav"]
        with torch.no_grad():
            y_hat = generator(batch["mel"])
        disc_opt.zero_grad(set_to_none=True)
        mpd_r, mpd_g, _, _ = mpd(y, y_hat)
        mrd_r, mrd_g, _, _ = mrd(y, y_hat)
        loss_mpd, _, _ = discriminator_loss(mpd_r, mpd_g)
        loss_mrd, _, _ = discriminator_loss(mrd_r, mrd_g)
        total = loss_mpd + loss_mrd
        total.backward()
        gnorm = clip_by_global_norm([p.grad for p in disc_params], GRAD_CLIP)
        disc_opt.step()
        return {"disc_loss": total.detach(), "disc_mpd": loss_mpd.detach(),
                "disc_mrd": loss_mrd.detach(), "disc_grad_norm": gnorm}

    def gen_step(batch):
        y = batch["wav"]
        gen_opt.zero_grad(set_to_none=True)
        with _frozen(mpd, mrd):
            y_hat = generator(batch["mel"])
            mel_loss = torch.mean(torch.abs(_mel(y_hat, data_cfg) - batch["mel"]))
            mpd_r, mpd_g, mpd_fr, mpd_fg = mpd(y, y_hat)
            mrd_r, mrd_g, mrd_fr, mrd_fg = mrd(y, y_hat)
            adv_mpd, _ = generator_loss(mpd_g)
            adv_mrd, _ = generator_loss(mrd_g)
            fm = feature_loss(mpd_fr, mpd_fg) + feature_loss(mrd_fr, mrd_fg)
            total = adv_mpd + adv_mrd + fm + MEL_LOSS_WEIGHT * mel_loss
            total.backward()
        gnorm = clip_by_global_norm([p.grad for p in gen_params], GRAD_CLIP)
        gen_opt.step()
        return {"gen_loss": total.detach(), "gen_adv": (adv_mpd + adv_mrd).detach(),
                "gen_fm": fm.detach(), "gen_mel_l1": mel_loss.detach(), "gen_grad_norm": gnorm}

    return disc_step, gen_step


def make_fused_vocoder_gan_step(generator, mpd, mrd, gen_opt, disc_opt,
                                data_cfg) -> Callable:
    """One training step: the real wavs' log-mel, then the discriminator
    step and the generator step (make_vocoder_gan_steps).
    fused_step(wav (B, L)) -> metrics of both."""
    disc_step, gen_step = make_vocoder_gan_steps(generator, mpd, mrd, gen_opt, disc_opt,
                                                 data_cfg)

    def fused_step(wav):
        batch = {"wav": wav, "mel": _mel(wav, data_cfg)}
        return {**disc_step(batch), **gen_step(batch)}

    return fused_step
