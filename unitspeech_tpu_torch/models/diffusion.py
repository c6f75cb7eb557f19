"""Score-based diffusion decoder (counterpart of
unitspeech_tpu/models/diffusion.py; reference unitspeech.py:220-374).

Dual classifier-free guidance runs as ONE 3-row estimator call per step
(rows: text-unconditional, speaker-unconditional, conditional), combined
with the reference's algebra. The JAX `lax.scan` is a Python loop here.
Randomness comes from an explicit torch.Generator, or is injected
(`noise_z` / `noises`) so a run can be compared with the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from unitspeech_tpu_torch.models.unet import GradLogPEstimator2d
from unitspeech_tpu_torch.ops.schedule import make_reverse_schedule


class UnitSpeech(nn.Module):
    """Parameters: text_uncon (n_feats), spk_uncon (spk_emb_dim), estimator."""

    def __init__(self, n_feats=80, dim=128, dim_mults=(1, 2, 4, 8), groups=8,
                 beta_min=0.05, beta_max=20.0, pe_scale=1000.0, spk_emb_dim=256,
                 dtype=torch.float32, use_kernels=False, use_int8_deep=False, use_deep=False,
                 use_resample=False, use_i8pre_deep=False):
        super().__init__()
        self.beta_min, self.beta_max = beta_min, beta_max
        self.text_uncon = nn.Parameter(torch.empty(n_feats))
        self.spk_uncon = nn.Parameter(torch.empty(spk_emb_dim))
        self.estimator = GradLogPEstimator2d(dim, dim_mults, groups, pe_scale, spk_emb_dim,
                                             dtype=dtype, use_kernels=use_kernels,
                                             use_int8_deep=use_int8_deep, use_deep=use_deep,
                                             use_resample=use_resample,
                                             use_i8pre_deep=use_i8pre_deep, n_feats=n_feats)

    def forward(self, xt, mask, cond, t, spk_emb):
        return self.estimator(xt, mask, cond, t, spk_emb)

    @classmethod
    def from_config(cls, cfg, dtype=torch.float32, **routes):
        """routes: use_kernels, use_int8_deep, use_deep, use_resample,
        use_i8pre_deep (GradLogPEstimator2d's switches)."""
        return cls(n_feats=cfg.n_feats, dim=cfg.dim, dim_mults=tuple(cfg.dim_mults),
                   groups=cfg.groups, beta_min=cfg.beta_min, beta_max=cfg.beta_max,
                   pe_scale=cfg.pe_scale, spk_emb_dim=cfg.spk_emb_dim, dtype=dtype, **routes)


def build_cfg_rows(model: UnitSpeech, mask, cond, spk_emb,
                   text_gradient_scale: float, spk_gradient_scale: float):
    """Loop-invariant guidance rows. Returns (cond_c, spk_c, mask_c, n_rows,
    combine(s_all) -> score); with both scales > 0 the rows are
    (text_uncon, cond, cond) x (spk, spk_uncon, spk)."""
    b = mask.shape[0]
    tg, sg = float(text_gradient_scale), float(spk_gradient_scale)
    if tg <= 0.0 and sg <= 0.0:
        return cond, spk_emb, mask, 1, lambda s_all: s_all
    text_uncon_b = model.text_uncon.to(cond.dtype)[None, None, :].expand(cond.shape)
    # unit-normalized like the reference (unitspeech.py:358); the floor
    # only matters for an all-zero parameter
    spk_norm = torch.clamp(torch.linalg.vector_norm(model.spk_uncon), min=1e-8)
    spk_uncon_b = (model.spk_uncon / spk_norm)[None, :].expand(spk_emb.shape)

    if tg > 0.0 and sg > 0.0:
        def combine(s_all):
            s_tu, s_su, s = s_all[:b], s_all[b:2 * b], s_all[2 * b:]
            return s + tg * (s - s_tu) + sg * (s - s_su)

        return (torch.cat([text_uncon_b, cond, cond]), torch.cat([spk_emb, spk_uncon_b, spk_emb]),
                torch.cat([mask, mask, mask]), 3, combine)
    if tg > 0.0:
        def combine(s_all):
            return s_all[b:] + tg * (s_all[b:] - s_all[:b])

        return (torch.cat([text_uncon_b, cond]), torch.cat([spk_emb, spk_emb]),
                torch.cat([mask, mask]), 2, combine)

    def combine(s_all):
        return s_all[b:] + sg * (s_all[b:] - s_all[:b])

    return (torch.cat([cond, cond]), torch.cat([spk_uncon_b, spk_emb]),
            torch.cat([mask, mask]), 2, combine)


def cfg_score(model: UnitSpeech, xt, mask, cond, t, spk_emb,
              text_gradient_scale: float, spk_gradient_scale: float):
    """Dual classifier-free guidance in one batched estimator call:
    score = s + tg*(s - s_text_uncon) + sg*(s - s_spk_uncon)."""
    cond_c, spk_c, mask_c, n_rows, combine = build_cfg_rows(
        model, mask, cond, spk_emb, text_gradient_scale, spk_gradient_scale)
    xt_c = torch.cat([xt] * n_rows) if n_rows > 1 else xt
    t_c = torch.cat([t] * n_rows) if n_rows > 1 else t
    return combine(model(xt_c, mask_c, cond_c, t_c, spk_c))


@torch.no_grad()
def reverse_diffusion(model: UnitSpeech, z, mask, cond, spk_emb, n_timesteps: int = 50,
                      text_gradient_scale: float = 0.0, spk_gradient_scale: float = 0.0,
                      generator: torch.Generator | None = None, noises=None):
    """Reverse DDPM sampling (reference unitspeech.py:333-374), guidance
    stride 1. z/cond (B, T, F); mask (B, T); spk_emb (B, S). `noises`
    (n_timesteps, B, T, F) replaces the per-step draws. Returns mel
    (B, T, F) f32."""
    sched = make_reverse_schedule(n_timesteps, model.beta_min, model.beta_max)
    mask3 = mask[:, :, None]
    xt = z * mask3
    cond_c, spk_c, mask_c, n_rows, combine = build_cfg_rows(
        model, mask, cond, spk_emb, text_gradient_scale, spk_gradient_scale)
    for i in range(n_timesteps):
        if noises is None:
            noise = torch.randn(xt.shape, generator=generator, device=xt.device)
        else:
            noise = noises[i]
        xt_c = torch.cat([xt] * n_rows) if n_rows > 1 else xt
        t_c = torch.full((xt_c.shape[0],), float(sched.t_cont[i]), device=xt.device)
        score = combine(model(xt_c, mask_c, cond_c, t_c, spk_c))
        xt = (float(sched.c_x[i]) * xt + float(sched.c_score[i]) * score
              + float(sched.c_noise[i]) * noise) * mask3
    return xt * mask3
