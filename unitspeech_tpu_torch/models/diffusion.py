"""Score-based diffusion decoder (counterpart of
unitspeech_tpu/models/diffusion.py; reference unitspeech.py:220-492).

Dual classifier-free guidance runs as ONE 3-row estimator call per step
(rows: text-unconditional, speaker-unconditional, conditional), combined
with the reference's algebra. The JAX `lax.scan` is a Python loop here.
Two samplers, named by a spec (`parse_sampler_spec`, dispatched by
`sample`): the reference's stochastic DDPM and the JAX package's
DPM-Solver++(2M) `dpm2`, each with an optional guidance stride `:cs<k>`
(CFG delta caching: the 3-row call on every k-th step, 1-row calls
between). The training losses (forward diffusion, the score-matching
loss, the fine-tune's random segment crop) run under autograd.

Randomness comes from an explicit torch.Generator, or is injected
(`noise_z` / `noises` for the sampler, `draws` for the losses) so a run
can be compared with the JAX package, whose PRNG streams torch cannot
reproduce.
"""

from __future__ import annotations

import torch
from torch import nn

from unitspeech_tpu_torch.models.unet import GradLogPEstimator2d
from unitspeech_tpu_torch.ops.masking import sequence_mask
from unitspeech_tpu_torch.ops.schedule import (
    forward_diffusion_coefficients,
    make_ode_schedule,
    make_reverse_schedule,
)


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


SAMPLERS = ("ddpm", "dpm2")


def parse_sampler_spec(spec: str):
    """A sampler spec: "ddpm" or "dpm2", optionally with a guidance stride
    ":cs<k>" (e.g. "dpm2:cs2"): the two unconditional guidance rows run
    only every k-th step, their delta cached in between (see
    reverse_diffusion's cfg_stride). Returns (name, cfg_stride); a
    malformed spec raises ValueError, with the JAX package's messages."""
    name, _, opt = str(spec).partition(":")
    stride = 1
    if opt:
        if not (opt.startswith("cs") and opt[2:].isdigit() and int(opt[2:]) >= 1):
            raise ValueError(f"bad sampler option {opt!r} in {spec!r} (expected 'cs<k>')")
        stride = int(opt[2:])
    if name not in SAMPLERS:
        raise ValueError(f"unknown sampler {name!r} (expected 'ddpm' or 'dpm2')")
    return name, stride


def _guided_score(model: UnitSpeech, mask, cond, spk_emb, text_gradient_scale: float,
                  spk_gradient_scale: float, n_timesteps: int, cfg_stride: int, std_of):
    """score(xt, t, i): the guided score of sampler step i at time t.

    With cfg_stride k > 1 and guidance on (CFG delta caching, the JAX
    package's `_reverse_diffusion_strided`): the steps run in groups of k
    (k clamped to n_timesteps); a group's first step makes the full
    guidance call and caches its delta in eps space, delta * std_t; the
    group's other steps run the estimator on the conditional rows alone
    (B rows, not 3B) and add the cached delta back as delta / std_t. The
    trailing n % k steps run full. std_of(i) is step i's std_t. The
    estimator returns f32 on every route, so the combine and the cached
    delta are f32, as the sampler state is."""
    cond_c, spk_c, mask_c, n_rows, combine = build_cfg_rows(
        model, mask, cond, spk_emb, text_gradient_scale, spk_gradient_scale)
    b = mask.shape[0]
    stride = min(cfg_stride, n_timesteps) if n_rows > 1 else 1
    n_grouped = (n_timesteps // stride) * stride
    cache = {}

    def score(xt, t: float, i: int):
        if stride > 1 and i < n_grouped and i % stride:
            s = model(xt, mask, cond, torch.full((b,), t, device=xt.device), spk_emb)
            return s + cache["delta_eps"] / std_of(i)
        xt_c = torch.cat([xt] * n_rows) if n_rows > 1 else xt
        s_all = model(xt_c, mask_c, cond_c, torch.full((xt_c.shape[0],), t, device=xt.device),
                      spk_c)
        guided = combine(s_all)
        if stride > 1:
            cache["delta_eps"] = (guided - s_all[-b:]) * std_of(i)
        return guided

    return score


@torch.no_grad()
def reverse_diffusion(model: UnitSpeech, z, mask, cond, spk_emb, n_timesteps: int = 50,
                      text_gradient_scale: float = 0.0, spk_gradient_scale: float = 0.0,
                      generator: torch.Generator | None = None, noises=None,
                      cfg_stride: int = 1):
    """Reverse DDPM sampling (reference unitspeech.py:333-374). z/cond
    (B, T, F); mask (B, T); spk_emb (B, S). `noises` (n_timesteps, B, T, F)
    replaces the per-step draws (also with cfg_stride > 1, which the JAX
    package refuses: a test hook for its fold_in draws). cfg_stride > 1:
    CFG delta caching (_guided_score); stride 1 is the reference's algebra.
    Returns mel (B, T, F) f32."""
    sched = make_reverse_schedule(n_timesteps, model.beta_min, model.beta_max)
    stds = forward_diffusion_coefficients(torch.from_numpy(sched.t_cont), model.beta_min,
                                          model.beta_max)[1].tolist()
    mask3 = mask[:, :, None]
    xt = z * mask3
    score_fn = _guided_score(model, mask, cond, spk_emb, text_gradient_scale,
                             spk_gradient_scale, n_timesteps, cfg_stride, stds.__getitem__)
    for i in range(n_timesteps):
        if noises is None:
            noise = torch.randn(xt.shape, generator=generator, device=xt.device)
        else:
            noise = noises[i]
        score = score_fn(xt, float(sched.t_cont[i]), i)
        xt = (float(sched.c_x[i]) * xt + float(sched.c_score[i]) * score
              + float(sched.c_noise[i]) * noise) * mask3
    return xt * mask3


@torch.no_grad()
def reverse_diffusion_ode(model: UnitSpeech, z, mask, cond, spk_emb, n_timesteps: int = 25,
                          text_gradient_scale: float = 0.0, spk_gradient_scale: float = 0.0,
                          t_end: float = 0.01, cfg_stride: int = 1):
    """Deterministic probability-flow sampling with DPM-Solver++(2M)
    (ops/schedule.make_ode_schedule; the JAX package's `dpm2` sampler, which
    the reference does not have): x0 = (x + sigma^2 * score) / alpha, then
    x <- a * x + b * (c1 * x0 + c2 * x0_prev). cfg_stride as in
    reverse_diffusion, with std_t = sqrt(sigma^2); the 2M history x0_prev
    runs through full and cheap steps alike. Returns mel (B, T, F) f32."""
    co = make_ode_schedule(n_timesteps, model.beta_min, model.beta_max,
                           t_end=float(t_end)).stacked()
    stds = torch.sqrt(torch.from_numpy(co[:, 6])).tolist()
    mask3 = mask[:, :, None]
    xt = z * mask3
    x0_prev = torch.zeros_like(xt)  # the first step's c2 is 0
    score_fn = _guided_score(model, mask, cond, spk_emb, text_gradient_scale,
                             spk_gradient_scale, n_timesteps, cfg_stride, stds.__getitem__)
    for i in range(n_timesteps):
        t_eval, a, b, c1, c2, inv_alpha, sigma2 = (float(v) for v in co[i])
        x0 = (xt + sigma2 * score_fn(xt, t_eval, i)) * inv_alpha
        xt = (a * xt + b * (c1 * x0 + c2 * x0_prev)) * mask3
        x0_prev = x0
    return xt * mask3


def sample(model: UnitSpeech, sampler: str, z, mask, cond, spk_emb, n_timesteps: int,
           text_gradient_scale: float = 0.0, spk_gradient_scale: float = 0.0,
           generator: torch.Generator | None = None, noises=None):
    """The sampler a spec names (parse_sampler_spec), the one dispatch
    point of the TTS and voice-conversion paths: "ddpm[:cs<k>]" is
    reverse_diffusion, "dpm2[:cs<k>]" reverse_diffusion_ode (deterministic:
    it draws nothing and ignores noises)."""
    name, stride = parse_sampler_spec(sampler)
    if name == "dpm2":
        return reverse_diffusion_ode(model, z, mask, cond, spk_emb, n_timesteps,
                                     text_gradient_scale, spk_gradient_scale, cfg_stride=stride)
    return reverse_diffusion(model, z, mask, cond, spk_emb, n_timesteps, text_gradient_scale,
                             spk_gradient_scale, generator=generator, noises=noises,
                             cfg_stride=stride)


def forward_diffusion(x0, mask, t, z, beta_min: float = 0.05, beta_max: float = 20.0):
    """q(x_t | x_0) sample from the standard-normal draw z (reference
    unitspeech.py:376-384). x0, z: (B, T, F); mask: (B, T); t: (B,).
    Returns (xt, z), both masked."""
    mean_coef, std = forward_diffusion_coefficients(t[:, None, None], beta_min, beta_max)
    mask3 = mask[:, :, None]
    return (x0 * mean_coef + z * std) * mask3, z * mask3


def diffusion_loss_t(model: UnitSpeech, x0, mask, cond, t, spk_emb, z,
                     beta_min: float = 0.05, beta_max: float = 20.0):
    """Weighted score-matching MSE at the given t (reference loss_t,
    unitspeech.py:393-405). Returns (loss, xt)."""
    n_feats = x0.shape[-1]
    mask3 = mask[:, :, None]
    xt, z = forward_diffusion(x0, mask, t, z, beta_min, beta_max)
    _, std = forward_diffusion_coefficients(t[:, None, None], beta_min, beta_max)
    noise_estimation = model(xt, mask, cond * mask3, t, spk_emb) * std
    loss = torch.sum((noise_estimation + z) ** 2) / (torch.sum(mask) * n_feats)
    return loss, xt


def diffusion_loss(model: UnitSpeech, x0, mask, cond, spk_emb, generator=None, draws=None,
                   beta_min: float = 0.05, beta_max: float = 20.0, offset: float = 1e-5):
    """Random-t diffusion loss (reference compute_loss, unitspeech.py:407-411):
    t uniform, clipped to [offset, 1 - offset], then z standard normal, both
    from `generator` on x0's device. draws: {"t": (B,), "z": x0's shape}
    in place of them."""
    if draws is None:
        t = torch.rand((x0.shape[0],), generator=generator, device=x0.device)
        z = torch.randn(x0.shape, generator=generator, device=x0.device)
    else:
        t, z = draws["t"], draws["z"]
    t = torch.clamp(t, offset, 1.0 - offset)
    return diffusion_loss_t(model, x0, mask, cond, t, spk_emb, z, beta_min, beta_max)


def random_segment_crop(y, attn, y_lengths, segment_size: int, u):
    """Fixed-size time crop of (mel, alignment) at a random offset
    (reference unitspeech.py:452-481): offset = floor(u * (max_offset + 1))
    capped at max_offset = max(len - segment, 0), for u uniform in [0, 1);
    utterances shorter than the segment are zero-padded.

    y: (B, Ty, F); attn: (B, Tx, Ty); y_lengths: (B,) int; u: (B,).
    Returns (y_cut (B, seg, F), attn_cut (B, Tx, seg), y_cut_mask (B, seg))."""
    b, t_y, n_feats = y.shape
    if t_y < segment_size:
        pad = segment_size - t_y
        y = torch.nn.functional.pad(y, (0, 0, 0, pad))
        attn = torch.nn.functional.pad(attn, (0, pad))
    max_offset = torch.clamp(y_lengths.to(torch.int64) - segment_size, min=0)
    offset = (u * (max_offset + 1).to(torch.float32)).to(torch.int64)
    offset = torch.minimum(offset, max_offset)
    idx = offset[:, None] + torch.arange(segment_size, device=y.device)  # (B, seg)
    y_cut = torch.gather(y, 1, idx[:, :, None].expand(b, segment_size, n_feats))
    attn_cut = torch.gather(attn, 2, idx[:, None, :].expand(b, attn.shape[1], segment_size))
    y_cut_mask = sequence_mask(torch.clamp(y_lengths, max=segment_size), segment_size,
                               dtype=y.dtype)
    return y_cut * y_cut_mask[:, :, None], attn_cut * y_cut_mask[:, None, :], y_cut_mask


def fine_tune_loss(model: UnitSpeech, cond_x, y, y_lengths, attn, spk_emb, segment_size: int,
                   generator=None, draws=None, beta_min: float = 0.05, beta_max: float = 20.0):
    """Speaker-adaptation loss on a random segment (reference fine_tune,
    unitspeech.py:452-492). cond_x: (B, Tx, F) frozen unit-encoder output;
    y: (B, Ty, F) normalized mel; attn: (B, Tx, Ty). The draws, in order:
    the crop's u (B,), then diffusion_loss's t and z, from `generator`;
    draws: {"u", "t", "z"} in place of them."""
    if draws is None:
        u = torch.rand((y.shape[0],), generator=generator, device=y.device)
    else:
        u = draws["u"]
    y_cut, attn_cut, y_cut_mask = random_segment_crop(y, attn, y_lengths, segment_size, u)
    cond_y = torch.einsum("bxy,bxf->byf", attn_cut, cond_x) * y_cut_mask[:, :, None]
    loss, _ = diffusion_loss(model, y_cut, y_cut_mask, cond_y, spk_emb, generator, draws,
                             beta_min, beta_max)
    return loss
