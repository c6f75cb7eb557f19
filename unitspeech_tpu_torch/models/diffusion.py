"""Score-based diffusion decoder (counterpart of
unitspeech_tpu/models/diffusion.py; reference unitspeech.py:220-492).

Dual classifier-free guidance runs as ONE 3-row estimator call per step
(rows: text-unconditional, speaker-unconditional, conditional), combined
with the reference's algebra. Where the JAX package runs the reverse
loop as one compiled `lax.scan`, a step here (`sampler_step`) reads every
per-step number from device tables at a device step counter, so that the
same step runs eagerly in a Python loop or, on the card, as one CUDA graph
replay a step (infer/graphs.py). Two samplers, named by a spec
(`parse_sampler_spec`, dispatched by `sample`): the reference's stochastic DDPM and the JAX package's
DPM-Solver++(2M) `dpm2`, each with an optional guidance stride `:cs<k>`
(CFG delta caching: the 3-row call on every k-th step, 1-row calls
between). The training losses (forward diffusion, the score-matching
loss, the fine-tune's random segment crop) run under autograd.

Randomness comes from an explicit torch.Generator, or is injected
(`noise_z` / `noises` for the sampler, `draws` for the losses) so a run
can be compared with the JAX package, whose PRNG streams torch cannot
reproduce.

The samplers take JAX's `mesh` and `sample_spec`: a spec putting 'data' on
the batch axis splits the rows over the ranks of the mesh's data axis
(parallel/mesh.py), 'seq' on the frame axis splits the frames over the
ranks of its seq axis (slices of whole 8-frame pieces; the estimator runs
every site's sharded form on them, models/unet.py), or both, as JAX's
P("data", "seq", None); each rank draws the global sample's noise and
keeps its rows and frames, and the result is gathered on every rank.
'model' in a spec raises ValueError: the axis shards the decoder's
parameters (parallel.shard_params_tp), with which every sampler runs the
tensor-parallel estimator, on any mesh or none; every model rank draws the
same noise.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from unitspeech_tpu_torch.models.unet import GradLogPEstimator2d
from unitspeech_tpu_torch.ops.masking import sequence_mask
from unitspeech_tpu_torch.ops.schedule import (
    forward_diffusion_coefficients,
    make_ode_schedule,
    make_reverse_schedule,
)
from unitspeech_tpu_torch.parallel.mesh import SINGLE, sample_shard


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

    def forward(self, xt, mask, cond, t, spk_emb, seq=None):
        """seq: a parallel.FrameSlice (xt, mask and cond hold its frames)."""
        return self.estimator(xt, mask, cond, t, spk_emb, seq=seq)

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


def step_kinds(n_timesteps: int, cfg_stride: int, n_rows: int) -> list:
    """Each step's kind, in order: "full" (the n_rows-row guidance call) or
    "cheap". With cfg_stride k > 1 and guidance on (CFG delta caching, the
    JAX package's `_reverse_diffusion_strided`) the steps run in groups of k
    (k clamped to n_timesteps): a group's first step is full and caches its
    delta in eps space, delta * std_t; the group's other steps are cheap:
    the estimator on the conditional rows alone (B rows, not 3B), the
    cached delta added back as delta / std_t. The trailing n % k steps run
    full."""
    stride = min(cfg_stride, n_timesteps) if n_rows > 1 else 1
    n_grouped = (n_timesteps // stride) * stride
    return ["cheap" if stride > 1 and i < n_grouped and i % stride else "full"
            for i in range(n_timesteps)]


def sampler_tables(name: str, n_timesteps: int, beta_min: float, beta_max: float,
                   t_end: float = 0.01) -> torch.Tensor:
    """Sampler `name`'s per-step coefficients as one (n, K) float32 table on
    the host, which a step reads at the device step counter: DDPM (t, c_x,
    c_score, c_noise, std_t) of ops/schedule.make_reverse_schedule; dpm2
    (t_eval, a, b, c1, c2, inv_alpha, sigma2, std_t) of make_ode_schedule.
    std_t is the guidance stride's (sqrt(sigma2) for dpm2)."""
    if name == "ddpm":
        s = make_reverse_schedule(n_timesteps, beta_min, beta_max)
        cols = [torch.from_numpy(c) for c in (s.t_cont, s.c_x, s.c_score, s.c_noise)]
        std = forward_diffusion_coefficients(cols[0], beta_min, beta_max)[1]
        return torch.stack(cols + [std], dim=1)
    co = torch.from_numpy(make_ode_schedule(n_timesteps, beta_min, beta_max,
                                            t_end=float(t_end)).stacked())
    return torch.cat([co, torch.sqrt(co[:, 6:7])], dim=1)


@dataclass
class SamplerState:
    """What a sampler step reads and writes, all of it tensors on the
    sample's device, so that the step runs eagerly and inside a CUDA graph
    alike (infer/graphs.py: a graph's replays read the addresses its
    capture saw). xt (B, T, F) f32 is the sample; mask (B, T), cond
    (B, T, F), spk (B, S) and the guidance rows cond_c, spk_c, mask_c of
    build_cfg_rows are the request's; tables (n, K) is sampler_tables';
    step (1,) int64 the device step counter, which each step increments;
    noises (n, B, T, F) DDPM's draws of the request (None for dpm2, or where
    each step draws its own); delta (B, T, F) the cached guidance delta of
    a stride > 1 (else None); x0_prev (B, T, F) dpm2's history (else None).
    n_rows, combine and scales (text, speaker) are the guidance's."""

    xt: torch.Tensor
    mask: torch.Tensor
    cond: torch.Tensor
    spk: torch.Tensor
    cond_c: torch.Tensor
    spk_c: torch.Tensor
    mask_c: torch.Tensor
    tables: torch.Tensor
    step: torch.Tensor
    n_rows: int
    combine: Callable
    scales: tuple
    noises: Optional[torch.Tensor] = None
    delta: Optional[torch.Tensor] = None
    x0_prev: Optional[torch.Tensor] = None

    TENSORS = ("xt", "mask", "cond", "spk", "cond_c", "spk_c", "mask_c", "tables", "step",
               "noises", "delta", "x0_prev")

    @classmethod
    def start(cls, model: UnitSpeech, name: str, z, mask, cond, spk_emb, n_timesteps: int,
              text_gradient_scale: float, spk_gradient_scale: float, cfg_stride: int,
              t_end: float = 0.01, noises=None) -> "SamplerState":
        """A request's state before its first step: xt = z * mask, the
        guidance rows, the tables on z's device, the counter at 0; noises
        (n, B, T, F) as given."""
        cond_c, spk_c, mask_c, n_rows, combine = build_cfg_rows(
            model, mask, cond, spk_emb, text_gradient_scale, spk_gradient_scale)
        xt = z * mask[:, :, None]
        cached = "cheap" in step_kinds(n_timesteps, cfg_stride, n_rows)
        return cls(xt=xt, mask=mask, cond=cond, spk=spk_emb, cond_c=cond_c, spk_c=spk_c,
                   mask_c=mask_c,
                   tables=sampler_tables(name, n_timesteps, model.beta_min, model.beta_max,
                                         t_end).to(xt.device),
                   step=torch.zeros(1, dtype=torch.int64, device=xt.device), n_rows=n_rows,
                   combine=combine,
                   scales=(float(text_gradient_scale), float(spk_gradient_scale)),
                   noises=noises, delta=torch.zeros_like(xt) if cached else None,
                   x0_prev=torch.zeros_like(xt) if name == "dpm2" else None)

    def like(self, steps: int) -> "SamplerState":
        """Buffers of this state's shapes, the tables and noises for up to
        `steps` steps: a CUDA graph's static state (load copies into it)."""
        def empty(name):
            t = getattr(self, name)
            if t is None:
                return None
            return t.new_empty((steps,) + t.shape[1:]) if name in ("tables", "noises") \
                else torch.empty_like(t)

        return dataclasses.replace(self, **{k: empty(k) for k in self.TENSORS})

    def load(self, other: "SamplerState") -> None:
        """Copy `other`'s tensors into this state's (its first rows of the
        tables and noises)."""
        for k in self.TENSORS:
            src, dst = getattr(other, k), getattr(self, k)
            if src is not None:
                (dst[:src.shape[0]] if k in ("tables", "noises") else dst).copy_(src)


def sampler_step(model: UnitSpeech, name: str, st: SamplerState, kind: str, noise=None,
                 seq=None) -> None:
    """One step of sampler `name` ("ddpm" / "dpm2") of kind `kind`
    (step_kinds') on st, in place, at the step that st.step holds, which it
    then increments. Every number it reads lies on the device, so a CUDA
    graph of it replays every step of a request. noise: this step's DDPM
    draw where the caller draws each step (the seq-sharded sampler), else
    st.noises' row. seq: the estimator's frame slice (the rows are this
    rank's frames). The estimator returns f32 on every route, so the
    combine and the cached delta are f32, as the sample is."""
    row = st.tables.index_select(0, st.step)[0]
    std = row[-1]
    b = st.xt.shape[0]
    sliced = {} if seq is None else {"seq": seq}  # a model called unsharded as before
    if kind == "cheap":
        s = model(st.xt, st.mask, st.cond, row[0].repeat(b), st.spk, **sliced)
        score = s + st.delta / std
    else:
        xt_c = torch.cat([st.xt] * st.n_rows) if st.n_rows > 1 else st.xt
        s_all = model(xt_c, st.mask_c, st.cond_c, row[0].repeat(xt_c.shape[0]), st.spk_c,
                      **sliced)
        score = st.combine(s_all)
        if st.delta is not None:
            st.delta.copy_((score - s_all[-b:]) * std)
    mask3 = st.mask[:, :, None]
    if name == "ddpm":
        if noise is None:
            noise = st.noises.index_select(0, st.step)[0]
        xt = (row[1] * st.xt + row[2] * score + row[3] * noise) * mask3
    else:
        x0 = (st.xt + row[6] * score) * row[5]
        xt = (row[1] * st.xt + row[2] * (row[3] * x0 + row[4] * st.x0_prev)) * mask3
        st.x0_prev.copy_(x0)
    st.xt.copy_(xt)
    st.step.add_(1)


def seq_sharded(run, seq_shard, z, mask, cond, spk_emb, noises=None):
    """run(z, mask, cond, spk_emb, noises, seq) on this rank's frames of the
    sample when seq_shard (a parallel.SeqShard) splits them, seq their
    FrameSlice, the result gathered along frames on every rank; else run on
    every frame with seq None. noises: (steps, B, T, F) or None."""
    if seq_shard is None:
        return run(z, mask, cond, spk_emb, noises, None)
    seq = seq_shard.at(z.shape[1])
    out = run(seq.take(z), seq.take(mask), seq.take(cond), spk_emb,
              None if noises is None else seq.take(noises, 2), seq)
    return seq.gather(out)


def sharded(run, mesh, sample_spec, z, mask, cond, spk_emb, noises=None):
    """run(z, mask, cond, spk_emb, noises, shard, seq) on this rank's part
    of the sample the spec shards (sample_shard): its rows of the global
    batch on 'data' (shard its DataShard, else None), its frames on 'seq'
    (seq_sharded), the result gathered on every rank."""
    shard, seq_shard = sample_shard(mesh, sample_spec)
    b = z.shape[0]
    if shard is not None:
        if b % shard.size:
            raise ValueError(f"{b} rows do not divide over the data axis ({shard.size})")
        z, mask, cond, spk_emb = (shard.take(a) for a in (z, mask, cond, spk_emb))
        noises = None if noises is None else shard.take(noises, 1)
    out = seq_sharded(lambda *a: run(*a[:5], shard, a[5]), seq_shard, z, mask, cond, spk_emb,
                      noises)
    return out if shard is None else shard.gather(out, b)


def draw_noises(shape, n_timesteps: int, generator, device, shard=None) -> torch.Tensor:
    """DDPM's per-step draws of a request, up front: (n, *shape), the same
    n calls of randn(shape, generator) in the same order as a draw each
    step (shard: the global batch's rows drawn, this rank's kept), so the
    request's numbers do not depend on when they are drawn."""
    return torch.stack([(shard or SINGLE).randn(shape, generator, device)
                        for _ in range(n_timesteps)])


def run_steps(model: UnitSpeech, name: str, st: SamplerState, kinds, graphs=None, seq=None,
              draw=None):
    """Run the steps `kinds` (step_kinds') of sampler `name` on st: each one
    replay of a CUDA graph (graphs, an infer/graphs.SamplerGraphs, which
    copies st into its static state) or eagerly. draw(): a step's DDPM
    noise drawn each step (the seq-sharded sampler, eager). Returns the
    masked sample, a tensor of its own."""
    if graphs is not None:
        xt = graphs.run(model, name, st, kinds)
    else:
        for kind in kinds:
            sampler_step(model, name, st, kind, None if draw is None else draw(), seq)
        xt = st.xt
    return xt * st.mask[:, :, None]


@torch.no_grad()
def reverse_diffusion(model: UnitSpeech, z, mask, cond, spk_emb, n_timesteps: int = 50,
                      text_gradient_scale: float = 0.0, spk_gradient_scale: float = 0.0,
                      generator: torch.Generator | None = None, noises=None,
                      cfg_stride: int = 1, mesh=None, sample_spec=None, shard=None, seq=None,
                      graphs=None):
    """Reverse DDPM sampling (reference unitspeech.py:333-374). z/cond
    (B, T, F); mask (B, T); spk_emb (B, S). The per-step noise is drawn up
    front from `generator` (draw_noises), or `noises` (n_timesteps, B, T, F)
    replaces the draws (also with cfg_stride > 1, which the JAX package
    refuses: a test hook for its fold_in draws). cfg_stride > 1: CFG delta
    caching (step_kinds); stride 1 is the reference's algebra. mesh,
    sample_spec: data- and sequence-sharded sampling (sharded); shard: the
    inputs are already this rank's rows of a data-sharded batch; seq: a
    parallel.FrameSlice, the inputs are its frames (each step's noise is
    drawn for the global sample, the rank keeping its rows and frames, as
    the step runs). graphs: each step one CUDA graph replay (run_steps).
    Returns mel (B, T, F) f32."""
    if mesh is not None:
        return sharded(
            lambda *a: reverse_diffusion(model, *a[:4], n_timesteps, text_gradient_scale,
                                         spk_gradient_scale, generator, a[4], cfg_stride,
                                         shard=a[5], seq=a[6]),
            mesh, sample_spec, z, mask, cond, spk_emb, noises)
    draw = None
    if noises is None and seq is not None:
        draw = lambda: seq.randn(z.shape, generator, z.device, shard)  # noqa: E731
    elif noises is None:
        noises = draw_noises(z.shape, n_timesteps, generator, z.device, shard)
    st = SamplerState.start(model, "ddpm", z, mask, cond, spk_emb, n_timesteps,
                            text_gradient_scale, spk_gradient_scale, cfg_stride, noises=noises)
    return run_steps(model, "ddpm", st, step_kinds(n_timesteps, cfg_stride, st.n_rows), graphs,
                     seq, draw)


@torch.no_grad()
def reverse_diffusion_ode(model: UnitSpeech, z, mask, cond, spk_emb, n_timesteps: int = 25,
                          text_gradient_scale: float = 0.0, spk_gradient_scale: float = 0.0,
                          t_end: float = 0.01, cfg_stride: int = 1, mesh=None,
                          sample_spec=None, seq=None, graphs=None):
    """Deterministic probability-flow sampling with DPM-Solver++(2M)
    (ops/schedule.make_ode_schedule; the JAX package's `dpm2` sampler, which
    the reference does not have): x0 = (x + sigma^2 * score) / alpha, then
    x <- a * x + b * (c1 * x0 + c2 * x0_prev). cfg_stride as in
    reverse_diffusion, with std_t = sqrt(sigma^2); the 2M history x0_prev
    runs through full and cheap steps alike. mesh, sample_spec, seq, graphs:
    as reverse_diffusion's (it draws nothing). Returns mel (B, T, F) f32."""
    if mesh is not None:
        return sharded(
            lambda *a: reverse_diffusion_ode(model, *a[:4], n_timesteps, text_gradient_scale,
                                             spk_gradient_scale, t_end, cfg_stride, seq=a[6]),
            mesh, sample_spec, z, mask, cond, spk_emb)
    st = SamplerState.start(model, "dpm2", z, mask, cond, spk_emb, n_timesteps,
                            text_gradient_scale, spk_gradient_scale, cfg_stride, t_end)
    return run_steps(model, "dpm2", st, step_kinds(n_timesteps, cfg_stride, st.n_rows), graphs,
                     seq)


def sample(model: UnitSpeech, sampler: str, z, mask, cond, spk_emb, n_timesteps: int,
           text_gradient_scale: float = 0.0, spk_gradient_scale: float = 0.0,
           generator: torch.Generator | None = None, noises=None, shard=None,
           seq_shard=None, graphs=None):
    """The sampler a spec names (parse_sampler_spec), the one dispatch
    point of the TTS and voice-conversion paths: "ddpm[:cs<k>]" is
    reverse_diffusion, "dpm2[:cs<k>]" reverse_diffusion_ode (deterministic:
    it draws nothing and ignores noises). shard: reverse_diffusion's;
    seq_shard: a parallel.SeqShard splitting the frames (seq_sharded: the
    inputs are every frame, so is the result). graphs: the decoder's
    infer/graphs.SamplerGraphs (graphs_for decides where), each step one
    CUDA graph replay; None runs the steps eagerly."""
    name, stride = parse_sampler_spec(sampler)

    def run(z, mask, cond, spk_emb, noises, seq):
        if name == "dpm2":
            return reverse_diffusion_ode(model, z, mask, cond, spk_emb, n_timesteps,
                                         text_gradient_scale, spk_gradient_scale,
                                         cfg_stride=stride, seq=seq, graphs=graphs)
        return reverse_diffusion(model, z, mask, cond, spk_emb, n_timesteps, text_gradient_scale,
                                 spk_gradient_scale, generator=generator, noises=noises,
                                 cfg_stride=stride, shard=shard, seq=seq, graphs=graphs)

    return seq_sharded(run, seq_shard, z, mask, cond, spk_emb, noises)


def forward_diffusion(x0, mask, t, z, beta_min: float = 0.05, beta_max: float = 20.0):
    """q(x_t | x_0) sample from the standard-normal draw z (reference
    unitspeech.py:376-384). x0, z: (B, T, F); mask: (B, T); t: (B,).
    Returns (xt, z), both masked."""
    mean_coef, std = forward_diffusion_coefficients(t[:, None, None], beta_min, beta_max)
    mask3 = mask[:, :, None]
    return (x0 * mean_coef + z * std) * mask3, z * mask3


def diffusion_loss_t(model: UnitSpeech, x0, mask, cond, t, spk_emb, z,
                     beta_min: float = 0.05, beta_max: float = 20.0, norm=None):
    """Weighted score-matching MSE at the given t (reference loss_t,
    unitspeech.py:393-405): the sum over the masked frames over `norm`,
    sum(mask) * n_feats of this batch unless given (a data-parallel step
    gives the global batch's). Returns (loss, xt)."""
    n_feats = x0.shape[-1]
    mask3 = mask[:, :, None]
    xt, z = forward_diffusion(x0, mask, t, z, beta_min, beta_max)
    _, std = forward_diffusion_coefficients(t[:, None, None], beta_min, beta_max)
    noise_estimation = model(xt, mask, cond * mask3, t, spk_emb) * std
    if norm is None:
        norm = torch.sum(mask) * n_feats
    return torch.sum((noise_estimation + z) ** 2) / norm, xt


def diffusion_loss(model: UnitSpeech, x0, mask, cond, spk_emb, generator=None, draws=None,
                   beta_min: float = 0.05, beta_max: float = 20.0, offset: float = 1e-5,
                   shard=None, norm=None):
    """Random-t diffusion loss (reference compute_loss, unitspeech.py:407-411):
    t uniform, clipped to [offset, 1 - offset], then z standard normal, both
    from `generator` on x0's device. draws: {"t": (B,), "z": x0's shape}
    in place of them. With `shard` (x0 its rows of a data-parallel batch)
    t and z are the global batch's, drawn or injected, its rows kept; norm:
    diffusion_loss_t's."""
    shard = shard or SINGLE
    if draws is None:
        t = shard.rand((x0.shape[0],), generator, x0.device)
        z = shard.randn(x0.shape, generator, x0.device)
    else:
        t, z = shard.take(draws["t"]), shard.take(draws["z"])
    t = torch.clamp(t, offset, 1.0 - offset)
    return diffusion_loss_t(model, x0, mask, cond, t, spk_emb, z, beta_min, beta_max, norm)


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
