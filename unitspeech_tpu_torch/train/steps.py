"""Training losses and the STEP1 and STEP2 train steps of the port
(counterpart of unitspeech_tpu/train/steps.py).

STEP1 (reference train_STEP1.py:307-387): text
encoder + duration predictor + diffusion decoder, the alignment by
monotonic alignment search (ops/mas.py, kernel M1 on the card, so the step
never waits on the host), the duration, prior and diffusion losses, the
speaker embedding replaced by the unconditional one in exactly
floor(B * 0.25) rows, and per-module gradient clipping (5 / 5 / 2).

STEP2 (reference train_STEP2.py:124-157): the unit encoder alone trains,
against a frozen decoder. The alignment is the units' own durations
(generate_path); the loss is the prior loss plus the diffusion loss, whose
gradient reaches the unit encoder only through the decoder's conditioning
on mu_y, so the decoder runs under autograd with its parameters frozen
(requires_grad False, outside the optimizer), as JAX's stop_gradient of
the decoder's parameters freezes them. One global clip of 5.

The JAX package jits the step over a mesh; here it is one eager step under
autograd on each rank. Every draw (the replaced rows, the dropout masks,
the crop's u, the diffusion t and z) comes from an explicit
torch.Generator, or is injected (`draws`) so that a step can be compared
with the JAX package's, whose PRNG streams torch cannot reproduce.

Data parallelism (`shard`, a parallel.DataShard: the batch holds the
rank's rows of the global batch) gives JAX's global-batch step whatever
the world size. Each loss divides a sum by a sum of lengths or mask
frames over the whole batch, so the ranks all-reduce those normalizers
before dividing (averaging per-rank ratios, as a DDP gradient mean does,
is another gradient when the shards' lengths differ); each rank's losses
are then its share of the global losses, and the gradients and the
metrics are summed over the ranks. Clipping runs on the summed gradients.
Every draw is made for the global batch from the same seeded generator on
every rank, which keeps its rows, and injected draws are the global
batch's.

Tensor parallelism (modules sharded by parallel/tp.py shard_params_tp,
each sharded parameter carrying its model axis's ModelShard in `tp`)
composes with it on a (data, 1, model) mesh, `shard` then the mesh's data
axis: the ranks of one data index hold the same rows and draw the same
masks, t, z and u, so every model rank computes the same values downstream
of each gather (whose backward takes the rank's columns of the gradient).
The data-axis sums run within the rank's model index; the replicated
parameters' gradients, which every model rank computes alone (and a
nondeterministic kernel, an embedding's backward, may round apart), are
then the model axis's first rank's, so the replicas stay equal; each clip
norm counts a sharded parameter's squares summed over the model axis and a
replicated one's once.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from unitspeech_tpu_torch.models.diffusion import diffusion_loss, random_segment_crop
from unitspeech_tpu_torch.models.layers import Dropout
from unitspeech_tpu_torch.ops.mas import maximum_path
from unitspeech_tpu_torch.ops.masking import generate_path, sequence_mask
from unitspeech_tpu_torch.parallel.mesh import SINGLE
from unitspeech_tpu_torch.parallel.tp import is_sharded


def _sum_squares(grads):
    return sum(torch.sum(g.to(torch.float32) ** 2) for g in grads)


def _scale_to(grads, gnorm, max_norm: float) -> torch.Tensor:
    scale = torch.clamp(max_norm / (gnorm + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return gnorm


def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place so that their global norm is at most
    max_norm: one norm over every tensor (None entries skipped), scale =
    min(1, max_norm / (norm + 1e-6)). Returns the norm before clipping, a
    device scalar (no host sync)."""
    grads = [g for g in grads if g is not None]
    return _scale_to(grads, torch.sqrt(_sum_squares(grads)), max_norm)


def clip_params_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """clip_by_global_norm of the parameters' gradients. A parameter that
    parallel/tp.py shard_params_tp sharded holds its rank's columns (p.tp
    its model axis): the norm sums its squares over the axis and counts a
    replicated parameter's once, the unsharded program's norm."""
    params = [p for p in params if p.grad is not None]
    model = next((p.tp for p in params if is_sharded(p)), None)
    if model is None:
        return clip_by_global_norm([p.grad for p in params], max_norm)
    sq = _sum_squares(p.grad for p in params if not is_sharded(p)) + model.all_sum(
        _sum_squares(p.grad for p in params if is_sharded(p)))
    return _scale_to([p.grad for p in params], torch.sqrt(sq), max_norm)


def random_replace_rows(x, replacement, rate: float, generator=None, perm=None, shard=None):
    """Replace exactly floor(B * rate) random rows of x (B, ...) with
    `replacement` (x's trailing shape): the rows perm[:n] of a random
    permutation of the batch (drawn from `generator` on x's device, or
    `perm` injected). Exact-count semantics of the reference's
    random_replace_tensor (util.py:224-231). With `shard`, x is the rank's
    rows and B, the permutation and the replaced rows the global batch's."""
    shard = shard or SINGLE
    b = shard.global_rows(x.shape[0])
    n = int(b * rate)
    if n == 0:
        return x
    if perm is None:
        perm = torch.randperm(b, generator=generator, device=x.device)
    replace = torch.zeros((b,), dtype=torch.bool, device=x.device)
    replace[perm[:n].to(x.device)] = True
    replace = shard.take(replace)
    rep = replacement.to(x.dtype).expand(x.shape)
    return torch.where(replace.reshape((x.shape[0],) + (1,) * (x.dim() - 1)), rep, x)


def gaussian_log_prior(mu_x, y):
    """log N(y_frame; mu_token, I) for every (token, frame) pair (reference
    train_STEP1.py:336-342). mu_x: (B, Tx, F); y: (B, Ty, F) -> (B, Tx, Ty)."""
    n_feats = mu_x.shape[-1]
    const = -0.5 * math.log(2 * math.pi) * n_feats
    y_sq = -0.5 * torch.sum(y ** 2, dim=-1)[:, None, :]
    cross = torch.einsum("bxf,byf->bxy", mu_x, y)
    mu_sq = -0.5 * torch.sum(mu_x ** 2, dim=-1)[:, :, None]
    return y_sq + cross + mu_sq + const


def duration_loss(logw, logw_, lengths, norm=None):
    """Reference util.py:105-107; norm: the normalizer, sum(lengths) of this
    batch unless given (a data-parallel step gives the global batch's)."""
    if norm is None:
        norm = torch.sum(lengths).to(logw.dtype)
    return torch.sum((logw - logw_) ** 2) / norm


def prior_loss_fn(y, mu_y, y_mask, n_feats: int, norm=None):
    """Reference train_STEP1.py:384-385; norm as duration_loss's, by default
    sum(y_mask) * n_feats of this batch."""
    mask3 = y_mask[:, :, None]
    loss = torch.sum(0.5 * ((y - mu_y) ** 2 + math.log(2 * math.pi)) * mask3)
    if norm is None:
        norm = torch.sum(mask3) * n_feats
    return loss / norm


def global_norms(shard, lengths, y_mask, n_feats: int):
    """The normalizers of a data-parallel step's losses, summed over the
    ranks: (sum of the token lengths, sum of the mask frames x n_feats) of
    the global batch, in one all-reduce; (None, None), each loss's own
    batch, without a process group."""
    if shard is None or shard.group is None:
        return None, None
    tot = shard.all_sum(torch.stack([torch.sum(lengths).to(torch.float32),
                                     torch.sum(y_mask).to(torch.float32)]))
    return tot[0], tot[1] * n_feats


def _crop_u(y, d, generator, shard):
    """The crop's u: injected (the global batch's) or drawn, the rank's rows."""
    shard = shard or SINGLE
    u = d.get("u")
    return shard.rand((y.shape[0],), generator, y.device) if u is None else shard.take(u)


def _reduced_metrics(parts: dict, total, shard) -> dict:
    """The losses as metrics: detached, summed over the ranks in one
    all-reduce when there is a process group (each rank's are its share)."""
    vals = {**parts, "total_loss": total}
    if shard is None or shard.group is None:
        return {k: v.detach() for k, v in vals.items()}
    summed = shard.all_sum(torch.stack([v.detach().float() for v in vals.values()]))
    return dict(zip(vals, summed.unbind()))


def step1_loss(text_encoder, duration_predictor, decoder, batch: dict, out_size: Optional[int],
               spk_uncond=None, spk_dropout: float = 0.25, beta_min: float = 0.05,
               beta_max: float = 20.0, generator=None, draws: Optional[dict] = None,
               shard=None):
    """The joint STEP1 loss. batch: tokens (B, Tx) int, token_lengths (B,),
    mel (B, Ty, F) normalized to [-1, 1], mel_lengths (B,), spk_emb (B, S),
    on the modules' device. The draws, in JAX's key order, from `generator`:
    the replaced rows' permutation, the text encoder's dropout masks, the
    duration predictor's, the crop's u (only when out_size < Ty), then the
    diffusion t and z; draws: {"perm", "te", "dp", "u", "t", "z"} in place
    of them ("te" / "dp": mask lists in call order). Returns (total,
    {dur_loss, prior_loss, diff_loss}, the alignment (B, Tx, Ty) before
    the crop). With `shard` the batch is the rank's rows: the draws are the
    global batch's (drawn or injected) and the losses the rank's share of
    the global ones (global_norms)."""
    d = draws or {}
    tokens, token_lengths = batch["tokens"], batch["token_lengths"]
    y, y_lengths, spk_emb = batch["mel"], batch["mel_lengths"], batch["spk_emb"]
    n_feats = y.shape[-1]

    if spk_uncond is not None and spk_dropout > 0:
        spk_emb = random_replace_rows(spk_emb, spk_uncond, spk_dropout, generator,
                                      d.get("perm"), shard)
    mu_x, hidden, x_mask = text_encoder(tokens, token_lengths,
                                        dropout=Dropout(generator, d.get("te"), shard))
    logw = duration_predictor(hidden, x_mask, spk_emb,
                              dropout=Dropout(generator, d.get("dp"), shard))

    t_y = y.shape[1]
    y_mask = sequence_mask(y_lengths, t_y, dtype=x_mask.dtype)
    attn_mask = x_mask * y_mask[:, None, :]  # (B, Tx, Ty)
    with torch.no_grad():
        attn = maximum_path(gaussian_log_prior(mu_x, y), attn_mask)

    logw_ = torch.log(1e-8 + attn.sum(dim=-1)) * x_mask[..., 0]

    attn_full = attn
    if out_size is not None and out_size < t_y:
        y, attn, y_mask = random_segment_crop(y, attn, y_lengths, out_size,
                                              _crop_u(y, d, generator, shard))
    dur_norm, mel_norm = global_norms(shard, token_lengths, y_mask, n_feats)
    dur_loss = duration_loss(logw, logw_, token_lengths, dur_norm)

    mu_y = torch.einsum("bxy,bxf->byf", attn, mu_x)
    diff_loss, _ = diffusion_loss(decoder, y, y_mask, mu_y, spk_emb, generator,
                                  {"t": d["t"], "z": d["z"]} if "t" in d else None,
                                  beta_min, beta_max, shard=shard, norm=mel_norm)
    prior_loss = prior_loss_fn(y, mu_y, y_mask, n_feats, mel_norm)
    total = dur_loss + prior_loss + diff_loss
    return total, {"dur_loss": dur_loss, "prior_loss": prior_loss,
                   "diff_loss": diff_loss}, attn_full


def make_step1_train_step(text_encoder, duration_predictor, decoder, optimizer,
                          out_size: Optional[int], spk_uncond=None, spk_dropout: float = 0.25,
                          clip_norms: Sequence[float] = (5.0, 5.0, 2.0), beta_min: float = 0.05,
                          beta_max: float = 20.0, shard=None) -> Callable:
    """Returns step(batch, generator=None, draws=None) -> metrics: step1_loss
    -> backward -> each module's gradients clipped to its global norm
    (clip_norms: encoder, duration, decoder) -> optimizer.step(). The
    optimizer holds every parameter of the three modules:
    torch.optim.Adam(lr, betas (0.9, 0.999), eps 1e-8) is optax's adam
    (m_hat / (sqrt(v_hat) + eps)); a parameter the loss never reaches (the
    decoder's unconditional embeddings) gets no gradient and does not
    move, as under optax with its zero gradient. Metrics: the three
    losses, total_loss and the three pre-clip gradient norms, 0-d tensors
    on the device (nothing syncs the host). With `shard` (data
    parallelism) the step takes the rank's rows: the gradients are summed
    over the ranks before the clipping, and the metrics are the global
    batch's. Modules that parallel/tp.py shard_params_tp sharded run the
    tensor-parallel step (the module docstring; shard is then the mesh's
    data axis): the model axis is the sharded parameters' own."""
    groups = [[p for p in m.parameters() if p.requires_grad]
              for m in (text_encoder, duration_predictor, decoder)]
    model = next((p.tp for ps in groups for p in ps if is_sharded(p)), None)
    replicated = [p for ps in groups for p in ps if not is_sharded(p)]

    def train_step(batch, generator=None, draws=None):
        optimizer.zero_grad(set_to_none=True)
        total, parts, _ = step1_loss(text_encoder, duration_predictor, decoder, batch, out_size,
                                     spk_uncond, spk_dropout, beta_min, beta_max, generator,
                                     draws, shard)
        total.backward()
        if shard is not None:
            shard.all_sum_([p.grad for ps in groups for p in ps if p.grad is not None])
        if model is not None:
            model.broadcast_([p.grad for p in replicated if p.grad is not None])
        norms = [clip_params_by_global_norm(ps, c) for ps, c in zip(groups, clip_norms)]
        optimizer.step()
        return {**_reduced_metrics(parts, total, shard), "grad_norm_encoder": norms[0],
                "grad_norm_duration": norms[1], "grad_norm_decoder": norms[2]}

    return train_step


STEP2_CLIP = 5.0  # the unit encoder's one global norm


def step2_loss(unit_encoder, decoder, batch: dict, out_size: Optional[int],
               beta_min: float = 0.05, beta_max: float = 20.0, generator=None,
               draws: Optional[dict] = None, shard=None):
    """The STEP2 loss. batch: units (B, Tx) int, unit_lengths (B,),
    durations (B, Tx) f32 (frames a unit), mel (B, Ty, F) normalized,
    mel_lengths (B,), spk_emb (B, S), on the modules' device. The draws,
    in JAX's key order, from `generator`: the unit encoder's dropout masks,
    the crop's u (only when out_size < Ty), then the diffusion t and z;
    draws: {"ue", "u", "t", "z"} in place of them ("ue": the mask list in
    call order). Returns (total, {prior_loss, diff_loss}). `shard`: as
    step1_loss's."""
    d = draws or {}
    y, y_lengths = batch["mel"], batch["mel_lengths"]
    n_feats = y.shape[-1]
    cond_x, _, x_mask = unit_encoder(batch["units"], batch["unit_lengths"],
                                     dropout=Dropout(generator, d.get("ue"), shard))
    t_y = y.shape[1]
    y_mask = sequence_mask(y_lengths, t_y, dtype=x_mask.dtype)
    attn = generate_path(batch["durations"], x_mask * y_mask[:, None, :])
    if out_size is not None and out_size < t_y:
        y, attn, y_mask = random_segment_crop(y, attn, y_lengths, out_size,
                                              _crop_u(y, d, generator, shard))
    _, mel_norm = global_norms(shard, batch["unit_lengths"], y_mask, n_feats)
    mu_y = torch.einsum("bxy,bxf->byf", attn, cond_x)
    diff_loss, _ = diffusion_loss(decoder, y, y_mask, mu_y, batch["spk_emb"], generator,
                                  {"t": d["t"], "z": d["z"]} if "t" in d else None,
                                  beta_min, beta_max, shard=shard, norm=mel_norm)
    prior_loss = prior_loss_fn(y, mu_y, y_mask, n_feats, mel_norm)
    return prior_loss + diff_loss, {"prior_loss": prior_loss, "diff_loss": diff_loss}


def make_step2_train_step(unit_encoder, decoder, optimizer, out_size: Optional[int],
                          beta_min: float = 0.05, beta_max: float = 20.0,
                          shard=None) -> Callable:
    """Returns step(batch, generator=None, draws=None) -> metrics: step2_loss
    -> backward -> the unit encoder's gradients clipped to one global norm
    of STEP2_CLIP -> optimizer.step(). The decoder is frozen here: its
    parameters stop requiring gradients (the optimizer must hold only the
    unit encoder's), while its forward stays under autograd, so that the
    diffusion loss reaches the unit encoder through mu_y. Metrics: prior_loss,
    diff_loss, total_loss and the pre-clip grad_norm, 0-d tensors on the
    device. `shard`: as make_step1_train_step's."""
    decoder.requires_grad_(False)
    params = [p for p in unit_encoder.parameters() if p.requires_grad]

    def train_step(batch, generator=None, draws=None):
        optimizer.zero_grad(set_to_none=True)
        total, parts = step2_loss(unit_encoder, decoder, batch, out_size, beta_min, beta_max,
                                  generator, draws, shard)
        total.backward()
        if shard is not None:
            shard.all_sum_([p.grad for p in params if p.grad is not None])
        gnorm = clip_by_global_norm([p.grad for p in params], STEP2_CLIP)
        optimizer.step()
        return {**_reduced_metrics(parts, total, shard), "grad_norm": gnorm}

    return train_step
