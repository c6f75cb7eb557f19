"""Speaker-adaptive fine-tuning of the diffusion decoder (counterpart of
unitspeech_tpu/train/finetune.py; reference finetune.py:34-173 calling
UnitSpeech.fine_tune, unitspeech.py:452-492): Adam over every decoder
parameter on random 2 s segments of one reference utterance, with the
unit-encoder conditioning and the alignment frozen.

The JAX package runs the loop as one jit-compiled `lax.scan`; here it is a
Python loop of optimizer steps under autograd, which keeps the per-step
losses and the clipping norm on the device so that the host never waits
for a step. The decoder trained is the plain estimator (no kernels, no
int8), as the JAX package builds its fine-tune decoder with no Pallas
flags: its activations run in `dtype` (bf16 by default) and its
parameters stay f32, cast at use, so that a step of 2e-5 is not lost to
bf16 rounding. Serve the result through the kernels by loading its state
dict into a kernel-route decoder, whose load hook packs the adapted
weights. finetune_decoder_batched adapts several speakers, one trajectory
each, and with a mesh splits them over the ranks of its data axis.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from unitspeech_tpu_torch.models.diffusion import UnitSpeech, fine_tune_loss
from unitspeech_tpu_torch.ops.masking import fix_len_compatibility, generate_path, sequence_mask
from unitspeech_tpu_torch.train.steps import clip_by_global_norm


@torch.no_grad()
def prepare_finetune_inputs(unit_encoder, units, durations, mel, num_downsamplings: int = 3,
                            pad_to: Optional[int] = None):
    """Encode the units once with the frozen unit encoder, build the duration
    alignment and pad the mel to a U-Net length (reference
    finetune.py:111-129).

    units, durations: (Tx,) int arrays at the mel frame rate; mel: (Ty, F)
    normalized, a tensor or an array. pad_to pads both the token and the
    frame axes to this bucket (a fix_len_compatibility multiple >= Ty and
    >= Tx); the encoder masks the padded tokens and the crop stays inside
    the true length. Everything lands on the unit encoder's device.
    Returns (cond_x (1, Tx', F), y (1, Ty', F), y_lengths (1,), attn
    (1, Tx', Ty'))."""
    device = next(unit_encoder.parameters()).device
    units = np.asarray(units, np.int64)[None]
    durations = np.asarray(durations, np.float32)[None]
    mel = torch.as_tensor(mel, dtype=torch.float32, device=device)
    t_x, t_y = units.shape[1], mel.shape[0]
    t_y_pad = fix_len_compatibility(t_y, num_downsamplings)
    if pad_to is not None:
        if pad_to < max(t_y_pad, t_x) or pad_to != fix_len_compatibility(pad_to,
                                                                         num_downsamplings):
            raise ValueError(f"pad_to={pad_to} must be a U-Net-compatible length >= "
                             f"(frames {t_y_pad}, tokens {t_x})")
        t_y_pad = pad_to
        units = np.pad(units, ((0, 0), (0, pad_to - t_x)))
        durations = np.pad(durations, ((0, 0), (0, pad_to - t_x)))
    y = torch.nn.functional.pad(mel, (0, 0, 0, t_y_pad - t_y))[None]
    unit_encoder.eval()
    cond_x, _, x_mask = unit_encoder(torch.from_numpy(units).to(device),
                                     torch.tensor([t_x], device=device))
    y_lengths = torch.tensor([t_y], device=device)
    y_mask = sequence_mask(y_lengths, t_y_pad)
    attn = generate_path(torch.from_numpy(durations).to(device), x_mask * y_mask[:, None, :])
    return cond_x, y, y_lengths, attn


def finetune_decoder(decoder_cfg, state_dict, cond_x, y, y_lengths, attn, spk_emb,
                     dtype=torch.bfloat16, segment_size: int = 176, n_iters: int = 500,
                     learning_rate: float = 2e-5, grad_clip: float = 1.0,
                     generator: Optional[torch.Generator] = None, draws=None,
                     step_hook: Optional[Callable[[int], None]] = None):
    """Fine-tune a decoder (DecoderConfig `decoder_cfg`, weights `state_dict`)
    on one utterance, on y's device: n_iters steps of fine_tune_loss ->
    backward -> clip_by_global_norm(grad_clip) -> Adam(learning_rate,
    betas (0.9, 0.999), eps 1e-8), optax's adam: the update is
    m_hat / (sqrt(v_hat) + eps).

    cond_x (1, Tx, F), y (1, Ty, F), y_lengths (1,), attn (1, Tx, Ty): from
    prepare_finetune_inputs; spk_emb (1, S) unit-normalized. The draws come
    from `generator`; draws: one {"u", "t", "z"} per step in place of them.
    step_hook(i), when given, is called after step i's update (measure.py
    records its timing events there). Returns (adapted f32 state dict on y's device, per-step losses
    (n_iters,) float32 numpy)."""
    with torch.device(y.device):
        model = UnitSpeech.from_config(decoder_cfg, dtype=dtype)
    model.load_state_dict({k: v.to(torch.float32) for k, v in state_dict.items()})
    model.train().requires_grad_(True)
    params = list(model.parameters())
    opt = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    losses = torch.empty(n_iters, device=y.device)
    for i in range(n_iters):
        opt.zero_grad(set_to_none=True)
        loss = fine_tune_loss(model, cond_x, y, y_lengths, attn, spk_emb, segment_size,
                              generator, None if draws is None else draws[i],
                              decoder_cfg.beta_min, decoder_cfg.beta_max)
        loss.backward()
        clip_by_global_norm([p.grad for p in params], grad_clip)
        opt.step()
        losses[i] = loss.detach()
        if step_hook is not None:
            step_hook(i)
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            losses.cpu().numpy())


def finetune_decoder_batched(decoder_cfg, stacked_state: dict, cond_x, y, y_lengths, attn,
                             spk_emb, dtype=torch.bfloat16, segment_size: int = 176,
                             n_iters: int = 500, learning_rate: float = 2e-5,
                             grad_clip: float = 1.0, generators=None, draws=None, mesh=None):
    """Adapt S speakers, one finetune_decoder trajectory each (JAX
    finetune_decoder_batched: lax.map runs the speakers one after another
    on a device). Every input carries a leading speaker axis:
    stacked_state maps each decoder parameter to (S, ...), cond_x
    (S, 1, Tx, F), y (S, 1, Ty, F), y_lengths (S, 1), attn (S, 1, Tx, Ty),
    spk_emb (S, 1, E). Speaker s draws from generators[s], or takes
    draws[s] (one {"u", "t", "z"} per step). With `mesh` (JAX's mesh form,
    speaker-per-chip) the speakers split over its 'data' axis, S / size on
    each rank (ValueError when S does not divide), each rank running its
    speakers on its own card with no collective in the loop; the adapted
    stack and the losses are gathered at the end, on every rank. Returns
    (the adapted stack, each parameter (S, ...) f32 on y's device; losses
    (S, n_iters) float32 numpy)."""
    n = y.shape[0]
    if mesh is not None:
        from unitspeech_tpu_torch.parallel.mesh import DataShard

        shard = DataShard.of(mesh)
        if n % shard.size:
            raise ValueError(f"speaker count {n} must divide by the mesh data axis "
                             f"({shard.size}) for speaker-per-chip fine-tuning")
        mine = list(range(shard.rank, n, shard.size))
        state, loss = finetune_decoder_batched(
            decoder_cfg, {k: v[mine] for k, v in stacked_state.items()}, cond_x[mine], y[mine],
            y_lengths[mine], attn[mine], spk_emb[mine], dtype, segment_size, n_iters,
            learning_rate, grad_clip, None if generators is None else [generators[i] for i in mine],
            None if draws is None else [draws[i] for i in mine])
        loss = shard.gather(torch.from_numpy(loss).to(y.device), n)
        return ({k: shard.gather(v, n) for k, v in state.items()}, loss.cpu().numpy())
    states, losses = [], []
    for s in range(n):
        state, loss = finetune_decoder(
            decoder_cfg, {k: v[s] for k, v in stacked_state.items()}, cond_x[s], y[s],
            y_lengths[s], attn[s], spk_emb[s], dtype=dtype, segment_size=segment_size,
            n_iters=n_iters, learning_rate=learning_rate, grad_clip=grad_clip,
            generator=None if generators is None else generators[s],
            draws=None if draws is None else draws[s])
        states.append(state)
        losses.append(loss)
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}, np.stack(losses)
