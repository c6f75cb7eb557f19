"""Speaker-adaptive fine-tuning of the diffusion decoder (counterpart of
unitspeech_tpu/train/finetune.py; reference finetune.py:34-173 calling
UnitSpeech.fine_tune, unitspeech.py:452-492): Adam over every decoder
parameter on random 2 s segments of one reference utterance, with the
unit-encoder conditioning and the alignment frozen.

The JAX package runs the loop as one jit-compiled `lax.scan`; here a step
(FinetuneLoop) keeps its draws, its loss and the clipping norm on the
device, so that the host never waits for a step, and on the card it is
captured once as a CUDA graph and replayed every step. The decoder trained is the plain estimator (no kernels, no
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
from unitspeech_tpu_torch.parallel.mesh import SINGLE, world_size
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


# eager steps before the fine-tune step's capture, on a side stream
# (PyTorch's warm-up for a captured backward and optimizer step: the
# gradients and Adam's moments exist before the capture); each is a real step
WARMUP_STEPS = 3


def draw_finetune(n_iters: int, rows: int, segment_size: int, n_feats: int, generator=None,
                  device=None) -> dict:
    """A fine-tune's draws up front: {"u" (n, B), "t" (n, B), "z" (n, B,
    segment, F)}, each step's u, t and z drawn in the order fine_tune_loss
    draws them (the crop's u, then the loss's t and z), so the numbers are
    those of drawing each step."""
    u, t, z = [], [], []
    for _ in range(n_iters):
        u.append(torch.rand((rows,), generator=generator, device=device))
        t.append(SINGLE.rand((rows,), generator, device))
        z.append(SINGLE.randn((rows, segment_size, n_feats), generator, device))
    return {"u": torch.stack(u), "t": torch.stack(t), "z": torch.stack(z)}


class FinetuneLoop:
    """The fine-tune's optimizer steps on one device (the counterpart of
    the JAX package's one jit-compiled `lax.scan` of n_iters steps): a
    step reads its draws at a device step counter and writes its loss
    there, zeroes the gradients in place, clips without a host sync
    (clip_by_global_norm) and steps Adam, so on the card the step is
    captured once as a CUDA graph and replayed n_iters times (after
    WARMUP_STEPS eager steps, which are the run's own; at world > 1 the
    steps run eagerly, as the sampler's, infer/graphs.py). Adam is
    capturable on the card in the graphed and the eager run alike (the two
    agree bit for bit); the CPU runs today's Adam, eagerly. start() loads a
    speaker (weights copied into the captured model in place, Adam's
    moments and step reset in place), run() runs its steps; one loop
    adapts many speakers with one graph."""

    def __init__(self, decoder_cfg, device, dtype=torch.bfloat16, segment_size: int = 176,
                 n_iters: int = 500, learning_rate: float = 2e-5, grad_clip: float = 1.0,
                 graphs: bool = True):
        self.cfg, self.device = decoder_cfg, torch.device(device)
        self.segment_size, self.n_iters, self.grad_clip = segment_size, n_iters, grad_clip
        with torch.device(self.device):
            self.model = UnitSpeech.from_config(decoder_cfg, dtype=dtype)
        self.model.train().requires_grad_(True)
        self.params = list(self.model.parameters())
        cuda = self.device.type == "cuda"
        self.opt = torch.optim.Adam(self.params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                    capturable=cuda)
        # at world > 1 (speaker-per-chip ranks) the steps stay eager, as the
        # sampler's do (infer/graphs.graphs_for)
        self.graphed = graphs and cuda and world_size() == 1
        self.graph = None
        self.losses = torch.zeros(n_iters, device=self.device)
        self.steps = torch.arange(n_iters, device=self.device)
        self.count = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.inputs = self.draws = None

    def start(self, state_dict, cond_x, y, y_lengths, attn, spk_emb, generator=None,
              draws=None) -> None:
        """Load one speaker: the weights `state_dict`, the inputs (cond_x
        (1, Tx, F), y (1, Ty, F), y_lengths (1,), attn (1, Tx, Ty), spk_emb
        (1, S)) and the draws, from `generator` (draw_finetune) or `draws`
        (one {"u", "t", "z"} a step); Adam's state and the counter reset."""
        self.model.load_state_dict({k: v.to(torch.float32) for k, v in state_dict.items()})
        with torch.no_grad():
            for st in self.opt.state.values():
                for v in st.values():
                    v.zero_()
            self.count.zero_()
            if draws is None:
                draws = draw_finetune(self.n_iters, y.shape[0], self.segment_size, y.shape[-1],
                                      generator, y.device)
            else:
                draws = {k: torch.stack([d[k] for d in draws]).to(self.device)
                         for k in ("u", "t", "z")}
            inputs = (cond_x, y, y_lengths, attn, spk_emb)
            if self.inputs is None or any(a.shape != b.shape for a, b in zip(
                    self.inputs + tuple(self.draws.values()), inputs + tuple(draws.values()))):
                self.graph = None  # a new shape: captured anew
                self.inputs = tuple(a.clone() for a in inputs)
                self.draws = {k: v.clone() for k, v in draws.items()}
            else:
                for a, b in zip(self.inputs, inputs):
                    a.copy_(b)
                for k, v in draws.items():
                    self.draws[k].copy_(v)

    def _step(self) -> None:
        i = self.count
        draws = {k: v.index_select(0, i)[0] for k, v in self.draws.items()}
        self.opt.zero_grad(set_to_none=False)
        cond_x, y, y_lengths, attn, spk_emb = self.inputs
        loss = fine_tune_loss(self.model, cond_x, y, y_lengths, attn, spk_emb, self.segment_size,
                              None, draws, self.cfg.beta_min, self.cfg.beta_max)
        loss.backward()
        clip_by_global_norm([p.grad for p in self.params], self.grad_clip)
        self.opt.step()
        with torch.no_grad():  # an elementwise write: no index kernel, no host sync
            self.losses.copy_(torch.where(self.steps == i, loss.detach(), self.losses))
            i.add_(1)

    def run(self, step_hook: Optional[Callable[[int], None]] = None):
        """The loaded speaker's n_iters steps; step_hook(i) after step i (a
        replay, or an eager step). Returns (the adapted f32 state dict, the
        per-step losses (n_iters,) float32 numpy)."""
        first = 0
        if self.graphed and self.graph is None:
            first = min(WARMUP_STEPS, self.n_iters)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for i in range(first):
                    self._step()
                    if step_hook is not None:
                        step_hook(i)
            torch.cuda.current_stream(self.device).wait_stream(side)
            if first < self.n_iters:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, capture_error_mode="global"):
                    self._step()
                self.graph = graph
        for i in range(first, self.n_iters):
            if self.graph is not None:
                self.graph.replay()
            else:
                self._step()
            if step_hook is not None:
                step_hook(i)
        return ({k: v.detach().clone() for k, v in self.model.state_dict().items()},
                self.losses.clone().cpu().numpy())


def finetune_decoder(decoder_cfg, state_dict, cond_x, y, y_lengths, attn, spk_emb,
                     dtype=torch.bfloat16, segment_size: int = 176, n_iters: int = 500,
                     learning_rate: float = 2e-5, grad_clip: float = 1.0,
                     generator: Optional[torch.Generator] = None, draws=None,
                     step_hook: Optional[Callable[[int], None]] = None, graphs: bool = True):
    """Fine-tune a decoder (DecoderConfig `decoder_cfg`, weights `state_dict`)
    on one utterance, on y's device: n_iters steps of fine_tune_loss ->
    backward -> clip_by_global_norm(grad_clip) -> Adam(learning_rate,
    betas (0.9, 0.999), eps 1e-8), optax's adam: the update is
    m_hat / (sqrt(v_hat) + eps).

    cond_x (1, Tx, F), y (1, Ty, F), y_lengths (1,), attn (1, Tx, Ty): from
    prepare_finetune_inputs; spk_emb (1, S) unit-normalized. The draws come
    from `generator`, all drawn up front (draw_finetune); draws: one {"u",
    "t", "z"} per step in place of them. On the card the step is one CUDA
    graph replay (FinetuneLoop); graphs=False runs it eagerly. step_hook(i),
    when given, is called after step i's update (measure.py records its
    timing events there). Returns (adapted f32 state dict on y's device,
    per-step losses (n_iters,) float32 numpy)."""
    loop = FinetuneLoop(decoder_cfg, y.device, dtype, segment_size, n_iters, learning_rate,
                        grad_clip, graphs)
    loop.start(state_dict, cond_x, y, y_lengths, attn, spk_emb, generator, draws)
    return loop.run(step_hook)


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
    draws[s] (one {"u", "t", "z"} per step). One FinetuneLoop runs them
    all: on the card one captured step replayed for every speaker. With
    `mesh` (JAX's mesh form, speaker-per-chip) the speakers split over its
    'data' axis, S / size on each rank (ValueError when S does not divide),
    each rank running its speakers on its own card with no collective in
    the loop; the adapted stack and the losses are gathered at the end, on
    every rank. Returns (the adapted stack, each parameter (S, ...) f32 on
    y's device; losses (S, n_iters) float32 numpy)."""
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
    loop = FinetuneLoop(decoder_cfg, y.device, dtype, segment_size, n_iters, learning_rate,
                        grad_clip)
    states, losses = [], []
    for s in range(n):
        loop.start({k: v[s] for k, v in stacked_state.items()}, cond_x[s], y[s], y_lengths[s],
                   attn[s], spk_emb[s], None if generators is None else generators[s],
                   None if draws is None else draws[s])
        state, loss = loop.run()
        states.append(state)
        losses.append(loss)
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}, np.stack(losses)
