"""BigVGAN's GAN training loop (counterpart of
unitspeech_tpu/train/vocoder_loop.py): random segment crops from a wav
list, the alternating steps of train/vocoder_gan.py, AdamW (0.8, 0.99)
with the learning rate decayed every step, TensorBoard scalars, atomic
checkpoints and resume.

  * the crops: `SegmentSampler` draws from numpy default_rng(seed), so its
    segments equal the JAX package's draw for draw; entries may be arrays
    or zero-argument loaders (a large corpus is read per draw);
  * the optimizer: optax.adamw(sched, b1=0.8, b2=0.99) is
    torch.optim.AdamW(betas (0.8, 0.99), eps 1e-8, weight_decay 1e-4,
    optax's default), and optax.exponential_decay(lr, transition_steps=
    max(len(wavs) // batch, 1), decay_rate) is not staircase: the rate at
    update n (from 0) is lr * decay ** (n / transition), a LambdaLR stepped
    after every update;
  * the parameters start from their flax initializers (utils/params
    init_module), drawn from a torch.Generator seeded with the seed;
  * a checkpoint `step_<n>` holds {"vocoder": the generator's state dict,
    "mpd", "mrd", "gen_opt", "disc_opt", "step", "config"}, so that
    utils/artifacts.load_vocoder_params, and with it `cli inference
    --vocoder`, reads the generator; resume restores all of it and
    re-seeds the sampler with seed + step, as JAX's loop does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from unitspeech_tpu_torch.models.discriminators import (
    MultiPeriodDiscriminator,
    MultiResolutionDiscriminator,
)
from unitspeech_tpu_torch.models.vocoder import BigVGAN
from unitspeech_tpu_torch.train.vocoder_gan import make_fused_vocoder_gan_step
from unitspeech_tpu_torch.utils import checkpoint as ckpt
from unitspeech_tpu_torch.utils.logging import MetricsWriter, StepTimer
from unitspeech_tpu_torch.utils.params import init_module

ADAM_BETAS = (0.8, 0.99)
# optax.adamw's default weight decay (torch's AdamW defaults to 0.01)
WEIGHT_DECAY = 1e-4
LR_DECAY = 0.999  # per transition (len(wavs) // batch_size steps)
LOG_EVERY = 50


@dataclass
class VocoderTrainConfig:
    segment_size: int = 8192       # samples a training crop
    batch_size: int = 16
    learning_rate: float = 2e-4
    steps: int = 1000
    seed: int = 42
    save_every: int = 500


class SegmentSampler:
    """Random fixed-size segments of waveforms, zero-padded where a clip is
    shorter than the segment. Entries are arrays or zero-argument
    callables that load one (per draw). The draws are the JAX sampler's:
    the clips of a batch, then each long clip's start, from one numpy
    default_rng(seed)."""

    def __init__(self, wavs: List, segment: int, batch: int, seed: int):
        if not wavs:
            raise ValueError("empty wav list")
        self.wavs = wavs
        self.segment = segment
        self.batch = batch
        self.rng = np.random.default_rng(seed)

    def next(self) -> np.ndarray:
        out = np.zeros((self.batch, self.segment), np.float32)
        idx = self.rng.integers(0, len(self.wavs), self.batch)
        for i, j in enumerate(idx):
            w = self.wavs[j]
            if callable(w):
                w = w()
            if len(w) <= self.segment:
                out[i, :len(w)] = w
            else:
                # inclusive upper bound: the last start is reachable
                s = int(self.rng.integers(0, len(w) - self.segment + 1))
                out[i] = w[s:s + self.segment]
        return out


def lr_lambda(transition_steps: int, decay: float):
    """optax.exponential_decay (not staircase) as a LambdaLR factor: the
    update count n -> decay ** (n / transition_steps)."""
    return lambda n: decay ** (n / transition_steps)


class GanTrainer:
    """The GAN's training state on `device`: the generator (plain path), the
    full MPD and MRD, their two AdamW optimizers and LambdaLR schedules,
    and the step count; from `tree` (a checkpoint) when given, else every
    parameter drawn from its flax initializer by a torch.Generator seeded
    with tcfg.seed. n_wavs sets the schedule's transition steps."""

    def __init__(self, cfg, tcfg: VocoderTrainConfig, n_wavs: int, device, tree=None):
        self.cfg, self.device = cfg, torch.device(device)
        with self.device:
            self.generator = BigVGAN.from_config(cfg.vocoder)
            self.disc = {"mpd": MultiPeriodDiscriminator(), "mrd": MultiResolutionDiscriminator()}
        modules = {"vocoder": self.generator, **self.disc}
        init = torch.Generator().manual_seed(tcfg.seed)
        for k, m in modules.items():
            m.load_state_dict(tree[k] if tree is not None else
                              init_module(m, init, cfg.vocoder.snake_logscale))
            m.train()

        def adamw(params):
            return torch.optim.AdamW(params, lr=tcfg.learning_rate,
                                     betas=ADAM_BETAS, eps=1e-8,
                                     weight_decay=WEIGHT_DECAY)

        self.gen_opt = adamw(self.generator.parameters())
        self.disc_opt = adamw([p for m in self.disc.values() for p in m.parameters()])
        self.step = 0
        if tree is not None:
            self.gen_opt.load_state_dict(tree["gen_opt"])
            self.disc_opt.load_state_dict(tree["disc_opt"])
            self.step = int(tree["step"])
        factor = lr_lambda(max(n_wavs // tcfg.batch_size, 1), LR_DECAY)
        # last_epoch = step - 1: the next update's rate is lr * factor(step)
        self.scheds = [torch.optim.lr_scheduler.LambdaLR(o, factor, last_epoch=self.step - 1)
                       for o in (self.gen_opt, self.disc_opt)]
        self._fused = make_fused_vocoder_gan_step(self.generator, self.disc["mpd"],
                                                  self.disc["mrd"], self.gen_opt,
                                                  self.disc_opt, cfg.data)

    def train_step(self, wav: torch.Tensor) -> dict:
        """One fused GAN step on wavs (B, L) on the device, then the
        schedules; returns its metrics, 0-d device tensors."""
        metrics = self._fused(wav)
        for s in self.scheds:
            s.step()
        self.step += 1
        return metrics

    def state_tree(self) -> dict:
        return {"vocoder": self.generator.state_dict(),
                **{k: m.state_dict() for k, m in self.disc.items()},
                "gen_opt": self.gen_opt.state_dict(), "disc_opt": self.disc_opt.state_dict(),
                "step": self.step, "config": dataclasses.asdict(self.cfg)}


def _host(metrics: dict) -> dict:
    return dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))


def train_vocoder(cfg, wavs: List, tcfg: VocoderTrainConfig, log_dir: Optional[str] = None,
                  checkpoint_dir: Optional[str] = None, resume: bool = False, device="cuda"):
    """Train BigVGAN (cfg: the MainConfig, its data and vocoder sections)
    against the full MPD and MRD on `device`, up to tcfg.steps steps,
    saving every tcfg.save_every steps and at the last. Returns (the
    GanTrainer, the last step's metrics as floats, the host-clock seconds
    between consecutive steps' ends: each step's input copy waits for the
    step before, so each is one whole step, the first step excluded); a
    resumed run at or past tcfg.steps returns at once with metrics
    {"already_complete": 1.0, "restored_step": step} and no seconds."""
    if resume and not checkpoint_dir:
        raise ValueError("resume=True requires checkpoint_dir (a silent fresh run would look "
                         "like a successful resume)")
    latest = ckpt.latest_checkpoint(checkpoint_dir) if resume else None
    trainer = GanTrainer(cfg, tcfg, len(wavs), device,
                         ckpt.load_checkpoint(latest) if latest else None)
    start_step = trainer.step
    if start_step >= tcfg.steps:
        # the loop would not run: say so rather than return empty metrics
        return trainer, {"already_complete": 1.0, "restored_step": float(start_step)}, []
    sampler = SegmentSampler(wavs, tcfg.segment_size, tcfg.batch_size, tcfg.seed + start_step)
    writer = MetricsWriter(log_dir) if log_dir else None
    timer = StepTimer()
    metrics = {}
    for step in range(start_step, tcfg.steps):
        metrics = trainer.train_step(torch.from_numpy(sampler.next()).to(trainer.device))
        sec = timer.tick()
        if writer and (step % LOG_EVERY == 0 or step == tcfg.steps - 1):
            scal = _host(metrics)
            if sec:
                scal.update(sec_per_step=sec, steps_per_sec=1.0 / sec)
            writer.scalars(scal, step, prefix="vocoder_gan")
        if checkpoint_dir and ((step + 1) % tcfg.save_every == 0 or step == tcfg.steps - 1):
            ckpt.save_checkpoint(checkpoint_dir, step + 1, trainer.state_tree())
    return trainer, _host(metrics), timer.seconds
