"""The epoch loop of STEP1 and STEP2 training (counterpart of
unitspeech_tpu/train/loop.py `TrainLoop`; reference train_STEP1.py:45-304,
train_STEP2.py), on one device or data-parallel over the ranks of a
process group (`shard`, parallel.train_shard: one rank a card):

  * `_prepare_batch` moves a collated batch of either form (tokens, or
    units and durations) to the device and computes the normalized log-mel
    there (ops/mel.py), attaching the speaker embeddings by speaker id;
  * `run` keeps the JAX loop's seeding: a numpy default_rng(seed) shuffles
    the epochs and a torch.Generator seeded from `seed` on the device makes
    every draw of the steps, both restarted by each run (a resumed run
    replays the first epochs' order, as JAX's does). Its one host sync a
    step is the metrics' (the JAX loop's `float(v)`), made as one copy;
    it writes TensorBoard scalars and an epoch summary to train.log, saves
    every `save_every` epochs, and on SIGTERM saves at the next step
    boundary and returns;
  * checkpoints (utils/checkpoint.py, `step_<epoch>` files) hold the
    trained modules' state dicts (STEP1's three; STEP2's unit encoder
    alone, its frozen decoder living in the step), the optimizer's state,
    the step and the epoch, with the config and the mel min / max beside
    them: the port's combined checkpoint layout, which `cli inference
    --checkpoint` (with `--spk-emb`) and `cli finetune --unit-encoder`
    read; `resume` restores parameters, Adam moments and step.

Across ranks the global batch stays cfg.train.batch_size, as on one JAX
host with several devices: each rank takes batch_size / world rows, its
strided slice of the epoch (iterate_batches with process_index = rank),
and the ranks pad their slices to one (token, frame) bucket, the largest
of theirs, so that the step is JAX's global-batch step (train/steps.py).
JAX's batch_size is per host: on several machines, set batch_size to the
global batch, hosts x JAX's. Only rank 0 writes checkpoints, TensorBoard
and train.log; `resume` reads on rank 0 and broadcasts, so every rank
holds the same parameters and Adam moments; SIGTERM on any rank stops
every rank after the same step. The shapes, the metrics and the stop flag
are the three small all-reduces a step adds.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from unitspeech_tpu_torch.config import MainConfig
from unitspeech_tpu_torch.data.dataset import BucketCollator, iterate_batches
from unitspeech_tpu_torch.ops.mel import mel_spectrogram, normalize_mel
from unitspeech_tpu_torch.parallel.mesh import DataShard, replicate_tree
from unitspeech_tpu_torch.utils import checkpoint as ckpt
from unitspeech_tpu_torch.utils.logging import MetricsWriter, StepTimer, get_logger

logger = get_logger()

# the integer arrays of a collated batch, text form and units form
_INT_KEYS = ("tokens", "token_lengths", "units", "unit_lengths", "mel_lengths")


@dataclass
class TrainLoop:
    """The epoch loop of either step. `modules` (STEP1: {text_encoder,
    duration_predictor, decoder}; STEP2: {unit_encoder}) and `optimizer`
    are the training state, on `device`; train_step(batch, generator) ->
    metrics (train/steps.py make_step1_train_step / make_step2_train_step).
    step_hook(step, metrics), when given, is called after each step with
    its metrics on the host. shard: the data-parallel shard the train step
    was made with (DataShard() in a single process)."""

    cfg: MainConfig
    train_step: Callable
    modules: Dict[str, torch.nn.Module]
    optimizer: torch.optim.Optimizer
    dataset: Any
    collator: BucketCollator
    mel_min: torch.Tensor  # (n_feats,) on device
    mel_max: torch.Tensor
    spk_embs: Optional[Dict[int, np.ndarray]] = None  # id -> (S,)
    log_dir: str = "logs/unitspeech_tpu"
    checkpoint_dir: str = "checkpoints/train"
    save_every: int = 5
    seed: int = 42
    device: Any = "cuda"
    step: int = 0
    step_hook: Optional[Callable[[int, dict], None]] = None
    step_seconds: List[float] = field(default_factory=list)
    shard: DataShard = field(default_factory=DataShard)

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.main = self.shard.group is None or torch.distributed.get_rank() == 0
        if self.shard.size > 1 and not self.cfg.train.drop_last:
            raise ValueError("data parallelism needs train.drop_last: the ranks step in "
                             "lock-step on whole batches")
        self.writer = MetricsWriter(self.log_dir) if self.main else None
        self.timer = StepTimer()

    def _prepare_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch -> device batch: the tokens (or units) and lengths as
        int64, the durations of a units batch (f32), the normalized mel
        (B, Ty, F) from the padded wavs, spk_emb (B, S)."""
        d, dev = self.cfg.data, self.device
        out = {k: torch.from_numpy(batch[k]).long().to(dev) for k in _INT_KEYS if k in batch}
        if "durations" in batch:
            out["durations"] = torch.from_numpy(batch["durations"]).to(dev)
        if self.spk_embs is not None:
            spk = np.stack([self.spk_embs[int(i)] for i in batch["spk_id"]]).astype(np.float32)
            out["spk_emb"] = torch.from_numpy(spk).to(dev)
        wav = torch.from_numpy(batch["wav"]).to(dev)
        mel = mel_spectrogram(wav, n_fft=d.n_fft, num_mels=d.n_feats,
                              sampling_rate=d.sampling_rate, hop_size=d.hop_length,
                              win_size=d.win_length, fmin=d.mel_fmin, fmax=d.mel_fmax)
        out["mel"] = normalize_mel(mel, self.mel_min, self.mel_max)
        return out

    def state_tree(self, epoch: int) -> dict:
        """What a checkpoint holds (the port's combined checkpoint layout)."""
        return {**{k: m.state_dict() for k, m in self.modules.items()},
                "opt_state": self.optimizer.state_dict(), "step": self.step, "epoch": epoch,
                "config": dataclasses.asdict(self.cfg), "mel_min": self.mel_min,
                "mel_max": self.mel_max}

    def resume(self) -> int:
        """Restore the newest checkpoint of checkpoint_dir (parameters, Adam
        state, step), read on rank 0 and broadcast to every rank; returns
        its epoch, 0 when there is none."""
        latest = ckpt.latest_checkpoint(self.checkpoint_dir) if self.main else None
        tree = ckpt.load_checkpoint(latest) if latest is not None else None
        if self.shard.group is not None:
            tree = replicate_tree(tree, self.shard, self.device)
        if tree is None:
            return 0
        for k, m in self.modules.items():
            m.load_state_dict(tree[k])
        self.optimizer.load_state_dict(tree["opt_state"])
        self.step = int(tree["step"])
        epoch = int(tree["epoch"])
        logger.info("resumed from %s (epoch %d, step %d)", latest or "rank 0", epoch, self.step)
        return epoch

    def _save(self, tag: int):
        if self.main:
            ckpt.save_checkpoint(self.checkpoint_dir, tag, self.state_tree(tag),
                                 keep=self.cfg.train.keep_checkpoints)

    def _lockstep(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Across ranks, the batch zero-padded to the largest token and frame
        buckets of the ranks' batches (one all-reduce); the batch itself in
        a single process."""
        if self.shard.group is None:
            return batch
        hop = self.cfg.data.hop_length
        key = "tokens" if "tokens" in batch else "units"
        t_x, t_y = self.shard.all_max(torch.tensor(
            [batch[key].shape[1], batch["wav"].shape[1] // hop], device=self.device)).tolist()
        out = dict(batch)
        for k in (key, "durations"):
            if k in out:
                out[k] = np.pad(out[k], ((0, 0), (0, t_x - out[k].shape[1])))
        out["wav"] = np.pad(out["wav"], ((0, 0), (0, t_y * hop - out["wav"].shape[1])))
        return out

    def _stop(self, preempted: dict) -> bool:
        """Whether any rank was asked to stop (SIGTERM), agreed by all."""
        if self.shard.group is None:
            return preempted["flag"]
        flag = torch.tensor([int(preempted["flag"])], device=self.device)
        return bool(self.shard.all_max(flag).item())

    def step_once(self, batch: Dict[str, np.ndarray], gen: torch.Generator) -> Dict[str, float]:
        """One step of the loop: the collated batch to the device
        (_prepare_batch), train_step, and its metrics to the host in one
        copy. Returns the metrics."""
        metrics = self.train_step(self._prepare_batch(batch), gen)
        values = torch.stack([v.float() for v in metrics.values()]).tolist()
        self.step += 1
        return dict(zip(metrics, values))

    def run(self, n_epochs: int, start_epoch: int = 0):
        """Epochs start_epoch .. n_epochs - 1. Returns the step count."""
        preempted = {"flag": False}

        def _on_term(signum, frame):
            preempted["flag"] = True

        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:  # not the main thread: no preemption handling
            prev_handler = None
        try:
            return self._epochs(n_epochs, start_epoch, preempted)
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    def _epochs(self, n_epochs: int, start_epoch: int, preempted: dict) -> int:
        tcfg, shard = self.cfg.train, self.shard
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        for epoch in range(start_epoch, n_epochs):
            sums: Dict[str, float] = {}
            count = 0
            for batch in iterate_batches(self.dataset, self.collator,
                                         tcfg.batch_size // shard.size, key=rng,
                                         shuffle=tcfg.shuffle, drop_last=tcfg.drop_last,
                                         process_index=shard.rank, process_count=shard.size):
                t0 = time.perf_counter()
                host = self.step_once(self._lockstep(batch), gen)
                self.step_seconds.append(time.perf_counter() - t0)
                ema = self.timer.tick()
                if self.main:
                    self.writer.scalars(host, self.step)
                    if ema is not None:
                        self.writer.scalars({"sec_per_step": ema}, self.step, prefix="perf")
                for k, v in host.items():
                    sums[k] = sums.get(k, 0.0) + v
                count += 1
                if self.step_hook is not None:
                    self.step_hook(self.step, host)
                if self._stop(preempted):
                    logger.info("SIGTERM: checkpointing at epoch %d and exiting", epoch)
                    self._save(epoch + 1)
                    return self.step
            if count and self.main:
                self.writer.epoch_summary(epoch, {k: v / count for k, v in sums.items()})
            if (epoch + 1) % self.save_every == 0:
                self._save(epoch + 1)
        return self.step
