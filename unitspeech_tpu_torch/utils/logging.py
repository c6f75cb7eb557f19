"""Training observability (counterpart of unitspeech_tpu/utils/logging.py;
reference train_STEP1.py:77, 250-261, 275-277): an append-only train.log
with one summary line an epoch, TensorBoard scalars when a SummaryWriter
imports, a step timer and the package logger."""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional


class MetricsWriter:
    """train.log lines (`Epoch <n>: name: value | ...`, as the JAX package
    writes them) in log_dir, and per-step scalars to TensorBoard when
    tensorboardX imports."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir)
        except ImportError:
            pass
        self._log_path = os.path.join(log_dir, "train.log")

    def scalars(self, metrics: Dict[str, float], step: int, prefix: str = "training"):
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), step)

    def log_line(self, msg: str):
        with open(self._log_path, "a", encoding="utf-8") as f:
            f.write(msg + "\n")

    def epoch_summary(self, epoch: int, means: Dict[str, float]):
        parts = " | ".join(f"{k}: {v:.6f}" for k, v in means.items())
        self.log_line(f"Epoch {epoch}: {parts}")


class StepTimer:
    """Seconds a step, an exponential moving average of the intervals
    between ticks; `seconds` keeps every interval."""

    def __init__(self, alpha: float = 0.05):
        self._last: Optional[float] = None
        self._ema: Optional[float] = None
        self.alpha = alpha
        self.seconds: List[float] = []

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.seconds.append(dt)
            self._ema = dt if self._ema is None else self.alpha * dt + (1 - self.alpha) * self._ema
        self._last = now
        return self._ema


def get_logger(name: str = "unitspeech_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger
