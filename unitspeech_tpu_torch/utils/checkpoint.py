"""Training checkpoints (counterpart of unitspeech_tpu/utils/checkpoint.py):
atomic, resumable, with the optimizer state, in a directory of
step-numbered files `step_<n>` (the JAX package's names; it writes orbax
directories, the port one `torch.save`d file each, as the card's machine
has no orbax).

  * each write goes to a temporary file in the same directory, then
    `os.replace` puts it in place: a crash leaves the old file or the new
    one, never half of one;
  * `latest_checkpoint` picks the highest n; `save_checkpoint` keeps the
    newest `keep` files and deletes the rest.

What a tree holds is the caller's; the train loop (train/loop.py) saves
the port's combined checkpoint layout, so utils/artifacts reads its modules
with no other loader.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

_STEP_RE = re.compile(r"^step_(\d+)$")


def save_checkpoint(directory: str, step: int, tree: Any, keep: int = 3) -> str:
    """Atomically save `tree` (tensors moved to the CPU) as
    <directory>/step_<step>; prune to the newest `keep`. Returns the path."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step}")
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(_to_cpu(tree), tmp)
    os.replace(tmp, path)
    _prune(directory, keep)
    return path


def load_checkpoint(path: str) -> Any:
    """The tree saved at `path`, its tensors on the CPU (tensors, numbers,
    strings and containers only: no code is unpickled)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def latest_checkpoint(directory: str) -> Optional[str]:
    """The step_<n> file of `directory` with the highest n, or None."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(directory, name), int(m.group(1))
    return best


def checkpoint_step(path: str) -> int:
    """n of a step_<n> path, -1 for any other name."""
    m = _STEP_RE.match(os.path.basename(path))
    return int(m.group(1)) if m else -1


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _prune(directory: str, keep: int):
    entries = sorted((int(m.group(1)), name) for name in os.listdir(directory)
                     if (m := _STEP_RE.match(name)))
    for _, name in entries[:-keep] if keep > 0 else []:
        os.remove(os.path.join(directory, name))
