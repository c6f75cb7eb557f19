"""Process-group launch of the port (counterpart of
unitspeech_tpu/parallel/launch.py): one call makes a process a rank of a
`torch.distributed` group, on the card of its local rank.

    torchrun --nproc_per_node 4 -m unitspeech_tpu_torch.cli train-step1 --distributed ...

`run_group` (`Group`) starts a group of local processes with the spawn
method and joins them with a time limit (the CPU tests and chip_smoke.py's
parallel phase use it; a user launches with torchrun).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Topology:
    """Where a rank meets the group: init_method (a `tcp://host:port` or
    `file://` URL), world size, rank, local rank (its card on the host)."""

    init_method: Optional[str]
    world: int
    rank: int
    local_rank: int


def resolve_topology(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Topology:
    """The topology in the JAX launcher's order: the explicit arguments;
    then UNITSPEECH_COORDINATOR (host:port, or a tcp:// or file:// URL) /
    UNITSPEECH_NUM_PROCESSES / UNITSPEECH_PROCESS_ID; then torchrun's
    MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, which stand where JAX
    auto-detects a TPU pod. The local rank is LOCAL_RANK, else the rank.
    Raises ValueError when no launcher set a world size and rank."""
    env = os.environ
    addr = coordinator_address or env.get("UNITSPEECH_COORDINATOR")
    world = num_processes if num_processes is not None else env.get("UNITSPEECH_NUM_PROCESSES")
    rank = process_id if process_id is not None else env.get("UNITSPEECH_PROCESS_ID")
    if addr is None and world is None and rank is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world, rank = env.get("WORLD_SIZE"), env.get("RANK")
    if world is None or rank is None:
        raise ValueError("no process topology: pass the coordinator, the number of processes "
                         "and the process id, set UNITSPEECH_COORDINATOR / "
                         "UNITSPEECH_NUM_PROCESSES / UNITSPEECH_PROCESS_ID, or launch with "
                         "torchrun")
    if addr is not None and "://" not in addr:
        addr = f"tcp://{addr}"
    rank = int(rank)
    return Topology(addr, int(world), rank, int(env.get("LOCAL_RANK", rank)))


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None, cpu: bool = False,
                                 backend: Optional[str] = None) -> bool:
    """Make this process a rank of the default process group (resolve_topology);
    idempotent; returns True, as the JAX launcher does. On the card (the
    default) the rank takes card LOCAL_RANK modulo the cards on the host
    (torch.cuda.set_device) and joins over `nccl`; with cpu=True it joins
    over `gloo`. `backend` names another (chip_smoke.py runs two ranks on
    one card over gloo, which NCCL refuses). Without a CUDA device and
    without cpu=True it raises; a failed init raises, with no other
    backend tried."""
    if dist.is_initialized():
        return True
    topo = resolve_topology(coordinator_address, num_processes, process_id)
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed on the card needs a CUDA device (pass --cpu for "
                               "ranks on the CPU over gloo)")
        torch.cuda.set_device(topo.local_rank % torch.cuda.device_count())
    dist.init_process_group(backend or ("gloo" if cpu else "nccl"),
                            init_method=topo.init_method or "env://", world_size=topo.world,
                            rank=topo.rank)
    return True


def local_device(cpu: bool = False) -> torch.device:
    """This rank's device: the CPU, or the card maybe_initialize_distributed
    set (the current CUDA device)."""
    return torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())


class Group:
    """fn(rank, world, *args) running in `world` spawned processes, to be
    joined within `timeout` seconds of the start (join). fn must be
    importable by the children (a module's top-level function)."""

    def __init__(self, fn: Callable, world: int, args: tuple = (), timeout: float = 120.0):
        ctx = torch.multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=fn, args=(rank, world, *args), daemon=True)
                      for rank in range(world)]
        for p in self.procs:
            p.start()
        self.timeout = timeout
        self.deadline = time.monotonic() + timeout

    def join(self) -> None:
        """Wait for every rank. A process that exits non-zero fails the
        group (RuntimeError with every exit code); one still running at the
        limit is killed with the others (TimeoutError)."""
        try:
            while True:
                codes = [p.exitcode for p in self.procs]
                if any(c not in (None, 0) for c in codes):
                    raise RuntimeError(f"a rank failed: exit codes {codes}")
                if all(c == 0 for c in codes):
                    return
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"ranks still running after {self.timeout:.0f} s: exit "
                                       f"codes {codes}")
                time.sleep(0.05)
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                p.join(5.0)


def run_group(fn: Callable, world: int, args: tuple = (), timeout: float = 120.0) -> None:
    """Run fn(rank, world, *args) in `world` spawned processes and join them
    (Group)."""
    Group(fn, world, args, timeout).join()
