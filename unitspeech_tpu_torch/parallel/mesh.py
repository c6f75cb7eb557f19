"""The device mesh and every collective the port makes (counterpart of
unitspeech_tpu/parallel/mesh.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with the JAX
package's axes (data, seq, model), one rank a card. The port shards on
`data` alone: a `DataShard` is one rank's place on that axis. It owns the
rows of a batch (rank, rank + size, ...), draws what a global batch draws
and keeps its own rows, and sums, takes maxima, gathers and broadcasts
over the axis's process group; with no group (a single process) each of
these is the identity. The collectives are `all_reduce` and `broadcast`
only, the two that gloo also runs on CUDA tensors, so the gather is the
sum of zero-filled buffers.

The `seq` and `model` axes exist so that specs naming them resolve, but no
path shards on them yet: the sequence-sharded sampler and tensor
parallelism are the next module slice (ROADMAP), and a spec naming them
raises NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "seq", "model")
QUEUED = ("sharding over 'seq' (the frame axis: halos for the 3x3 convs, 8-frame shard "
          "boundaries for the stride-2 resamples, K3's and K4's partial reductions) and "
          "'model' (tensor parallelism) are the next module slice of the port (ROADMAP), not "
          "ported yet")


def make_mesh(data: Optional[int] = None, seq: int = 1, model: int = 1):
    """A (data, seq, model) DeviceMesh over every rank of the default process
    group (maybe_initialize_distributed first). With data None, every rank
    goes to the data axis. Its device type is the backend's own device:
    "cpu" for gloo (whose all_reduce and broadcast also take CUDA
    tensors), else "cuda"."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.maybe_initialize_distributed first")
    n = dist.get_world_size()
    if data is None:
        data = n // (seq * model)
    assert data * seq * model == n, f"mesh {data}x{seq}x{model} != {n} devices"
    device_type = "cpu" if dist.get_backend() == "gloo" else "cuda"
    return init_device_mesh(device_type, (data, seq, model), mesh_dim_names=AXES)


@dataclass(frozen=True)
class DataShard:
    """Rank `rank` of `size` on the data axis, over `group` (None: this
    process alone, every collective the identity). A batch's rows are split
    with a stride: the rank holds rows rank, rank + size, ... of the global
    batch, so that the slices of one epoch's strided sample order
    (data/dataset.iterate_batches) stack into the global batch in its own
    order."""

    rank: int = 0
    size: int = 1
    group: Any = None

    @classmethod
    def of(cls, mesh, axis: str = "data") -> "DataShard":
        sub = mesh[axis]
        return cls(sub.get_local_rank(), sub.size(), sub.get_group())

    @property
    def src(self) -> int:
        """The global rank of the axis's first rank (the broadcasts' source)."""
        return 0 if self.group is None else dist.get_global_rank(self.group, 0)

    def take(self, x, dim: int = 0):
        """This rank's rows of x along `dim` (a tensor or an array), as a
        contiguous copy (the kernels take contiguous operands)."""
        if self.size == 1:
            return x
        rows = x[(slice(None),) * dim + (slice(self.rank, None, self.size),)]
        return rows.contiguous() if isinstance(rows, torch.Tensor) else np.ascontiguousarray(rows)

    def global_rows(self, b: int) -> int:
        """The global batch of a rank's b rows (every rank holds as many)."""
        return b * self.size

    def rand(self, shape, generator=None, device=None):
        """torch.rand of the global batch (shape[0] this rank's rows), this
        rank's rows: the draw does not depend on the world size."""
        full = (self.global_rows(shape[0]),) + tuple(shape[1:])
        return self.take(torch.rand(full, generator=generator, device=device))

    def randn(self, shape, generator=None, device=None):
        """torch.randn of the global batch, this rank's rows (as rand)."""
        full = (self.global_rows(shape[0]),) + tuple(shape[1:])
        return self.take(torch.randn(full, generator=generator, device=device))

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.group is None:
            return t
        out = t.detach().clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the axis (a new tensor, outside autograd)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of t over the axis."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def all_sum_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum every tensor over the axis in place: one all_reduce of one
        flat buffer a dtype (the gradients of a data-parallel step)."""
        if self.group is None:
            return
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat, group=self.group)
            for t, part in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))

    def gather(self, local: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
        """The global tensor of `n` rows along `dim` from each rank's rows
        (`local` holds rows rank, rank + size, ... of it), on every rank: each
        rank writes its rows into zeros and the buffers are summed (floats
        summed in f32, exact next to zeros, then cast back)."""
        if self.group is None:
            return local
        dtype = torch.float32 if local.is_floating_point() else torch.int64
        shape = list(local.shape)
        shape[dim] = n
        buf = torch.zeros(shape, dtype=dtype, device=local.device)
        buf[(slice(None),) * dim + (slice(self.rank, None, self.size),)] = local.to(dtype)
        dist.all_reduce(buf, group=self.group)
        return buf.to(local.dtype)

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite every tensor with the axis's first rank's, in place."""
        if self.group is None:
            return
        for t in tensors:
            dist.broadcast(t, src=self.src, group=self.group)


# a single process: every row, draws as drawn, every collective the identity
SINGLE = DataShard()


def shard_batch(batch: dict, shard: DataShard) -> dict:
    """This rank's slice of axis 0 of every array of a host batch."""
    return {k: shard.take(v) for k, v in batch.items()}


def replicate_tree(tree, shard: DataShard, device=None):
    """The axis's first rank's tree on every rank (the other ranks' `tree`
    is ignored and may be None): its structure and non-tensor leaves by
    broadcast_object_list, then each tensor by broadcast, on `device` (the
    tensors' own when None; NCCL needs the card)."""
    if shard.group is None:
        return tree
    first = shard.rank == 0

    def skeleton(x):
        if isinstance(x, torch.Tensor):
            return ("__tensor__", tuple(x.shape), x.dtype)
        if isinstance(x, dict):
            return {k: skeleton(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(skeleton(v) for v in x)
        return x

    box = [skeleton(tree) if first else None]
    dist.broadcast_object_list(box, src=shard.src, group=shard.group)
    tensors = []

    def build(spec, x):
        if isinstance(spec, tuple) and len(spec) == 3 and spec[0] == "__tensor__":
            if first:
                t = x if device is None else x.to(device)
            else:
                t = torch.empty(spec[1], dtype=spec[2], device=device)
            tensors.append(t.contiguous())
            return tensors[-1]
        if isinstance(spec, dict):
            return {k: build(v, x[k] if first else None) for k, v in spec.items()}
        if isinstance(spec, (list, tuple)):
            return type(spec)(build(v, x[i] if first else None) for i, v in enumerate(spec))
        return spec

    out = build(box[0], tree)
    shard.broadcast_(tensors)
    return out


def sample_shard(mesh, sample_spec) -> Optional[DataShard]:
    """The DataShard a sampler's (B, T, F) spec asks for: None without a
    mesh or a spec, or when the spec names no axis; this rank's place on
    'data' when the spec puts 'data' on the batch axis alone. A spec naming
    'seq' or 'model' raises NotImplementedError (QUEUED): it never runs
    unsharded without saying so."""
    if mesh is None or sample_spec is None:
        return None
    named = [a for entry in sample_spec if entry is not None
             for a in (entry if isinstance(entry, (tuple, list)) else (entry,))]
    if any(a != "data" for a in named):
        raise NotImplementedError(f"sample_spec {tuple(sample_spec)}: {QUEUED}")
    if not named:
        return None
    if list(sample_spec)[0] != "data" or len(named) != 1:
        raise ValueError(f"sample_spec {tuple(sample_spec)}: 'data' shards the batch axis only")
    return DataShard.of(mesh)


def train_shard(batch_size: int) -> DataShard:
    """The data-parallel shard of a training run: DataShard() in a single
    process; in a process group, the whole world on 'data'. The width is
    the JAX TrainLoop's, the largest divisor of batch_size up to the world
    size; a world it does not fill raises ValueError (launch that many
    ranks) rather than leaving ranks idle."""
    if not dist.is_initialized():
        return DataShard()
    world = dist.get_world_size()
    width = max(d for d in range(1, min(world, batch_size) + 1) if batch_size % d == 0)
    if width != world:
        raise ValueError(f"batch_size {batch_size} splits over at most {width} of the {world} "
                         f"ranks: launch {width} ranks or change the batch size")
    return DataShard.of(make_mesh(data=world))
