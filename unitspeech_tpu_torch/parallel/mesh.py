"""The device mesh and every collective the port makes (counterpart of
unitspeech_tpu/parallel/mesh.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with the JAX
package's axes (data, seq, model), one rank a card. A `DataShard` is one
rank's place on `data`: it owns the rows of a batch (rank, rank + size,
...), draws what a global batch draws and keeps its own rows, and sums,
takes maxima, gathers and broadcasts over the axis's process group; with
no group (a single process) each of these is the identity.

A `SeqShard` is one rank's place on `seq`, the sampler's frame axis: it
splits T into contiguous slices whose boundaries fall on multiples of
SEQ_UNIT = 8 frames (2 ** (len(dim_mults) - 1): every U-Net level's slice
is then whole and the stride-2 halves line up), uneven where T asks for
it (344 frames: 176 + 168 over two ranks), never padded (GroupNorm pools
over every row, padding included: extra frames would change the
statistics). `SeqShard.at(T)` is one call's `FrameSlice`, which the
estimator carries down its levels: the global frames, this rank's first
frame and its length, and the collectives a sharded site needs (the
neighbours' edge frames as a halo, sums, maxima, the slices gathered).

The collectives are `all_reduce` and `broadcast` only, the two that gloo
also runs on CUDA tensors (two ranks on one card run over gloo), so a
gather or a halo is the sum of zero-filled buffers (exact: each element
has one non-zero term). Every axis gathers by one rule, `_sum_exact`: the
sum runs on the buffer's bits as int32 where its bytes allow (exact for
every dtype, -0.0 and NaNs kept), else in f32 (integers in int64). Every
collective of the seq axis adds one to `SeqShard.collectives`, as a
kernel wrapper counts its launches. A halo carries any dtype: its frames
travel as f32, exact for bf16 and for int8 (K9's quantized activations,
whose neighbours' frames arrive quantized with the one global scale).

A `ModelShard` is one rank's place on `model`, the tensor-parallel axis
(parallel/tp.py): a layer holds its rank's output-channel columns of every
sharded kernel, computes its slice of the output from the whole input, and
one gather over the axis restores the whole activation (the layout JAX's
GSPMD gives a Cout-sharded kernel). The gather has an autograd form for
training, whose backward
takes the rank's columns of the gradient, and `enter` is the identity
whose backward sums a layer input's gradient over the axis (the other
ranks' columns' share). Every collective of the model axis adds one to
`ModelShard.collectives`. The axis shards parameters, never a sample: a
sample spec naming 'model' raises ValueError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "seq", "model")
SEQ_UNIT = 8  # frames: the seq slices' boundaries, 2 ** (len(dim_mults) - 1)


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


def _sum_exact(buf: torch.Tensor, group) -> torch.Tensor:
    """The all_reduce SUM over `group` of zero-filled buffers in which every
    element has at most one non-zero term (a gather): on the bits as int32
    where the bytes allow (exact for every dtype, -0.0 and NaNs kept), else
    in f32 (integers in int64). Returns the sum in buf's dtype."""
    if buf.is_contiguous() and buf.numel() and buf.numel() * buf.element_size() % 4 == 0:
        dist.all_reduce(buf.view(-1).view(torch.int32), group=group)
        return buf
    wide = buf.to(torch.float32 if buf.is_floating_point() else torch.int64)
    dist.all_reduce(wide, group=group)
    return wide.to(buf.dtype)


def _reduced(t: torch.Tensor, group, op=None, dtype=None) -> torch.Tensor:
    """t reduced over `group` (SUM unless op; in `dtype` when given), a new
    tensor outside autograd, in t's dtype."""
    out = t.detach().to(dtype or t.dtype).clone()
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    return out.to(t.dtype)


def _flat_(tensors: Sequence[torch.Tensor], collective) -> int:
    """Run `collective` (in place, on one tensor) once on one flat buffer
    for each dtype and device among `tensors`, and copy the result back
    into each. Returns the number of collectives."""
    by_kind: dict = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for ts in by_kind.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))
    return len(by_kind)


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
        return t if self.group is None else _reduced(t, self.group, op)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the axis (a new tensor, outside autograd)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of t over the axis."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def all_sum_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum every tensor over the axis in place: one all_reduce of one
        flat buffer a dtype (the gradients of a data-parallel step)."""
        if self.group is not None:
            _flat_(tensors, lambda flat: dist.all_reduce(flat, group=self.group))

    def gather(self, local: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
        """The global tensor of `n` rows along `dim` from each rank's rows
        (`local` holds rows rank, rank + size, ... of it), on every rank: each
        rank writes its rows into zeros and the buffers are summed,
        _sum_exact)."""
        if self.group is None:
            return local
        shape = list(local.shape)
        shape[dim] = n
        buf = torch.zeros(shape, dtype=local.dtype, device=local.device)
        buf[(slice(None),) * dim + (slice(self.rank, None, self.size),)] = local
        return _sum_exact(buf, self.group)

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite every tensor with the axis's first rank's, in place: one
        broadcast of one flat buffer a dtype."""
        if self.group is not None:
            _flat_(tensors, lambda flat: dist.broadcast(flat, src=self.src, group=self.group))


@dataclass(frozen=True)
class SeqShard:
    """Rank `rank` of `size` on the seq axis, over `group` (None: this
    process alone). Frames split into contiguous slices of whole
    SEQ_UNIT-frame pieces (`split`); `at(T)` is one call's FrameSlice."""

    rank: int = 0
    size: int = 1
    group: Any = None

    # every collective over the axis (all_reduce / broadcast calls), as the
    # kernel wrappers count their launches; set it to 0 before a run
    collectives = 0

    @classmethod
    def of(cls, mesh) -> "SeqShard":
        sub = mesh["seq"]
        return cls(sub.get_local_rank(), sub.size(), sub.get_group())

    def split(self, t: int):
        """Every rank's (first frame, frames) of T frames: whole units, the
        first T / SEQ_UNIT % size ranks one unit more. T must be a multiple
        of the unit and hold at least one unit a rank (ValueError)."""
        if t % SEQ_UNIT or t < SEQ_UNIT * self.size:
            raise ValueError(f"{t} frames do not split over the seq axis ({self.size} ranks) in "
                             f"whole slices of {SEQ_UNIT} frames: at least {SEQ_UNIT} a rank")
        base, extra = divmod(t // SEQ_UNIT, self.size)
        sizes = [(base + (r < extra)) * SEQ_UNIT for r in range(self.size)]
        starts = [sum(sizes[:r]) for r in range(self.size)]
        return tuple(zip(starts, sizes))

    def at(self, t: int) -> "FrameSlice":
        """The FrameSlice of a call over T global frames (level 0)."""
        bounds = self.split(t)
        return FrameSlice(self, t, *bounds[self.rank], bounds)

    def all_reduce(self, t: torch.Tensor, op=None) -> torch.Tensor:
        """t reduced over the axis (SUM unless op), in a new tensor outside
        autograd; counted."""
        if self.group is None:
            return t
        SeqShard.collectives += 1
        return _reduced(t, self.group, op)


@dataclass(frozen=True)
class FrameSlice:
    """One call's frames on the seq axis at one U-Net level: T global
    frames `t`, this rank's `start` and `length`, every rank's (start,
    length) in `bounds`. Arrays hold frames on dim 1 ((B, T, ...)) unless
    a dim is given."""

    shard: SeqShard
    t: int
    start: int
    length: int
    bounds: tuple

    def down(self) -> "FrameSlice":
        """The next level's slice: every frame count halved (the slices'
        boundaries are whole units, so every level's are whole)."""
        return FrameSlice(self.shard, self.t // 2, self.start // 2, self.length // 2,
                          tuple((s // 2, n // 2) for s, n in self.bounds))

    def rows(self, n: int) -> int:
        """The global rows of a local (length x F) row count n."""
        return n // self.length * self.t

    def take(self, x, dim: int = 1):
        """This rank's frames of x along `dim`, contiguous."""
        return x.narrow(dim, self.start, self.length).contiguous()

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.shard.all_reduce(t)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        return self.shard.all_reduce(t, dist.ReduceOp.MAX)

    def cat(self, local: torch.Tensor, sizes, dim: int = 1) -> torch.Tensor:
        """Every rank's `local` concatenated along `dim` in rank order, on
        every rank; sizes[r] is rank r's extent along dim (each rank writes
        its part into zeros, the buffers are summed, _sum_exact). One
        collective."""
        if self.shard.group is None:
            return local
        shape = list(local.shape)
        shape[dim] = sum(sizes)
        buf = torch.zeros(shape, dtype=local.dtype, device=local.device)
        buf.narrow(dim, sum(sizes[:self.shard.rank]), sizes[self.shard.rank]).copy_(local)
        SeqShard.collectives += 1
        return _sum_exact(buf, self.shard.group)

    def gather(self, local: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The global frames along `dim` from every rank's slice."""
        return self.cat(local, [n for _, n in self.bounds], dim)

    def halo(self, x: torch.Tensor, before: int = 1, after: int = 1, mask=None):
        """x (B, length, ...) with the neighbours' edge frames around it: the
        `before` frames ahead of this slice and the `after` frames past it
        -> (B, before + length + after, ...), zeros beyond the global ends
        (exactly SAME zero padding). mask (B, length) or broadcastable to
        x's frames: the frames sent are masked (the receiver sees the
        padding as the unsharded program does). One collective."""
        b, n = x.shape[:2]
        rest = tuple(x.shape[2:])
        if before > n or after > n:
            raise ValueError(f"a halo of {before} / {after} frames over a slice of {n}")

        def edge(frames):
            e = x[:, frames]
            if mask is not None:
                m = mask[:, frames]
                e = e * m.reshape(m.shape + (1,) * (e.dim() - m.dim())).to(e.dtype)
            return e.to(torch.float32)

        size, rank = self.shard.size, self.shard.rank
        buf = torch.zeros((size, b, before + after) + rest, dtype=torch.float32,
                          device=x.device)
        if before:
            buf[rank, :, :before] = edge(slice(n - before, n))
        if after:
            buf[rank, :, before:] = edge(slice(0, after))
        if self.shard.group is not None:
            buf = self.all_sum(buf)
        lo = buf[rank - 1, :, :before] if rank > 0 else buf.new_zeros((b, before) + rest)
        hi = buf[rank + 1, :, before:] if rank < size - 1 else buf.new_zeros((b, after) + rest)
        return torch.cat([lo.to(x.dtype), x, hi.to(x.dtype)], dim=1)

    def randn(self, shape, generator=None, device=None, rows=None):
        """torch.randn of the global frames (shape[1] this slice's), this
        slice's frames kept: the draw does not depend on the world size.
        rows: the batch's DataShard (its global rows drawn, this rank's
        kept), when the rows are sharded too."""
        full = (shape[0], self.t) + tuple(shape[2:])
        return self.take((rows or SINGLE).randn(full, generator=generator, device=device))


class _Gather(torch.autograd.Function):
    """ModelShard.gather under autograd: the backward takes the rank's
    columns of the gradient (every model rank computes the same values
    downstream of the gather, so each holds the whole gradient)."""

    @staticmethod
    def forward(ctx, local, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return shard._gather(local, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.take(g, ctx.dim), None, None


class _Enter(torch.autograd.Function):
    """ModelShard.enter: the identity, whose backward sums the gradient over
    the axis (each rank's columns contribute their share to the input's)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.all_sum(g), None


@dataclass(frozen=True)
class ModelShard:
    """Rank `rank` of `size` on the model axis, over `group` (None: this
    process alone; every collective the identity). A sharded layer holds
    columns `cols(C)` of its kernel's last dimension (parallel/tp.py)."""

    rank: int = 0
    size: int = 1
    group: Any = None

    # every collective over the axis (all_reduce calls), as SeqShard counts
    # its own; set it to 0 before a run
    collectives = 0

    @classmethod
    def of(cls, mesh, axis: str = "model") -> "ModelShard":
        sub = mesh[axis]
        return cls(sub.get_local_rank(), sub.size(), sub.get_group())

    src = DataShard.src

    def cols(self, c: int) -> slice:
        """This rank's columns of C (C a multiple of the axis size)."""
        if c % self.size:
            raise ValueError(f"{c} channels do not split over the model axis ({self.size})")
        w = c // self.size
        return slice(self.rank * w, (self.rank + 1) * w)

    def take(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's columns of x along `dim`, contiguous."""
        c = self.cols(x.shape[dim])
        return x.narrow(dim, c.start, c.stop - c.start).contiguous()

    def _gather(self, local: torch.Tensor, dim: int) -> torch.Tensor:
        if self.group is None:
            return local
        shape = list(local.shape)
        w = shape[dim]
        shape[dim] = w * self.size
        buf = torch.zeros(shape, dtype=local.dtype, device=local.device)
        buf.narrow(dim, self.rank * w, w).copy_(local)
        ModelShard.collectives += 1
        return _sum_exact(buf, self.group)

    def gather(self, local: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's columns along `dim` concatenated in rank order, on
        every rank (one collective; under autograd, _Gather)."""
        if torch.is_grad_enabled() and local.requires_grad:
            return _Gather.apply(local, self, dim)
        return self._gather(local, dim)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """x, with its gradient summed over the axis in the backward (a
        sharded layer's input under autograd; the identity otherwise)."""
        if self.group is not None and torch.is_grad_enabled() and x.requires_grad:
            return _Enter.apply(x, self)
        return x

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the axis (in f32 for narrower floats), a new
        tensor outside autograd; counted."""
        if self.group is None:
            return t
        ModelShard.collectives += 1
        return _reduced(t, self.group, dtype=torch.float32 if t.is_floating_point() else None)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of t over the axis (K9's activation maxima
        of a column slice), a new tensor outside autograd; counted."""
        if self.group is None:
            return t
        ModelShard.collectives += 1
        return _reduced(t, self.group, dist.ReduceOp.MAX)

    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Overwrite every tensor with the axis's first rank's, in place, as
        DataShard.broadcast_ does (the replicated parameters' gradients of a
        tensor-parallel step, which each rank computed alone and
        nondeterministic kernels may round apart); counted."""
        if self.group is not None:
            ModelShard.collectives += _flat_(
                tensors, lambda flat: dist.broadcast(flat, src=self.src, group=self.group))


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


def sample_shard(mesh, sample_spec):
    """The shards a sampler's (B, T, F) spec asks for: (data, seq), each
    None where the spec does not name its axis (both None without a mesh
    or a spec). 'data' may shard the batch axis: this rank's DataShard;
    'seq' the frame axis: its SeqShard, None where the mesh's seq axis has
    one rank (the unsharded program). 'model' shards parameters
    (parallel/tp.py shard_params_tp), never the sample: a spec naming it,
    or an axis anywhere else, raises ValueError."""
    if mesh is None or sample_spec is None:
        return None, None
    spec = list(sample_spec) + [None] * (3 - len(sample_spec))

    def names(entry):
        return [] if entry is None else list(entry) if isinstance(entry, (tuple, list)) else [entry]

    named = [a for entry in spec for a in names(entry)]
    if "model" in named:
        raise ValueError(f"sample_spec {tuple(sample_spec)}: 'model' shards the parameters "
                         f"(parallel.shard_params_tp), not the sample")
    if len(spec) != 3 or names(spec[0]) not in ([], ["data"]) or \
            names(spec[1]) not in ([], ["seq"]) or names(spec[2]):
        raise ValueError(f"sample_spec {tuple(sample_spec)}: 'data' shards the batch axis and "
                         f"'seq' the frame axis only")
    data = DataShard.of(mesh) if spec[0] is not None else None
    seq = SeqShard.of(mesh) if spec[1] is not None and mesh["seq"].size() > 1 else None
    return data, seq


def world_size() -> int:
    """The default process group's world size, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


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
