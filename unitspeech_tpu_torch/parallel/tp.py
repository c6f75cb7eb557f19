"""Tensor parallelism over the mesh's `model` axis (counterpart of
unitspeech_tpu/parallel/tp.py).

JAX places every `kernel` leaf with its output-channel (last) dimension
sharded over `model` and lets GSPMD all-gather the channel-sharded
activation at each layer boundary: a TP run computes the replicated
program. The port does the same by hand. Each rank keeps exactly JAX's
slice of every eligible kernel, columns [r C / n, (r + 1) C / n) of its last
dimension, and the layer's 1-D bias the same columns; the layer
(models/layers.py) computes its slice of the output from the whole input,
and one gather over the axis (parallel.mesh.ModelShard) restores the whole
activation. The fused chains move the gather past work local to a column
slice (models/unet.py, ops/fused_resnet.py). Everything else stays
replicated: norm scales, embeddings, the rezero gates, a kernel whose
last dimension does not split.

Parameters are named as in the port's state dicts: the flax path joined
with '.' (utils/params.py), so `tp_spec_tree` is JAX's tree of specs,
leaf by leaf. A spec is a tuple of axis names, JAX's PartitionSpec's
entries: (None, ..., None, "model") or () (replicated).
"""

from __future__ import annotations

import torch
from torch import nn

from unitspeech_tpu_torch.parallel.mesh import ModelShard

# Leaf names whose last dim is a genuine output-channel contraction output
# (flax Conv / ConvTranspose / Dense all name their weight 'kernel');
# embedding and relative-position tables stay replicated, as in JAX
SHARDED_LEAF_NAMES = ("kernel",)


def tp_spec(shape, n_model: int, model_axis: str = "model", min_per_shard: int = 1) -> tuple:
    """The spec of one parameter of `shape`: its last dim over `model_axis`
    when it is a matrix or kernel (ndim >= 2) whose output channels divide
    evenly with at least `min_per_shard` a rank; () (replicated) else."""
    shape = tuple(shape)
    if (len(shape) >= 2 and n_model > 1 and shape[-1] % n_model == 0
            and shape[-1] // n_model >= min_per_shard):
        return (None,) * (len(shape) - 1) + (model_axis,)
    return ()


def _model_size(mesh, model_axis: str) -> int:
    """The model axis's size of a DeviceMesh, a ModelShard or a plain int."""
    if isinstance(mesh, int):
        return mesh
    if isinstance(mesh, ModelShard):
        return mesh.size
    return mesh[model_axis].size()


def _shapes(module_or_state_dict) -> dict:
    if isinstance(module_or_state_dict, nn.Module):
        return {k: tuple(p.shape) for k, p in module_or_state_dict.named_parameters()}
    return {k: tuple(v.shape) for k, v in module_or_state_dict.items()}


def tp_spec_tree(module_or_state_dict, mesh, model_axis: str = "model", min_per_shard: int = 1,
                 leaf_names=SHARDED_LEAF_NAMES) -> dict:
    """{parameter name: spec} of a module's parameters (or a state dict's
    entries) under tp_spec; only leaves named in `leaf_names` (the name's
    last part) are considered, None applies the bare shape rule to every
    leaf. mesh: a DeviceMesh, a ModelShard or the model axis's size."""
    n = _model_size(mesh, model_axis)
    out = {}
    for name, shape in _shapes(module_or_state_dict).items():
        leaf = name.rsplit(".", 1)[-1]
        out[name] = (() if leaf_names is not None and leaf not in leaf_names
                     else tp_spec(shape, n, model_axis, min_per_shard))
    return out


def is_sharded(p: torch.Tensor) -> bool:
    """Whether shard_params_tp replaced parameter p by its rank's columns
    (then p.tp is its model axis's ModelShard)."""
    return getattr(p, "tp", None) is not None


def shard_params_tp(module: nn.Module, mesh, model_axis: str = "model", min_per_shard: int = 1,
                    leaf_names=SHARDED_LEAF_NAMES) -> nn.Module:
    """Shard `module` in place over `model_axis` (other mesh axes see the
    parameters replicated): every parameter that tp_spec_tree shards
    becomes this rank's columns of its last dim, the layer's 1-D bias of
    as many entries the same columns, and the layer and each sharded
    parameter get its ModelShard (`tp`), which the layer's forward gathers
    over and a training step reads (train/steps.py). Then the estimator's kernels
    are re-packed (GradLogPEstimator2d.pack: the K4 sites gather their
    whole weights once). mesh: a DeviceMesh or a ModelShard. A model axis
    of one rank changes nothing. Returns the module."""
    shard = mesh if isinstance(mesh, ModelShard) else ModelShard.of(mesh, model_axis)
    if shard.size == 1:
        return module
    specs = tp_spec_tree(module, shard.size, model_axis, min_per_shard, leaf_names)
    for prefix, layer in module.named_modules():
        for pname, p in list(layer.named_parameters(recurse=False)):
            name = f"{prefix}.{pname}" if prefix else pname
            if not specs.get(name) or is_sharded(p):
                continue
            if not hasattr(layer, "tp"):
                raise ValueError(f"{name}: {type(layer).__name__} has no tensor-parallel form")
            cols = p.shape[-1]
            with torch.no_grad():
                p.data = shard.take(p.data, -1).clone()
            p.tp = shard
            bias = getattr(layer, "bias", None)
            if isinstance(bias, nn.Parameter) and bias.dim() == 1 and bias.shape[0] == cols:
                with torch.no_grad():
                    bias.data = shard.take(bias.data, 0).clone()
                bias.tp = shard
            layer.tp = shard
    from unitspeech_tpu_torch.models.unet import GradLogPEstimator2d

    for m in module.modules():
        if isinstance(m, GradLogPEstimator2d):
            # the load hook packed the whole weights: pack the slices
            m.tp = shard
            if m.packs():
                m.pack()
    return module


def gather_params_tp(module: nn.Module) -> dict:
    """The whole state dict of a module that shard_params_tp sharded: every
    sharded parameter gathered over its layer's model axis (a kernel along
    its last dim, a bias along its one), the rest as they are. Bit for bit
    the state dict before sharding; every rank gets it (rank 0 writes a
    checkpoint in the unsharded layout)."""
    params = dict(module.named_parameters(remove_duplicate=False))
    return {name: params[name].tp.gather(t, -1) if name in params and is_sharded(params[name])
            else t for name, t in module.state_dict().items()}
