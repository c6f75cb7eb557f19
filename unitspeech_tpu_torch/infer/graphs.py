"""CUDA graphs of the sampler's steps: the port's counterpart of the JAX
package's compiled sampler (unitspeech_tpu/models/diffusion.py runs the
reverse loop as one jit-compiled `lax.scan`, and its serving warm-up
compiles the grid before the port opens, unitspeech_tpu/cli.py).

A sampler step (models/diffusion.sampler_step) reads every per-step number
from device tables at a device step counter and writes the sample in
place, so one captured step replays every step of a request: a request is
one graph replay a step, not the thousand-odd kernel launches of an eager
estimator call. `SamplerGraphs` holds one decoder's graphs, keyed by the
decoder and its pack generation (models/unet.py GradLogPEstimator2d: every
pack and load_state_dict makes new weight tensors, and a graph captured
before reads freed memory, so the cache drops every graph of an older
generation), the sampler, the guidance (rows, scales, stride), the sample's
shape (rows B, frame bucket T, F), the estimator's routes and the f32 math
modes (TF32); within an
entry one graph per step kind: "full" (the 3B-row guidance call) and, with
a guidance stride, "cheap" (B rows). The first step of a kind in an entry
runs eagerly on a side stream (PyTorch's warm-up before a capture: each
kernel's first-call setup, cuBLAS's workspaces and any pack a route makes
on the spot happen there) and is the request's real step; the capture
after it records the next one without running it. Graphs of one decoder
share one memory pool; the static state's result is copied out before the
next capture or replay. A failed capture or replay raises: nothing falls
back to the eager loop.

Launch counts: a replay calls no kernel wrapper, so a capture records how
many launches each wrapper (ops.kernel_wrappers) counted while it ran,
takes them back off the counters (a capture runs nothing), and every
replay adds them again: the counters count the launches that ran on the
card, eager or replayed. A replay runs no module's forward either: hooks
registered with register_replay_hook see each replay's estimator rows, as
a forward pre-hook sees an eager call's.

The sampler runs eagerly where `graphs_for` returns None: on the CPU, and
at world > 1 (a data or sequence shard, a model-sharded decoder, or a
process group of more than one rank), whose collectives run through the
host over gloo (PERF.md §5), which a graph does not capture.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field

import torch
from torch.utils.hooks import RemovableHandle

from unitspeech_tpu_torch.models.diffusion import SamplerState, sampler_step
from unitspeech_tpu_torch.ops import kernel_wrappers
from unitspeech_tpu_torch.parallel.mesh import world_size

# hooks called with a replayed step's estimator rows (register_replay_hook)
_REPLAY_HOOKS: collections.OrderedDict = collections.OrderedDict()


def register_replay_hook(hook):
    """Call hook(rows) at every sampler step replay, over every cache, rows
    the batch rows of its estimator call (the counterpart of a global
    forward pre-hook on the estimator, which a replay does not run).
    Returns a handle whose remove() unregisters it."""
    handle = RemovableHandle(_REPLAY_HOOKS)
    _REPLAY_HOOKS[handle.id] = hook
    return handle


class CudaCapture:
    """Capture and warm-up on the card, as PyTorch's CUDA graph docs
    prescribe: the warm-up on a side stream, the capture in "global" error
    mode (a call that is unsafe during a capture, from any thread, fails
    it)."""

    def takes(self, x: torch.Tensor) -> bool:
        return x.is_cuda

    def pool(self):
        return torch.cuda.graph_pool_handle()

    def warm(self, fn, device) -> None:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(device).wait_stream(side)

    def capture(self, fn, pool):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="global"):
            fn()
        return graph


@dataclass
class _Graph:
    """A captured step: the graph, what each wrapper launched in it, and
    the estimator rows of its call."""

    graph: object
    launches: dict
    rows: int


@dataclass
class _Entry:
    """One key's static state (tables and noises for `steps` steps) and
    its graphs by step kind."""

    state: SamplerState
    steps: int
    graphs: dict = field(default_factory=dict)


class SamplerGraphs:
    """The sampler step graphs of one decoder (graphs_for keeps one on the
    decoder). backend: CudaCapture on the card; the CPU tests pass a
    stand-in with the same four methods."""

    def __init__(self, backend=None):
        self.backend = backend or CudaCapture()
        self.entries: dict = {}
        self.generation = None
        self.min_steps = 0
        self._pool = None
        self.captures = 0
        self.capture_s = 0.0  # host seconds in captures, warm-up steps not included
        self.replays = 0

    def reserve(self, steps: int) -> None:
        """Size new entries' tables and noises for requests of up to `steps`
        steps, so that a warm-up of fewer steps captures graphs that those
        requests replay (a longer request recaptures its key)."""
        self.min_steps = max(self.min_steps, int(steps))

    def clear(self) -> None:
        """Drop every graph and static state (their memory returns to the
        allocator once nothing else holds the pool)."""
        self.entries.clear()
        self._pool = None

    def key(self, model, name: str, st: SamplerState) -> tuple:
        est = model.estimator
        routes = (est.use_kernels, est.use_int8_deep, est.use_deep, est.use_resample,
                  est.use_i8pre_deep, est.dtype)
        # the math modes a capture bakes in (utils/precision.strict_f32 turns
        # TF32 off around a request)
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                torch.get_float32_matmul_precision())
        return (id(model), name, st.n_rows, st.scales, st.delta is not None,
                tuple(st.xt.shape), st.xt.device, routes, tf32)

    def run(self, model, name: str, st: SamplerState, kinds) -> torch.Tensor:
        """Run the steps `kinds` of sampler `name` from state st (a fresh
        request's, models/diffusion.SamplerState.start) by graph replays,
        capturing a kind's graph where its key has none. Returns the static
        sample: copy it out before the next call."""
        generation = model.estimator.pack_generation
        if generation != self.generation:
            self.clear()
            self.generation = generation
        key = self.key(model, name, st)
        entry = self.entries.get(key)
        if entry is None or entry.steps < len(kinds):
            steps = max(len(kinds), self.min_steps)
            # normal tensors: a request under inference_mode (the serving
            # dispatcher's) and one outside it both write them in place
            with torch.inference_mode(False):
                entry = self.entries[key] = _Entry(st.like(steps), steps)
        entry.state.load(st)
        for kind in kinds:
            g = entry.graphs.get(kind)
            if g is None:
                entry.graphs[kind] = self._capture(model, name, entry.state, kind)
            else:
                self._replay(g)
        return entry.state.xt

    def _capture(self, model, name, state, kind) -> _Graph:
        """This step eagerly (the warm-up), then its graph."""
        def step():
            sampler_step(model, name, state, kind)

        self.backend.warm(step, state.xt.device)
        if self._pool is None:
            self._pool = self.backend.pool()
        counters = kernel_wrappers()
        before = {k: w.launches for k, w in counters.items()}
        t0 = time.perf_counter()
        graph = self.backend.capture(step, self._pool)
        self.capture_s += time.perf_counter() - t0
        self.captures += 1
        launches = {k: w.launches - before[k] for k, w in counters.items()
                    if w.launches != before[k]}
        for k in launches:  # the capture launched nothing
            counters[k].launches = before[k]
        rows = state.xt.shape[0] * (state.n_rows if kind == "full" else 1)
        return _Graph(graph, launches, rows)

    def _replay(self, g: _Graph) -> None:
        g.graph.replay()
        counters = kernel_wrappers()
        for k, n in g.launches.items():
            counters[k].launches += n
        for hook in list(_REPLAY_HOOKS.values()):
            hook(g.rows)
        self.replays += 1


def graphs_for(decoder, x: torch.Tensor, shard=None, seq_shard=None):
    """The decoder's SamplerGraphs where its sampler runs as CUDA graph
    replays: x (the sample's conditioning) on the card, at world 1. At
    world > 1 the sampler stays eager, an explicit branch and no fallback:
    a data shard or a seq shard of the sample, a decoder sharded over the
    model axis (parallel.shard_params_tp) or a process group of more than
    one rank runs collectives through the host over gloo inside the steps,
    which a graph does not capture. Returns None where the steps run
    eagerly."""
    if shard is not None or seq_shard is not None or decoder.estimator.tp is not None \
            or world_size() > 1:
        return None
    cache = decoder.__dict__.get("_sampler_graphs")
    if cache is None:
        cache = decoder.__dict__["_sampler_graphs"] = SamplerGraphs()
    return cache if cache.backend.takes(x) else None
