"""CUDA graphs: the port's counterpart of ``jax.jit`` on the engine's path.

The JAX engine runs a decode megastep and a prefill wave as one XLA
dispatch each, compiled once per static key. Here each is a CUDA graph,
captured once per key (``EngineCore`` builds the keys: width, megastep
length and sampling variant for decode; token bucket and sampling variant
for a prefill wave; token bucket, width, sample width (1, or spec_k + 1
with verify rows) and sampling variant for a mixed step, and the megastep
length too for a fused one; token bucket, width, megastep length and
sampling variant for a drafting megastep) and replayed as one launch. All graphs of an engine share one
memory pool: replays run one at a time on one stream, so a graph's
temporaries may reuse another's.

A graph's inputs are ONE static int32 buffer on the card. The host packs
every per-dispatch array into one int32 array (:class:`Layout`; f32
fields travel as their bits, bool fields as 0/1), and the replay starts
with one copy from pinned host memory into that buffer. The same packed
array, wrapped as a tensor, feeds the eager body on the CPU, so both
devices run the same unpacking.

Capture records the attention kernel's launches without running them, so
:class:`GraphCache` takes them back off the launch counters and adds each
graph's launches again on every replay: the counters count the kernels
that ran. A rank's collectives and a pipeline stage's hops (NCCL,
captured with the forward; ``parallel/comm.py``) are counted the same
way.

cuBLAS keeps its handles per thread and creates one at a thread's first
matrix product, which must not happen inside a capture; the engine's
steps may run on a thread that has not multiplied yet (the worker runs
them through ``asyncio.to_thread``), so a capture first runs the model's
two kinds of product once, outside the capture, on its own thread.

Nothing here falls back: a capture or a replay that fails raises.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from dynamo_tpu_torch.ops import ragged_attention
from dynamo_tpu_torch.parallel import comm

_KINDS = {"i": np.int32, "f": np.float32, "b": np.bool_}


class Layout:
    """Named arrays of fixed shapes packed into one int32 buffer. Each
    field is ``(name, shape, kind)``: kind ``i`` is int32, ``f`` float32
    (its bits), ``b`` bool (0 or 1)."""

    def __init__(self, fields: list[tuple[str, tuple[int, ...], str]]):
        self.spec = list(fields)
        self.fields: dict[str, tuple[int, tuple[int, ...], str]] = {}
        off = 0
        for name, shape, kind in fields:
            self.fields[name] = (off, tuple(shape), kind)
            off += int(np.prod(shape, dtype=np.int64))
        self.size = off

    def pack(self, arrays: dict[str, np.ndarray]) -> np.ndarray:
        out = np.empty(self.size, np.int32)
        for name, (off, shape, kind) in self.fields.items():
            a = np.asarray(arrays[name], _KINDS[kind]).reshape(-1)
            n = a.size
            if a.shape != (int(np.prod(shape, dtype=np.int64)),):
                raise ValueError(f"field {name}: shape {a.shape}, layout {shape}")
            out[off : off + n] = a.view(np.int32) if kind == "f" else a
        return out

    def field(self, buf: torch.Tensor, name: str) -> torch.Tensor:
        """The raw int32 view of one field of a packed buffer."""
        off, shape, _ = self.fields[name]
        return buf[off : off + int(np.prod(shape, dtype=np.int64))].view(shape)

    def unpack(self, buf: torch.Tensor) -> dict[str, torch.Tensor]:
        out = {}
        for name, (_, _, kind) in self.fields.items():
            v = self.field(buf, name)
            out[name] = v.view(torch.float32) if kind == "f" else (v != 0) if kind == "b" else v
        return out


@dataclass
class Launch:
    """One dispatch, ready to run: its graph key, the host arrays packed
    by ``layout``, and the body that computes it from a packed buffer on
    the engine's device (a tuple of output tensors)."""

    key: tuple
    layout: Layout
    packed: np.ndarray
    body: Callable[[torch.Tensor], tuple]
    # Run the body eagerly on the card too, never captured (a multimodal
    # dispatch: its embedding rows ride beside the packed buffer).
    eager: bool = False


@dataclass
class Graph:
    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor        # the packed input buffer
    outputs: tuple                 # the body's outputs, in the graph's pool
    launches: dict[str, int]       # attention launches per replay, by C entry point
    collectives: dict[str, int]    # collective calls per replay (tensor parallelism)


_thread = threading.local()


def _prime_cublas(device: torch.device) -> None:
    """Create this thread's cuBLAS handles, outside any capture, with the
    products the model runs: bf16 with an f32 result, and f32."""
    if getattr(_thread, "primed", False):
        return
    a = torch.zeros(16, 16, dtype=torch.bfloat16, device=device)
    torch.mm(a, a, out_dtype=torch.float32)
    a.float() @ a.float()
    torch.cuda.synchronize(device)
    _thread.primed = True


class GraphCache:
    """One engine's captured graphs, keyed by the static key of each
    dispatch, in one shared memory pool."""

    def __init__(self):
        self._graphs: dict[tuple, Graph] = {}
        self._pool = None
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def __contains__(self, key: tuple) -> bool:
        return key in self._graphs

    def capture(self, launch: Launch, device: torch.device) -> Graph:
        """Capture ``launch.body`` on a zeroed static buffer (capture runs
        nothing on the card; it synchronises the card first)."""
        t0 = time.perf_counter()
        _prime_cublas(device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static_in = torch.zeros(launch.layout.size, dtype=torch.int32, device=device)
        before = dict(ragged_attention.kernel_launches)
        calls_before = dict(comm.calls)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=self._pool, capture_error_mode="thread_local"):
            outputs = launch.body(static_in)
        launches = {k: ragged_attention.kernel_launches[k] - n for k, n in before.items()}
        ragged_attention.kernel_launches.update(before)  # recorded, not run
        collectives = {k: comm.calls[k] - n for k, n in calls_before.items()}
        comm.calls.update(calls_before)
        graph = self._graphs[launch.key] = Graph(g, static_in, outputs, launches, collectives)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return graph

    def replay(self, launch: Launch, feed: Callable | None = None) -> tuple:
        """Copy the packed inputs in, let ``feed(static_in)`` write its
        device-resident slots, replay, and return copies of the outputs
        that this dispatch owns (the next replay of any graph in the pool
        may overwrite the graph's own)."""
        graph = self._graphs[launch.key]
        pinned = torch.from_numpy(launch.packed).pin_memory()
        graph.static_in.copy_(pinned, non_blocking=True)
        if feed is not None:
            feed(graph.static_in)
        graph.graph.replay()
        self.replays += 1
        for name, n in graph.launches.items():
            ragged_attention.kernel_launches[name] += n
        for name, n in graph.collectives.items():
            comm.calls[name] += n
        return tuple(o.clone() for o in graph.outputs)
