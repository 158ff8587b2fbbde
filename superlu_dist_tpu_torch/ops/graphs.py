"""Captured CUDA graphs: the port's counterpart of the reference's
jitted programs with donated buffers.

The reference compiles one XLA program per merged segment of the
factor and solve sweeps (ops/batched.py `_staged_factor_segment`,
ops/trisolve.py `_staged_fwd_segment`) or per whole phase
(`_phase_fns`, `_solve_packed_fn`), keyed by static metadata, and
donates the buffers that stream through them.  Here each such program
is a Python body that runs eagerly on the CPU and, on the card, is
captured once into a CUDA graph and replayed:

  * a graph bakes in the addresses it was captured with, so a body
    reads and writes only static tensors allocated before the capture
    (inputs filled with `copy_` before a replay, buffers updated in
    place, outputs copied out by the caller) and device index sets
    uploaded before it;
  * a `GraphSet` holds the graphs of one owner (a schedule's factor
    programs, a handle's solve programs) with one shared memory pool,
    so that the temporaries of one graph reuse those of another
    instead of each graph keeping a private pool; its graphs must not
    run concurrently;
  * the kernel wrappers count launches (in all and per lane) on the
    host, where a capture records but launches nothing, so each `Graph`
    keeps the counts its capture made and adds them on every replay;
  * nothing falls back: a capture that fails raises.
"""

from __future__ import annotations

import gc
import threading
from typing import Callable, Hashable

import torch

from . import _cuda
from .df64_spmv import df64_ell_spmv
from .ea_scatter import ea_scatter_add
from .lsum import lsum_panel
from .panel_lu import partial_lu_batch

# every wrapper whose `launches` and `lanes` a replay carries forward:
# the factor and solve sweeps' kernels (K1–K3) and the doubleword
# residual's (K4)
COUNTED = (partial_lu_batch, ea_scatter_add, lsum_panel, df64_ell_spmv)

_lock = threading.Lock()
_streams: dict = {}


def on_card(device) -> bool:
    """Whether bodies on `device` run as captured graphs (the card) or
    eagerly (the CPU)."""
    return torch.device(device).type == "cuda"


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The device's capture stream, made once per process together with
    what a capture must not be the first to meet: the kernel libraries
    and cuBLAS's handle and workspace for this stream."""
    key = device.index if device.index is not None else \
        torch.cuda.current_device()
    with _lock:
        s = _streams.get(key)
        if s is not None:
            return s
        for name in _cuda.SOURCES:
            _cuda.library(name)
        s = torch.cuda.Stream(device)
        s.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(s):
            for dt in (torch.float32, torch.float64):
                a = torch.ones(2, 8, 8, dtype=dt, device=device)
                torch.bmm(a, a)
        s.synchronize()
        _streams[key] = s
        return s


class Graph:
    """One captured body and the kernel launches its capture recorded."""

    def __init__(self, body: Callable[[], None], device: torch.device,
                 pool):
        s = _capture_stream(device)
        before = [(f.launches, f.lanes.copy()) for f in COUNTED]
        graph = torch.cuda.CUDAGraph()
        s.wait_stream(torch.cuda.current_stream(device))
        # no garbage collection inside the capture: a collection there
        # can free another graph (held in a reference cycle, as a fused
        # context is), and destroying a graph while a stream captures
        # is refused by CUDA and invalidates this capture
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(s):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    body()
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass            # the capture was already invalid
                    raise
                graph.capture_end()
        finally:
            if gc_on:
                gc.enable()
            # the capture launched nothing: its counts belong to replays
            self.launches = tuple(f.launches - b
                                  for f, (b, _) in zip(COUNTED, before))
            self.lanes = tuple(f.lanes - lb
                               for f, (_, lb) in zip(COUNTED, before))
            for f, (b, lb) in zip(COUNTED, before):
                f.launches = b
                f.lanes.clear()
                f.lanes.update(lb)
        torch.cuda.current_stream(device).wait_stream(s)
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()
        for f, n, ln in zip(COUNTED, self.launches, self.lanes):
            f.launches += n
            f.lanes.update(ln)


class GraphSet:
    """The graphs of one owner, keyed like the reference's jit caches,
    sharing one memory pool, and the static tensors they were captured
    with (`static`, built by the owner)."""

    def __init__(self, device, static=None):
        self.device = torch.device(device)
        self.static = static
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: dict = {}
        # held by the caller from filling the static inputs to copying
        # out the results: two runs would share the static tensors
        self.lock = threading.Lock()

    def capture(self, key: Hashable, body: Callable[[], None]) -> bool:
        """Capture `body` for `key` unless a graph of `key` exists;
        True when it captured."""
        if key in self.graphs:
            return False
        self.graphs[key] = Graph(body, self.device, self.pool)
        return True

    def run(self, key: Hashable, body: Callable[[], None]) -> None:
        """Replay the graph of `key`, capturing `body` first when there
        is none."""
        self.capture(key, body)
        self.graphs[key].replay()


def graph_set(owner, key: Hashable, device, make_static):
    """The GraphSet cached on `owner` (a schedule or a factor handle)
    under (`key`, device), built with `make_static()` on first use."""
    dev = torch.device(device)
    with _lock:
        cache = owner.__dict__.setdefault("_graph_sets", {})
        full = (key, str(dev))
        gs = cache.get(full)
        if gs is None:
            gs = cache[full] = GraphSet(dev, make_static())
        return gs


def graph_count(owner) -> int:
    """Graphs captured on `owner` so far (all its GraphSets)."""
    return sum(len(gs.graphs)
               for gs in owner.__dict__.get("_graph_sets", {}).values())
