"""CUDA graphs of the engines' steps.

No reference counterpart: :class:`StepGraphs` stands in for ``jax.jit``
with ``donate_argnums``.  An engine registers each of its steps once per
declared shape (:meth:`StepGraphs.add`): a function and its static
arguments -- the model, the engine's own caches, and input tensors that
the engine refills before every run (:meth:`StepGraphs.put`).  On the card
the step is captured there and then as one CUDA graph, and
:meth:`StepGraphs.run` replays it; on the CPU, or with ``graphs=False``,
``run`` calls the function eagerly on the same arguments, so that both
paths run the engine's same code.

On the card:

- Inputs: host arrays go through pinned memory (the caching host
  allocator keeps a pinned block until the copy that reads it has run), so
  no pageable host-to-device copy happens, least of all inside a capture.
- Warm-up, then capture, on one side stream per :class:`StepGraphs`: the
  step runs ``WARMUP`` times eagerly on that stream, then is captured on
  it.  The warm-up makes what is created at first use before the capture,
  so that none of it is first allocated in a graph's pool: the kernels'
  ``nvcc`` builds (``kernels._build``), the ``lru_cache``d device tensors
  (``layers._rope_freqs_on``) and the per-(device, stream) workspaces
  (``kernels.split_k_workspace``, the int8 attention's amax slots).  The
  warm-up runs are real steps: they write the caches, which the engine
  clears once its steps are registered.  Python's automatic garbage
  collection is off inside a capture (and left as the caller had it
  after): a collection there can free a CUDA graph that a caller's cyclic
  garbage holds (an engine kept by a closure or a test's traceback), a
  CUDA call that invalidates the capture.  An engine itself holds no
  reference cycle: dropped, it frees its graphs, pool and caches at once.
- Workspaces: the kernels key them by the stream they launch on, which for
  a graph is the side stream, and every graph is replayed on that same
  stream: :meth:`run` makes the side stream wait for the caller's current
  stream, replays, and makes the caller's stream wait for the side stream.
  A graph's launches and any eager launch on the side stream (another
  step's warm-up) therefore run in stream order, never at the same time.
  Each graph also holds the workspace tensors it was captured with, so
  that a later warm-up which grows a workspace never frees memory that a
  graph still writes.
- Memory: the graphs of one :class:`StepGraphs` share one pool, so that
  the widths do not each hold their own activations; every graph's static
  outputs stay referenced here, so no later capture reuses them.
- Launch accounting: the kernel wrappers count launches in Python
  (``wrapper.launches``), which a replay does not run.  A capture records
  how far each count moved (and puts it back: nothing ran), and every
  replay adds that to the wrapper's count.
- A capture that fails raises, naming the step and its shape.  There is
  no eager fallback on the card.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Hashable

import numpy as np
import torch

from repro_torch import kernels

# eager runs of a step on the side stream before its capture
WARMUP = 2


@dataclasses.dataclass
class _Step:
    fn: Callable
    args: tuple
    graph: Any = None                    # torch.cuda.CUDAGraph on the card
    out: Any = None                      # the graph's static outputs
    launches: tuple = ()                 # ((wrapper, launches a replay), ...)
    workspaces: tuple = ()               # kept alive for the graph


class StepGraphs:
    """An engine's steps: one CUDA graph per registered key on the card
    (``graphs=True``), eager calls on the CPU or with ``graphs=False``.

    ``captured`` lists the keys captured as graphs, in order;
    ``capture_s`` the seconds each capture took (its warm-up apart);
    :meth:`stats` both, and the bytes the shared pool holds."""

    def __init__(self, device: torch.device, *, graphs: bool = True):
        self.device = torch.device(device)
        self.graphed = bool(graphs) and self.device.type == "cuda"
        self._steps: dict[Hashable, _Step] = {}
        self.captured: list = []
        self.capture_s: dict = {}
        if self.graphed:
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()

    @staticmethod
    def put(static: torch.Tensor, value) -> None:
        """Copy ``value`` (a numpy array or a tensor) into ``static``; a
        host value bound for the card goes through pinned memory."""
        src = value if isinstance(value, torch.Tensor) \
            else torch.from_numpy(np.array(value))
        if static.is_cuda and src.is_cpu:
            src = src.pin_memory()
        static.copy_(src, non_blocking=static.is_cuda)

    def add(self, key: Hashable, fn: Callable, *args) -> None:
        """Register step ``key``: ``fn(*args)``, its tensors static.  On
        the card it is warmed up and captured now."""
        if key in self._steps:
            raise ValueError(f"step {key!r} is already registered")
        step = _Step(fn, args)
        if self.graphed:
            self._capture(key, step)
        self._steps[key] = step

    def _capture(self, key: Hashable, step: _Step) -> None:
        counters = list(kernels.launch_counters().values())
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        try:
            with torch.cuda.stream(self.stream):
                for _ in range(WARMUP):
                    step.fn(*step.args)
            before = [f.launches for f in counters]
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            # no automatic collection inside the capture: freeing a graph
            # that cyclic garbage holds there invalidates the capture
            # (``torch.cuda.graph`` collects explicitly before it begins)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self.pool,
                                      stream=self.stream):
                    out = step.fn(*step.args)
            finally:
                if collecting:
                    gc.enable()
                moved = [f.launches - n for f, n in zip(counters, before)]
                for f, n in zip(counters, before):
                    f.launches = n
            self.capture_s[key] = time.perf_counter() - t0
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture of step {key!r} "
                               f"failed: {e}") from e
        finally:
            cur.wait_stream(self.stream)
        step.graph, step.out = graph, out
        step.launches = tuple((f, n) for f, n in zip(counters, moved) if n)
        step.workspaces = kernels.stream_workspaces(self.device,
                                                    self.stream.cuda_stream)
        self.captured.append(key)

    def run(self, key: Hashable):
        """Run step ``key`` on its static arguments: replay its graph (its
        static outputs, overwritten by the next replay), or call it."""
        step = self._steps.get(key)
        if step is None:
            raise KeyError(f"step {key!r} was never registered; registered: "
                           f"{list(self._steps)}")
        if step.graph is None:
            return step.fn(*step.args)
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            step.graph.replay()
        cur.wait_stream(self.stream)
        for f, n in step.launches:
            f.launches += n
        return step.out

    def stats(self) -> dict:
        """The keys captured as graphs (none on the CPU or with
        ``graphs=False``), the seconds each capture took and the bytes of
        device memory the graphs' shared pool holds."""
        pool_bytes = 0
        if self.captured:
            pool = tuple(self.pool)
            pool_bytes = sum(
                seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", ())) == pool)
        return {"graphs": [list(k) if isinstance(k, tuple) else k
                           for k in self.captured],
                "capture_s": {str(k): v for k, v in self.capture_s.items()},
                "pool_bytes": pool_bytes}
