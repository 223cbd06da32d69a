"""Meshes over ``torch.distributed`` (port of ``repro.launch.mesh``), and
the helpers that start their ranks.

The reference's mesh is a grid of the devices one controller sees; the
port's is a grid of processes, one per device, each running the same
program (:class:`~repro_torch.parallel.sharding.Mesh`).  The functions
here build it collectively over the initialised process group, which
:func:`spawn` and :class:`RankPool` start: ``data * model`` processes over
NCCL where every rank has its own GPU, or over gloo on the CPU.  The
backend is never chosen quietly: ranks that share one GPU must ask for
``backend="gloo"`` by name (NCCL refuses two ranks on one card, and gloo
stages CUDA tensors through the host).  Like the port's other entry
points they run on the card unless the caller asks for the CPU
(``device="cpu"``), and raise where there is no card.

    from repro_torch.launch import mesh as M
    outs = M.spawn(fn, world=8, device="cpu")    # fn(*args) on 8 gloo ranks
    # inside fn: mesh = M.make_debug_mesh(2, 4, device="cpu")
"""
from __future__ import annotations

import datetime
import queue
import socket
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device
from repro_torch.parallel.sharding import Mesh

# a collective that waits longer than this raises instead of hanging
COLLECTIVE_TIMEOUT_S = 300.0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def choose_backend(device, world: int, backend: str | None = None) -> str:
    """The process group's backend: ``backend`` when given; else gloo on
    the CPU and NCCL on CUDA when every one of the ``world`` ranks has a
    GPU of its own.  CUDA ranks sharing a GPU raise unless ``backend="gloo"``
    was asked for by name."""
    dev = torch.device(device)
    if backend is not None:
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                             f"{backend!r}")
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError("NCCL needs CUDA ranks")
        return backend
    if dev.type != "cuda":
        return "gloo"
    n = torch.cuda.device_count()
    if world > n:
        raise ValueError(
            f"{world} CUDA ranks on {n} GPU(s): NCCL needs one GPU a rank; "
            "pass backend='gloo' to share a GPU (collectives staged through "
            "the host, no CUDA graphs)")
    return "nccl"


def rank_device(device, rank: int, backend: str) -> torch.device:
    """A rank's device: its own GPU under NCCL, the one given otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and backend == "nccl":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_group(rank: int, world: int, port: int, backend: str,
               device) -> torch.device:
    """Join the process group at ``tcp://127.0.0.1:port``; returns this
    rank's device (made the current CUDA device under NCCL)."""
    dev = rank_device(device, rank, backend)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return dev


def _world_device(device) -> tuple[torch.device, str]:
    """(this rank's device, the group's backend): ``device`` as given, else
    the rank's GPU (the current one under NCCL), raising without one."""
    backend = dist.get_backend()
    if device is None and backend == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = resolve_device(device)
    return rank_device(dev, dist.get_rank(), backend), backend


def make_debug_mesh(data: int = 1, model: int = 1, *, device=None,
                    backend: str | None = None) -> Mesh:
    """A ``(data, model)`` mesh over the first ``data * model`` ranks of
    the process group, built collectively (every rank calls it; a rank
    past them gets a mesh it is no member of).

    Raises, naming the ranks it needs, when the group is smaller, as the
    reference raises for too few devices.  A ``(1, 1)`` mesh with no group
    initialised starts a world of one itself (``backend`` as
    :func:`choose_backend` gives it for ``device``).  ``device`` defaults
    to the rank's GPU and raises where there is none: the CPU is asked for
    with ``device="cpu"``."""
    n = data * model
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(
                f"mesh ({data}, {model}) needs {n} devices (ranks of an "
                "initialised process group), have 1 -- start them with "
                f"repro_torch.launch.mesh.spawn(fn, world={n})")
        dev = resolve_device(device)
        init_group(0, 1, _free_port(), choose_backend(dev, 1, backend), dev)
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"mesh ({data}, {model}) needs {n} devices "
                         f"(ranks), have {world}")
    dev, backend = _world_device(device)
    return Mesh(("data", "model"), (data, model), tuple(range(n)),
                device=dev, backend=backend)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 ``(data, model)`` or 2x16x16 ``(pod, data, model)``: 256 or
    512 ranks, raising below that world size (``device`` as
    :func:`make_debug_mesh` takes it)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {n} devices (ranks), have {world}")
    dev, backend = _world_device(device)
    return Mesh(axes, shape, tuple(range(n)), device=dev, backend=backend)


def parse_mesh(spec: str | None, *, device=None,
               backend: str | None = None) -> Mesh | None:
    """``"DATAxMODEL"`` (e.g. ``"2x4"``) -> debug mesh; None / "" -> None."""
    if not spec:
        return None
    return make_debug_mesh(*mesh_shape(spec), device=device, backend=backend)


def mesh_shape(spec: str) -> tuple[int, int]:
    """``"DATAxMODEL"`` -> (data, model), without building anything."""
    parts = spec.lower().split("x")
    if len(parts) != 2:
        raise ValueError(f"mesh spec must be DATAxMODEL, got {spec!r}")
    return int(parts[0]), int(parts[1])


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------


def spawn(fn, *args, world: int, device=None, backend: str | None = None,
          timeout: float = 3600.0) -> list:
    """Run ``fn(*args)`` on ``world`` new processes joined in one process
    group (``device`` the card unless the CPU is asked for; ``backend`` as
    :func:`choose_backend` gives it for ``device``);
    returns every rank's result, by rank, and stops the processes.  ``fn``
    and its arguments must pickle (a module-level function).  A rank that
    raises fails the call: the others are killed and the error, with the
    rank's traceback, raises here."""
    with RankPool(world, device=device, backend=backend,
                  timeout=timeout) as pool:
        return pool.run(fn, *args)


def _pool_worker(rank, world, port, backend, device, tasks, results):
    torch.set_num_threads(1)
    try:
        init_group(rank, world, port, backend, device)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = task
        try:
            results.put((rank, True, fn(*args)))
        except Exception:
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` ranks started once, each waiting for tasks: :meth:`run`
    calls ``fn(*args)`` on every rank and returns their results by rank.

    For a file of tests that each need a mesh: the ranks pay their start
    and their imports once.  A rank that raises fails the run (its
    traceback in the error) and closes the pool; the next run starts a new
    one.  ``timeout`` bounds each run's wait for every result."""

    def __init__(self, world: int, *, device=None,
                 backend: str | None = None, timeout: float = 600.0):
        self.world = world
        self.device = str(resolve_device(device))
        self.backend = choose_backend(self.device, world, backend)
        self.timeout = timeout
        self._procs: list = []

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        port = _free_port()
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.world)]
        self._procs = [ctx.Process(
            target=_pool_worker, args=(r, self.world, port, self.backend,
                                       self.device, self._tasks[r],
                                       self._results), daemon=True)
            for r in range(self.world)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args) -> list:
        if not self._procs:
            self._start()
        for q in self._tasks:
            q.put((fn, args))
        out, errors = {}, []
        try:
            for _ in range(self.world):
                rank, ok, value = self._results.get(timeout=self.timeout)
                if ok:
                    out[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    break
        except queue.Empty:
            errors.append(f"no result within {self.timeout} s")
        if errors:
            self.close(kill=True)
            raise RuntimeError("a rank failed: " + "\n".join(errors))
        return [out[r] for r in range(self.world)]

    def close(self, kill: bool = False) -> None:
        """Stop every rank (at once with ``kill``)."""
        if not self._procs:
            return
        if not kill:
            for q in self._tasks:
                q.put(None)
        for p in self._procs:
            if kill:
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(kill=exc[0] is not None)
