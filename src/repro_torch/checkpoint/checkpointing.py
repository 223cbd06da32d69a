"""Atomic, hash-verified, keep-N checkpoints with async save (port of
``repro.checkpoint.checkpointing``, the same layout and guarantees).

Layout: ``<dir>/step_<N>/`` holding ``arrays.npz`` (each tensor of the
state, whole, as ``a0``, ``a1``, ...) and ``meta.json`` (the step, the
tensors' keys and dtypes, the sha256 of the npz and ``extra``, e.g. the
data iterator's state).  Writes go to ``step_<N>.tmp`` and are renamed
into place after the meta file is fsynced, so a crash mid-save never
corrupts the latest checkpoint; ``keep_n`` old checkpoints are removed
after each save.

A state is a tree of dicts whose leaves are tensors or ``nn.Module``s; a
tensor's key is its path, a module's tensors keyed by their
``state_dict`` names under it (``params.stages.0.layers.0.attn.wq``,
``opt.mu.embed``, ``step``).  numpy has no bfloat16, so a bfloat16 tensor
is stored as its int16 bit pattern and its dtype kept in ``meta.json``.
:meth:`CheckpointManager.restore` refuses a state of another structure
and writes the stored values into the template's tensors, in place.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
from torch import nn


def flatten(state: Any, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``(key, tensor)`` of every tensor of ``state``, in its order."""
    if isinstance(state, nn.Module):
        return [(prefix + k, t)
                for k, t in state.state_dict(keep_vars=True).items()]
    if isinstance(state, dict):
        return [kt for k, v in state.items()
                for kt in flatten(v, f"{prefix}{k}.")]
    if isinstance(state, torch.Tensor):
        return [(prefix[:-1], state)]
    raise TypeError(f"checkpoint: {prefix[:-1]!r} is a {type(state)}, not "
                    "a tensor, a module or a dict")


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` that nothing else writes: ``.cpu()`` of a CPU
    tensor is the tensor itself, and the training step updates its state
    in place while an async save is still writing."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, *, keep_n: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any, extra: dict | None = None) -> None:
        """Copy ``state`` to the host on the calling thread (a copy of its
        own, also of a CPU tensor), then write it (on a thread of its own
        with ``async_save``, after the previous save has finished)."""
        flat = flatten(state)
        keys = [k for k, _ in flat]
        dtypes = [str(t.dtype).removeprefix("torch.") for _, t in flat]
        arrs = [_host(t) for _, t in flat]
        args = (step, keys, dtypes, arrs, extra or {})
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(target=self._write, args=args,
                                            daemon=True)
            self._thread.start()
        else:
            self._write(*args)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, keys, dtypes, arrs, extra: dict) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        npz = os.path.join(tmp, "arrays.npz")
        np.savez(npz, **{f"a{i}": a for i, a in enumerate(arrs)})
        meta = {"step": step, "keys": keys, "dtypes": dtypes,
                "sha256": _sha256(npz), "extra": extra}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep_n)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, template: Any, step: int | None = None
                ) -> tuple[Any, dict]:
        """Write checkpoint ``step`` (default the latest) into the tensors
        of ``template``, in place, after checking its structure and its
        content hash; -> ``(template, extra)``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        flat = flatten(template)
        if [k for k, _ in flat] != meta["keys"]:
            raise ValueError("checkpoint tree structure mismatch")
        npz_path = os.path.join(d, "arrays.npz")
        if _sha256(npz_path) != meta["sha256"]:
            raise IOError(f"checkpoint {d} failed hash verification")
        with np.load(npz_path) as data:
            for i, ((_, t), dtype) in enumerate(zip(flat, meta["dtypes"])):
                src = torch.from_numpy(data[f"a{i}"])
                if dtype == "bfloat16":
                    src = src.view(torch.bfloat16)
                t.copy_(src)
        return template, meta["extra"]
