"""The rank side of ``tests/test_torch_parallel.py``: functions each rank
of a ``repro_torch.launch.mesh.RankPool`` runs.  Imports neither JAX nor
the reference, so that the ranks start quickly; the test process runs the
reference and sends the weights as numpy trees."""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_vision_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.serve import engine as E
from repro_torch.vision import models as vmodels
from repro_torch.vision.engine import ImageRequest, VisionEngine


def lm_config(arch: str):
    """The reduced config with MoE capacity lifted (no drops: chunked
    prefill and decode route identically), as the reference's mesh tests
    take it."""
    return dataclasses.replace(get_config(arch, reduced=True),
                               capacity_factor=64.0)


def engine_kw(**kw) -> dict:
    out = dict(batch_slots=2, max_len=32, prefill_chunk=4, temperature=0.0,
               seed=0, device="cpu")
    out.update(kw)
    return out


def serve_recorded(model, cfg, requests: list[dict], mesh=None, **kw):
    """(tokens, the logits rows of every chunk step, the engine)."""
    eng = E.ServeEngine(model, cfg, mesh=mesh, **engine_kw(**kw))
    rows, step = [], eng._step

    def recording(*args):
        nxt, caches, sel = step(*args)
        rows.append(sel.float().numpy().copy())
        return nxt, caches, sel

    eng._step = recording
    tokens = eng.generate([E.Request(**r) for r in requests])
    return tokens, rows, eng


def serve_row(arch: str, tree: dict, mesh_shape, requests: list[dict],
              kw: dict):
    """One row: the unmeshed engine, then the engine on a ``mesh_shape``
    mesh, on the weights of the reference tree ``tree``."""
    cfg = lm_config(arch)
    model = lm_params_from_jax(tree, cfg, device="cpu")
    mesh = M.make_debug_mesh(*mesh_shape, device="cpu")
    if not mesh.member:
        return None
    base, base_rows, _ = serve_recorded(model, cfg, requests, **kw)
    got, rows, eng = serve_recorded(model, cfg, requests, mesh=mesh, **kw)
    lead = mesh.rank == 0
    return {"base": base, "meshed": got, "mesh": eng.last_stats["mesh"],
            "param_bytes": eng.param_bytes,
            "base_rows": base_rows if lead else None,
            "rows": rows if lead else None}


def vision_row(mesh_shape, batch_slots: int, n_images: int):
    """The reduced ResNet-50 served unmeshed and data-parallel on a
    ``mesh_shape`` mesh: (outputs, meshed outputs, the mesh stats)."""
    cfg = get_vision_config("resnet50", reduced=True)
    model = vmodels.init(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    mesh = M.make_debug_mesh(*mesh_shape, device="cpu")
    if not mesh.member:
        return None
    rng = np.random.default_rng(0)
    reqs = [ImageRequest(image=rng.standard_normal(
        (*cfg.input_hw, cfg.in_channels)).astype(np.float32))
        for _ in range(n_images)]
    outs = []
    for m in (None, mesh):
        eng = VisionEngine(model, cfg, batch_slots=batch_slots, mesh=m,
                           device="cpu")
        eng.warmup()
        outs.append((eng.infer(reqs), eng.last_stats))
    (base, _), (meshed, st) = outs
    return base, meshed, st.get("mesh")


def seeded_model(cfg, device):
    return T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device=device)


def gloo_rank(requests: list[dict]) -> list:
    """A rank of a (1, 2) mesh over gloo on the card (ranks sharing it),
    eager: its tokens of the reduced Yi-9B."""
    cfg = lm_config("yi-9b")
    mesh = M.make_debug_mesh(1, 2, device="cuda")
    eng = E.ServeEngine(seeded_model(cfg, "cuda"), cfg, mesh=mesh,
                        graphs=False, **engine_kw(device="cuda"))
    return eng.generate([E.Request(**r) for r in requests])


def placement_row(mesh_shape):
    """This rank's coordinate and its blocks of two whole tensors placed
    by ``place_tree`` under a cache-like spec (slots over ``batch``, dim 1
    over ``model`` where it divides), with their ``ShardInfo`` axes."""
    from repro_torch.parallel import sharding as shd
    mesh = M.make_debug_mesh(*mesh_shape, device="cpu")
    tree = {"a": torch.arange(8 * 8 * 6, dtype=torch.float32)
            .reshape(8, 8, 6),
            "b": [torch.arange(8 * 6 * 2, dtype=torch.float32)
                  .reshape(8, 6, 2)]}
    shd.place_tree(tree, mesh, lambda path, shape: ("batch", "model")
                   + (None,) * (len(shape) - 2))
    return mesh.coord, {k: (t.numpy(), shd.info(t).axes) for k, t in
                        (("a", tree["a"]), ("b", tree["b"][0]))}


def groups_row(mesh_shape):
    """The sets of axes the mesh made process groups over, and this rank's
    members of each; and whether a set it did not make raises."""
    mesh = M.make_debug_mesh(*mesh_shape, device="cpu")
    try:
        mesh.group_of(())
        refused = False
    except ValueError:
        refused = True
    return mesh.coord, {axes: mesh.group_of(axes)[1]
                        for axes in mesh._groups}, refused


@contextlib.contextmanager
def world_of_one():
    """A ``(1, 1)`` mesh in this process (a world of one over gloo), the
    process group destroyed afterwards if this made it."""
    made = not dist.is_initialized()
    try:
        yield M.make_debug_mesh(1, 1, device="cpu")
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
