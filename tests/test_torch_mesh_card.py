"""Mesh-parallel serving on the card (``-m cuda``; skipped without one).

Two holds of ``chip_smoke.py``'s mesh phase at the reduced Yi-9B: a (1, 1)
mesh over NCCL whose steps are CUDA graphs holding the collectives, and a
(1, 2) mesh of two ranks sharing the card over gloo with eager steps, each
serving the unmeshed engine's tokens.  The CPU holds against the
reference are ``tests/test_torch_parallel.py``.
"""
import numpy as np
import pytest
import torch

import _torch_mesh_rows as R
from _torch_parity import cuda_device  # noqa: F401
from repro_torch.launch import mesh as M
from repro_torch.parallel import sharding as shd
from repro_torch.serve import engine as E


def _requests(cfg) -> list[dict]:
    rng = np.random.default_rng(1)
    return [dict(prompt=rng.integers(2, cfg.vocab, n).tolist(),
                 max_new_tokens=4, eos_id=-1) for n in (5, 3, 7)]


def _model(cfg, device):
    return R.seeded_model(cfg, device)


@pytest.mark.cuda
def test_mesh_1x1_nccl_graphs_equal_unmeshed(cuda_device):
    cfg = R.lm_config("yi-9b")
    model = _model(cfg, cuda_device)
    reqs = [E.Request(**r) for r in _requests(cfg)]
    base = E.ServeEngine(model, cfg, **R.engine_kw(device=cuda_device)
                         ).generate(reqs)
    made = not torch.distributed.is_initialized()
    try:
        mesh = M.make_debug_mesh(1, 1, device=cuda_device)
        assert mesh.backend == "nccl"
        n0 = sum(shd.COLLECTIVES.values())
        eng = E.ServeEngine(model, cfg, mesh=mesh,
                            **R.engine_kw(device=cuda_device))
        assert eng.graphs.captured and sum(shd.COLLECTIVES.values()) > n0
        n1 = sum(shd.COLLECTIVES.values())
        assert eng.generate(reqs) == base
        assert sum(shd.COLLECTIVES.values()) == n1    # all in the graphs
    finally:
        if made:
            torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_equal_unmeshed(cuda_device):
    cfg = R.lm_config("yi-9b")
    reqs = _requests(cfg)
    base = E.ServeEngine(_model(cfg, cuda_device), cfg,
                         **R.engine_kw(device=cuda_device)).generate(
        [E.Request(**r) for r in reqs])
    with pytest.raises(ValueError, match="backend='gloo'"):
        M.choose_backend("cuda", torch.cuda.device_count() + 1)
    outs = M.spawn(R.gloo_rank, reqs, world=2, device="cuda",
                   backend="gloo", timeout=300)
    assert outs == [base, base]
