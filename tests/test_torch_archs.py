"""The port's counterpart of ``tests/test_archs_smoke.py`` over all ten LM
architectures: each reduced config built by the port's own
``transformer.init_params`` (a seeded ``torch.Generator``) runs its
forward and loss, a gradient of every parameter, two decode steps and a
chunked prefill with ragged ``valid`` equal to the one-token decode loop,
on the CPU; and the port's ``ARCH_IDS`` and parameter counts are the
reference's.

Tolerance of the prefill against the decode loop: rtol / atol 2e-3, the
reference test's own (a chunk and one token at a time are float32 sums in
other orders, and an MoE router's choice can follow them).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get_config
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import transformer as T
from repro_torch.train.train_step import trainable

B, S = 2, 16


def _model(cfg, seed: int = 0) -> T.LM:
    return T.init_params(cfg, generator=torch.Generator().manual_seed(seed),
                         device="cpu")


def _batch(cfg, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    batch = {"labels": torch.randint(0, cfg.vocab, (B, S), generator=g)}
    if cfg.frontend == "audio":
        batch["embeds"] = torch.randn((B, S, cfg.d_model), generator=g) * 0.02
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab, (B, S), generator=g)
    if cfg.frontend == "vlm":
        batch["pixel_embeds"] = torch.randn(
            (B, cfg.n_patches, cfg.d_model), generator=g) * 0.02
    return batch


def test_arch_ids_equal_reference():
    assert ARCH_IDS == J_ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_equals_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_loss(arch):
    cfg = get_config(arch, reduced=True)
    model = _model(cfg)
    batch = _batch(cfg)
    hidden, _ = T.forward(model, batch, cfg)
    exp_s = S + (cfg.n_patches if cfg.frontend == "vlm" else 0)
    assert hidden.shape == (B, exp_s, cfg.d_model)
    assert bool(torch.isfinite(hidden).all())
    with torch.no_grad():
        loss, metrics = T.loss_fn(model, batch, cfg)
    assert np.isfinite(float(loss))
    # untrained CE should be near log(vocab)
    assert float(metrics["ce"]) < np.log(cfg.vocab) * 2 + 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grad_step_finite(arch):
    cfg = get_config(arch, reduced=True)
    model = trainable(_model(cfg))
    params = dict(model.named_parameters())
    loss, _ = T.loss_fn(model, _batch(cfg), cfg)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    assert grads
    for name, g in zip(params, grads):
        assert bool(torch.isfinite(g).all()), name
    # the head's gradient reaches the embedding when the two are tied
    if cfg.tie_embeddings:
        assert float(dict(zip(params, grads))["embed"].abs().max()) > 0


def _feed(cfg, toks, embeds, b, t0: int, n: int) -> dict:
    if cfg.frontend == "audio":
        return {"embeds": embeds[b, t0:t0 + n]}
    return {"tokens": toks[b, t0:t0 + n]}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_step(arch):
    cfg = get_config(arch, reduced=True)
    model = _model(cfg)
    caches = T.init_caches(cfg, B, 32, torch.float32, device="cpu")
    batch = {"embeds": torch.zeros((B, 1, cfg.d_model))} \
        if cfg.frontend == "audio" \
        else {"tokens": torch.zeros((B, 1), dtype=torch.int32)}
    logits, caches = T.decode_step(model, caches, batch, cfg)
    assert logits.shape == (B, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    logits2, caches = T.decode_step(model, caches, batch, cfg)
    np.testing.assert_array_equal(caches["pos"].numpy(), [2] * B)
    assert bool(torch.isfinite(logits2).all())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_step_matches_decode_loop(arch):
    """Chunked teacher-forced prefill (ragged valid masks, per-slot
    positions) matches per-request one-token decode."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              capacity_factor=64.0)        # no MoE drops
    model = _model(cfg)
    Sq, lens, chunk = 6, [6, 3], 4
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, Sq), generator=g)
    embeds = torch.randn((B, Sq, cfg.d_model), generator=g) * 0.02
    caches = T.init_caches(cfg, B, Sq + 1, torch.float32, device="cpu")
    got: list = [[], []]
    fed = [0, 0]
    while any(lens[b] - fed[b] for b in range(B)):
        valid = np.zeros((B, chunk), bool)
        tk = torch.zeros((B, chunk), dtype=torch.long)
        em = torch.zeros((B, chunk, cfg.d_model))
        for b in range(B):
            n = min(chunk, lens[b] - fed[b])
            tk[b, :n] = toks[b, fed[b]:fed[b] + n]
            em[b, :n] = embeds[b, fed[b]:fed[b] + n]
            valid[b, :n] = True
        batch = {"embeds": em} if cfg.frontend == "audio" else {"tokens": tk}
        logits, caches = T.prefill_step(model, caches, batch,
                                        torch.from_numpy(valid), cfg)
        for b in range(B):
            n = int(valid[b].sum())
            got[b] += [logits[b, i].numpy() for i in range(n)]
            fed[b] += n
    np.testing.assert_array_equal(caches["pos"].numpy(), lens)
    for b in range(B):
        c1 = T.init_caches(cfg, 1, Sq + 1, torch.float32, device="cpu")
        for t in range(lens[b]):
            feed = {k: v[None] for k, v in
                    _feed(cfg, toks, embeds, b, t, 1).items()}
            want, c1 = T.decode_step(model, c1, feed, cfg)
            np.testing.assert_allclose(got[b][t], want[0, 0].numpy(),
                                       rtol=2e-3, atol=2e-3,
                                       err_msg=f"{arch} slot {b} tok {t}")
