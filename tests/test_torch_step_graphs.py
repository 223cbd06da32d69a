"""The engines' CUDA graphs: what they rely on, on the CPU, and graph steps
against eager steps on the card.

On the CPU: every cache tensor keeps its storage across ``prefill_step``,
``decode_step``, ``reset_slots`` and ``insert_slot`` (a graph replays
fixed addresses), with the values the out-of-place formulas gave;
``StepGraphs`` runs its steps eagerly there; the engine's step runs only
on its own caches and declared widths; the sampler inverts the softmax's
CDF at the given uniforms.

On the card (``cuda``-marked, skipped here): the engines with graphs
(the default) against the same engines with ``graphs=False`` on reduced
Yi-9B (float32, int4 + ``attn_int8``, calibrated int8), decoupled
prefill, the wave engine and reduced ResNet50: tokens EQUAL, every step's
logits rows bit for bit (the same kernels on the same inputs; each kernel
of these paths sums in a fixed order), the wrappers' launch counts of a
replayed run equal the eager run's, exactly the declared shapes captured;
a graph keeps the split-K workspace it was captured with when a later
step grows the stream's workspace.  This file imports no JAX: the card's tests run where JAX is missing.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from _torch_parity import cuda_device  # noqa: F401
from repro_torch import kernels
from repro_torch.configs import get_config, get_vision_config
from repro_torch.models import transformer as T
from repro_torch.quant import quantize_lm
from repro_torch.serve import engine as E
from repro_torch.serve.step_graph import StepGraphs
from repro_torch.vision import engine as V
from repro_torch.vision import models as VM

B, S = 3, 16


@pytest.fixture(scope="module")
def lm():
    cfg = get_config("yi-9b", reduced=True)
    return cfg, T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")


def _filled(cfg, model):
    """Caches after one prefill chunk (slots at 5, 0 and 3 tokens)."""
    caches = T.init_caches(cfg, B, S, torch.float32, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab, (B, 5)).astype(np.int32))
    valid = torch.arange(5)[None, :] < torch.tensor([5, 0, 3])[:, None]
    T.prefill_step(model, caches, {"tokens": tok}, valid, cfg)
    return caches, tok, valid


def _counters(caches):
    return [caches["pos"]] + [layer["attn"]["len"]
                              for c_s in caches["stages"]
                              for layer in c_s["layers"]]


@pytest.mark.parametrize("op", ["prefill_step", "decode_step", "reset_slots",
                                "reset_slots_lens", "insert_slot"])
def test_cache_tensors_keep_storage(lm, op):
    cfg, model = lm
    caches, tok, valid = _filled(cfg, model)
    tensors = list(T.cache_tensors(caches))
    ptrs = [t.data_ptr() for t in tensors]
    before = [t.clone() for t in tensors]
    counters = [t.clone() for t in _counters(caches)]
    mask = torch.tensor([True, False, True])
    if op == "prefill_step":
        out = T.prefill_step(model, caches, {"tokens": tok}, valid, cfg)[1]
        want = [c + valid.sum(-1).to(torch.int32) for c in counters]
    elif op == "decode_step":
        out = T.decode_step(model, caches, {"tokens": tok[:, :1]}, cfg)[1]
        want = [c + 1 for c in counters]
    elif op == "reset_slots":
        out = T.reset_slots(caches, mask)
        want = [torch.where(mask, torch.zeros((), dtype=c.dtype), c)
                for c in counters]
    elif op == "reset_slots_lens":
        lens = torch.tensor([4, 9, 2])
        out = T.reset_slots(caches, mask, lens)
        want = [torch.where(mask, lens.to(c.dtype), c) for c in counters]
    else:
        src, _, _ = _filled(cfg, model)
        T.decode_step(model, src, {"tokens": tok[:, :1]}, cfg)
        out = T.insert_slot(caches, src, torch.tensor(1), src_slot=2)
        for t, s_, b in zip(T.cache_tensors(caches), T.cache_tensors(src),
                            before):
            w = b.clone()
            w[1] = s_[2]
            assert torch.equal(t, w)
        want = None
    assert out is caches
    assert [t.data_ptr() for t in T.cache_tensors(caches)] == ptrs
    if want is not None:
        for got, w in zip(_counters(caches), want):
            assert torch.equal(got, w)
    if op.startswith("reset"):
        # K/V contents stay
        for t, b in zip(T.cache_tensors(caches), before):
            if t.dim() > 1:
                assert torch.equal(t, b)


@pytest.mark.parametrize("size", [4, 16])
def test_rows_written_in_place_without_a_sync(size):
    # a cache shorter than the chunk (4 < 6) too: valid tokens write their
    # rows, padded ones nothing, as a loop over the tokens does
    from repro_torch.models.layers import _write_rows
    g = torch.Generator().manual_seed(size)
    buf = torch.randn(3, size, 2, 4, generator=g)
    new = torch.randn(3, 6, 2, 4, generator=g)
    positions = torch.tensor([0, 1, 2])[:, None] + torch.arange(6)
    valid = torch.arange(6)[None] < torch.tensor([4, 2, 0])[:, None]
    want = buf.clone()
    for b, t in zip(*torch.nonzero(valid, as_tuple=True)):
        want[b, positions[b, t]] = new[b, t]
    ptr = buf.data_ptr()
    _write_rows(buf, new, positions, valid)
    assert buf.data_ptr() == ptr and torch.equal(buf, want)


def test_step_graphs_run_eagerly_on_the_cpu():
    g = StepGraphs(torch.device("cpu"))
    assert not g.graphed
    x = torch.zeros((2, 3), dtype=torch.int32)
    calls = []
    g.add("double", lambda t: calls.append(1) or t * 2, x)
    assert calls == []                      # registering runs nothing here
    g.put(x, np.arange(6, dtype=np.int32).reshape(2, 3))
    assert torch.equal(g.run("double"), torch.arange(6).reshape(2, 3) * 2)
    s = torch.zeros((), dtype=torch.int64)
    g.put(s, np.int64(5))
    assert int(s) == 5
    with pytest.raises(ValueError, match="already"):
        g.add("double", lambda t: t, x)
    with pytest.raises(KeyError, match="never registered"):
        g.run("triple")
    assert g.stats() == {"graphs": [], "capture_s": {}, "pool_bytes": 0}


def test_engine_step_runs_on_its_own_caches(lm):
    cfg, model = lm
    eng = E.ServeEngine(model, cfg, batch_slots=2, max_len=S,
                        prefill_chunk=4, device="cpu")
    caches = eng.init_caches()
    assert caches is eng.init_caches()
    tok, valid = np.zeros((2, 4), np.int32), np.ones((2, 4), bool)
    with pytest.raises(ValueError, match="own"):
        eng._step(model, T.init_caches(cfg, 2, S, device="cpu"), tok, valid,
                  eng.generator)
    with pytest.raises(ValueError, match="declared"):
        eng.step(caches, tok[:, :3], valid[:, :3])
    assert eng.step(caches, tok, valid).shape == (2,)
    assert caches["pos"].tolist() == [4, 4]
    assert eng.graphs.stats() == {"graphs": [], "capture_s": {},
                                 "pool_bytes": 0}


def test_sample_inverts_the_cdf():
    p = torch.tensor([[0.2, 0.5, 0.3]] * 4)
    rows = torch.log(p)
    u = torch.tensor([0.1, 0.3, 0.69, 0.75])
    assert E.sample(rows, 1.0, u).tolist() == [0, 1, 1, 2]
    assert E.sample(rows, 0.0, None).tolist() == [1, 1, 1, 1]
    # a token of zero probability is never drawn
    rows = torch.tensor([[0.0, -1e30, 0.0]] * 4)
    assert 1 not in E.sample(rows, 1.0, torch.tensor([0.0, 0.5, 0.4999,
                                                      0.9999])).tolist()


# ---------------------------------------------------------------------------
# on the card: graphs against eager steps
@pytest.mark.parametrize("engine", ["continuous", "wave"])
def test_dropped_engine_is_freed_without_a_collection(lm, engine):
    """An engine holds no reference cycle: with the cyclic collector off,
    dropping it frees it at once."""
    cfg, model = lm
    cls = E.ServeEngine if engine == "continuous" else E.WaveServeEngine
    collecting = gc.isenabled()
    gc.disable()
    try:
        eng = cls(model, cfg, batch_slots=2, max_len=S, device="cpu")
        eng.generate([E.Request(prompt=[3, 4, 5], max_new_tokens=2,
                                eos_id=-1)])
        ref = weakref.ref(eng)
        del eng
        assert ref() is None
    finally:
        if collecting:
            gc.enable()


# ---------------------------------------------------------------------------

SLOTS, MAX_LEN, CHUNK = 4, 64, 8


def _requests(cfg, n=6):
    rng = np.random.default_rng(1)
    return [E.Request(prompt=rng.integers(2, cfg.vocab,
                                          int(rng.integers(3, 30))).tolist(),
                      max_new_tokens=int(rng.integers(2, 8)), eos_id=-1)
            for _ in range(n)]


def _served(eng, reqs):
    """Tokens, every step's logits rows (on the host) and the wrappers'
    launch counts of one ``generate``."""
    inner, rows = eng._step, []

    def step(*args):
        nxt, caches, r = inner(*args)
        rows.append(r.cpu())
        return nxt, caches, r

    eng._step = step
    counters = kernels.launch_counters()
    for f in counters.values():
        f.launches = 0
    try:
        outs = eng.generate(reqs)
        torch.cuda.synchronize()
    finally:
        eng._step = inner
    return outs, rows, {k: f.launches for k, f in counters.items()}


def _card_lm(cfg, dev):
    return T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device=dev)


CARD_MODES = {"float32": {}, "int4_attn_int8": dict(quantized="int4",
                                                    attn_int8=True),
              "int8_calibrated": {}}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(CARD_MODES))
def test_graph_steps_equal_eager_steps(cuda_device, mode):
    cfg = get_config("yi-9b", reduced=True)
    model = _card_lm(cfg, cuda_device)
    if mode == "int8_calibrated":
        calib = [{"tokens": torch.randint(2, cfg.vocab, (2, 16),
                                          device=cuda_device,
                                          generator=torch.Generator(
                                              cuda_device).manual_seed(1))}]
        model = quantize_lm(model, cfg, calib, fmt="int8")
    reqs = _requests(cfg)
    runs = {}
    for graphs in (True, False):
        eng = E.ServeEngine(model, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
                            prefill_chunk=CHUNK, graphs=graphs,
                            **CARD_MODES[mode])
        runs[graphs] = _served(eng, reqs)
        if graphs:
            assert eng.graphs.captured == [
                ("step", C) for C in eng.declared_step_widths()] + ["reset"]
            st = eng.graphs.stats()
            assert st["pool_bytes"] > 0 and len(st["capture_s"]) == 3
            # the split-K counters and the int8 attention's amax slots are
            # left zero by every replay
            torch.cuda.synchronize()
            for ws in kernels.stream_workspaces(cuda_device,
                                                eng.graphs.stream.cuda_stream):
                if ws.dtype == torch.int32:
                    assert int(ws.abs().sum()) == 0
        else:
            assert eng.graphs.captured == []
    (g_out, g_rows, g_n), (e_out, e_rows, e_n) = runs[True], runs[False]
    assert g_out == e_out
    assert len(g_rows) == len(e_rows)
    assert all(torch.equal(a, b) for a, b in zip(g_rows, e_rows))
    assert g_n == e_n and sum(g_n.values()) > 0


@pytest.mark.cuda
def test_graph_keeps_its_workspace_when_a_later_step_grows_it(cuda_device):
    """A graph whose GEMV splits K keeps the stream's split-K workspace it
    was captured with when a later step's warm-up grows the workspace
    (Zamba2's width-16 step, then its width-1 step's wider GEMVs): the
    old planes and counters stay allocated for the graph, and the memory
    freed around them (masked scores of -1e30 here) never reaches its
    output.  ``stream_workspaces`` keys a device without an index as the
    kernels key their operands' device."""
    from repro_torch.kernels import gemv as G
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(8, 3584, device=cuda_device, generator=g)
    w1 = torch.randn(3584, 7168, device=cuda_device, generator=g)
    w2 = torch.randn(3584, 14336, device=cuda_device, generator=g)
    big = torch.randn(8, 16, 32, 512, device=cuda_device, generator=g)

    def first(x, w, big):
        p = torch.softmax(torch.where(big > 0, big, -1e30), -1)
        return G.gemv(x, w), p.sum()

    steps = StepGraphs(cuda_device)
    steps.add("first", first, x, w1, big)
    held = steps._steps["first"].workspaces
    assert held and all(t.is_cuda for t in held)
    steps.add("wider", lambda x, w: G.gemv(x, w), x, w2)
    want = G.gemv_plain(x, w1)
    for _ in range(3):
        y, _ = steps.run("first")
        steps.run("wider")
        torch.cuda.synchronize()
        assert float((y - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


@pytest.mark.cuda
def test_decoupled_graphs_equal_inline_and_eager(cuda_device):
    cfg = get_config("yi-9b", reduced=True)
    model = _card_lm(cfg, cuda_device)
    reqs = _requests(cfg)
    kw = dict(batch_slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK)
    inline = E.ServeEngine(model, cfg, **kw).generate(reqs)
    outs = {}
    for graphs in (True, False):
        eng = E.ServeEngine(model, cfg, decouple_prefill=True,
                            graphs=graphs, **kw)
        outs[graphs] = eng.generate(reqs)
        if graphs:
            assert eng.graphs.captured == [("step", 1), ("prefill", CHUNK),
                                           "reset", "insert",
                                           "reset_prefill"]
    assert outs[True] == outs[False] == inline


@pytest.mark.cuda
def test_dropped_graph_engine_frees_the_card_without_a_collection(
        cuda_device):
    """The captures leave the collector as they found it (off here), and
    a dropped graph engine gives its graphs, pool and caches back at once.
    What outlives it by design is cached per stream, for the next engine
    that draws its side stream from the stream pool: the kernels'
    workspaces and cuBLAS's workspace (32 MiB on the H100) of that
    stream; with those cleared the card holds no more than before."""
    from repro_torch.kernels import flash_attention
    cfg = get_config("yi-9b", reduced=True)
    model = _card_lm(cfg, cuda_device)
    reqs = _requests(cfg)
    # what a first run makes once per process (the rope tables, the
    # default stream's workspaces) is made before the count
    E.ServeEngine(model, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
                  prefill_chunk=CHUNK, graphs=False).generate(reqs)
    collecting = gc.isenabled()
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda_device)
    gc.disable()
    try:
        eng = E.ServeEngine(model, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
                            prefill_chunk=CHUNK)
        assert eng.graphs.captured and not gc.isenabled()
        eng.generate(reqs)
        stream = eng.graphs.stream.cuda_stream
        ref = weakref.ref(eng)
        del eng
        torch.cuda.synchronize()
        assert ref() is None
        for cache in (kernels._split_k_scratch, flash_attention._attn_scratch):
            for key in [k for k in cache if k[1] == stream]:
                del cache[key]
        torch._C._cuda_clearCublasWorkspaces()
        assert torch.cuda.memory_allocated(cuda_device) <= before
    finally:
        if collecting:
            gc.enable()


@pytest.mark.cuda
def test_sampled_tokens_equal_graph_and_eager(cuda_device):
    cfg = get_config("yi-9b", reduced=True)
    model = _card_lm(cfg, cuda_device)
    reqs = _requests(cfg)
    outs = [E.ServeEngine(model, cfg, batch_slots=SLOTS, max_len=MAX_LEN,
                          prefill_chunk=CHUNK, temperature=1.0, seed=3,
                          graphs=graphs).generate(reqs)
            for graphs in (True, False)]
    assert outs[0] == outs[1]


@pytest.mark.cuda
def test_wave_graphs_equal_eager(cuda_device):
    cfg = get_config("yi-9b", reduced=True)
    model = _card_lm(cfg, cuda_device)
    # waves of 2, 2 and 1, their prompts left-padded with token 1
    reqs = [E.Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
            for r in _requests(cfg, n=5)]
    outs = {}
    for graphs in (True, False):
        eng = E.WaveServeEngine(model, cfg, batch_slots=2, max_len=MAX_LEN,
                                graphs=graphs)
        outs[graphs] = eng.generate(reqs)
        assert eng.graphs.captured == ([("decode", 2), ("decode", 1)]
                                       if graphs else [])
    assert outs[True] == outs[False]


@pytest.mark.cuda
def test_vision_graph_equals_eager(cuda_device):
    cfg = get_vision_config("resnet50", reduced=True)
    model = VM.init(cfg, generator=torch.Generator().manual_seed(0))
    imgs = np.random.default_rng(2).standard_normal(
        (7, *cfg.input_hw, 3)).astype(np.float32)
    reqs = [V.ImageRequest(im) for im in imgs]
    res = {}
    counters = kernels.launch_counters()
    for graphs in (True, False):
        eng = V.VisionEngine(model, cfg, batch_slots=4, graphs=graphs)
        assert eng.graphs.captured == ([("infer", 4)] if graphs else [])
        eng.warmup()
        for f in counters.values():
            f.launches = 0
        out = eng.infer(reqs)
        res[graphs] = (np.stack(out),
                       {k: f.launches for k, f in counters.items()})
    assert np.array_equal(res[True][0], res[False][0])
    assert res[True][1] == res[False][1] and res[True][1]["im2col_conv"] > 0
