"""Paged, quantized KV cache of the port (``repro.serve.kvcache``).

The dense serving caches give every slot its own ``max_len`` buffer.  A
paged cache instead keeps one **fixed-size page pool** per cache tensor,
shared by every slot, and a slot -> page table: a slot holds only the pages
its request needs (``ceil((prompt + max_new) / page_size)``).  The pages may
hold their payload **quantized** (int8 or fp8 e4m3) with one float32 scale
per token and head, written on the way in and dequantized on the way out,
so that every float attention path (and the int8 attention's own per-head
quantization) runs on them unchanged.  **Prefix reuse**: the full prompt
pages of a finished request are registered under a hash of their tokens,
and a later request with the same page-aligned prefix shares them (they
are frozen: writes are append-only past the shared tokens), so a repeated
system prompt costs no prefill step.

On a mesh (``parallel.sharding.make_cache_spec_fn``) a rank holds the
pools' block of kv heads (the scale pools mirror their payload's) and the
whole page table; every rank's ``PagePool`` mirror stays the same, as
every rank runs the same schedule, and a step that holds only its rank's
slots writes every slot's rows (``layers.attention_fwd``), so that the
pools, whole over (pod, data), stay the same on every rank there.

Two halves, as in the reference:

* the device half, plain PyTorch ops run inside the engine's steps (the
  reference's are plain XLA ops, no Pallas): :func:`gather_pages` /
  :func:`scatter_pages` move token rows between the ``(pages, page_size,
  ...)`` pools and ``(B, S, ...)`` views through the page table;
  :func:`read_seq` / :func:`write_seq` add the dequantize-on-read /
  quantize-on-write layer.  The page table is a step input (one device
  tensor in the caches, refilled from the host before a step), never a
  constant a CUDA graph captured, and nothing read from it reaches the
  host: a graph captured at construction serves pages allocated later.
* the host half, :class:`PagePool`: the allocator with refcounts, a free
  list, the prefix index (sha1 over the tokens, LRU eviction under
  pressure), its counters, ``stats()`` and ``invariant_errors()`` -- the
  reference's, decision for decision, so that an engine of the port gives
  every request the same physical pages.

Layout deviation, the sink page: every pool tensor (payload and scales)
has ONE page more than ``PagedCacheConfig.pool_pages``, at index
``pool_pages``.  No page table ever names it.  The reference drops the
writes of padded and inactive lanes by sending them out of bounds with
``mode="drop"``; the port sends them to the sink page instead, which keeps
the scatter free of host syncs and of write races (an unallocated table
row holds page 0, which may be another slot's live page, and one scatter
with two writes to a row leaves either).  ``pool_pages``,
``PagePool.n_pages`` and ``stats()["pages"]`` keep the reference's count;
``pytree_bytes`` counts the sink's bytes.

Kept from the reference: under ``attn_int8`` the int8 attention derives
its own per-head scales from the dequantized page view, not from the
per-token page scales.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.quant.qtensor import FMT_MAX, FP8_DTYPE, to_fp8

_EPS = 1e-12

# payload formats the pools support ("fp8" still carries an f32 scale so a
# row's abs-max lands on e4m3's top of range)
CACHE_FMTS = ("int8", "fp8")

_FLOAT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Static description of a paged cache.

    ``page_size``      : tokens per page.
    ``pages_per_slot`` : logical pages a slot's table addresses
                         (``ceil(max_len / page_size)``).
    ``pool_pages``     : physical pages per pool tensor that tables name
                         (each pool tensor holds one more, the sink).
    ``fmt``            : ``None`` (float payload at ``dtype``), ``"int8"``,
                         or ``"fp8"`` -- the quantize-on-write format.
    ``dtype_name``     : float dtype that reads restore (and the storage
                         dtype when ``fmt`` is None).
    """

    page_size: int
    pages_per_slot: int
    pool_pages: int
    fmt: str | None = None
    dtype_name: str = "float32"

    def __post_init__(self) -> None:
        if min(self.page_size, self.pages_per_slot, self.pool_pages) < 1:
            raise ValueError(f"degenerate paged cache config {self}")
        if self.fmt is not None and self.fmt not in CACHE_FMTS:
            raise ValueError(
                f"cache fmt must be None or one of {CACHE_FMTS}, "
                f"got {self.fmt!r}")

    @property
    def dtype(self) -> torch.dtype:
        return _FLOAT_DTYPES[self.dtype_name]

    @property
    def store_dtype(self) -> torch.dtype:
        """Physical pool dtype: int8 / fp8 payload, or the float dtype."""
        if self.fmt == "int8":
            return torch.int8
        if self.fmt == "fp8":
            return FP8_DTYPE
        return self.dtype

    @property
    def max_tokens(self) -> int:
        """Logical token capacity a slot's table addresses."""
        return self.pages_per_slot * self.page_size

    def seq_pages(self, window: int = 0) -> int:
        """Logical pages backing one cache buffer: the full table for dense
        attention, the rolling-window span for sliding windows."""
        if window:
            return min(self.pages_per_slot,
                       -(-min(window, self.max_tokens) // self.page_size))
        return self.pages_per_slot


def supports_prefix_reuse(cfg) -> bool:
    """Prefix pages can stand in for prefill only when the whole per-slot
    sequence state lives in paged buffers: full-attention dense / moe
    stages (rolling windows and recurrent state are not addressable by
    position) and a token frontend (the prefix hash keys on token ids)."""
    return (cfg.frontend == "none"
            and all(s.block in ("dense", "moe") and not s.window
                    and not s.shared_attn_every for s in cfg.stages))


# ---------------------------------------------------------------------------
# device side: quantize / gather / scatter
# ---------------------------------------------------------------------------


def quantize_tokens(x: torch.Tensor, fmt: str
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric quantization over the trailing feature axis.

    ``x`` (..., d) float -> (payload (..., d) int8 | fp8, scale (...) f32):
    one scale per token row (per head when a head axis precedes ``d``), the
    row's abs-max over the format's top, the row divided by it (a true
    division), int8 rounded half to even and clipped."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=_EPS) / FMT_MAX[fmt]
    q = xf / scale[..., None]
    if fmt == "fp8":
        return to_fp8(q), scale
    qmax = FMT_MAX[fmt]
    return torch.clamp(torch.round(q), -qmax, qmax).to(torch.int8), scale


def dequantize_tokens(payload: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_tokens` (restores ``dtype``)."""
    return (payload.float() * scale[..., None]).to(dtype)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """An e4m3 tensor as its bytes (indexing has no e4m3 kernels); any
    other tensor as it is."""
    return t.view(torch.uint8) if t.dtype == FP8_DTYPE else t


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """(pages, page_size, ...) pool + (B, n) page table -> the (B, n *
    page_size, ...) contiguous per-slot view."""
    B, n = page_table.shape
    gathered = _bytes(pool)[page_table]               # (B, n, ps, ...)
    return gathered.reshape((B, n * pool.shape[1]) + tuple(pool.shape[2:])
                            ).view(pool.dtype)


def page_rows(pool: torch.Tensor, page_table: torch.Tensor,
              idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The flat row (page * page_size + offset) of ``pool`` that each token
    at logical index ``idx (B, T)`` lands on through the page table, (B *
    T,) int64: an index past the table clipped to its last page, as the
    reference clips, and every invalid lane on the sink page (the pool's
    last), which no table names -- the reference's dropped writes, with
    no host sync.  Every pool of a paged cache has the same pages, so one
    call serves all of a step's scatters."""
    ps = pool.shape[1]
    idx = idx.long()
    page = torch.clamp(idx // ps, max=page_table.shape[1] - 1)
    phys = torch.where(valid.bool(), torch.gather(page_table, 1, page),
                       pool.shape[0] - 1)
    return (phys * ps + idx % ps).reshape(-1)


def scatter_pages(pool: torch.Tensor, page_table: torch.Tensor,
                  values: torch.Tensor, idx: torch.Tensor,
                  valid: torch.Tensor,
                  rows: torch.Tensor | None = None) -> torch.Tensor:
    """Write token rows ``values (B, T, ...)`` at logical token index ``idx
    (B, T)`` through the page table, in place; returns ``pool``.  Invalid
    lanes write to the sink page (:func:`page_rows`, which ``rows`` may
    give precomputed)."""
    ps = pool.shape[1]
    if rows is None:
        rows = page_rows(pool, page_table, idx, valid)
    flat = pool.view((pool.shape[0] * ps,) + tuple(pool.shape[2:]))
    vals = values.reshape((-1,) + tuple(pool.shape[2:])).to(pool.dtype)
    _bytes(flat).index_copy_(0, rows, _bytes(vals))
    return pool


def read_seq(cache: dict, name: str, page_table: torch.Tensor,
             n_pages: int, *, dtype: torch.dtype) -> torch.Tensor:
    """Gather cache tensor ``name`` into a contiguous (B, n_pages * ps, ...)
    view at ``dtype``, dequantizing quantized payloads on the way out."""
    pt = page_table[:, :n_pages]
    vals = gather_pages(cache[name + "_pages"], pt)
    scales = cache.get(name + "_scales")
    if scales is None:
        return vals.to(dtype)
    return dequantize_tokens(vals, gather_pages(scales, pt), dtype)


def write_seq(cache: dict, name: str, page_table: torch.Tensor,
              values: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
              fmt: str | None, rows: torch.Tensor | None = None) -> dict:
    """Scatter this step's token rows into the pools of ``name`` in place
    (quantize-on-write where the cache carries a scale pool); returns the
    updated leaves.  ``rows``: :func:`page_rows` of the step, if already
    computed."""
    pool = cache[name + "_pages"]
    scales = cache.get(name + "_scales")
    if rows is None:
        rows = page_rows(pool, page_table, idx, valid)
    if scales is None:
        return {name + "_pages": scatter_pages(pool, page_table, values,
                                               idx, valid, rows)}
    payload, scale = quantize_tokens(values, fmt)
    return {
        name + "_pages": scatter_pages(pool, page_table, payload, idx, valid,
                                       rows),
        name + "_scales": scatter_pages(scales, page_table, scale, idx, valid,
                                        rows),
    }


def init_paged_seq_cache(feats: dict[str, tuple[int, ...]], batch: int,
                         pcfg: PagedCacheConfig,
                         float_names: frozenset[str] = frozenset(), *,
                         device=None) -> dict:
    """One layer's paged cache: a ``(pool_pages + 1, page_size) + feat``
    payload pool per tensor (the last page the sink), a float32 scale pool
    beside it when quantized, and the per-slot ``len`` counter.  ``feats``
    maps tensor name -> per-token feature shape, e.g. ``{"k": (n_kv,
    d_head), "v": (n_kv, d_head)}``.  Tensors named in ``float_names`` stay
    float under a quantized ``fmt`` (the reference keeps MLA's latent ``c``
    so)."""
    out: dict = {}
    pages = (pcfg.pool_pages + 1, pcfg.page_size)
    for name, feat in feats.items():
        quantize = pcfg.fmt is not None and name not in float_names
        out[name + "_pages"] = torch.zeros(
            pages + tuple(feat),
            dtype=pcfg.store_dtype if quantize else pcfg.dtype,
            device=device)
        if quantize:
            out[name + "_scales"] = torch.zeros(
                pages + tuple(feat[:-1]), dtype=torch.float32, device=device)
    out["len"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return out


# leaf names that have no slot axis: the pools (stale rows are unreachable
# once the slot counters reset) and the page table (the host mirror owns it)
PAGED_LEAF_SUFFIXES = ("_pages", "_scales")
PAGE_TABLE_KEY = "page_table"


def device_page_table(pt_host, table: torch.Tensor) -> torch.Tensor:
    """Host page-table mirror -> the device table: copied into ``table``
    (the caches' static table tensor) in place, through pinned memory when
    it lies on the card, and returned."""
    src = torch.from_numpy(np.array(pt_host, dtype=np.int32))
    if table.is_cuda:
        src = src.pin_memory()
    table.copy_(src, non_blocking=table.is_cuda)
    return table


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------


def _leaves_with_path(tree, path: str = ""):
    """(path, tensor) of every tensor of nested dicts / lists / tuples,
    paths as ``jax.tree_util.keystr`` prints them (``['stages'][0]``)."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")


def tree_tensors(tree):
    """Every tensor of nested dicts / lists / tuples, in order."""
    for _, t in _leaves_with_path(tree):
        yield t


def pytree_bytes(tree) -> int:
    """Total bytes of every tensor (the cache footprint on the device)."""
    return sum(t.numel() * t.element_size() for t in tree_tensors(tree))


def summarize_pytree(tree, top: int = 8) -> dict:
    """{"total_bytes", "total_gb", "leaves": [(path, shape, dtype, bytes)]}
    sorted largest first -- the per-tensor cache accounting rows."""
    rows = [(path, tuple(t.shape), str(t.dtype).removeprefix("torch."),
             t.numel() * t.element_size())
            for path, t in _leaves_with_path(tree)]
    rows.sort(key=lambda r: -r[-1])
    total = sum(r[-1] for r in rows)
    return {"total_bytes": total, "total_gb": total / 1024 ** 3,
            "leaves": rows[:top]}


# ---------------------------------------------------------------------------
# host side: the page allocator + prefix index
# ---------------------------------------------------------------------------


class PagePool:
    """Host-side page allocator with refcounts and a prefix index.

    The pool never touches device memory: it decides which physical page
    backs which (slot, logical page), and the engine mirrors that into the
    device page table.  Pages are refcounted because the prefix index and
    several slots may share one; a page returns to the free list only at
    refcount zero.

    Sharing discipline (what makes copy-on-write trivial): only *full*
    prompt pages are ever registered or shared, and cache writes are
    append-only at positions >= the shared token count, so a shared page
    is frozen by construction and a writable page always has exactly one
    owner.  ``invariant_errors`` checks exactly that, plus refcount and
    free-list consistency.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError(
                f"PagePool needs n_pages/page_size >= 1, got "
                f"{n_pages}/{page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        self.refcount = np.zeros(n_pages, np.int32)
        self._free: collections.deque[int] = collections.deque(range(n_pages))
        self._slot_pages: dict[int, list[int]] = {}
        self._slot_shared: dict[int, int] = {}      # leading shared pages
        # prefix key -> frozen page ids, insertion order = LRU order
        self._prefix: collections.OrderedDict[bytes, tuple[int, ...]] = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0

    # -------------------------------------------------------------- prefix
    @staticmethod
    def _key(tokens) -> bytes:
        return hashlib.sha1(np.asarray(tokens, np.int64).tobytes()).digest()

    def match_prefix(self, prompt) -> tuple[tuple[int, ...], int]:
        """Longest registered page-aligned prefix of ``prompt``, capped at
        ``len(prompt) - 1`` tokens: the last prompt token is always re-fed
        so the finishing prefill step has logits to sample from."""
        ps = self.page_size
        for k in range((len(prompt) - 1) // ps, 0, -1):
            ent = self._prefix.get(self._key(prompt[: k * ps]))
            if ent is not None:
                self._prefix.move_to_end(self._key(prompt[: k * ps]))
                return ent, k * ps
        return (), 0

    def register_prefix(self, prompt, pages) -> int:
        """Freeze the full prompt pages of a finished request under every
        page-aligned prefix key (so later lookups find the longest match
        directly).  Returns the number of new index entries."""
        ps = self.page_size
        added = 0
        for k in range(1, len(prompt) // ps + 1):
            key = self._key(prompt[: k * ps])
            if key in self._prefix:
                self._prefix.move_to_end(key)
                continue
            ent = tuple(pages[:k])
            for p in ent:
                self._ref(p)
            self._prefix[key] = ent
            added += 1
        return added

    def _evict_one(self) -> bool:
        if not self._prefix:
            return False
        _, ent = self._prefix.popitem(last=False)      # least recently used
        for p in ent:
            self._deref(p)
        self.evictions += 1
        return True

    # --------------------------------------------------------------- pages
    def _ref(self, p: int) -> None:
        self.refcount[p] += 1

    def _deref(self, p: int) -> None:
        self.refcount[p] -= 1
        if self.refcount[p] < 0:
            raise RuntimeError(f"refcount underflow on page {p}")
        if self.refcount[p] == 0:
            self._free.append(p)

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` free pages, evicting LRU prefix entries under
        pressure; raises RuntimeError when the pool is truly exhausted."""
        while len(self._free) < n and self._evict_one():
            pass
        if len(self._free) < n:
            raise RuntimeError(
                f"page pool exhausted: need {n}, have {len(self._free)} "
                f"of {self.n_pages}")
        return [self._free.popleft() for _ in range(n)]

    def admit(self, slot: int, prompt, need_tokens: int, *,
              prefix: bool = True) -> tuple[list[int], int]:
        """Assign pages for a request needing ``need_tokens`` positions.

        Returns ``(page_ids, shared_tokens)``: the slot's logical->physical
        page list (shared prefix pages first, then fresh pages) and how many
        leading prompt tokens the shared pages already hold."""
        if slot in self._slot_pages:
            raise ValueError(f"slot {slot} already holds pages")
        shared, stok = self.match_prefix(prompt) if prefix else ((), 0)
        for p in shared:
            self._ref(p)
        n_total = -(-need_tokens // self.page_size)
        try:
            fresh = self.alloc(n_total - len(shared))
        except RuntimeError:
            for p in shared:
                self._deref(p)
            raise
        for p in fresh:
            self._ref(p)
        self._slot_pages[slot] = list(shared) + fresh
        self._slot_shared[slot] = len(shared)
        if stok:
            self.hits += 1
            self.hit_tokens += stok
        else:
            self.misses += 1
        return self._slot_pages[slot], stok

    def release(self, slot: int, prompt=None) -> None:
        """Return a finished slot's pages; with ``prompt`` given, its full
        prompt pages are first frozen into the prefix index."""
        pages = self._slot_pages.pop(slot)
        self._slot_shared.pop(slot)
        if prompt is not None:
            self.register_prefix(prompt, pages)
        for p in pages:
            self._deref(p)

    def slot_pages(self, slot: int) -> tuple[int, ...]:
        return tuple(self._slot_pages.get(slot, ()))

    # --------------------------------------------------------------- state
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def stats(self) -> dict:
        lookups = self.hits + self.misses
        return {
            "pages": self.n_pages,
            "page_size": self.page_size,
            "free_pages": self.free_pages,
            "occupancy": 1.0 - self.free_pages / self.n_pages,
            "prefix_entries": len(self._prefix),
            "prefix_hits": self.hits,
            "prefix_hit_tokens": self.hit_tokens,
            "prefix_hit_rate": self.hits / lookups if lookups else 0.0,
            "evictions": self.evictions,
        }

    def invariant_errors(self) -> list[tuple[str, str]]:
        """Machine-checkable allocator contract; empty = consistent.

        Codes: PGT001 a page aliased into a writable region, PGT002 a freed
        page still referenced, PGT003 refcount inconsistent with the
        reference graph, PGT004 free-list corruption (duplicate or leaked
        page)."""
        errs: list[tuple[str, str]] = []
        expected = np.zeros(self.n_pages, np.int64)
        owners: dict[int, list[int]] = collections.defaultdict(list)
        writable: dict[int, int] = {}
        for s, pages in self._slot_pages.items():
            sh = self._slot_shared.get(s, 0)
            for i, p in enumerate(pages):
                expected[p] += 1
                owners[p].append(s)
                if i >= sh:
                    if p in writable:
                        errs.append((
                            "PGT001",
                            f"page {p} is in the writable region of slots "
                            f"{writable[p]} and {s}"))
                    writable[p] = s
        frozen = set()
        for ent in self._prefix.values():
            for p in ent:
                expected[p] += 1
                frozen.add(p)
        for p, s in writable.items():
            if p in frozen:
                errs.append((
                    "PGT001",
                    f"page {p} is writable by slot {s} but frozen in the "
                    "prefix index"))
            if len(owners[p]) > 1:
                errs.append((
                    "PGT001",
                    f"page {p} is writable by slot {s} but referenced by "
                    f"slots {sorted(owners[p])}"))
        for p in np.nonzero(expected != self.refcount)[0]:
            errs.append((
                "PGT003",
                f"page {int(p)} refcount {int(self.refcount[p])} != "
                f"{int(expected[p])} references held"))
        free = list(self._free)
        free_set = set(free)
        if len(free) != len(free_set):
            errs.append(("PGT004", "free list holds duplicate pages"))
        for p in free:
            if expected[p] or self.refcount[p] > 0:
                errs.append((
                    "PGT002", f"free page {p} is still referenced"))
        for p in range(self.n_pages):
            if self.refcount[p] == 0 and p not in free_set:
                errs.append((
                    "PGT004",
                    f"page {p} has refcount 0 but is not on the free list "
                    "(leaked)"))
        return errs
