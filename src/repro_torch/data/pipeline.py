"""Deterministic synthetic LM data (a numpy copy of
``repro.data.pipeline``: the same batches for the same seed, step and
host).

Documents are Zipf-distributed token runs with short copy runs and EOS
tokens, packed into fixed-length sequences, so that a model's loss falls.
Batch ``i`` depends only on (seed, i, host), so the iterator state is one
integer that rides along in the checkpoint.  Batches are numpy arrays;
the train step moves them to the model's device.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class SyntheticLMDataset:
    def __init__(self, *, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, frontend: str = "none", d_model: int = 0,
                 n_patches: int = 0,
                 host_index: int = 0, host_count: int = 1):
        if global_batch % host_count:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {host_count} hosts")
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // host_count
        self.seed = seed
        self.frontend = frontend
        self.d_model = d_model
        self.n_patches = n_patches
        self.host_index = host_index
        self.step = 0

    # ------------------------------------------------------------ state
    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
        self.seed = int(state["seed"])

    # ------------------------------------------------------------ batches
    def _tokens(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        # a Zipf-ish unigram stream; each token repeats the one before it
        # with p = 0.25, and EOS (1) lands with p = 0.01
        z = rng.zipf(1.3, size=(batch, self.seq_len + 1)).astype(np.int64)
        toks = z % (self.vocab - 2) + 2
        rep = rng.random((batch, self.seq_len + 1)) < 0.25
        for t in range(1, self.seq_len + 1):
            toks[:, t] = np.where(rep[:, t], toks[:, t - 1], toks[:, t])
        eos = rng.random((batch, self.seq_len + 1)) < 0.01
        toks[eos] = 1
        return toks

    def next(self) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.step, self.host_index]))
        toks = self._tokens(rng, self.local_batch)
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "mask": np.ones((self.local_batch, self.seq_len), np.float32),
        }
        if self.frontend == "audio":
            batch["embeds"] = rng.standard_normal(
                (self.local_batch, self.seq_len, self.d_model)
            ).astype(np.float32) * 0.02
        elif self.frontend == "vlm":
            batch["pixel_embeds"] = rng.standard_normal(
                (self.local_batch, self.n_patches, self.d_model)
            ).astype(np.float32) * 0.02
        self.step += 1
        return batch

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            yield self.next()
