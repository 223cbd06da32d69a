"""Serving of the port: the engines (``serve.engine``), their compiled
steps (``serve.step_graph``) and the paged, quantized KV cache
(``serve.kvcache``)."""
from repro_torch.serve.kvcache import (PagedCacheConfig, PagePool,
                                       pytree_bytes, summarize_pytree,
                                       supports_prefix_reuse)

__all__ = ["PagePool", "PagedCacheConfig", "pytree_bytes",
           "summarize_pytree", "supports_prefix_reuse"]
