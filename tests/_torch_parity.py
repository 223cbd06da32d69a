"""Shared helpers for the PyTorch port's parity tests.

The JAX reference calls ``jax.core.trace_state_clean``, which jax 0.9
removed (it lives on as ``jax._src.core.trace_state_clean``).  The
``jax_alias`` fixture restores the name for the duration of ONE port test
and undoes it afterwards, so it never leaks into another file's tests that
share the pytest worker.  Port test modules use it with
``pytestmark = pytest.mark.usefixtures("jax_alias")`` after importing it.

Inputs are made with numpy from a seed and handed to both packages.
"""
from __future__ import annotations

import dataclasses
import enum
import math

import jax
import numpy as np
import pytest
import torch


@pytest.fixture
def jax_alias(monkeypatch):
    monkeypatch.setattr(jax.core, "trace_state_clean",
                        jax._src.core.trace_state_clean, raising=False)
    yield


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip where there is none (decided here, at
    run time, never at import).  TF32 is off for the test, so that the
    references computed with cuBLAS or cuDNN on the card are float32, as
    the kernels are (cuDNN's convolutions default to TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def rand(seed: int, *shape: int) -> np.ndarray:
    """Standard-normal float32 array from ``seed``."""
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def to_jax(a: np.ndarray):
    return jax.numpy.asarray(a)


def to_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def np_of(x) -> np.ndarray:
    """numpy copy of a jax array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _qt_to_dict(qt) -> dict:
    """A reference ``QuantizedTensor`` as the plain dict
    ``repro_torch.convert.params_from_jax`` takes."""
    return {"q": np.asarray(qt.q), "scale": np.asarray(qt.scale),
            "act_scale": None if qt.act_scale is None
            else np.asarray(qt.act_scale),
            "axis": qt.axis, "dtype_name": qt.dtype_name, "bits": qt.bits,
            "pack_size": qt.pack_size}


def tree_to_numpy(tree):
    """A reference pytree (dicts / lists of jax arrays) as numpy arrays;
    each ``QuantizedTensor`` leaf becomes a plain dict of numpy arrays and
    its static fields."""
    from repro.quant import QuantizedTensor
    is_qt = lambda x: isinstance(x, QuantizedTensor)       # noqa: E731
    return jax.tree.map(lambda x: _qt_to_dict(x) if is_qt(x)
                        else np.asarray(x), tree, is_leaf=is_qt)


# f32 vs f32 with a different summation order: relative error grows like
# sqrt(K) * eps32; these stay well above that for the sizes tested.
RTOL = 2e-5
ATOL = 2e-5


def assert_close(got, want, *, rtol: float = RTOL, atol: float = ATOL):
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=rtol, atol=atol)


def plain(x):
    """A result as plain Python: enums by value, dataclasses as (class
    name, fields), arrays as nested lists."""
    if isinstance(x, enum.Enum):
        return ("enum", type(x).__name__, x.value)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, np.ndarray):
        return plain(x.tolist())
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, np.generic):
        return x.item()
    return x


def same(got, want, path="", rel: float = 1e-12) -> None:
    """``got`` EQUAL ``want`` (dataclasses, enums, arrays, containers)
    but for floats, within ``rel`` relative."""
    _same(plain(got), plain(want), path, rel)


def _same(got, want, path, rel):
    if isinstance(want, float) or isinstance(got, float):
        assert isinstance(got, (int, float)) and isinstance(want,
                                                            (int, float)), \
            (path, got, want)
        if math.isinf(want) or math.isnan(want):
            assert got == want or (math.isnan(got) and math.isnan(want))
            return
        assert abs(got - want) <= rel * abs(want), (path, got, want)
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}", rel)
        return
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), \
            (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]", rel)
        return
    assert got == want, (path, got, want)
