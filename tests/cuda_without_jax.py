"""A pytest plugin that runs the port's ``cuda``-marked tests where there
is a CUDA card but no JAX::

    PYTHONPATH=src:tests python -m pytest -p cuda_without_jax -m cuda \\
        tests/test_torch_*.py

The port's test modules import the JAX reference at the top for their
parity tests; their ``cuda`` tests hold each kernel against its plain
PyTorch version and use none of it.  Where ``jax`` cannot be imported,
this stands in an empty module for ``jax``, ``jaxlib``, the reference
package ``repro`` (which imports JAX) and ``ml_dtypes`` where that is
missing too, each attribute of which is a stand-in object, so that the
modules import and their ``cuda`` tests run.  A test that does use the
reference fails under it, so select ``-m cuda`` alone.  Where JAX can be
imported the plugin does nothing.
"""
from __future__ import annotations

import importlib.abc
import importlib.machinery
import importlib.util
import sys
from unittest import mock


def _missing(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is None
    except (ImportError, ValueError):
        return True


class _StandIns(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Finds every module under ``roots`` and makes each a stand-in."""

    def __init__(self, roots: tuple[str, ...]):
        self.roots = roots

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] not in self.roots:
            return None
        return importlib.machinery.ModuleSpec(name, self, is_package=True)

    def create_module(self, spec):
        return mock.MagicMock(name=spec.name)

    def exec_module(self, module):
        pass


if _missing("jax"):
    _roots = ("jax", "jaxlib", "repro") + (
        ("ml_dtypes",) if _missing("ml_dtypes") else ())
    sys.meta_path.insert(0, _StandIns(_roots))
