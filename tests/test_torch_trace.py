"""The port's layer tracer (``repro_torch.vision.trace``) against the
reference's ``repro.vision.trace``: the records of all four vision archs
at full size, the ``ConvShape`` / GeMM conversions, the precision sweep and
the paper report (every key but ``"attribution"``, which each package
fills from its own telemetry), the cross-validation of the hand tables in
``repro_torch.core.workloads`` against the traced shapes (the port's
counterpart of ``tests/test_vision.py::TestTraceCrossValidation``), and
that tracing computes nothing.

Tolerances: records, shapes and integers EQUAL; report floats within
1e-12 relative (the same arithmetic on the same integers).
"""
import dataclasses
import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_parity import jax_alias, same  # noqa: F401
from repro.configs import get_vision_config as j_vision_config
from repro.vision import trace as JTR
from repro_torch import vision
from repro_torch.configs import get_vision_config
from repro_torch.core import workloads
from repro_torch.vision import trace

pytestmark = pytest.mark.usefixtures("jax_alias")

ARCHS = ("resnet50", "mobilenet-v1", "yolov3-tiny", "yolov3")
REPORTED = ("resnet50", "yolov3", "yolov3-tiny")
N_CONVS = {"resnet50": 53, "mobilenet-v1": 27, "yolov3-tiny": 13,
           "yolov3": 75}


def _ref_fields(r) -> tuple:
    return dataclasses.astuple(r)


def _port_fields(r) -> tuple:
    """A port record without its batch (``N``), in the reference's field
    order."""
    t = dataclasses.astuple(r)
    return t[:1] + t[2:]


def _shape_tuple(c):
    return (c.H, c.W, c.C_in, c.C_out, c.n, c.stride, c.padding)


def test_public_names_match_reference():
    assert trace.__all__ == JTR.__all__
    for name in trace.__all__:
        assert getattr(vision, name) is getattr(trace, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_records_equal_reference(arch):
    got = trace.trace_model(get_vision_config(arch))
    want = JTR.trace_model(j_vision_config(arch))
    assert len(got) == N_CONVS[arch]
    assert [_port_fields(r) for r in got] == [_ref_fields(r) for r in want]
    assert all(r.N == 1 for r in got)
    assert [(r.H_out, r.W_out, r.macs) for r in got] == \
        [(r.H_out, r.W_out, r.macs) for r in want]


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_reduced_configs_equal_reference(arch):
    got = trace.trace_model(get_vision_config(arch, reduced=True), batch=3)
    want = JTR.trace_model(j_vision_config(arch, reduced=True), batch=3)
    assert [_port_fields(r) for r in got] == [_ref_fields(r) for r in want]
    assert {r.N for r in got} == {3}


@pytest.mark.parametrize("arch", ARCHS)
def test_conv_shapes_and_gemms_equal_reference(arch):
    for dw in (False, True):
        same(trace.conv_shapes(get_vision_config(arch),
                               include_depthwise=dw),
             JTR.conv_shapes(j_vision_config(arch), include_depthwise=dw))
    same(trace.lowered_gemms(get_vision_config(arch)),
         JTR.lowered_gemms(j_vision_config(arch)))


@pytest.mark.parametrize("arch", REPORTED)
def test_paper_report_equals_reference(arch):
    got = trace.paper_report(get_vision_config(arch))
    want = JTR.paper_report(j_vision_config(arch))
    assert got.keys() == want.keys()
    att = got.pop("attribution")
    want.pop("attribution")
    same(got, want)
    # telemetry is off: the section says why it is empty
    assert att["available"] is False and "measure_dispatch" in att["reason"]


@pytest.mark.parametrize("arch", REPORTED)
def test_precision_report_equals_reference(arch):
    for kw in ({}, {"array": (64, 64), "feeder_group": 8,
                    "precisions": ("fp32", "int4")}):
        same(trace.precision_report(get_vision_config(arch), **kw),
             JTR.precision_report(j_vision_config(arch), **kw))


def test_to_conv_shape_rejects_what_the_reference_rejects():
    kw = dict(name="bad", H=8, W=8, C_in=8, C_out=8, kh=3, kw=3)
    for mod, extra in ((trace, {"N": 1}), (JTR, {})):
        with pytest.raises(ValueError, match="no ConvShape equivalent"):
            mod.to_conv_shape(mod.TracedConv(
                **kw, **extra, stride=(2, 1), padding=((1, 1), (1, 1))))
        with pytest.raises(ValueError, match="grouped conv"):
            mod.to_conv_shape(mod.TracedConv(
                **kw, **extra, stride=(1, 1), padding=((1, 1), (1, 1)),
                groups=2))


# ---------------------------------------------------------------------------
# the hand tables against the traced shapes
# ---------------------------------------------------------------------------


class TestTraceCrossValidation:
    @pytest.mark.parametrize("arch,table", [
        ("resnet50", "resnet50_convs"), ("yolov3", "yolov3_convs"),
        ("yolov3-tiny", "yolov3_tiny_convs")])
    def test_table_matches_trace(self, arch, table):
        traced = trace.conv_shapes(get_vision_config(arch))
        assert [_shape_tuple(c) for c in traced] == \
            [_shape_tuple(c) for c in getattr(workloads, table)()]

    def test_mobilenet_dw_table_matches_trace(self):
        # MOBILENET_DW lists the unique depthwise shapes (14x14x512 s1 runs
        # five times)
        recs = [r for r in trace.trace_model(get_vision_config(
            "mobilenet-v1")) if r.depthwise]
        assert len(recs) == 13
        uniq = list(dict.fromkeys(
            _shape_tuple(trace.to_conv_shape(r)) for r in recs))
        assert uniq == [_shape_tuple(c) for c in workloads.MOBILENET_DW]

    @pytest.mark.parametrize("entry,arch", [
        ("Resnet50_0_conv2d", "resnet50"), ("Resnet50_1_conv2d", "resnet50"),
        ("YOLO_v3_0_conv2d", "yolov3"), ("YOLO_v3_1_conv2d", "yolov3")])
    def test_table3_conv_gemms_vs_trace(self, entry, arch):
        # Table 3's printed conv GeMMs carry a traced layer's filter
        # geometry (M, K) but not its window count N
        printed = workloads.TABLE3[entry]
        traced = {g for _, g in trace.lowered_gemms(get_vision_config(arch))}
        assert any(g.M == printed.M and g.K == printed.K for g in traced)
        assert printed not in traced


# ---------------------------------------------------------------------------
# no compute
# ---------------------------------------------------------------------------


class _Ops(TorchDispatchMode):
    """Every aten op dispatched in scope, with the devices of its tensor
    outputs."""

    def __init__(self):
        super().__init__()
        self.devices: set = set()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.devices.add(t.device.type)
        return out


@pytest.mark.parametrize("arch", ["resnet50", "yolov3"])
def test_tracing_runs_no_compute(arch, monkeypatch):
    # every op of the trace -- the model's construction and the forward --
    # runs on the meta device, where tensors have shapes and no data, and
    # no weight is drawn
    def no_draw(*a, **k):
        raise AssertionError("tracing drew a random weight")
    monkeypatch.setattr(torch, "randn", no_draw)
    t0 = time.perf_counter()
    with _Ops() as ops:
        recs = trace.trace_model(get_vision_config(arch))
    assert time.perf_counter() - t0 < 30
    assert len(recs) == N_CONVS[arch] and ops.ops > len(recs)
    assert ops.devices == {"meta"}
    first = recs[0]
    assert first.stride == ((2, 2) if arch == "resnet50" else (1, 1))
    assert all(r.macs > 0 for r in recs)
