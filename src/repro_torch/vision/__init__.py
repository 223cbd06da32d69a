"""The conv-net model zoo and its serving engine (port of
``repro.vision``): the networks (``models``, ``blocks``), the
continuous-batching engine (``engine``), letterboxing on the device
(``preprocess``), YOLO decode and NMS (``postprocess``) and the layer
tracer that feeds the paper's analytic models (``trace``)."""
from repro_torch.vision.engine import ImageRequest, VisionEngine, make_infer_step
from repro_torch.vision.models import ARCHS, VisionConfig, apply, init
from repro_torch.vision.postprocess import YOLO_ANCHORS, nms, postprocess_yolo
from repro_torch.vision.preprocess import letterbox, unletterbox_boxes
from repro_torch.vision.trace import (TracedConv, conv_shapes, lowered_gemms,
                                      paper_report, precision_report,
                                      to_conv_shape, trace_model)

__all__ = [
    "ARCHS",
    "ImageRequest",
    "TracedConv",
    "VisionConfig",
    "VisionEngine",
    "YOLO_ANCHORS",
    "apply",
    "conv_shapes",
    "init",
    "letterbox",
    "lowered_gemms",
    "make_infer_step",
    "nms",
    "paper_report",
    "postprocess_yolo",
    "precision_report",
    "to_conv_shape",
    "trace_model",
    "unletterbox_boxes",
]
