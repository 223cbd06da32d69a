"""Architecture configs of the port.

``get_vision_config(name)`` resolves the conv-net zoo as the reference
does: ResNet50, MobileNetV1, YOLOv3 and YOLOv3-tiny are all ported (the
LM configs come with the LM slice).
"""
from __future__ import annotations

import importlib

VISION_IDS = (
    "resnet50",
    "yolov3-tiny",
    "yolov3",
    "mobilenet-v1",
)


def get_vision_config(name: str, *, reduced: bool = False):
    if name not in VISION_IDS:
        raise ValueError(f"unknown vision config {name!r}; one of {VISION_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{name.replace('-', '_')}")
    cfg = mod.CONFIG
    return cfg.reduced() if reduced else cfg
