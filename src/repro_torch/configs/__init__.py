"""Architecture configs of the port.

``get_config(name)`` resolves the reference's ten LM ids, in the
reference's order: ``get_config("yi-9b")`` or ``get_config("zamba2-7b")``,
or with ``reduced=True`` for the CPU test variant.  ``get_vision_config(name)`` resolves the
conv-net zoo: ResNet50, MobileNetV1, YOLOv3 and YOLOv3-tiny.
"""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "deepseek-v3-671b",
    "mixtral-8x7b",
    "yi-9b",
    "deepseek-coder-33b",
    "qwen2.5-14b",
    "llama3-405b",
    "musicgen-medium",
    "zamba2-7b",
    "falcon-mamba-7b",
    "internvl2-1b",
)

VISION_IDS = (
    "resnet50",
    "yolov3-tiny",
    "yolov3",
    "mobilenet-v1",
)


def _load(name: str, *, reduced: bool):
    mod_name = name.replace("-", "_").replace(".", "_")
    cfg = importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
    return cfg.reduced() if reduced else cfg


def get_config(name: str, *, reduced: bool = False):
    if name in VISION_IDS:
        raise ValueError(f"{name!r} is a vision config: use get_vision_config")
    if name not in ARCH_IDS:
        raise ValueError(f"unknown LM config {name!r}; one of {ARCH_IDS}")
    return _load(name, reduced=reduced)


def get_vision_config(name: str, *, reduced: bool = False):
    if name not in VISION_IDS:
        raise ValueError(f"unknown vision config {name!r}; one of {VISION_IDS}")
    return _load(name, reduced=reduced)
