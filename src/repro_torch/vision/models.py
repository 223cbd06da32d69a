"""The conv-net model zoo in the port: ResNet50 in this slice.

``init(cfg, generator=...)`` builds an ``nn.Module`` holding the
parameters in the reference's layout; ``apply(model, x, cfg)`` runs
inference on NHWC input and returns ``(N, num_classes)`` logits.  The other
architectures of the reference (MobileNetV1, YOLOv3, YOLOv3-tiny) have a
config here but raise ``NotImplementedError`` until they are ported.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.vision import blocks as B

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

ARCHS = ("resnet", "mobilenet_v1", "yolov3_tiny", "yolov3")
PORTED_ARCHS = ("resnet",)


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    name: str
    arch: str                                 # one of ARCHS
    input_hw: tuple[int, int] = (224, 224)
    in_channels: int = 3
    num_classes: int = 1000
    width_mult: float = 1.0
    # resnet: bottleneck blocks per stage; yolov3: residual reps per stage
    stage_blocks: tuple[int, ...] = (3, 4, 6, 3)
    anchors_per_scale: int = 3                # yolo heads
    param_dtype: str = "float32"

    def __post_init__(self) -> None:
        if self.arch not in ARCHS:
            raise ValueError(f"arch must be one of {ARCHS}, got {self.arch!r}")
        if self.arch == "yolov3" and len(self.stage_blocks) != 5:
            raise ValueError(
                "yolov3 needs one stage_blocks entry per Darknet-53 stage "
                f"(5), got {self.stage_blocks}")

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def head_channels(self) -> int:
        """YOLO detection-map channels: anchors * (x, y, w, h, obj + classes)."""
        return self.anchors_per_scale * (5 + self.num_classes)

    def reduced(self) -> "VisionConfig":
        """Small same-family variant for CPU tests."""
        hw = (64, 64) if self.arch.startswith("yolo") else (32, 32)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            input_hw=hw,
            num_classes=8,
            width_mult=self.width_mult * 0.125,
            stage_blocks=tuple(1 for _ in self.stage_blocks),
        )


def _c(cfg: VisionConfig, c: int) -> int:
    """Width-scaled channel count (full configs: identity)."""
    return max(4, int(round(c * cfg.width_mult)))


def _check_ported(cfg: VisionConfig) -> None:
    if cfg.arch not in PORTED_ARCHS:
        raise NotImplementedError(f"{cfg.arch}: not ported yet")


# ---------------------------------------------------------------------------
# ResNet50 (He et al. 2016): bottleneck stages, the paper's Fig. 11 workload
# ---------------------------------------------------------------------------


class ResNet(nn.Module):
    """Stem conv, bottleneck stages, dense head (reference pytree layout:
    ``stem``, ``stages[si][bi]``, ``head``)."""

    def __init__(self, cfg: VisionConfig, stem: B.ConvBN,
                 stages: list[list[B.Bottleneck]], head: B.Dense):
        super().__init__()
        self.cfg = cfg
        self.stem = stem
        self.stages = nn.ModuleList(nn.ModuleList(s) for s in stages)
        self.head = head

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply(self, x, self.cfg)


def _resnet_init(cfg: VisionConfig, generator: torch.Generator,
                 device: torch.device) -> ResNet:
    kw = dict(dtype=cfg.pdtype, device=device)
    stem_c = _c(cfg, 64)
    stem = B.init_conv_bn(generator, 7, cfg.in_channels, stem_c, **kw)
    stages = []
    c_in = stem_c
    for si, n_blocks in enumerate(cfg.stage_blocks):
        c_mid = _c(cfg, 64 * 2 ** si)
        c_out = 4 * c_mid
        stage = []
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            stage.append(B.init_bottleneck(generator, c_in, c_mid, c_out,
                                           stride=stride, **kw))
            c_in = c_out
        stages.append(stage)
    head = B.init_dense(generator, c_in, cfg.num_classes, **kw)
    return ResNet(cfg, stem, stages, head)


def resnet_features(p: ResNet, x: torch.Tensor,
                    cfg: VisionConfig) -> torch.Tensor:
    """The conv stack: stem, max pool and bottleneck stages, up to (not
    including) the global average pool."""
    h = B.conv_bn_act(p.stem, x, stride=2, padding=3, name="conv1")
    h = B.max_pool(h, 3, stride=2, padding=1)
    for si, n_blocks in enumerate(cfg.stage_blocks):
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            h = B.bottleneck(p.stages[si][bi], h, stride=stride,
                             name=f"l{si + 1}b{bi + 1}")
    return h


def _resnet_apply(p: ResNet, x: torch.Tensor,
                  cfg: VisionConfig) -> torch.Tensor:
    return B.dense(p.head, B.global_avg_pool(resnet_features(p, x, cfg)))


# ---------------------------------------------------------------------------
# public init / apply
# ---------------------------------------------------------------------------


def init(cfg: VisionConfig, *, generator: torch.Generator,
         device=None) -> nn.Module:
    """Build the model (BN pre-folded into conv weight + bias) with every
    random draw from ``generator`` (a CPU generator).  ``device=None``
    means the CUDA device and raises without one."""
    _check_ported(cfg)
    dev = resolve_device(device)
    return _resnet_init(cfg, generator, dev)


def apply(model: nn.Module, x: torch.Tensor,
          cfg: VisionConfig) -> torch.Tensor:
    """Inference forward pass.  ``x: (N, H, W, C)`` in ``cfg.input_hw``."""
    _check_ported(cfg)
    if tuple(x.shape[1:]) != (*cfg.input_hw, cfg.in_channels):
        raise ValueError(
            f"{cfg.name}: expected input (N, {cfg.input_hw[0]}, "
            f"{cfg.input_hw[1]}, {cfg.in_channels}), got {tuple(x.shape)}")
    with torch.no_grad():
        return _resnet_apply(model, x, cfg)
