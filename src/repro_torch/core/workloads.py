"""Workload suites from the paper (Table 3, Fig. 14, Fig. 11 / §5.2.1).

The port's copy of ``repro.core.workloads``.

GeMM workloads are ``(M, K, N)`` exactly as printed in Table 3.  The GEMV and
depth-wise-conv suites follow Fig. 14's description (MobileNet DW layers and
selected matrix-vector shapes).  The ResNet50 / YOLOv3 conv layer lists are the
standard public architectures (He et al. 2016 @224x224; Redmon & Farhadi 2018
@416x416) used for the Fig. 11 / §5.2.1 traffic & energy numbers.

Every conv table here is cross-validated against shapes traced from the
*runnable* models in ``repro_torch.vision`` (``vision/trace.py``, exercised
by ``tests/test_torch_trace.py``), so a transcription error in the paper-figure
inputs fails CI instead of silently skewing the analytic results.
"""
from __future__ import annotations

from repro_torch.core.dataflows import GemmShape
from repro_torch.core.im2col_model import ConvShape

# --- Table 3 -----------------------------------------------------------------
TABLE3: dict[str, GemmShape] = {
    "TF0": GemmShape(31999, 84, 1024),
    "TF1": GemmShape(84, 4096, 1024),
    "GNMT0": GemmShape(128, 4096, 2048),
    "GNMT1": GemmShape(2048, 32, 4096),
    "GPT3_0": GemmShape(1024, 1024, 80),
    "GPT3_1": GemmShape(1024, 2560, 7680),
    "GPT3_2": GemmShape(1024, 2560, 10240),
    "GPT3_3": GemmShape(1024, 2560, 50257),
    "NCF0": GemmShape(2048, 128, 1),
    "NCF1": GemmShape(256, 2048, 256),
    "DB0": GemmShape(1024, 50000, 16),
    "DB1": GemmShape(35, 2560, 4096),
    "Resnet50_0_conv2d": GemmShape(64, 147, 62500),
    "Resnet50_1_conv2d": GemmShape(512, 4608, 676),
    "YOLO_v3_0_conv2d": GemmShape(64, 288, 42436),
    "YOLO_v3_1_conv2d": GemmShape(128, 576, 10404),
    "GEMM_0": GemmShape(128, 10, 128),
    "GEMM_1": GemmShape(2048, 10, 2048),
    "GEMM_2": GemmShape(1024, 1024, 128),
    "GEMM_3": GemmShape(64, 2560, 2560),
}

# --- Fig. 14: memory-bound suites ---------------------------------------------
GEMV: dict[str, GemmShape] = {
    "MV_0": GemmShape(1, 1024, 4096),
    "MV_1": GemmShape(1, 4096, 4096),
    "MV_2": GemmShape(1, 2560, 7680),
    "MV_3": GemmShape(1, 8192, 1024),
}

# MobileNetV1 depth-wise layers (Howard et al. 2017, 224x224): each DW conv is
# C_in == C_out groups of 3x3x1 filters -> per-channel GeMM (1, 9, H_out*W_out).
MOBILENET_DW: list[ConvShape] = [
    ConvShape(112, 112, 32, 32, 3, stride=1, padding=1, name="dw1"),
    ConvShape(112, 112, 64, 64, 3, stride=2, padding=1, name="dw2"),
    ConvShape(56, 56, 128, 128, 3, stride=1, padding=1, name="dw3"),
    ConvShape(56, 56, 128, 128, 3, stride=2, padding=1, name="dw4"),
    ConvShape(28, 28, 256, 256, 3, stride=1, padding=1, name="dw5"),
    ConvShape(28, 28, 256, 256, 3, stride=2, padding=1, name="dw6"),
    ConvShape(14, 14, 512, 512, 3, stride=1, padding=1, name="dw7"),
    ConvShape(14, 14, 512, 512, 3, stride=2, padding=1, name="dw8"),
    ConvShape(7, 7, 1024, 1024, 3, stride=1, padding=1, name="dw9"),
]

# --- ResNet50 conv stack @224 (conv layers only; He et al. 2016) --------------
def _bottleneck(h: int, c_in: int, c_mid: int, c_out: int, stride: int,
                tag: str) -> list[ConvShape]:
    h2 = h // stride
    layers = [
        ConvShape(h, h, c_in, c_mid, 1, stride=1, padding=0, name=f"{tag}.conv1"),
        ConvShape(h, h, c_mid, c_mid, 3, stride=stride, padding=1, name=f"{tag}.conv2"),
        ConvShape(h2, h2, c_mid, c_out, 1, stride=1, padding=0, name=f"{tag}.conv3"),
    ]
    if stride != 1 or c_in != c_out:
        layers.append(
            ConvShape(h, h, c_in, c_out, 1, stride=stride, padding=0, name=f"{tag}.down")
        )
    return layers


def resnet50_convs() -> list[ConvShape]:
    convs = [ConvShape(224, 224, 3, 64, 7, stride=2, padding=3, name="conv1")]
    spec = [  # (blocks, c_mid, c_out, first_stride, in_hw)
        (3, 64, 256, 1, 56),
        (4, 128, 512, 2, 56),
        (6, 256, 1024, 2, 28),
        (3, 512, 2048, 2, 14),
    ]
    c_in = 64
    for si, (blocks, c_mid, c_out, stride0, hw) in enumerate(spec):
        h = hw
        for b in range(blocks):
            stride = stride0 if b == 0 else 1
            convs.extend(_bottleneck(h, c_in, c_mid, c_out, stride, f"l{si+1}b{b+1}"))
            h = h // stride
            c_in = c_out
    return convs


# --- YOLOv3 conv stack @416 (Darknet-53 backbone + head; Redmon 2018) ---------
def yolov3_convs() -> list[ConvShape]:
    convs: list[ConvShape] = []

    def add(h, c_in, c_out, n, stride, name):
        convs.append(ConvShape(h, h, c_in, c_out, n, stride=stride,
                               padding=n // 2, name=name))

    add(416, 3, 32, 3, 1, "conv0")
    # darknet-53 residual stages: (downsample, then `reps` x [1x1 half, 3x3 full])
    stages = [(416, 32, 64, 1), (208, 64, 128, 2), (104, 128, 256, 8),
              (52, 256, 512, 8), (26, 512, 1024, 4)]
    for h, c_in, c_out, reps in stages:
        add(h, c_in, c_out, 3, 2, f"down{c_out}")
        h2 = h // 2
        for r in range(reps):
            add(h2, c_out, c_out // 2, 1, 1, f"res{c_out}.{r}.a")
            add(h2, c_out // 2, c_out, 3, 1, f"res{c_out}.{r}.b")
    # detection head (scale 1: 13x13)
    for r in range(3):
        add(13, 1024, 512, 1, 1, f"head1.{r}.a")
        add(13, 512, 1024, 3, 1, f"head1.{r}.b")
    add(13, 1024, 255, 1, 1, "det1")
    # scale 2: upsample + concat(256+512) @26
    add(13, 512, 256, 1, 1, "up1")
    add(26, 768, 256, 1, 1, "head2.0.a")
    add(26, 256, 512, 3, 1, "head2.0.b")
    for r in range(1, 3):
        add(26, 512, 256, 1, 1, f"head2.{r}.a")
        add(26, 256, 512, 3, 1, f"head2.{r}.b")
    add(26, 512, 255, 1, 1, "det2")
    # scale 3: upsample + concat(128+256) @52
    add(26, 256, 128, 1, 1, "up2")
    add(52, 384, 128, 1, 1, "head3.0.a")
    add(52, 128, 256, 3, 1, "head3.0.b")
    for r in range(1, 3):
        add(52, 256, 128, 1, 1, f"head3.{r}.a")
        add(52, 128, 256, 3, 1, f"head3.{r}.b")
    add(52, 256, 255, 1, 1, "det3")
    return convs


# --- YOLOv3-tiny conv stack @416 (2-scale head; Redmon 2018) ------------------
def yolov3_tiny_convs() -> list[ConvShape]:
    """The 13 convs of YOLOv3-tiny (maxpools between backbone convs carry no
    weights and are excluded, like ResNet50's pool above)."""
    convs: list[ConvShape] = []

    def add(h, c_in, c_out, n, name):
        convs.append(ConvShape(h, h, c_in, c_out, n, stride=1,
                               padding=n // 2, name=name))

    backbone = [(416, 3, 16), (208, 16, 32), (104, 32, 64), (52, 64, 128),
                (26, 128, 256), (13, 256, 512)]
    for i, (h, c_in, c_out) in enumerate(backbone):
        add(h, c_in, c_out, 3, f"conv{i + 1}")
    add(13, 512, 1024, 3, "conv7")
    add(13, 1024, 256, 1, "neck")
    add(13, 256, 512, 3, "head1")
    add(13, 512, 255, 1, "det1")
    add(13, 256, 128, 1, "up1")
    add(26, 384, 256, 3, "head2")      # concat(128 upsampled + 256 route)
    add(26, 256, 255, 1, "det2")
    return convs
