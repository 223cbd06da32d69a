"""YOLOv3 @ 416x416 (Darknet-53 backbone, 3-scale head; Redmon & Farhadi
2018) -- the paper's Fig. 11 / §5.2.1 detection workload.  ``stage_blocks``
are the Darknet-53 residual repeats."""
from repro_torch.vision.models import VisionConfig

CONFIG = VisionConfig(
    name="yolov3",
    arch="yolov3",
    input_hw=(416, 416),
    num_classes=80,
    stage_blocks=(1, 2, 8, 8, 4),
    anchors_per_scale=3,
)
