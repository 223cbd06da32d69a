"""YOLOv3-tiny @ 416x416 (Redmon & Farhadi 2018): the light 2-scale
detector -- the serving-friendly sibling of the paper's YOLOv3 workload."""
from repro_torch.vision.models import VisionConfig

CONFIG = VisionConfig(
    name="yolov3-tiny",
    arch="yolov3_tiny",
    input_hw=(416, 416),
    num_classes=80,
    anchors_per_scale=3,
)
