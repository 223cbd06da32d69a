"""MobileNetV1 @ 224x224 (Howard et al. 2017) -- the paper's Fig. 14
depthwise (memory-bound) workload: 13 depthwise-separable blocks, whose
depthwise convs run on the ``dwconv`` kernel."""
from repro_torch.vision.models import VisionConfig

CONFIG = VisionConfig(
    name="mobilenet-v1",
    arch="mobilenet_v1",
    input_hw=(224, 224),
    num_classes=1000,
)
