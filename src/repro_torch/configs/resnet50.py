"""ResNet50 @ 224x224 (He et al. 2016) -- the paper's Fig. 11 / Table 3
conv workload, the port's main path."""
from repro_torch.vision.models import VisionConfig

CONFIG = VisionConfig(
    name="resnet50",
    arch="resnet",
    input_hw=(224, 224),
    num_classes=1000,
    stage_blocks=(3, 4, 6, 3),
)
