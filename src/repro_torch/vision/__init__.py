"""The conv-net model zoo and its serving engine (ResNet50 in this slice)."""
