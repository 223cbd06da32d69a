"""The conv-net model zoo and its serving engine."""
