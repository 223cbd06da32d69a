"""Optimizers of the port: AdamW, its schedule and gradient compression."""
