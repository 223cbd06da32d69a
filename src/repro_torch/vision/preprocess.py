"""Letterbox preprocessing on the device.

Aspect-preserving resize onto the model's input canvas with centered
constant-fill padding (the YOLO convention: fill 0.5), so the engine's
step shape stays fixed whatever size arrives.  The reference resizes with
``jax.image.resize(method="linear")``, which antialiases when it shrinks;
here that is ``F.interpolate(mode="bilinear", antialias=True)``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["letterbox", "letterbox_geometry"]


def letterbox_geometry(in_hw: tuple[int, int], target_hw: tuple[int, int]
                       ) -> tuple[tuple[int, int], tuple[int, int]]:
    """((resized_h, resized_w), (pad_top, pad_left)) for an aspect-
    preserving fit of ``in_hw`` into ``target_hw``."""
    h, w = in_hw
    th, tw = target_hw
    if min(h, w) < 1 or min(th, tw) < 1:
        raise ValueError(f"degenerate letterbox geometry {in_hw}->{target_hw}")
    scale = min(th / h, tw / w)
    nh = max(1, min(th, round(h * scale)))
    nw = max(1, min(tw, round(w * scale)))
    return (nh, nw), ((th - nh) // 2, (tw - nw) // 2)


def letterbox(image, target_hw: tuple[int, int], *, fill: float = 0.5,
              dtype=torch.float32, device=None) -> torch.Tensor:
    """Aspect-preserving resize + centered pad of an ``(H, W, C)`` image
    (numpy array or tensor) to ``target_hw``, on ``device`` (default: the
    image's own device)."""
    if not isinstance(image, torch.Tensor):
        image = torch.as_tensor(np.asarray(image))
    if image.dim() != 3:
        raise ValueError(f"letterbox expects (H, W, C), got {tuple(image.shape)}")
    img = image.to(device=device, dtype=torch.float32)
    (nh, nw), (pt, pl) = letterbox_geometry(tuple(img.shape[:2]), target_hw)
    th, tw = target_hw
    resized = F.interpolate(img.permute(2, 0, 1)[None], size=(nh, nw),
                            mode="bilinear", align_corners=False,
                            antialias=True)[0].permute(1, 2, 0)
    canvas = torch.full((th, tw, img.shape[2]), fill, dtype=torch.float32,
                        device=img.device)
    canvas[pt:pt + nh, pl:pl + nw] = resized
    return canvas.to(dtype)
