"""YOLO head postprocessing: box decode + class-aware NMS, on the device.

Port of ``repro.vision.postprocess`` in PyTorch tensor ops with fixed
output shapes: the detection maps never go to the host for the
O(H*W*anchors) decode, only the final ``max_det`` rows do.  The reference
wrote no Pallas kernel here, so no hand kernel is owed.

Decode follows YOLOv3: per cell/anchor ``xy = (sigmoid(t_xy) + cell) /
grid``, ``wh = anchor * exp(t_wh)`` (``t_wh`` clipped to +-10), objectness
and class scores via sigmoid, boxes as normalized xyxy.  NMS is greedy and
class-aware via the coordinate-offset trick (each class's boxes, clipped to
the canvas, are shifted to a disjoint region, so one IoU pass never
suppresses across classes), ``max_det`` rows with a valid flag, and runs
batched over the images: the reference's ``vmap`` written out.  The greedy
loop makes no host round trip: every pick stays on the device.
"""
from __future__ import annotations

import torch

__all__ = ["YOLO_ANCHORS", "decode_scale", "decode_outputs", "nms",
           "postprocess_yolo"]

# COCO anchors (pixels on the nominal 416x416 canvas), per detection head,
# keyed by the model-zoo output names (det1 = coarsest grid).
YOLO_ANCHORS = {
    "yolov3": {
        "det1": ((116, 90), (156, 198), (373, 326)),
        "det2": ((30, 61), (62, 45), (59, 119)),
        "det3": ((10, 13), (16, 30), (33, 23)),
    },
    "yolov3_tiny": {
        "det1": ((81, 82), (135, 169), (344, 319)),
        "det2": ((10, 14), (23, 27), (37, 58)),
    },
}
_NOMINAL_CANVAS = 416.0


def decode_scale(det: torch.Tensor, anchors, *, num_classes: int,
                 canvas: float = _NOMINAL_CANVAS
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One detection map -> (boxes (N, h*w*A, 4) xyxy in [0, 1],
    scores (N, h*w*A, C) = sigmoid(obj) * sigmoid(cls))."""
    N, h, w, _ = det.shape
    A = len(anchors)
    det = det.reshape(N, h, w, A, 5 + num_classes).float()
    dev = det.device
    cell_x = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :,
                                                              None]
    cell_y = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None,
                                                              None]
    cx = (torch.sigmoid(det[..., 0]) + cell_x) / w
    cy = (torch.sigmoid(det[..., 1]) + cell_y) / h
    anc = torch.tensor(anchors, dtype=torch.float32, device=dev) / canvas
    # clip t_wh so exp() of random/garbage heads cannot overflow
    bw = anc[:, 0] * torch.exp(det[..., 2].clamp(-10.0, 10.0))
    bh = anc[:, 1] * torch.exp(det[..., 3].clamp(-10.0, 10.0))
    obj = torch.sigmoid(det[..., 4])
    cls = torch.sigmoid(det[..., 5:])
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                        dim=-1)
    scores = obj[..., None] * cls
    return (boxes.reshape(N, h * w * A, 4),
            scores.reshape(N, h * w * A, num_classes))


def decode_outputs(outputs: dict, anchors: dict, *, num_classes: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode and concatenate every scale of a YOLO model-zoo output dict."""
    boxes, scores = [], []
    for name in sorted(outputs):
        b, s = decode_scale(outputs[name], anchors[name],
                            num_classes=num_classes)
        boxes.append(b)
        scores.append(s)
    return torch.cat(boxes, dim=1), torch.cat(scores, dim=1)


def _iou(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of xyxy ``box (..., 4)`` against ``boxes (..., P, 4)``."""
    box = box[..., None, :]
    lt = torch.maximum(box[..., :2], boxes[..., :2])
    rb = torch.minimum(box[..., 2:], boxes[..., 2:])
    inter = torch.prod((rb - lt).clamp(min=0.0), dim=-1)
    area = torch.prod(box[..., 2:] - box[..., :2], dim=-1).clamp(min=0.0)
    areas = torch.prod(boxes[..., 2:] - boxes[..., :2], dim=-1).clamp(min=0.0)
    return inter / (area + areas - inter).clamp(min=1e-9)


def _nms_batched(boxes, scores, classes, *, iou_thresh: float,
                 score_thresh: float, max_det: int):
    """:func:`nms` over a leading image axis: ``boxes (N, P, 4)``,
    ``scores (N, P)``, ``classes (N, P)``."""
    N = boxes.shape[0]
    live = torch.where(scores >= score_thresh, scores,
                       torch.zeros_like(scores))
    # suppression geometry is clipped to the canvas first, so an offset of
    # 2/class fully separates classes even for degenerate oversized boxes
    shifted = boxes.clamp(0.0, 1.0) + (classes.float() * 2.0)[..., None]
    rows = torch.arange(N, device=boxes.device)
    picks = torch.full((N, max_det), -1, dtype=torch.int64,
                       device=boxes.device)
    for i in range(max_det):
        j = live.argmax(dim=-1)                        # (N,)
        ok = live[rows, j] > 0.0
        picks[:, i] = torch.where(ok, j, -1)
        iou = _iou(shifted[rows, j], shifted)          # (N, P)
        suppress = ok[:, None] & (iou > iou_thresh)    # includes j
        live = torch.where(suppress, torch.zeros_like(live), live)
    valid = picks >= 0
    take = picks.clamp(min=0)
    b = boxes[rows[:, None], take]
    return (torch.where(valid[..., None], b, torch.zeros_like(b)),
            torch.where(valid, scores[rows[:, None], take],
                        torch.zeros((), device=boxes.device)),
            torch.where(valid, classes[rows[:, None], take],
                        torch.zeros((), dtype=classes.dtype,
                                    device=boxes.device)),
            valid)


def nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor, *,
        iou_thresh: float = 0.45, score_thresh: float = 0.25,
        max_det: int = 100):
    """Greedy class-aware NMS with fixed-shape outputs.

    ``boxes (P, 4)`` normalized xyxy, ``scores (P,)``, ``classes (P,)``.
    Returns ``(boxes (max_det, 4), scores (max_det,), classes (max_det,),
    valid (max_det,) bool)`` -- invalid rows are zeroed."""
    out = _nms_batched(boxes[None], scores[None], classes[None],
                       iou_thresh=iou_thresh, score_thresh=score_thresh,
                       max_det=max_det)
    return tuple(t[0] for t in out)


def postprocess_yolo(outputs: dict, *, arch: str, num_classes: int,
                     anchors: dict | None = None, iou_thresh: float = 0.45,
                     score_thresh: float = 0.25,
                     max_det: int = 100) -> dict:
    """Model-zoo YOLO outputs -> batched fixed-shape detections.

    Returns ``{"boxes" (N, max_det, 4), "scores" (N, max_det),
    "classes" (N, max_det) int32, "valid" (N, max_det) bool}``, on the
    maps' device."""
    anchors = anchors if anchors is not None else YOLO_ANCHORS[arch]
    if set(anchors) != set(outputs):
        raise ValueError(
            f"anchor scales {sorted(anchors)} do not match model outputs "
            f"{sorted(outputs)}")
    boxes, scores = decode_outputs(outputs, anchors,
                                   num_classes=num_classes)
    best, cls = scores.max(dim=-1)                        # (N, P)
    b, s, c, v = _nms_batched(boxes, best, cls.to(torch.int32),
                              iou_thresh=iou_thresh,
                              score_thresh=score_thresh, max_det=max_det)
    return {"boxes": b, "scores": s, "classes": c, "valid": v}
