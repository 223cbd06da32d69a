"""AdamW with global-norm clipping, a warmup-cosine schedule and a
configurable moment dtype.

Port of ``repro.optim.adamw``, formula for formula.  Parameters, gradients
and moments are dicts of tensors keyed by the parameter's name
(``model.named_parameters()``); the update writes the parameters and the
moments in place (the reference returns new arrays), which keeps one copy
of a full-width training state on the card.  Every quantity stays on the
parameters' device: the step counter, the learning rate and the norm are
0-dim tensors, so a step waits on the host for nothing.
"""
from __future__ import annotations

import dataclasses
import math

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"

    @property
    def sdtype(self) -> torch.dtype:
        return _DTYPES[self.state_dtype]


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio * lr``."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: dict[str, torch.Tensor], cfg: OptConfig) -> dict:
    """Zero moments ``mu`` / ``nu`` of each parameter (in ``cfg.sdtype``)
    and a zero int32 step, on the parameters' device."""
    dev = next(iter(params.values())).device
    zeros = {n: torch.zeros(p.shape, dtype=cfg.sdtype, device=p.device)
             for n, p in params.items()}
    return {"mu": zeros,
            "nu": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tensors: dict[str, torch.Tensor]) -> torch.Tensor:
    """The float32 L2 norm of every tensor together (a sum a tensor, then
    the sum of those, as the reference takes it)."""
    sums = [torch.sum(torch.square(x.float())) for x in tensors.values()]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float
                        ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """``grads`` scaled by ``min(1, max_norm / norm)``, and the norm."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, \
        norm


_NO_DECAY_KEYS = ("scale", "bias", "dt_bias", "A_log", "conv_b",
                  "conv_x_b", "conv_b_b", "conv_c_b", "bq", "bk", "bv", "D")


def decays(name: str) -> bool:
    """Whether weight decay applies to the parameter ``name``: not to a
    norm scale or a bias (the last name of its path in
    ``_NO_DECAY_KEYS``)."""
    return name.rsplit(".", 1)[-1] not in _NO_DECAY_KEYS


class PartialUpdateError(RuntimeError):
    """An update that failed after it had begun writing the parameters and
    moments in place: the state is part old, part new, and only a
    checkpoint can restore it."""


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], opt_state: dict,
                 cfg: OptConfig) -> tuple[dict, dict, dict]:
    """One AdamW step on ``params`` (written in place), from ``grads``.
    Returns ``(params, opt_state, {"lr", "grad_norm"})``; ``opt_state``'s
    moments are written in place and its step advanced.  A failure after
    the first in-place write raises :class:`PartialUpdateError`."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1 - torch.pow(b1, step.float())
    c2 = 1 - torch.pow(b2, step.float())
    written = 0
    try:
        for name, p in params.items():
            mu, nu = opt_state["mu"][name], opt_state["nu"][name]
            g32 = grads[name].float()
            mu32 = mu.float() * b1 + (1 - b1) * g32
            nu32 = nu.float() * b2 + (1 - b2) * g32 * g32
            update = (mu32 / c1) / (torch.sqrt(nu32 / c2) + cfg.eps)
            if cfg.weight_decay and decays(name):
                update = update + cfg.weight_decay * p.float()
            new_p = p.float() - lr * update
            written += 1
            p.copy_(new_p)
            mu.copy_(mu32)
            nu.copy_(nu32)
    except Exception as e:
        if not written:
            raise
        raise PartialUpdateError(
            f"AdamW failed at {name!r} after writing {written} of "
            f"{len(params)} parameters in place") from e
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
