"""AdamW with WSD (warmup–stable–decay) schedule (MiniCPM [arXiv:2404.06395])
and global-norm clipping: the port's copy of ``repro.train.optimizer``.

The parameters are a model's (an ``nn.Module``: ``models.LM`` or
``models.EncDec``), the gradients and moments dicts keyed by its parameter
names.  Moments are float32, parameters may be bf16; the schedule, the
bias corrections, the clip scale and the update are float32 tensors on the
parameters' device, as in the reference, and the update writes the
parameters and moments in place (no host sync).

Decoupled weight decay goes to the leaves of rank >= 2, as in the
reference, counted as the reference's tree has them: it stacks every
layer's leaves over a leading layer axis, so a layer's vectors (norm
scales, biases, Mamba2's ``a_log``, ``dt_bias`` and ``d_skip``) decay as
well, and only the unstacked ones (the final norms, the hybrid's one
shared block) do not.  A model names its stacked parameters by prefix
(``stacked_prefixes``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    stable_steps: int = 1000
    decay_steps: int = 100
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "wsd"       # wsd | cosine | const


def wsd_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), a
    float32 tensor."""
    s = torch.as_tensor(step).to(torch.float32)
    w, st, d = cfg.warmup_steps, cfg.stable_steps, cfg.decay_steps
    warm = s / max(w, 1)
    if cfg.schedule == "const":
        frac = torch.clamp(warm, max=1.0)
    elif cfg.schedule == "cosine":
        t = torch.clamp((s - w) / max(st + d - w, 1), 0, 1)
        frac = torch.where(s < w, warm,
                           cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                           * 0.5 * (1 + torch.cos(math.pi * t)))
    else:  # wsd: linear warmup, flat, then linear decay to min_lr_frac
        decay_t = torch.clamp((s - w - st) / max(d, 1), 0, 1)
        frac = torch.where(s < w, warm,
                           torch.where(s < w + st, torch.ones_like(s),
                                       1.0 - (1.0 - cfg.min_lr_frac)
                                       * decay_t))
    return cfg.peak_lr * frac


def init_opt_state(params: nn.Module) -> dict:
    """{"mu", "nu"}: float32 zeros a parameter, by name; "step": an int32
    scalar tensor, all on the parameters' device."""
    named = list(params.named_parameters())
    mu = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
          for n, p in named}
    return {"mu": mu, "nu": {n: t.clone() for n, t in mu.items()},
            "step": torch.zeros((), dtype=torch.int32,
                                device=named[0][1].device)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, leaf by
    leaf."""
    total = None
    for x in tree.values():
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def decays(params: nn.Module, name: str, p: torch.Tensor) -> bool:
    """Whether the reference's leaf for parameter ``name`` has rank >= 2."""
    stacked = name.startswith(getattr(params, "stacked_prefixes", ()))
    return p.ndim + stacked >= 2


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: nn.Module, grads: dict,
                 state: dict) -> tuple[nn.Module, dict, dict]:
    """One AdamW step over every parameter of ``params`` with ``grads``
    (by name), in place: the parameters, ``state["mu"]``, ``state["nu"]``
    and ``state["step"]``.  Returns (params, state, {"lr", "grad_norm"}),
    the metrics float32 tensors."""
    state["step"] += 1
    step = state["step"].to(torch.float32)
    lr = wsd_lr(cfg, state["step"])
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    bc1 = 1 - torch.pow(cfg.b1, step)
    bc2 = 1 - torch.pow(cfg.b2, step)
    for name, p in params.named_parameters():
        g = grads[name].float() * scale
        mu, nu = state["mu"][name], state["nu"][name]
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if decays(params, name, p):  # decoupled, on the reference's matrices
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, state, {"lr": lr, "grad_norm": gnorm}
