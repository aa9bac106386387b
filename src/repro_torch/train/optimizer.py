"""Adam with parameter groups, dense and sparse, as plain tensor functions.

PyTorch port of ``repro.train.optimizer``. ES-RNN trains the per-series
Holt-Winters table and the shared network jointly (paper section 3.2), the
table on a higher learning rate: a group function maps each leaf's path to
a group name, and ``AdamConfig.group_lr`` gives each group its multiplier.
Also: global-norm gradient clipping, cosine/exponential schedules with
warm-up, decoupled weight decay, and the sparse per-series update that
touches only a batch's rows (:func:`adam_update_sparse`).

Not ``torch.optim.Adam``: its clipping, grouping and sparse semantics
differ from the reference's. The functions here work on an explicit leaf
order, :func:`repro_torch.core.esrnn.param_leaves` (the JAX params tree's
flatten order), so gradients, moments and parameters line up with the
reference leaf for leaf. The scalar factors (bias corrections, schedule, learning
rates) are computed in float32 on the host, as the reference computes them
in float32, and the updates run on the leaves' device.

Unlike the pure JAX functions, the updates write the parameter and moment
tensors in place (under ``torch.no_grad()``): the table and its moments are
the largest state of a fit, and nothing needs the old values.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.esrnn import param_leaves

Path = Tuple
_f32 = np.float32


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = None
    # group name -> lr multiplier (group "default" always exists)
    group_lr: Optional[Dict[str, float]] = None
    schedule: str = "constant"           # constant | cosine | exp
    total_steps: int = 1000
    warmup_steps: int = 0
    min_lr_frac: float = 0.1


def esrnn_group_fn(path: Path) -> str:
    """ES-RNN grouping: per-series HW params vs shared network weights."""
    return "per_series" if "hw" in path else "default"


# ---------------------------------------------------------------------------
# Scalars (float32 on the host) and clipping
# ---------------------------------------------------------------------------


def schedule_factor(cfg: AdamConfig, step: int) -> np.float32:
    """The learning-rate multiplier at ``step`` (1-based), in float32."""
    step_f = _f32(step)
    warm = min(_f32(1.0), (step_f + _f32(1.0)) / _f32(max(cfg.warmup_steps, 1)))
    if cfg.schedule == "cosine":
        t = np.clip(step_f / _f32(max(cfg.total_steps, 1)), _f32(0.0), _f32(1.0))
        base = _f32(cfg.min_lr_frac) + _f32((1 - cfg.min_lr_frac) * 0.5) * (
            _f32(1.0) + np.cos(_f32(np.pi) * t))
    elif cfg.schedule == "exp":
        t = step_f / _f32(max(cfg.total_steps, 1))
        base = np.power(_f32(cfg.min_lr_frac), t)
    else:
        base = _f32(1.0)
    return _f32(base * (warm if cfg.warmup_steps else _f32(1.0)))


def _leaf_lr(path: Path, cfg: AdamConfig, sched, group_fn) -> float:
    mult = 1.0
    if group_fn is not None:
        mult = dict(cfg.group_lr or {}).get(group_fn(path), 1.0)
    return float(_f32(cfg.lr * mult) * sched)


def _bias_corrections(cfg: AdamConfig, step: int) -> Tuple[float, float]:
    step_f = _f32(step)
    return (float(_f32(1.0) - _f32(cfg.b1) ** step_f),
            float(_f32(1.0) - _f32(cfg.b2) ** step_f))


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient leaf (a device scalar)."""
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(g.float())) for g in grads])))


def clip_by_global_norm(grads: Sequence[torch.Tensor],
                        cfg: AdamConfig) -> List[torch.Tensor]:
    """Scale every gradient by ``min(1, clip_norm / norm)``; no host sync."""
    if cfg.clip_norm is None:
        return list(grads)
    norm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(norm, 1e-12), 1.0)
    return [g * scale for g in grads]


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


def adam_init(params) -> Dict:
    """``{"mu": [...], "nu": [...], "step": 0}``: float32 zeros per leaf of
    :func:`param_leaves`, on each leaf's device. ``step`` counts updates."""
    zeros = lambda: [torch.zeros_like(t, dtype=torch.float32).detach()
                     for _, t in param_leaves(params)]
    return {"mu": zeros(), "nu": zeros(), "step": 0}


def hw_table_rows(params, hw_key: str = "hw") -> int:
    """Number of per-series rows in the ``hw`` table (its leading axis)."""
    return params[hw_key].alpha_logit.shape[0]


def adam_init_sparse(params, hw_key: str = "hw") -> Dict:
    """State for :func:`adam_update_sparse`: :func:`adam_init` plus ``t_hw``
    (N,) int32, the step at which each per-series row was last updated
    (0 = never) -- all the closed-form catch-up needs."""
    state = adam_init(params)
    state["t_hw"] = torch.zeros((hw_table_rows(params, hw_key),), dtype=torch.int32,
                                device=params[hw_key].alpha_logit.device)
    return state


# ---------------------------------------------------------------------------
# Updates
# ---------------------------------------------------------------------------


def _dense_leaf_update(p, g, mu, nu, *, cfg, lr, bc1, bc2) -> None:
    """The one copy of the per-leaf AdamW math, in place."""
    g32 = g.float()
    mu.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
    nu.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
    upd = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
    if cfg.weight_decay:
        upd = upd + cfg.weight_decay * p.float()
    p.copy_((p.float() - lr * upd).to(p.dtype))


@torch.no_grad()
def adam_update(grads: Sequence[torch.Tensor], opt_state: Dict, params,
                cfg: AdamConfig, *, group_fn: Optional[Callable] = None):
    """One AdamW step over every leaf; returns ``(params, opt_state)``.

    ``grads[i]`` belongs to ``param_leaves(params)[i]``; ``group_fn`` maps a
    leaf path to a group name for the group learning rates. The parameter
    and moment tensors are updated in place.
    """
    step = opt_state["step"] + 1
    sched = schedule_factor(cfg, step)
    bc1, bc2 = _bias_corrections(cfg, step)
    grads = clip_by_global_norm(grads, cfg)
    for (path, p), g, mu, nu in zip(param_leaves(params), grads,
                                    opt_state["mu"], opt_state["nu"], strict=True):
        _dense_leaf_update(p, g, mu, nu, cfg=cfg,
                           lr=_leaf_lr(path, cfg, sched, group_fn), bc1=bc1, bc2=bc2)
    return params, dict(opt_state, step=step)


# Sparse (segment) per-series Adam.
#
# The per-series table has N rows, and a step touches only the B rows of its
# batch. The dense path differentiates through the row gather, which
# scatters a zero-padded (N, ...) gradient and runs Adam over the full table
# every step. The sparse path takes the per-row gradients (B, ...), applies
# Adam to those rows only, and reconciles the steps a row skipped since its
# last touch with the closed-form catch-up mu <- b1^k mu, nu <- b2^k nu (a
# zero gradient decays the moments geometrically). Moments and the touched
# rows' bias corrections match the dense path exactly; untouched rows hold
# still, where dense Adam would drift them along their stale momentum.


@torch.no_grad()
def adam_update_sparse(grads: Sequence[torch.Tensor], opt_state: Dict, params,
                       cfg: AdamConfig, *, idx: torch.Tensor,
                       group_fn: Optional[Callable] = None, hw_key: str = "hw"):
    """One Adam step touching only the batch's per-series rows ``idx`` (B,).

    ``grads`` follows ``param_leaves(params)``, except that every leaf under
    ``hw_key`` carries the per-row gradient (B, ...) of the rows ``idx``
    (which must not repeat). Shared leaves update densely, as
    :func:`adam_update`. Global-norm clipping matches the dense path: the
    zero rows of a scattered gradient add nothing to the norm.
    """
    step = opt_state["step"] + 1
    sched = schedule_factor(cfg, step)
    bc1, bc2 = _bias_corrections(cfg, step)
    grads = clip_by_global_norm(grads, cfg)
    t_hw = opt_state["t_hw"]
    # rows touched k steps ago: one b1^k / b2^k power replays the k
    # zero-gradient moment decays of the dense path
    k = (step - t_hw[idx]).float()                                    # (B,)
    for (path, p), g, mu, nu in zip(param_leaves(params), grads,
                                    opt_state["mu"], opt_state["nu"], strict=True):
        lr = _leaf_lr(path, cfg, sched, group_fn)
        if path[0] != hw_key:
            _dense_leaf_update(p, g, mu, nu, cfg=cfg, lr=lr, bc1=bc1, bc2=bc2)
            continue
        kb = k.reshape(k.shape + (1,) * (g.dim() - 1))
        g32 = g.float()
        mu_rows = torch.pow(cfg.b1, kb) * mu[idx] + (1 - cfg.b1) * g32
        nu_rows = torch.pow(cfg.b2, kb) * nu[idx] + (1 - cfg.b2) * torch.square(g32)
        upd = (mu_rows / bc1) / (torch.sqrt(nu_rows / bc2) + cfg.eps)
        p_rows = p[idx].float()
        if cfg.weight_decay:
            upd = upd + cfg.weight_decay * p_rows
        p[idx] = (p_rows - lr * upd).to(p.dtype)
        mu[idx] = mu_rows
        nu[idx] = nu_rows
    t_hw[idx] = step
    return params, dict(opt_state, step=step)
