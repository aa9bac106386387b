"""Mixture-of-Experts FFN with capacity-based gather/scatter dispatch.

The port of the JAX package's ``models/moe.py``. Each batch row is one
dispatch group, and its capacity comes from the call's own sequence length
(:func:`_capacity`): a decode step (S = 1) has capacity 1. Dispatch computes
each (token, k) assignment's position within its expert's buffer with a
cumsum over the row's flattened (S·K) axis, s-major and k-minor, and drops
the assignments at or past the capacity:

  router (fp32) -> softmax -> top-k ids/weights -> positions (cumsum)
  buffer (E, B, C, d) <- scatter the kept tokens
  expert SwiGLU on the buffer                (batched over E)
  out <- gather back with the same (id, position), combine with the weights

The buffer is laid out expert-major, (E, B, C, d) where the reference has
(B, E, C, d), so the expert products are one ``bmm`` each over E with no
transposed copy; every (row, expert, slot) holds the same token. Only the
kept assignments are scattered (a dropped one goes to a spare last row
that nothing reads), so no write can land on a kept token's slot. The
products run over all E experts, empty buffers included, as the
reference's einsums do.

Shared experts (DeepSeek-V2) run densely on every token. The reference's
sharding constraints and its remat name are the identity on one device and
are not ported.

Under a ``model`` axis of more than one rank (tensor-parallel serving, the
spec's decode mode) the router and the routing are computed whole and
identically on every rank; each rank holds every expert's block of ``f``
(and the shared experts' block of theirs), so its expert outputs are
float32 partial sums, gathered and weighted as above, joined by the shared
experts' partial sums and all-reduced once over the axis, then rounded to
the activations' dtype.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dense_init, mm, mm_f32, promoted, swiglu_apply
from repro_torch.sharding.ctx import model_axis


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype):
    """Random expert params from ``gen``, on its device; the router in fp32."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

    def experts(shape, scale):
        # drawn in fp32 and scaled in place: one fp32 temporary at a time
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
        return w.mul_(scale).to(dtype)

    p = {
        "router": dense_init(gen, d, e, torch.float32),
        "w_gate": experts((e, d, f), d ** -0.5),
        "w_up": experts((e, d, f), d ** -0.5),
        "w_down": experts((e, f, d), f ** -0.5),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": dense_init(gen, d, fs, dtype),
            "w_up": dense_init(gen, d, fs, dtype),
            "w_down": dense_init(gen, fs, d, dtype),
        }
    return p


def _capacity(tokens_per_group: int, cfg: ArchConfig) -> int:
    c = int(tokens_per_group * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    c = max(c, cfg.top_k, 4)
    return min(c, tokens_per_group)


class Routing(NamedTuple):
    """One call's routing decisions; (B, S, K) fields in descending
    probability order along K."""
    probs: torch.Tensor      # (B, S, E) fp32 router softmax
    top_w: torch.Tensor      # combine weights (renormalized if norm_topk_prob)
    top_ids: torch.Tensor    # int64 expert ids
    pos: torch.Tensor        # int64 slot in the expert's buffer, before the cap
    keep: torch.Tensor       # bool, pos < capacity
    row: torch.Tensor        # int64 row in the flattened (E·B·C, d) buffer,
                             # pos clamped to the last slot (the reference's pos_c)
    counts: torch.Tensor     # (E,) int64 assignments per expert, over the call
    capacity: int


def moe_route(p, cfg: ArchConfig, x, capacity: Optional[int] = None) -> Routing:
    """The router, top-k and each assignment's buffer position, per row."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity or _capacity(s, cfg)
    probs = torch.softmax(mm(x.float(), p["router"]), dim=-1)
    top_w, top_ids = torch.topk(probs, k, dim=-1, sorted=True)
    if cfg.norm_topk_prob:
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # assignments made before each (token, k) to the same expert, in the
    # row's s-major, k-minor order
    flat_ids = top_ids.reshape(b, s * k)
    one_hot = F.one_hot(flat_ids, e).to(torch.int32)           # (B, S*K, E)
    before = torch.cumsum(one_hot, dim=1, dtype=torch.int32) - one_hot
    pos = before.gather(-1, flat_ids[..., None]).reshape(b, s, k).long()
    rows = torch.arange(b, device=x.device)[:, None, None]
    row = (top_ids * b + rows) * c + pos.clamp_max(c - 1)
    return Routing(probs, top_w, top_ids, pos, pos < c, row,
                   one_hot.sum(dim=(0, 1)).long(), c)


def moe_aux(cfg: ArchConfig, r: Routing):
    """Switch-style load-balancing loss: E · Σ_e mean(p_e) · f_e / K."""
    b, s = r.probs.shape[:2]
    me = r.probs.mean(dim=(0, 1))
    fe = r.counts.float() / (b * s)                            # fraction routed
    return cfg.n_experts * torch.sum(me * fe) / cfg.top_k


def moe_scatter(cfg: ArchConfig, x, r: Routing):
    """The kept tokens in their experts' buffers: (E, B·C, d), zeros elsewhere."""
    b, s, d = x.shape
    e, k, c = cfg.n_experts, cfg.top_k, r.capacity
    spare = e * b * c                                 # where dropped ones go
    dest = torch.where(r.keep, r.row, spare).reshape(-1)
    xk = x[:, :, None, :].expand(b, s, k, d).reshape(-1, d)
    buf = x.new_zeros((spare + 1, d)).index_copy_(0, dest, xk)
    return buf[:spare].view(e, b * c, d)


def _expert_act(p, buf):
    return F.silu(torch.bmm(*promoted(buf, p["w_gate"]))) * torch.bmm(*promoted(buf, p["w_up"]))


def moe_experts(p, buf):
    """The expert SwiGLU, batched over E: (E, N, d) -> (E, N, d)."""
    return torch.bmm(*promoted(_expert_act(p, buf), p["w_down"]))


def moe_gather(out_buf, r: Routing, dtype):
    """Each token's expert outputs gathered back, weighted and summed over K."""
    b, s, k = r.top_ids.shape
    d = out_buf.shape[-1]
    ytok = out_buf.reshape(-1, d)[r.row.reshape(-1)]          # (B*S*K, d)
    wk = (r.top_w * r.keep).to(dtype)
    return (ytok.view(b, s, k, d) * wk[..., None]).sum(dim=2)


def moe_apply(p, cfg: ArchConfig, x, *, capacity: Optional[int] = None):
    """x: (B, S, d) -> (B, S, d), plus the aux load-balancing loss (scalar).

    The batch dim is the dispatch group.
    """
    r = moe_route(p, cfg, x, capacity)
    aux = moe_aux(cfg, r)
    axis = model_axis()
    if axis is not None:
        buf = moe_scatter(cfg, x, r)
        y = moe_gather(mm_f32(_expert_act(p, buf), p["w_down"]), r, torch.float32)
        if cfg.n_shared_experts:
            sp = p["shared"]
            y = y + mm_f32(F.silu(mm(x, sp["w_gate"])) * mm(x, sp["w_up"]), sp["w_down"])
        return axis.all_reduce(y).to(x.dtype), aux
    y = moe_gather(moe_experts(p, moe_scatter(cfg, x, r)), r, x.dtype)
    if cfg.n_shared_experts:
        y = y + swiglu_apply(p["shared"], x)
    return y, aux
