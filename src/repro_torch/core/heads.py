"""Forecasting heads behind ``ESRNNConfig.head`` (PyTorch port).

Counterpart of ``repro.core.heads``: the network that maps the windowed
features ``(N, P, W + C)`` to normalized log-space predictions ``(N, P, H)``
is a registry entry

    HeadSpec(
        init(cfg, generator, device) -> non-hw params subtrees,
        apply(cfg, params, feats)    -> (yhat_n (N, P, H), c_sq scalar),
        frozen                       -> top-level param keys training leaves
                                        fixed (empty for lstm),
    )

The port registers the paper's ``lstm`` head only: the dilated residual
LSTM (+ optional causal attention) followed by the tanh-dense + linear
readout. The ``esn`` head (which freezes ``"rnn"``) and the ``ssm`` head
come in a later slice.
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import Callable, Dict, FrozenSet, Tuple

import torch
from torch import nn

from repro_torch.core.drnn import drnn_apply, drnn_init, uniform_init
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import widen

__all__ = [
    "HeadSpec", "register_head", "get_head", "available_heads", "Readout",
    "Attention", "frozen_param_groups", "lstm_head_init", "lstm_head_apply",
]


@dataclasses.dataclass(frozen=True)
class HeadSpec:
    """One pluggable head: its init and apply functions, and the top-level
    param groups training keeps fixed."""

    name: str
    init: Callable
    apply: Callable
    frozen: FrozenSet[str] = frozenset()


_HEADS: Dict[str, HeadSpec] = {}


def register_head(spec: HeadSpec) -> HeadSpec:
    """Add a head to the registry (last registration of a name wins)."""
    _HEADS[spec.name] = spec
    return spec


def available_heads() -> Tuple[str, ...]:
    return tuple(sorted(_HEADS))


def get_head(name: str) -> HeadSpec:
    try:
        return _HEADS[name]
    except KeyError:
        raise KeyError(
            f"unknown forecasting head {name!r}; available heads: "
            f"{list(available_heads())}") from None


def frozen_param_groups(cfg) -> FrozenSet[str]:
    """Top-level param keys the config's head excludes from training."""
    return get_head(cfg.head).frozen


# ---------------------------------------------------------------------------
# Shared readout: tanh dense -> linear
# ---------------------------------------------------------------------------


class Readout(nn.Module):
    """``dense_w (H, H)``, ``dense_b (H,)``, ``out_w (H, out)``, ``out_b (out,)``."""

    def __init__(self, dense_w, dense_b, out_w, out_b):
        super().__init__()
        self.dense_w = nn.Parameter(dense_w)
        self.dense_b = nn.Parameter(dense_b)
        self.out_w = nn.Parameter(out_w)
        self.out_b = nn.Parameter(out_b)


class Attention(nn.Module):
    """Causal self-attention weights ``wq``, ``wk``, ``wv``, each ``(H, H)``."""

    def __init__(self, wq, wk, wv):
        super().__init__()
        self.wq = nn.Parameter(wq)
        self.wk = nn.Parameter(wk)
        self.wv = nn.Parameter(wv)


def _readout_init(cfg, generator, dev) -> Readout:
    scale = 1.0 / math.sqrt(cfg.hidden_size)
    h, out = cfg.hidden_size, cfg.output_size
    dt = cfg.tdtype
    dense_w = uniform_init(generator, (h, h), scale)
    out_w = uniform_init(generator, (h, out), scale)
    return Readout(dense_w.to(dev, dt), torch.zeros(h, dtype=dt, device=dev),
                   out_w.to(dev, dt), torch.zeros(out, dtype=dt, device=dev))


def _policy_cast(mod, dtype):
    """A shared-weight subtree with its parameters in the compute dtype.

    Identity under the fp32 policy. Under bf16 the modules are mirrored by
    plain objects (lists for ``nn.ModuleList``s) whose tensors are the
    parameters cast with ``.to``: an autograd op, so a gradient flows back
    to the float32 master weights, which never round.
    """
    if dtype == torch.float32:
        return mod
    if isinstance(mod, nn.ModuleList):
        return [_policy_cast(m, dtype) for m in mod]
    return types.SimpleNamespace(**{name: p.to(dtype) for name, p
                                    in mod.named_parameters(recurse=False)})


def _readout_apply(params, hid):
    """tanh dense -> linear, with float32 accumulation whatever the stream
    dtype: under bf16 the dense pre-activation (float32 sum plus float32
    bias) rounds to bf16 before the tanh, and the output product re-emits
    ``yhat_n`` in float32 (reference ``heads.py:137-147``). Under fp32 every
    ``widen`` and cast is the identity."""
    head = _policy_cast(params["head"], hid.dtype)
    z = torch.tanh((widen(hid) @ widen(head.dense_w) + widen(head.dense_b)).to(hid.dtype))
    return widen(z) @ widen(head.out_w) + widen(head.out_b)


# ---------------------------------------------------------------------------
# lstm: the paper's dilated residual LSTM (+ attention) head
# ---------------------------------------------------------------------------


def lstm_head_init(cfg, generator: torch.Generator, device=None):
    dev = resolve_device(device)
    feat = cfg.input_size + cfg.n_categories
    rnn = drnn_init(generator, feat, cfg.hidden_size, cfg.dilations,
                    dtype=cfg.tdtype, device=dev)
    params = {"rnn": rnn, "head": _readout_init(cfg, generator, dev)}
    if cfg.attention:
        h = cfg.hidden_size
        scale = 1.0 / math.sqrt(h)
        ws = [(torch.randn((h, h), generator=generator, device=generator.device)
               * scale).to(dev, cfg.tdtype) for _ in range(3)]
        params["attn"] = Attention(*ws)
    return params


def lstm_head_apply(cfg, params, feats):
    """Dilated residual LSTM -> (causal attention) -> tanh dense -> linear.

    ``feats`` arrives in the policy's compute dtype; the recurrent stack and
    the attention weights are cast to match (:func:`_policy_cast`). The
    attention variant (``heads.py:192-204`` in the JAX package) is a plain
    einsum with a softmax and has no kernel of its own; its products
    accumulate in float32 and its scores and softmax stay float32 under
    bf16, the probabilities rounded to the stream dtype before the product
    with v.
    """
    dt = feats.dtype
    hid, c_sq = drnn_apply(_policy_cast(params["rnn"], dt), feats, dilations=cfg.dilations)
    if cfg.attention:
        ap = _policy_cast(params["attn"], dt)
        wide_hid = widen(hid)
        q = (wide_hid @ widen(ap.wq)).to(dt)
        k = (wide_hid @ widen(ap.wk)).to(dt)
        v = (wide_hid @ widen(ap.wv)).to(dt)
        s = torch.einsum("nph,nqh->npq", widen(q), widen(k)) / math.sqrt(cfg.hidden_size)
        p_idx = torch.arange(hid.shape[1], device=hid.device)
        mask = p_idx[:, None] >= p_idx[None, :]
        s = s.masked_fill(~mask[None], float("-inf"))
        probs = torch.softmax(s, dim=-1).to(dt)
        hid = hid + torch.einsum("npq,nqh->nph", widen(probs), widen(v)).to(dt)
    return _readout_apply(params, hid), c_sq


register_head(HeadSpec("lstm", lstm_head_init, lstm_head_apply))
