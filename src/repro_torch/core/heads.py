"""Forecasting heads behind ``ESRNNConfig.head`` (PyTorch port).

Counterpart of ``repro.core.heads``: the network that maps the windowed
features ``(N, P, W + C)`` to normalized log-space predictions ``(N, P, H)``
is a registry entry

    HeadSpec(
        init(cfg, generator, device) -> non-hw params subtrees,
        apply(cfg, params, feats)    -> (yhat_n (N, P, H), c_sq scalar),
        frozen                       -> top-level param keys training leaves
                                        fixed (``{"rnn"}`` for esn),
    )

Three heads, as in the reference (``heads.py:326-329``):

* ``lstm`` -- the paper's dilated residual LSTM (+ optional causal
  attention) followed by the tanh-dense + linear readout;
* ``esn`` -- an echo-state head: the same dilated stack as a fixed random
  reservoir (``frozen={"rnn"}``), only the readout (and the per-series HW
  table) trains. The training steps pass the reservoir with no gradient
  requirement, so on the card its backward takes K5's dx-only launch and
  forms no reservoir weight gradient; dx still flows through it to the HW
  parameters upstream of the windows;
* ``ssm`` -- a state-space head: a linear projection, then the Mamba2 SSD
  chunked scan (:func:`repro_torch.models.ssm.ssd_chunked`) over the window
  positions, causal by construction.

Every head keeps its readout under ``"head"`` and no per-series state
outside ``"hw"``.
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import Callable, Dict, FrozenSet, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.core.drnn import drnn_apply, drnn_init, uniform_init
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import widen
from repro_torch.models.ssm import ssd_chunked

__all__ = [
    "HeadSpec", "register_head", "get_head", "available_heads", "Readout",
    "Attention", "SSM", "frozen_param_groups", "lstm_head_init", "lstm_head_apply",
    "esn_head_init", "esn_head_apply", "ssm_dims", "ssm_head_init", "ssm_head_apply",
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


class SSM(nn.Module):
    """The ssm head's input projection ``w_in (W + C, H + 2 N + heads)`` (order
    x, B, C, dt) and its float32 ``a_log``, ``dt_bias``, ``d_skip`` (heads,)."""

    def __init__(self, w_in, a_log, dt_bias, d_skip):
        super().__init__()
        self.w_in = nn.Parameter(w_in)
        self.a_log = nn.Parameter(a_log)
        self.dt_bias = nn.Parameter(dt_bias)
        self.d_skip = nn.Parameter(d_skip)


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


# ---------------------------------------------------------------------------
# esn: fixed random reservoir (the same dilated stack), trained readout only
# ---------------------------------------------------------------------------


def esn_head_init(cfg, generator: torch.Generator, device=None):
    """Reservoir = the dilated recurrent stack (``drnn_init`` unchanged: the
    gates are contractive, so the 1/sqrt(fan-in) init gives a fading-memory
    reservoir), then the readout: the lstm head's draws without attention.
    ``cfg.attention`` is ignored: attention is a trained component, which
    this head omits."""
    return lstm_head_init(dataclasses.replace(cfg, attention=False), generator, device)


def esn_head_apply(cfg, params, feats):
    """Reservoir pass -> tanh dense -> linear readout: the lstm head's forward
    without attention. The difference is in training only (``frozen``)."""
    return lstm_head_apply(dataclasses.replace(cfg, attention=False), params, feats)


# ---------------------------------------------------------------------------
# ssm: Mamba2 SSD chunked scan over the window positions
# ---------------------------------------------------------------------------

_SSM_STATE = 8     # per-head state size N of the SSD recurrence
_SSM_CHUNK = 32    # positions per intra-chunk quadratic block


def ssm_dims(cfg) -> Tuple[int, int]:
    """(heads, head width) of the SSD scan: the largest divisor of
    ``hidden_size`` that is at most ``hidden_size // 8`` (so the head width is
    at least 8), and at least one head."""
    hid = cfg.hidden_size
    nheads = max(d for d in range(1, max(1, hid // 8) + 1) if hid % d == 0)
    return nheads, hid // nheads


def ssm_head_init(cfg, generator: torch.Generator, device=None):
    """``w_in`` uniform in ``(-1, 1) / sqrt(W + C)`` in the weight dtype;
    ``a_log = 0`` (A = -1) and ``dt_bias = 0`` (dt ~ softplus(0)), a decay of
    about 0.5 a step at init, and ``d_skip = 1``, all float32."""
    dev = resolve_device(device)
    feat = cfg.input_size + cfg.n_categories
    nheads, _ = ssm_dims(cfg)
    w_in = uniform_init(generator, (feat, cfg.hidden_size + 2 * _SSM_STATE + nheads),
                        1.0 / math.sqrt(feat))
    f32 = dict(dtype=torch.float32, device=dev)
    ssm = SSM(w_in.to(dev, cfg.tdtype), torch.zeros(nheads, **f32),
              torch.zeros(nheads, **f32), torch.ones(nheads, **f32))
    return {"ssm": ssm, "head": _readout_init(cfg, generator, dev)}


def ssm_head_apply(cfg, params, feats):
    """Linear projection -> SSD chunked scan over the positions -> readout.

    Under the bf16 policy (reference ``heads.py:280-323``): the projection
    accumulates in float32; x, B and C drop to the stream dtype for the scan;
    dt, the decay and ``a_log``/``dt_bias``/``d_skip`` stay float32. The
    positions are padded to a multiple of the chunk with dt = 0, a no-op step
    (decay exp(0) = 1, update 0), so the padding is exact. ``c_sq`` is the
    mean square of the pre-readout sequence, the cell-state penalty's analog.
    """
    n, t, _ = feats.shape
    hid = cfg.hidden_size
    nheads, headdim = ssm_dims(cfg)
    sp = params["ssm"]
    cdt = feats.dtype
    proj = widen(feats) @ widen(sp.w_in.to(cdt))
    x = proj[..., :hid].to(cdt).reshape(n, t, nheads, headdim)
    bb = proj[..., hid:hid + _SSM_STATE].to(cdt).reshape(n, t, 1, _SSM_STATE)
    cc = proj[..., hid + _SSM_STATE:hid + 2 * _SSM_STATE].to(cdt).reshape(
        n, t, 1, _SSM_STATE)
    dt = F.softplus(proj[..., hid + 2 * _SSM_STATE:].float() + sp.dt_bias)
    a = -torch.exp(sp.a_log)

    q = min(_SSM_CHUNK, t)
    pad = (-t) % q
    padt = lambda z: torch.cat([z, z.new_zeros((n, pad) + z.shape[2:])], dim=1) if pad else z
    y, _ = ssd_chunked(padt(x), padt(dt), a, padt(bb), padt(cc), chunk=q)
    y = y[:, :t] + sp.d_skip.to(y.dtype)[None, None, :, None] * x
    hidseq = y.reshape(n, t, hid)
    c_sq = torch.mean(torch.square(hidseq.float()))
    return _readout_apply(params, hidseq), c_sq


register_head(HeadSpec("lstm", lstm_head_init, lstm_head_apply))
register_head(HeadSpec("esn", esn_head_init, esn_head_apply, frozen=frozenset({"rnn"})))
register_head(HeadSpec("ssm", ssm_head_init, ssm_head_apply))
