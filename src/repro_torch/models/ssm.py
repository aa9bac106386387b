"""Mamba2 via SSD (state-space duality, Dao & Gu 2024, arXiv:2405.21060):
the chunked scan that the ``ssm`` forecasting head uses, and the Mamba2
block of the LM stack's ssm and hybrid families.

PyTorch port of ``repro.models.ssm``: ``segsum`` and ``ssd_chunked``
(``src/repro/models/ssm.py:74-149``), and the block around them
(``:24-71``, ``:152-217``): :class:`SSMCache`, :func:`ssm_init` (the
in-projection's columns in the order z, x, B, C, dt), the depthwise causal
conv with its tail, :func:`ssm_apply` and :func:`make_ssm_cache`.

Within a chunk of Q positions the mixing is a masked quadratic (an
attention-like einsum); across chunks a first-order recurrence carries the
(H, P, N) state. That recurrence runs as a loop over the chunks (at most
ceil(T / Q) of them), carried in float32. The decay and segment sums stay
float32; the large einsum operands and outputs take the input dtype, as in
the reference (``:104-108``), so under the bf16 policy they are bf16.

:func:`ssm_apply` without a cache (train, prefill) runs the chunked scan
over T padded to a chunk multiple after the softplus (dt = 0 on the
padding: the final state is exact) and returns the final state and the
conv's last K-1 inputs as the decode cache; with a cache (decode, T = 1) it
takes the O(1) recurrent step on the float32 state. Neither runs a kernel
of the port: as in the reference, the SSD is plain tensor code.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dense_init, rms_norm

__all__ = ["segsum", "ssd_chunked", "SSMCache", "ssm_init", "ssm_apply", "make_ssm_cache"]


class SSMCache(NamedTuple):
    state: torch.Tensor   # (B, H, P, N) float32
    conv: torch.Tensor    # (B, K-1, conv_dim) the last conv inputs, time-major


def _conv_dim(cfg: ArchConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def ssm_init(gen: torch.Generator, cfg: ArchConfig, dtype):
    """Random block params from ``gen``, on its device; ``a_log``,
    ``dt_bias`` and ``d_skip`` float32 whatever ``dtype``."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    dev = gen.device
    conv_w = torch.randn((cfg.ssm_conv, _conv_dim(cfg)), generator=gen, dtype=torch.float32,
                         device=dev)
    return {
        # columns: z (di), x (di), B (g*n), C (g*n), dt (h)
        "w_in": dense_init(gen, d, 2 * di + 2 * g * n + h, dtype),
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros((_conv_dim(cfg),), dtype=dtype, device=dev),
        "a_log": torch.zeros((h,), dtype=torch.float32, device=dev),      # A = -exp(a_log)
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "out_norm": torch.ones((di,), dtype=dtype, device=dev),
        "w_out": dense_init(gen, di, d, dtype),
    }


def _silu(x):
    """x * sigmoid(x) with the sigmoid as 1 / (1 + exp(-x)), each step
    rounded to x's dtype: the rounding of the reference's ``jax.nn.silu``
    (XLA expands its logistic so). In bf16 the block then gives the
    reference's bits; ``F.silu`` rounds once, and its outputs sit an ulp
    apart on 40 % of bf16 inputs, which the block's out-projection sums."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def _split_proj(cfg: ArchConfig, zxbcdt):
    di, gn = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di], zxbcdt[..., 2 * di:2 * di + gn],
            zxbcdt[..., 2 * di + gn:2 * di + 2 * gn], zxbcdt[..., 2 * di + 2 * gn:])


def _causal_conv(u, w, b, *, tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d, then SiLU. u: (B, T, C); w: (K, C); ``tail``
    (B, K-1, C) the inputs before u (zeros without one). Returns the output
    (B, T, C) and the new tail: the last K-1 inputs, a copy (a view would
    keep the whole padded sequence alive in the cache)."""
    k, t = w.shape[0], u.shape[1]
    pad = u.new_zeros((u.shape[0], k - 1, u.shape[2])) if tail is None else tail.to(u.dtype)
    up = torch.cat([pad, u], dim=1)                     # (B, T + K - 1, C)
    out = sum(up[:, i:i + t, :] * w[i] for i in range(k))
    new_tail = up[:, t:, :].clone() if k > 1 else None
    return _silu(out + b), new_tail


def segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: ``out[..., i, j] = sum_{j < l <= i} a[..., l]``.

    a: (..., Q). Returns (..., Q, Q) with -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(q, device=a.device)
    return diff.masked_fill(i[:, None] < i[None, :], float("-inf"))


def ssd_chunked(x, dt, a, bb, cc, *, chunk: int):
    """SSD forward. x: (B, T, H, P); dt: (B, T, H) float32; a: (H,) negative
    float32; bb, cc: (B, T, G, N) with G dividing H. T must be a multiple of
    ``min(chunk, T)``. Returns y (B, T, H, P) in x's dtype and the final
    state (B, H, P, N) in float32."""
    b, t, h, p = x.shape
    g, n = bb.shape[2], bb.shape[3]
    q = min(chunk, t)
    nc = t // q
    if nc * q != t:
        raise ValueError(f"T = {t} is not a multiple of the SSD chunk {q}")
    rep = h // g

    xc = x.reshape(b, nc, q, h, p)
    dtc = dt.reshape(b, nc, q, h)
    bc = bb.reshape(b, nc, q, g, n)
    ccc = cc.reshape(b, nc, q, g, n)
    cdt = x.dtype
    da = dtc * a                                        # (B, NC, Q, H), negative
    cum = torch.cumsum(da, dim=2)

    # intra-chunk (diagonal) term: the decay in float32, the (Q, Q) product
    # chain in the input dtype
    l_mat = torch.exp(segsum(da.movedim(3, 2))).to(cdt)  # (B, NC, H, Q, Q)
    cb = torch.einsum("bcqgn,bckgn->bcgqk", ccc, bc).repeat_interleave(rep, dim=2)
    scores = cb * l_mat * dtc.movedim(3, 2).to(cdt)[:, :, :, None, :]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores, xc)

    # chunk-final states: sum_k exp(cum_end - cum_k) dt_k B_k x_k
    decay = torch.exp(cum[:, :, -1:, :] - cum)          # (B, NC, Q, H)
    xw = xc * (dtc * decay).to(cdt)[..., None]          # (B, NC, Q, H, P)
    bh = bc.repeat_interleave(rep, dim=3)               # (B, NC, Q, H, N)
    states = torch.einsum("bcqhn,bcqhp->bchpn", bh, xw).float()

    # inter-chunk recurrence S_c = exp(sum da_c) S_{c-1} + states_c, in
    # float32; each chunk reads the state entering it
    chunk_decay = torch.exp(cum[:, :, -1, :])           # (B, NC, H)
    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_in = torch.stack(s_in, dim=1)                     # (B, NC, H, P, N)

    # inter-chunk contribution: C_t . (decay-to-t * S_in)
    ch = ccc.repeat_interleave(rep, dim=3)              # (B, NC, Q, H, N)
    y_off = (torch.einsum("bcqhn,bchpn->bcqhp", ch, s_in.to(cdt))
             * torch.exp(cum).to(cdt)[..., None])
    return (y_diag + y_off).reshape(b, t, h, p), s


def _pad_time(z, pad: int):
    return torch.cat([z, z.new_zeros((z.shape[0], pad) + z.shape[2:])], dim=1)


def ssm_apply(p, cfg: ArchConfig, u, *, cache: Optional[SSMCache] = None):
    """u: (B, T, d). Train or prefill without ``cache`` (the chunked SSD),
    decode with one (T == 1: the recurrent step). Returns (out (B, T, d),
    the new cache; None where K = 1 leaves no conv tail in a prefill)."""
    b, t, _ = u.shape
    di, h, pp = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    g, n = cfg.ssm_ngroups, cfg.ssm_state

    z, x, bb, cc, dt = _split_proj(cfg, u @ p["w_in"])
    a = -torch.exp(p["a_log"])                                      # (H,)
    dt_act = F.softplus(dt.float() + p["dt_bias"])                  # (B, T, H) float32
    conv_out, tail = _causal_conv(torch.cat([x, bb, cc], dim=-1), p["conv_w"], p["conv_b"],
                                  tail=None if cache is None else cache.conv)
    xs = conv_out[..., :di].reshape(b, t, h, pp)
    bs = conv_out[..., di:di + g * n].reshape(b, t, g, n)
    cs = conv_out[..., di + g * n:].reshape(b, t, g, n)

    if cache is None:
        # T padded to a chunk multiple after the softplus: dt = 0 on the
        # padding leaves the state as it was (decay exp(0) = 1, update 0)
        q = min(cfg.ssm_chunk, t)
        pad = (-t) % q
        xh, bbr, ccr, dtr = xs, bs, cs, dt_act
        if pad:
            xh, bbr, ccr, dtr = (_pad_time(v, pad) for v in (xh, bbr, ccr, dtr))
        y, s_final = ssd_chunked(xh, dtr, a, bbr, ccr, chunk=q)
        y = y[:, :t]
        new_cache = SSMCache(s_final, tail) if tail is not None else None
    else:
        # the recurrent step on the float32 state: x * dt promotes to float32
        rep = h // g
        xh, dt1 = xs[:, -1], dt_act[:, -1]                           # (B, H, P), (B, H)
        bh = bs[:, -1].repeat_interleave(rep, dim=1).float()         # (B, H, N)
        ch = cs[:, -1].repeat_interleave(rep, dim=1).float()
        upd = torch.einsum("bhp,bhn->bhpn", xh * dt1[..., None], bh)
        state = cache.state * torch.exp(dt1 * a)[:, :, None, None] + upd
        y = torch.einsum("bhpn,bhn->bhp", state, ch)[:, None]        # (B, 1, H, P)
        new_cache = SSMCache(state, tail)

    # the D skip on the conv's x, in the input dtype
    y = y.to(u.dtype) + p["d_skip"].to(u.dtype)[None, None, :, None] * xs.to(u.dtype)
    y = rms_norm(y.reshape(b, t, di) * _silu(z), p["out_norm"])
    return y @ p["w_out"], new_cache


def make_ssm_cache(cfg: ArchConfig, batch: int, dtype, device=None) -> SSMCache:
    return SSMCache(
        torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state),
                    dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.ssm_conv - 1, _conv_dim(cfg)), dtype=dtype, device=device))
