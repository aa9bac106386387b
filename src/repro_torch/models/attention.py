"""GQA attention (+bias / partial RoPE / QK-norm) and DeepSeek's MLA.

The port of the JAX package's ``models/attention.py`` for the dense, MoE
and encoder-decoder families:

* prefill attention (:func:`chunked_attention`) goes by device. A CUDA
  tensor launches K6 (:func:`repro_torch.kernels.ops.flash_attention`)
  with the model's own scale, V at its own head dim; a CPU tensor runs
  the plain chunked path (query chunks of 512, scores grouped ``(B, Hkv,
  G, BQ, Tk)``, K/V heads never repeated), the reference's
  ``use_pallas=False``. There is no ``use_pallas`` flag: the device
  decides. Training is the one exception: a call whose q, k or v needs a
  gradient takes the plain path on the card too, counted by
  :func:`grad_route_calls` (K6 has no backward; the reference trains
  with ``use_pallas=False``, and its kernel has no ``custom_vjp``);
* decode (:func:`cached_attention`) attends over the whole preallocated
  cache buffer with an explicit position mask, a plain masked einsum, as in
  the reference; it runs no kernel;
* cross-attention (:func:`cross_attn_apply`, whisper's decoder) attends
  from the decoder's positions over the encoder's ``memory``, non-causal,
  through :func:`chunked_attention`: on the card one K6 launch a call, in
  the prefill (Tq the prompt) and in every decode step (Tq = 1), k and v
  recomputed from ``memory`` each time (:func:`cross_attn_kv`), as the
  reference does;
* MLA (DeepSeek-V2's multi-head latent attention, :func:`mla_apply`)
  caches the RMS-normed rank-``r`` latent ``c_kv`` and one RoPE'd key
  ``k_rope`` a position, shared by every head. Its train and prefill modes
  up-project the latent to per-head K (``k_nope`` then ``k_rope``
  broadcast, ``qk_nope + qk_rope`` wide) and V (``v_head_dim`` wide) and
  run :func:`chunked_attention` at scale ``(qk_nope + qk_rope)^-0.5``: on
  the card one K6 launch at D = 192, DV = 128 for deepseek-v2-lite. Its
  decode either attends in the latent space with W_uk and W_uv absorbed
  (:func:`_mla_absorbed`, the default; plain einsums, as in the reference)
  or up-projects the whole cache and runs :func:`cached_attention`.

KV caches: (B, S_max, Hkv, hd); MLA's :class:`MLACache`: (B, S_max, r) and
(B, S_max, qk_rope). Prefill writes the fresh K/V (latents) into a zeroed
buffer of ``cache_max_len``; decode appends in place. Unlike the JAX
package, which returns new buffers, the port writes the cache tensors in
place at ``length`` and returns a cache over the same storage: a caller
that needs the old cache keeps a copy.

Under a ``model`` axis of more than one rank
(:func:`repro_torch.sharding.ctx.model_axis`, tensor-parallel serving) every
attention runs at the rank's heads: the head counts come from the params'
shapes (:func:`repro_torch.sharding.tp.shard_lm_params` cut them), K6 runs
at the local head counts on the card, a bias kept whole is cut to the
rank's heads at use, the KV caches hold the rank's kv heads (MLA's latents
whole: every head reads them), and the output projection is
:func:`repro_torch.models.layers.row_parallel` (one all-reduce).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_rope, dense_init, mm, rms_norm, row_parallel
from repro_torch.sharding import tp
from repro_torch.sharding.ctx import model_axis

DEFAULT_Q_CHUNK = 512


class KVCache(NamedTuple):
    k: torch.Tensor    # (B, S_max, Hkv, hd)
    v: torch.Tensor
    length: int        # current fill


def _grouped(q, hkv):
    b, hq, tq, hd = q.shape
    return q.reshape(b, hkv, hq // hkv, tq, hd)


def _attn_block(qg, k, v, q_start, offset, causal, scale):
    """qg: (B, Hkv, G, BQ, hd); k/v: (B, Hkv, Tk, hd)."""
    tk = k.shape[2]
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k).float() * scale
    if causal:
        q_ids = q_start + torch.arange(qg.shape[3], device=qg.device)[:, None] + offset
        k_ids = torch.arange(tk, device=qg.device)[None, :]
        s = s.masked_fill(k_ids > q_ids, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqt,bktd->bkgqd", p.to(v.dtype), v)


# attention calls that needed a gradient, since the last reset: each took
# the plain chunked path (on the card, in place of K6)
_grad_route_calls = 0


def needs_grad(*tensors) -> bool:
    """Grad mode is on and one of ``tensors`` needs a gradient: the route
    of a training call (and of its recompute under remat)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def grad_route_calls() -> int:
    """Calls of :func:`chunked_attention` that needed a gradient and so took
    the plain path, since the last :func:`reset_grad_route_calls`: on the
    card, the attention calls of a train step that did not launch K6 (one a
    layer and microbatch, twice under remat: the forward and its
    recompute)."""
    return _grad_route_calls


def reset_grad_route_calls() -> None:
    global _grad_route_calls
    _grad_route_calls = 0


def chunked_attention(q, k, v, *, causal: bool, scale: float,
                      q_chunk: int = DEFAULT_Q_CHUNK):
    """softmax(q k^T * scale) v without materializing (Tq, Tk) or repeated KV.

    q: (B, Hq, Tq, hd); k: (B, Hkv, Tk, hd); v: (B, Hkv, Tk, dv) -> (B, Hq,
    Tq, dv). End-aligned causal offset.
    On a CUDA tensor this is one K6 launch; on the CPU the chunked plain path.
    A call that needs a gradient (:func:`needs_grad`) takes the plain path
    on every device and is counted (:func:`grad_route_calls`): K6 has no
    backward, as the reference's Pallas kernel has none, and the reference
    trains through this same plain path (``use_pallas=False``).
    """
    global _grad_route_calls
    if needs_grad(q, k, v):
        _grad_route_calls += 1
    elif q.device.type == "cuda":
        return kernel_ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                          causal=causal, scale=scale)
    b, hq, tq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    offset = tk - tq
    qg = _grouped(q, hkv)
    outs = [_attn_block(qg[:, :, :, start:start + q_chunk], k, v, start, offset,
                        causal, scale)
            for start in range(0, tq, q_chunk)]
    return torch.cat(outs, dim=3).reshape(b, hq, tq, dv)


def cached_attention(q, k, v, positions, scale):
    """Decode-step attention over a preallocated cache buffer.

    q: (B, Hq, S, hd) at absolute ``positions``; k/v: (B, Hkv, S_max, hd).
    Key slot j is valid iff j <= query position (slots are written at their
    absolute position, so unwritten future slots are masked out).
    """
    b, hq, s, hd = q.shape
    hkv, smax = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    qg = _grouped(q, hkv)
    logits = torch.einsum("bkgqd,bktd->bkgqt", qg, k).float() * scale
    pos = torch.as_tensor(positions, device=q.device).expand(b, s)
    mask = torch.arange(smax, device=q.device)[None, None, :] <= pos[:, :, None]
    logits = logits.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqt,bktd->bkgqd", probs.to(v.dtype), v)
    return out.reshape(b, hq, s, dv)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def gqa_init(gen: torch.Generator, cfg: ArchConfig, dtype):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = gen.device
    p = {
        "wq": dense_init(gen, d, hq * hd, dtype),
        "wk": dense_init(gen, d, hkv * hd, dtype),
        "wv": dense_init(gen, d, hkv * hd, dtype),
        "wo": dense_init(gen, hq * hd, d, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((hkv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((hkv * hd,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


def _local_kv_heads(cfg: ArchConfig) -> int:
    axis = model_axis()
    if axis is None:
        return cfg.n_kv_heads
    k0, k1 = tp.kv_block(cfg.n_heads, cfg.n_kv_heads, axis)
    return k1 - k0


def _head_bias(b, cfg: ArchConfig, kv: bool):
    """A bias over every q (or kv) head, kept whole by the serving plan as
    the spec keeps it, cut to this rank's heads; as it is on one device."""
    axis = model_axis()
    if axis is None:
        return b
    lo, hi = (tp.kv_block(cfg.n_heads, cfg.n_kv_heads, axis) if kv
              else tp.q_block(cfg.n_heads, axis))
    return b[lo * cfg.hd:hi * cfg.hd]


def make_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device=None) -> KVCache:
    """Zeroed (B, S_max, Hkv, hd) buffers; under a ``model`` axis at the
    rank's kv heads."""
    shape = (batch, max_len, _local_kv_heads(cfg), cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def gqa_qkv(p, cfg: ArchConfig, x, positions):
    """The projections of :func:`gqa_apply`, after bias, QK-norm and RoPE.

    x: (B, S, d) -> q (B, S, Hq, hd), k and v (B, S, Hkv, hd).
    """
    b, s, _ = x.shape
    hd = cfg.hd
    q = mm(x, p["wq"])
    k = mm(x, p["wk"])
    v = mm(x, p["wv"])
    if cfg.qkv_bias:
        q = q + _head_bias(p["bq"], cfg, kv=False)
        k = k + _head_bias(p["bk"], cfg, kv=True)
        v = v + _head_bias(p["bv"], cfg, kv=True)
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    k = apply_rope(k, positions, theta=cfg.rope_theta, fraction=cfg.rope_fraction)
    return q, k, v


def gqa_apply(
    p,
    cfg: ArchConfig,
    x,
    positions,
    *,
    cache: Optional[KVCache] = None,
    cache_max_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """x: (B, S, d).

    Modes: train (no cache args); prefill (``cache_max_len`` set: attention
    over the fresh K/V, returns a cache buffer of that length); decode
    (``cache`` set: append S positions in place, attend over the buffer).
    """
    b, s, _ = x.shape
    hd = cfg.hd
    q, k, v = gqa_qkv(p, cfg, x, positions)
    scale = cfg.attention_multiplier if cfg.attention_multiplier is not None else hd ** -0.5
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))

    new_cache = None
    if cache is not None:  # decode/append
        end = cache.length + s
        cache.k[:, cache.length:end] = k.to(cache.k.dtype)
        cache.v[:, cache.length:end] = v.to(cache.v.dtype)
        new_cache = KVCache(cache.k, cache.v, end)
        out = cached_attention(qh, cache.k.transpose(1, 2), cache.v.transpose(1, 2),
                               positions, scale)
    else:
        out = chunked_attention(qh, kh, vh, causal=True, scale=scale)
        if cache_max_len is not None:  # prefill: publish the cache buffer
            kc = k.new_zeros((b, cache_max_len) + k.shape[2:])
            vc = v.new_zeros((b, cache_max_len) + v.shape[2:])
            kc[:, :s] = k
            vc[:, :s] = v
            new_cache = KVCache(kc, vc, s)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return row_parallel(out, p["wo"]), new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


class MLACache(NamedTuple):
    c_kv: torch.Tensor     # (B, S_max, kv_lora_rank)
    k_rope: torch.Tensor   # (B, S_max, qk_rope_dim)
    length: int            # current fill


def mla_init(gen: torch.Generator, cfg: ArchConfig, dtype):
    d, h = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq": dense_init(gen, d, h * (dn + dr), dtype),
        "w_dkv": dense_init(gen, d, r + dr, dtype),        # latent + shared k_rope
        "kv_norm": torch.ones((r,), dtype=dtype, device=gen.device),
        "w_uk": dense_init(gen, r, h * dn, dtype),
        "w_uv": dense_init(gen, r, h * dv, dtype),
        "wo": dense_init(gen, h * dv, d, dtype),
    }


def make_mla_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device=None) -> MLACache:
    return MLACache(
        torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype, device=device),
        0)


def _mla_latent(p, cfg: ArchConfig, x, positions):
    """x: (B, S, d) -> q_nope (B, S, H, dn), q_rope (B, S, H, dr) after
    RoPE, the RMS-normed latent c_kv (B, S, r) and k_rope (B, S, dr) after
    RoPE (through a head axis of 1)."""
    b, s, _ = x.shape
    r, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim
    q = mm(x, p["wq"]).reshape(b, s, -1, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, theta=cfg.rope_theta)
    ckv = mm(x, p["w_dkv"])
    c_kv, k_rope = ckv[..., :r], ckv[..., r:]
    c_kv = rms_norm(c_kv, p["kv_norm"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions, theta=cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _mla_heads(p, cfg: ArchConfig, q_nope, q_rope, c, kr):
    """Per-head q, k, v over the latents ``c`` (B, T, r) and ``kr`` (B, T,
    dr): k is ``c @ W_uk`` then ``kr`` broadcast to every head, v is ``c @
    W_uv``. Returns qh (B, H, S, dn + dr), kh (B, H, T, dn + dr) and vh (B,
    H, T, dv), transposed views."""
    b, t, _ = c.shape
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    k_nope = mm(c, p["w_uk"]).reshape(b, t, -1, dn)
    h = k_nope.shape[2]
    v = mm(c, p["w_uv"]).reshape(b, t, h, dv)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(b, t, h, dr)], dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    return tuple(t_.transpose(1, 2) for t_ in (qfull, k, v))


def mla_qkv(p, cfg: ArchConfig, x, positions):
    """The projections of :func:`mla_apply`'s train and prefill modes, with
    ``kv_norm``, RoPE, the up-projections and the k concat.

    x: (B, S, d) -> qh, kh (B, H, S, dn + dr) and vh (B, H, S, dv), the
    transposed views K6 reads (after ``.contiguous()``), and the latents
    c_kv (B, S, r) and k_rope (B, S, dr) that the cache keeps.
    """
    q_nope, q_rope, c_kv, k_rope = _mla_latent(p, cfg, x, positions)
    qh, kh, vh = _mla_heads(p, cfg, q_nope, q_rope, c_kv, k_rope)
    return qh, kh, vh, c_kv, k_rope


def mla_apply(p, cfg: ArchConfig, x, positions, *,
              cache: Optional[MLACache] = None,
              cache_max_len: Optional[int] = None,
              absorbed_decode: bool = True):
    """x: (B, S, d); the modes of :func:`gqa_apply`.

    Decode writes the latents in place at ``cache.length`` and attends over
    the whole buffer: in the latent space (``absorbed_decode``, the
    default) or over per-head K/V up-projected from it.
    """
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    scale = (dn + dr) ** -0.5

    new_cache = None
    if cache is not None:  # decode
        q_nope, q_rope, c_kv, k_rope = _mla_latent(p, cfg, x, positions)
        end = cache.length + s
        cache.c_kv[:, cache.length:end] = c_kv.to(cache.c_kv.dtype)
        cache.k_rope[:, cache.length:end] = k_rope.to(cache.k_rope.dtype)
        new_cache = MLACache(cache.c_kv, cache.k_rope, end)
        if absorbed_decode:
            out = _mla_absorbed(p, cfg, q_nope, q_rope, cache.c_kv, cache.k_rope,
                                positions, scale)
            return row_parallel(out, p["wo"]), new_cache
        qh, kh, vh = _mla_heads(p, cfg, q_nope, q_rope, cache.c_kv, cache.k_rope)
        out = cached_attention(qh, kh, vh, positions, scale)
    else:  # train / prefill
        qh, kh, vh, c_kv, k_rope = mla_qkv(p, cfg, x, positions)
        out = chunked_attention(qh, kh, vh, causal=True, scale=scale)
        if cache_max_len is not None:  # prefill: publish the cache buffers
            cc = c_kv.new_zeros((b, cache_max_len, c_kv.shape[-1]))
            kc = k_rope.new_zeros((b, cache_max_len, dr))
            cc[:, :s] = c_kv
            kc[:, :s] = k_rope
            new_cache = MLACache(cc, kc, s)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return row_parallel(out, p["wo"]), new_cache


def _mla_absorbed(p, cfg: ArchConfig, q_nope, q_rope, c_all, kr_all, positions, scale):
    """Matrix-absorbed MLA decode: attention in the rank-r latent space.

    q_lat = q_nope @ W_uk^T per head; logits = q_lat . c_kv + q_rope .
    k_rope, summed before the fp32 cast; the probabilities cast to the
    cache's dtype before the product with the latents, then W_uv. No
    per-head K/V of length S_max is made.
    """
    b, s, h, dn = q_nope.shape
    r, dv = cfg.kv_lora_rank, cfg.v_head_dim
    smax = c_all.shape[1]
    w_uk = p["w_uk"].reshape(r, h, dn)
    w_uv = p["w_uv"].reshape(r, -1, dv)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
    logits = (torch.einsum("bshr,btr->bhst", q_lat, c_all)
              + torch.einsum("bshd,btd->bhst", q_rope, kr_all)).float() * scale
    pos = torch.as_tensor(positions, device=q_nope.device).expand(b, s)
    mask = torch.arange(smax, device=q_nope.device)[None, None, :] <= pos[:, :, None]
    logits = logits.masked_fill(~mask[:, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", probs.to(c_all.dtype), c_all)
    out = torch.einsum("bshr,rhd->bshd", ctx, w_uv)
    return out.reshape(b, s, -1)


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder)
# ---------------------------------------------------------------------------


def cross_attn_init(gen: torch.Generator, cfg: ArchConfig, dtype):
    """q, k, v and o projections, MHA; biases on q, v and o, none on k."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    dev = gen.device
    return {
        "wq": dense_init(gen, d, h * hd, dtype),
        "wk": dense_init(gen, d, h * hd, dtype),
        "wv": dense_init(gen, d, h * hd, dtype),
        "wo": dense_init(gen, h * hd, d, dtype),
        "bq": torch.zeros((h * hd,), dtype=dtype, device=dev),
        "bv": torch.zeros((h * hd,), dtype=dtype, device=dev),
        "bo": torch.zeros((d,), dtype=dtype, device=dev),
    }


def cross_attn_kv(p, cfg: ArchConfig, memory):
    """The encoder states' keys and values, memory (B, M, d) -> kh, vh (B,
    H, M, hd), transposed views."""
    b, m = memory.shape[:2]
    hd = cfg.hd
    k = mm(memory, p["wk"]).reshape(b, m, -1, hd)
    v = (mm(memory, p["wv"]) + _head_bias(p["bv"], cfg, kv=False)).reshape(b, m, -1, hd)
    return k.transpose(1, 2), v.transpose(1, 2)


def cross_attn_apply(p, cfg: ArchConfig, x, memory):
    """x: (B, S, d) queries; memory: (B, M, d) encoder states -> (B, S, d).
    Non-causal at scale ``hd ** -0.5``: one K6 launch on the card."""
    b, s, _ = x.shape
    hd = cfg.hd
    qh = (mm(x, p["wq"]) + _head_bias(p["bq"], cfg, kv=False)).reshape(b, s, -1, hd)
    qh = qh.transpose(1, 2)
    kh, vh = cross_attn_kv(p, cfg, memory)
    out = chunked_attention(qh, kh, vh, causal=False, scale=hd ** -0.5)
    return row_parallel(out.transpose(1, 2).reshape(b, s, -1), p["wo"]) + p["bo"]
