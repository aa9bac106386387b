"""GQA attention of the dense LM stack (+bias / partial RoPE / QK-norm).

The port of the JAX package's ``models/attention.py`` for the dense family:

* prefill attention (:func:`chunked_attention`) goes by device. A CUDA
  tensor launches K6 (:func:`repro_torch.kernels.ops.flash_attention`)
  with the model's own scale; a CPU tensor runs the plain chunked path
  (query chunks of 512, scores grouped ``(B, Hkv, G, BQ, Tk)``, K/V heads
  never repeated), the reference's ``use_pallas=False``. There is no
  ``use_pallas`` flag: the device decides;
* decode (:func:`cached_attention`) attends over the whole preallocated
  cache buffer with an explicit position mask, a plain masked einsum, as in
  the reference; it runs no kernel.

KV caches: (B, S_max, Hkv, hd). Prefill writes the fresh K/V into a zeroed
buffer of ``cache_max_len``; decode appends in place. Unlike the JAX
package, which returns new buffers, the port writes the cache tensors in
place at ``length`` and returns a :class:`KVCache` over the same storage:
a caller that needs the old cache keeps a copy.

MLA, its absorbed decode and cross-attention wait for their slices
(``ROADMAP.md``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_rope, dense_init, rms_norm

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


def chunked_attention(q, k, v, *, causal: bool, scale: float,
                      q_chunk: int = DEFAULT_Q_CHUNK):
    """softmax(q k^T * scale) v without materializing (Tq, Tk) or repeated KV.

    q: (B, Hq, Tq, hd); k, v: (B, Hkv, Tk, hd). End-aligned causal offset.
    On a CUDA tensor this is one K6 launch; on the CPU the chunked plain path.
    """
    if q.device.type == "cuda":
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


def make_kv_cache(cfg: ArchConfig, batch: int, max_len: int, dtype, device=None) -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def gqa_qkv(p, cfg: ArchConfig, x, positions):
    """The projections of :func:`gqa_apply`, after bias, QK-norm and RoPE.

    x: (B, S, d) -> q (B, S, Hq, hd), k and v (B, S, Hkv, hd).
    """
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
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
    hq, hd = cfg.n_heads, cfg.hd
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
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    return out @ p["wo"], new_cache
