"""Shared functional building blocks of the LM stack (the dense family).

The port of the JAX package's ``models/layers.py``: params are nested dicts
of tensors, every module an ``init(generator, ...) -> params`` plus a plain
``apply`` function. Initializers draw from an explicit ``torch.Generator``
and allocate on its device (a CUDA generator initializes on the card). The
same numpy weights through :func:`repro_torch.convert.lm_params_from_numpy`
give the JAX package's numbers; the two frameworks' generators do not.

``gelu_mlp_*`` (encoder-decoder) and ``cross_entropy_loss`` (LM training)
wait for the slices that run them (``ROADMAP.md``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, d_in, d_out, dtype=torch.float32, scale=None):
    scale = scale if scale is not None else (d_in ** -0.5)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=gen.device)
    return (w * scale).to(dtype)


def rms_norm(x, scale, eps=1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x, params, kind: str):
    if kind == "layernorm":
        return layer_norm(x, params["scale"], params["bias"])
    return rms_norm(x, params["scale"])


def norm_init(d, kind: str, dtype=torch.float32, device=None):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


# -- rotary ------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None):
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, *, theta: float = 10000.0, fraction: float = 1.0):
    """Rotary embedding on the leading ``fraction`` of head dims.

    x: (..., S, H, D); positions: broadcastable to (..., S). Non-interleaved
    (half-split) convention, fp32 rotation.
    """
    d = x.shape[-1]
    rot = int(d * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    freqs = rope_freqs(rot, theta, device=x.device)            # (rot/2,)
    ang = positions[..., None].float() * freqs                 # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x_rot.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# -- MLPs ----------------------------------------------------------------------


def swiglu_init(gen: torch.Generator, d_model, d_ff, dtype=torch.float32):
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype),
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype),
    }


def swiglu_apply(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# -- embeddings -----------------------------------------------------------------


def embed_init(gen: torch.Generator, vocab, d_model, dtype=torch.float32):
    w = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32, device=gen.device)
    return (w * 0.02).to(dtype)


def embed_lookup(table, ids):
    return table[ids]
