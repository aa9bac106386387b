"""Shared functional building blocks of the LM stack (the dense family).

The port of the JAX package's ``models/layers.py``: params are nested dicts
of tensors, every module an ``init(generator, ...) -> params`` plus a plain
``apply`` function. Initializers draw from an explicit ``torch.Generator``
and allocate on its device (a CUDA generator initializes on the card). The
same numpy weights through :func:`repro_torch.convert.lm_params_from_numpy`
give the JAX package's numbers; the two frameworks' generators do not.

``gelu_mlp_*`` is the encoder-decoder's MLP (whisper), with the tanh GELU
rounded as XLA rounds ``jax.nn.gelu(approximate=True)`` (:func:`gelu_tanh`).
``cross_entropy_loss`` is LM training's token loss.

Products of the models go through :func:`mm` (and ``promoted``), which
promote mixed float operands as ``jnp.matmul`` does: under the train
step's cast (:func:`repro_torch.launch.steps.cast_params_for_compute`) a
float32 config's activations meet bfloat16 weights, and JAX computes such a
product in float32 where ``torch.matmul`` refuses it. Element-wise
arithmetic needs nothing: PyTorch promotes two float tensors as JAX does.
:func:`remat_call` is the per-layer rematerialization of the losses.

Tensor parallelism (serving under a ``model`` axis of more than one rank,
:func:`repro_torch.sharding.ctx.model_axis`; the rank's params from
:func:`repro_torch.sharding.tp.shard_lm_params`): :func:`row_parallel` is
an output projection over this rank's rows of the inner dim, its float32
partial sums all-reduced and rounded once, as one GEMM on one device
accumulates and rounds; :func:`embed_lookup` and :func:`vocab_logits` take
a vocabulary cut into row blocks (a masked lookup and one all-reduce; the
local logits gathered by one all-reduce of a zero-filled float32 buffer).
Outside such an axis each is the single-device call it replaces.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.ctx import model_axis


def promoted(a, b):
    """``a`` and ``b`` cast to their common dtype (``torch.promote_types``:
    float32 with bfloat16 is float32, as in JAX); as they are if equal."""
    if a.dtype == b.dtype:
        return a, b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def mm(a, b):
    """``a @ b`` with JAX's promotion of mixed operands: ``jnp.matmul`` of
    float32 and bfloat16 is a float32 product."""
    a, b = promoted(a, b)
    return a @ b


def mm_f32(a, b):
    """``a @ b`` (2-D or batched 3-D ``b``) with float32 outputs: a float32
    product as it is; bf16 operands accumulate in float32 and are not
    rounded (on the card the GEMM's ``out_dtype``, on the CPU the operands
    widened)."""
    a, b = promoted(a, b)
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        if b.dim() == 2:
            out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
            return out.reshape(*a.shape[:-1], b.shape[-1])
        return torch.bmm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def row_parallel(x, w):
    """``x @ w`` where ``w`` holds this rank's rows of the inner dim (an
    attention output or FFN down projection, ``x`` its columns): the
    float32 partial sums all-reduced over the ``model`` axis, then rounded
    once to the operands' dtype. Without a ``model`` axis, :func:`mm`."""
    axis = model_axis()
    if axis is None:
        return mm(x, w)
    dt = torch.promote_types(x.dtype, w.dtype)
    return axis.all_reduce(mm_f32(x, w)).to(dt)


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward when ``remat`` (the
    reference's ``jax.checkpoint`` with ``nothing_saveable``): only the
    inputs are kept, and grad mode stays on while ``fn`` runs, so every call
    inside it sees the tensors that need a gradient."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


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


@functools.lru_cache(maxsize=None)
def _rope_freqs(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    exps = (torch.arange(0, dim, 2, dtype=torch.float32) / dim).numpy()
    # one float32 power at a time: numpy's scalar power is libm's powf, as
    # XLA's is; a vectorized power (numpy's, PyTorch's) differs by an ulp on
    # about 1 % of the frequencies
    one, base = np.float32(1.0), np.float32(theta)
    return torch.tensor([one / (base ** e) for e in exps], dtype=torch.float32).to(device)


def rope_freqs(dim: int, theta: float, device=None):
    """1 / theta^(i / dim) for even i < dim, float32 (dim / 2,).

    Made on the host, whatever ``device``, and copied there once (cached per
    device; callers must not write to it): the exponents by float32 true
    division, the power and the reciprocal in float32, each equal to the
    reference's bits (held at every even width to 398 and five thetas). The
    card divides a tensor by a number as a product with the reciprocal,
    which puts some exponents an ulp off at a width that is not a power of
    two (zamba2's 80), an ulp that grows with the position in the angle."""
    return _rope_freqs(int(dim), float(theta), torch.device("cpu" if device is None else device))


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
    return row_parallel(F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"]), p["w_down"])


def _rounded(v: float, dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python float."""
    return torch.tensor(v, dtype=dtype).item()


def gelu_tanh(x):
    """0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))) with XLA's rounding of
    ``jax.nn.gelu(approximate=True)``: its two constants rounded to x's
    dtype (the reference casts sqrt(2/pi) to it, and 0.044715 is weakly
    typed), each step rounded to x's dtype in the reference's order (x^3,
    * 0.044715, + x, * sqrt(2/pi), tanh, + 1, * 0.5, x *). In bf16 this
    gives the reference's bits; ``F.gelu(approximate="tanh")`` rounds once,
    and its outputs differ from them on 45 % of bf16 inputs."""
    k0, k1 = _rounded(math.sqrt(2 / math.pi), x.dtype), _rounded(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(k0 * (x + k1 * x ** 3))))


def gelu_mlp_init(gen: torch.Generator, d_model, d_ff, dtype=torch.float32):
    dev = gen.device
    return {
        "w_in": dense_init(gen, d_model, d_ff, dtype),
        "b_in": torch.zeros((d_ff,), dtype=dtype, device=dev),
        "w_out": dense_init(gen, d_ff, d_model, dtype),
        "b_out": torch.zeros((d_model,), dtype=dtype, device=dev),
    }


def _hidden_bias(b, width: int):
    """A bias over the whole hidden (kept whole by the plan, as the spec
    does) cut to this rank's ``width`` units."""
    if b.shape[-1] == width:
        return b
    i = model_axis().index
    return b[i * width:(i + 1) * width]


def gelu_mlp_apply(p, x):
    hid = mm(x, p["w_in"])
    hid = gelu_tanh(hid + _hidden_bias(p["b_in"], hid.shape[-1]))
    return row_parallel(hid, p["w_out"]) + p["b_out"]


# -- embeddings -----------------------------------------------------------------


def embed_init(gen: torch.Generator, vocab, d_model, dtype=torch.float32):
    w = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32, device=gen.device)
    return (w * 0.02).to(dtype)


def embed_lookup(table, ids, vocab_size=None):
    """``table[ids]``. Under a ``model`` axis, a ``table`` of fewer rows than
    ``vocab_size`` is this rank's block of them: the ids outside it look up
    zeros, and one all-reduce (float32, exact: one term is not zero) gives
    every rank every row."""
    axis = model_axis()
    n = table.shape[0]
    if axis is None or vocab_size is None or n == vocab_size:
        return table[ids]
    local = ids - axis.index * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].float()
    rows = torch.where(inside[..., None], rows, torch.zeros((), device=rows.device))
    return axis.all_reduce(rows).to(table.dtype)


def vocab_logits(h, head, vocab_size: int):
    """``h @ head`` (head (d, V)). Under a ``model`` axis, a ``head`` of
    fewer columns than ``vocab_size`` is this rank's block of them: its
    logits go into a zero-filled float32 (..., V) buffer, and one
    all-reduce gives every rank every logit."""
    logits = mm(h, head)
    axis = model_axis()
    n = head.shape[-1]
    if axis is None or n == vocab_size:
        return logits
    buf = torch.zeros(logits.shape[:-1] + (vocab_size,), dtype=torch.float32,
                      device=logits.device)
    buf[..., axis.index * n:(axis.index + 1) * n] = logits.float()
    return axis.all_reduce(buf).to(logits.dtype)


def cross_entropy_loss(logits, labels, mask=None):
    """Token CE with an fp32 logsumexp; logits (B, S, V), labels (B, S).
    With ``mask`` (B, S), the masked mean: sum(nll * mask) / max(sum(mask),
    1)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
