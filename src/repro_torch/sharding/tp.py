"""The rank-local serving plan: tensor parallelism on the ``model`` axis.

:func:`shard_lm_params` cuts a model's params (the port's layout, one dict
per layer) to this rank's share on ``model`` and keeps whole copies on
``data``: the reference serves with its params unsharded and constrains only
the activations (``launch/serve.py``), so serving needs no FSDP. The plan
splits a weight only on a dim that :func:`repro_torch.sharding.specs.param_spec`
(mode ``"decode"``) puts on ``model``, and only on head or hidden
boundaries:

* attention q heads (``wq`` columns, ``wo`` rows) and the kv heads they
  read (``wk``, ``wv`` columns): with ``n_kv_heads`` a multiple of the axis
  size each rank holds its own kv heads; with fewer kv heads than ranks
  (chatglm3's 2 over 4) each rank holds the whole kv heads its q heads
  read, though the spec cuts across a head;
* the FFN hidden: SwiGLU, the GELU MLP, DeepSeek's dense prefix and shared
  experts, the MoE experts' ``f`` (the experts replicated, the spec's
  decode mode);
* MLA's heads (``wq``, ``w_uk``, ``w_uv``, ``wo``);
* the vocab (``embed`` rows, ``lm_head`` columns, a tied head through the
  embedding) where the spec's divisibility guard lets it.

Everything else stays whole, and the rank computes it whole: norms, biases
(cut to the rank's heads at use, as XLA slices a replicated operand), the
MoE router, MLA's ``w_dkv`` and latent cache, the Mamba2 block (``w_in``,
``conv_w``, ``w_out``: the spec keeps the first two whole on ``model``),
zamba2's ``w_concat`` (which the spec cuts: a layout that differs on
purpose, ``ROADMAP.md``). A layout this plan cannot cut on head or hidden
boundaries raises ``NotImplementedError``.

The plan is a tree of cuts (:func:`model_cuts`), which the training plan
(:mod:`repro_torch.sharding.fsdp`) reads too, with the MoE experts cut
whole on ``model`` (the spec's train mode) and a kv head shared by ranks
refused. Model code finds its ``model`` axis through
:func:`repro_torch.sharding.ctx.model_axis` and reads the blocks below
(:func:`q_block`, :func:`kv_block`). :func:`gather_caches` and
:func:`gather_rows` put a rank's caches and rows back into the
one-device layout, for checks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_ITEM = "the plan cuts heads and hidden units evenly over the axis"
_ITEM_TRAIN = "the training plan holds each kv head on one rank"


# -- blocks ------------------------------------------------------------------


def even_block(n: int, axis) -> Tuple[int, int]:
    """This rank's block of ``n`` (heads, hidden units) on ``axis``."""
    if n % axis.size:
        raise NotImplementedError(
            f"tensor parallelism cuts {n} over {axis.size} ranks on head or hidden "
            f"boundaries only ({_ITEM})")
    b = n // axis.size
    return axis.index * b, (axis.index + 1) * b


def q_block(n_heads: int, axis) -> Tuple[int, int]:
    return even_block(n_heads, axis)


def kv_block(n_heads: int, n_kv: int, axis) -> Tuple[int, int]:
    """The kv heads this rank's q heads read: its own block when ``n_kv``
    is a multiple of the axis size, the one kv head they share when there
    are fewer kv heads than ranks."""
    q0, q1 = q_block(n_heads, axis)
    g = n_heads // n_kv
    k0, k1 = q0 // g, -(-q1 // g)
    if k1 - k0 > 1 and (q0 % g or (q1 - q0) % g):
        raise NotImplementedError(
            f"{n_heads} q heads over {n_kv} kv heads on {axis.size} ranks: a rank's q "
            f"heads would read part of a kv group ({_ITEM})")
    return k0, k1


def kv_owner(n_heads: int, n_kv: int, axis) -> bool:
    """Whether this rank is the first to hold its kv heads (the one that
    gives them back in :func:`gather_caches`)."""
    return q_block(n_heads, axis)[0] % (n_heads // n_kv) == 0


def vocab_block(vocab: int, axis) -> Optional[Tuple[int, int]]:
    """This rank's rows of the vocabulary, or None where the spec's guard
    keeps it whole (a vocabulary the axis size does not divide)."""
    return None if vocab % axis.size else even_block(vocab, axis)


def batch_rows(mesh, batch: int) -> slice:
    """This rank's rows of a batch on ``data``: a contiguous block where the
    axis divides the batch, else every row (the spec's ``dp_dim``)."""
    axis = mesh.axis("data")
    if batch % axis.size:
        return slice(0, batch)
    b = batch // axis.size
    return slice(axis.index * b, (axis.index + 1) * b)


# -- the plan ------------------------------------------------------------------
#
# A plan is a tree of cuts beside the params: ``(dim, lo, hi)`` where a
# leaf keeps ``[lo, hi)`` of ``dim``, None where it stays whole.
# :func:`shard_lm_params` applies the serving plan; the training plan
# (:mod:`repro_torch.sharding.fsdp`) reads the same cuts with the MoE
# experts on ``model`` (``experts="ep"``).


def _cols(w, lo, hi):
    return (w.dim() - 1, lo, hi)


def _rows(w, lo, hi):
    return (w.dim() - 2, lo, hi)


def _whole(tree):
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_whole(v) for v in tree]
    return None


def _gqa(cfg, p, axis, n_kv=None, train=False):
    hd = cfg.hd
    n_kv = n_kv or cfg.n_kv_heads
    if train and n_kv < axis.size:
        raise NotImplementedError(
            f"{n_kv} kv heads on {axis.size} ranks: training would sum a shared kv head's "
            f"gradient over part of the axis ({_ITEM_TRAIN})")
    q0, q1 = q_block(cfg.n_heads, axis)
    k0, k1 = kv_block(cfg.n_heads, n_kv, axis)
    out = _whole(p)        # biases and QK-norm scales stay whole
    out["wq"] = _cols(p["wq"], q0 * hd, q1 * hd)
    out["wk"] = _cols(p["wk"], k0 * hd, k1 * hd)
    out["wv"] = _cols(p["wv"], k0 * hd, k1 * hd)
    out["wo"] = _rows(p["wo"], q0 * hd, q1 * hd)
    return out


def _mla(cfg, p, axis):
    q0, q1 = q_block(cfg.n_heads, axis)
    dq, dn, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.qk_nope_dim, cfg.v_head_dim
    out = _whole(p)        # w_dkv and kv_norm stay whole: the latent is every head's
    out["wq"] = _cols(p["wq"], q0 * dq, q1 * dq)
    out["w_uk"] = _cols(p["w_uk"], q0 * dn, q1 * dn)
    out["w_uv"] = _cols(p["w_uv"], q0 * dv, q1 * dv)
    out["wo"] = _rows(p["wo"], q0 * dv, q1 * dv)
    return out


def _ffn(p, axis, up=("w_gate", "w_up"), down="w_down"):
    f0, f1 = even_block(p[down].shape[-2], axis)
    out = _whole(p)        # a GELU MLP's biases stay whole
    for k in up:
        out[k] = _cols(p[k], f0, f1)
    out[down] = _rows(p[down], f0, f1)
    return out


def _moe(p, axis, experts):
    if experts == "ep":    # (E, d, f) and (E, f, d): the experts cut, each whole
        e0, e1 = even_block(p["w_down"].shape[0], axis)
        out = _whole(p)
        for k in ("w_gate", "w_up", "w_down"):
            out[k] = (0, e0, e1)
    else:                  # f cut, the experts whole (the spec's decode mode)
        out = _ffn(p, axis)
    if "shared" in p:
        out["shared"] = _ffn(p["shared"], axis)
    return out


def _block(cfg, p, axis, experts, train):
    out = _whole(p)
    if "attn" in p:
        out["attn"] = (_mla(cfg, p["attn"], axis) if cfg.use_mla
                       else _gqa(cfg, p["attn"], axis, train=train))
    if "cross" in p:
        out["cross"] = _gqa(cfg, p["cross"], axis, n_kv=cfg.n_heads)
    if "moe" in p:
        out["moe"] = _moe(p["moe"], axis, experts)
    if "mlp" in p:
        out["mlp"] = (_ffn(p["mlp"], axis, up=("w_in",), down="w_out") if "w_in" in p["mlp"]
                      else _ffn(p["mlp"], axis))
    return out


def model_cuts(cfg, params, axis, *, experts: str = "f", train: bool = False):
    """The plan's cut of every leaf of ``params`` (one device's, any
    family) on ``axis`` (``model``): a tree beside ``params`` of ``(dim,
    lo, hi)`` or None (whole). ``experts``: ``"f"`` cuts the MoE experts'
    hidden (serving), ``"ep"`` the experts themselves (training). With
    ``train``, a kv head shared by ranks raises: its gradient would be a
    sum over part of the axis."""
    out = _whole(params)
    if axis.size == 1:
        return out
    vb = vocab_block(cfg.vocab_size, axis)
    if vb is not None:
        out["embed"] = _rows(params["embed"], *vb)
        if "lm_head" in params:
            out["lm_head"] = _cols(params["lm_head"], *vb)
    for key in ("layers", "prefix_layers", "enc_layers", "dec_layers"):
        if key in params and cfg.family != "ssm":
            out[key] = [_block(cfg, lp, axis, experts, train) for lp in params[key]]
    if "shared" in params:             # the hybrid's: attention and MLP cut, w_concat whole
        sp = dict(out["shared"])
        sp["attn"] = _gqa(cfg, params["shared"]["attn"], axis, train=train)
        sp["mlp"] = _ffn(params["shared"]["mlp"], axis)
        out["shared"] = sp
    return out


def cut(t, c):
    """``t``'s block under the cut ``c`` (a contiguous copy), or ``t``."""
    if c is None:
        return t
    dim, lo, hi = c
    return t.narrow(dim, lo, hi - lo).contiguous()


def apply_cuts(params, cuts):
    """``params`` with every leaf cut by its entry of ``cuts``; a whole leaf
    is shared with ``params``, not copied."""
    if isinstance(params, dict):
        return {k: apply_cuts(v, cuts[k]) for k, v in params.items()}
    if isinstance(params, list):
        return [apply_cuts(v, c) for v, c in zip(params, cuts)]
    return cut(params, cuts)


def shard_lm_params(cfg, params, mesh):
    """``params`` (one device's, any family) cut to this rank's share on
    ``mesh``'s ``model`` axis (:mod:`this module <repro_torch.sharding.tp>`);
    the same params where the axis has one rank. Tensors kept whole are
    shared with ``params``, not copied."""
    axis = mesh.axis("model")
    if axis.size == 1:
        return params
    return apply_cuts(params, model_cuts(cfg, params, axis))


# -- back to one device's layout (checks) ----------------------------------------


def gather_rows(mesh, local: torch.Tensor, batch: int) -> torch.Tensor:
    """The ``(batch, ...)`` tensor whose rows on ``data`` are each rank's
    ``local`` (:func:`batch_rows`): one all-reduce of a zero-filled float32
    buffer over ``data`` (gloo has no all-gather of CUDA tensors)."""
    axis = mesh.axis("data")
    if axis.size == 1:
        return local
    rows = batch_rows(mesh, batch)
    if local.shape[0] == batch:        # every data row holds the whole batch
        return local
    buf = torch.zeros((batch,) + tuple(local.shape[1:]), dtype=torch.float32,
                      device=local.device)
    buf[rows] = local.float()
    return axis.all_reduce(buf).to(local.dtype)


def _gather_leaf(cfg, mesh, field, local, batch):
    """One cache tensor back to one device's shape: a KV cache's heads from
    the ``model`` ranks that own them, anything else from ``model`` rank 0;
    rows from their ``data`` ranks."""
    model, data = mesh.axis("model"), mesh.axis("data")
    rows = batch_rows(mesh, batch)
    row_owner = local.shape[0] != batch or data.index == 0
    if field in ("k", "v") and model.size > 1:
        n_kv = cfg.n_kv_heads
        k0, k1 = kv_block(cfg.n_heads, n_kv, model)
        owner = row_owner and kv_owner(cfg.n_heads, n_kv, model)
        shape = (batch,) + tuple(local.shape[1:-2]) + (n_kv, local.shape[-1])
        index = (rows, Ellipsis, slice(k0, k1), slice(None))
    else:
        owner = row_owner and model.index == 0
        shape = (batch,) + tuple(local.shape[1:])
        index = (rows,)
    buf = torch.zeros(shape, dtype=torch.float32, device=local.device)
    if owner:
        buf[index] = local.float()
    if model.size > 1:
        model.all_reduce(buf)
    if data.size > 1:
        data.all_reduce(buf)
    return buf.to(local.dtype)


def gather_caches(cfg, mesh, caches, batch: int):
    """A rank's caches (any family's nest of ``KVCache``, ``MLACache``,
    ``SSMCache`` and an encdec model's ``memory``) in one device's layout
    on every rank: every KV head, every batch row. Float32 all-reduces of
    zero-filled buffers, one a tensor and axis; exact."""
    if isinstance(caches, dict):
        return {k: gather_caches(cfg, mesh, v, batch) for k, v in caches.items()}
    if isinstance(caches, list):
        return [gather_caches(cfg, mesh, v, batch) for v in caches]
    if hasattr(caches, "_fields"):
        return type(caches)(*(
            getattr(caches, f) if isinstance(getattr(caches, f), int)
            else _gather_leaf(cfg, mesh, f, getattr(caches, f), batch)
            for f in caches._fields))
    return _gather_leaf(cfg, mesh, None, caches, batch)


def collectives_per_call(cfg, model_size: int, prefill: bool) -> int:
    """The all-reduces on ``model`` of one prefill (``prefill``) or one
    decode step at ``model_size > 1`` ranks: two a transformer layer
    (after the attention's ``wo``, after the FFN's or the MoE layer's down
    projection), two a hybrid's shared-block application, none a Mamba2
    block, two an encoder layer and three a decoder layer (self-attention,
    cross-attention, MLP) of an encdec model; and one each for the
    embedding and the logits where the vocabulary is cut."""
    if cfg.family == "ssm":
        layers = 0
    elif cfg.family == "hybrid":
        layers = 2 * (cfg.n_layers // cfg.attn_every)
    elif cfg.family == "encdec":
        layers = 3 * cfg.n_layers + (2 * (cfg.n_enc_layers or cfg.n_layers) if prefill else 0)
    else:
        layers = 2 * cfg.n_layers
    return layers + (0 if cfg.vocab_size % model_size else 2)
