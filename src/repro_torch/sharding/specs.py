"""Partition rules: parameters, batches, optimizer state, caches.

The port of the JAX package's ``sharding/specs.py``, rule for rule:

* TP on ``model``: attention q/o heads, FFN hidden, vocab, MoE experts (EP),
  MLA latent, zamba shared-block internals;
* FSDP on ``data`` (x ``pod``): the non-TP dim of every large matrix;
* DP: batch dims on ``data`` (x ``pod``);
* sequence sharding: decode KV caches shard the sequence axis on ``model``
  where the kv heads do not divide it; MLA caches shard the sequence (else
  the latent dim); SSM state caches shard heads;
* ES-RNN per-series params sharded on ``data`` (:func:`esrnn_param_spec`).

A spec is a plain tuple with one entry per dim of the leaf: an axis name, a
tuple of names, or None. Paths are tuples of names over the reference's
stacked layout (:func:`repro_torch.convert.lm_stacked_layout`: a dict key
as itself, a list index as ``"[i]"``, a cache's field by its name), so a
stacked layer's leading ``(L,)`` or ``(G, K)`` dims get None prepended, as
in the reference. The reference keeps the mesh and the param mode in module
globals (``set_mesh``, ``set_param_mode``); here both are arguments. A
mesh is anything with ``axis_names`` and ``shape`` (a dict of axis sizes):
:class:`repro_torch.launch.mesh.AbstractMesh` or a host mesh. The
divisibility guard is the reference's: an axis whose size does not divide
its dim is dropped.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

Spec = Tuple[Any, ...]


def axes_for(mesh) -> Dict[str, Any]:
    names = mesh.axis_names
    dp = tuple(n for n in names if n in ("pod", "data"))
    return {"dp": dp if len(dp) > 1 else dp[0], "tp": "model"}


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size; ``{}`` for no mesh (every axis then divides)."""
    return {} if mesh is None else dict(mesh.shape)


def _axis_size(sizes: Dict[str, int], ax) -> int:
    return int(np.prod([sizes.get(a, 1) for a in (ax if isinstance(ax, tuple) else (ax,))]))


# weight-name classes (trailing-2D rules)
_OUT_TP = {"wq", "wk", "wv", "w_gate", "w_up", "w_in"}      # (d_in, out): out on tp
_IN_TP = {"wo", "w_down", "w_out"}                          # (in, d_out): in on tp
_EMBED = {"embed"}
_HEAD = {"lm_head"}


def param_spec(path: Sequence[str], leaf, axes, *, mesh=None, mode: str = "train") -> Spec:
    """The spec of the param at ``path`` (a tuple of names) with
    ``leaf.shape``. ``mode``: ``"train"`` or ``"prefill"`` put the MoE
    experts on ``model`` (EP); ``"decode"`` replicates them and puts their
    FFN hidden there."""
    names = tuple(path)
    name = names[-1]
    ndim = len(leaf.shape)
    dp, tp = axes["dp"], axes["tp"]
    in_ssm = "ssm" in names or name in ("conv_w", "conv_b", "a_log", "dt_bias",
                                        "d_skip", "out_norm")
    # expert-stacked weights: trailing (E, a, b); shared experts are plain
    # dense mats (leading layer-stack dims get None prepended below)
    in_moe = ("moe" in names and "shared" not in names
              and name in ("w_gate", "w_up", "w_down") and ndim >= 3)

    def base() -> Tuple:
        if name in _EMBED:
            return (tp, dp)
        if name in _HEAD:
            return (dp, tp)
        if in_moe:  # (E, a, b) expert-stacked
            if mode == "decode":
                return (None, dp, tp) if name in ("w_gate", "w_up") else (None, tp, dp)
            return (tp, dp, None)
        if name == "router":
            return (dp, None)
        if in_ssm:
            if name == "w_in":
                return (dp, None)      # mixed z/x/B/C/dt out dim: keep whole
            if name == "w_out":
                return (None, dp)
            if name == "conv_w":
                return (None, None)
            return tuple([None] * ndim)
        if name == "w_dkv":             # MLA latent down-proj (small)
            return (dp, None)
        if name in ("w_uk", "w_uv"):    # MLA up-proj: heads on tp
            return (None, tp)
        if name == "w_concat":          # zamba concat proj
            return (dp, tp)
        if name in _OUT_TP:
            return (dp, tp)
        if name in _IN_TP:
            return (tp, dp)
        return tuple([None] * ndim)

    spec = base()
    if len(spec) < ndim:
        spec = tuple([None] * (ndim - len(spec))) + spec
    elif len(spec) > ndim:
        spec = spec[-ndim:]
    # divisibility guard: drop axes that don't divide the dim
    sizes = mesh_sizes(mesh)
    fixed = []
    for dim, ax in zip(leaf.shape, spec):
        if ax is None:
            fixed.append(None)
            continue
        size = _axis_size(sizes, ax)
        fixed.append(ax if size and dim % size == 0 else None)
    return tuple(fixed)


def path_part(key) -> str:
    return f"[{key}]" if isinstance(key, int) else str(key)


def tree_map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a nest of dicts, lists and named tuples (a
    field by its name); any other object is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (path_part(k),)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (path_part(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_leaves_with_path(tree):
    """[(path, leaf)] of :func:`tree_map_with_path`'s walk, in its order."""
    out = []
    tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def param_shardings(mesh, params_abs, mode: str = "train"):
    """The tree of specs matching ``params_abs`` (any tree of leaves with a
    ``shape``: the stacked layout's :class:`~repro_torch.convert.StackedLeaf`)."""
    axes = axes_for(mesh)
    return tree_map_with_path(
        lambda path, leaf: param_spec(path, leaf, axes, mesh=mesh, mode=mode), params_abs)


# -- batches / caches --------------------------------------------------------


def dp_dim(mesh, batch: int):
    """dp axis tuple if it divides the batch, else None (tiny-batch decode)."""
    dp = axes_for(mesh)["dp"]
    return dp if batch % _axis_size(mesh_sizes(mesh), dp) == 0 else None


def batch_spec(mesh, leaf_ndim: int, batch: int) -> Spec:
    return (dp_dim(mesh, batch),) + (None,) * (leaf_ndim - 1)


def cache_spec(mesh, path: Sequence[str], leaf, batch: int) -> Spec:
    """Cache sharding by leaf shape heuristics (see the module docstring)."""
    names = tuple(path)
    name = names[-1] if names else ""
    dpd = dp_dim(mesh, batch)
    tp = "model"
    tp_size = mesh_sizes(mesh).get("model", 1)
    shape = tuple(leaf.shape)
    nd = len(shape)

    if nd == 0:  # length scalars
        return ()
    if nd == 1:  # stacked length (L,)
        return (None,)

    # the batch dim: the first dim equal to the batch (the reference's
    # scan, which may meet a stack dim of the same size first)
    spec = [None] * nd
    b_idx = next((i for i, d in enumerate(shape) if d == batch), None)
    if b_idx is not None and dpd is not None:
        spec[b_idx] = dpd

    if name in ("k", "v") and nd >= 4:            # (..., B, S, Hkv, hd)
        s_idx, h_idx = nd - 3, nd - 2
        if shape[h_idx] % tp_size == 0:
            spec[h_idx] = tp
        elif shape[s_idx] % tp_size == 0:
            spec[s_idx] = tp
    elif name in ("c_kv", "k_rope") and nd >= 3:  # (..., B, S, r): the sequence
        if shape[-2] % tp_size == 0:
            spec[-2] = tp
        elif shape[-1] % tp_size == 0:
            spec[-1] = tp
    elif name == "state" and nd >= 4:             # (..., B, H, P, N)
        h_idx = nd - 3
        if shape[h_idx] % tp_size == 0:
            spec[h_idx] = tp
    elif name == "conv" and nd >= 3:              # (..., B, K-1, conv_dim)
        if shape[-1] % tp_size == 0:
            spec[-1] = tp
    return tuple(spec)


def cache_shardings(mesh, caches_abs, batch: int):
    return tree_map_with_path(lambda path, leaf: cache_spec(mesh, path, leaf, batch),
                              caches_abs)


def batch_shardings(mesh, batch_abs, batch: int):
    """Specs of a batch template: ``{name: (shape, dtype)}``
    (:func:`repro_torch.launch.steps.batch_template`) or leaves with a
    ``shape``."""
    return {k: batch_spec(mesh, len(_shape(v)), batch) for k, v in batch_abs.items()}


def esrnn_param_spec(path: Sequence[str], leaf, dp) -> Spec:
    """ES-RNN: the per-series ``hw`` table on ``dp`` (its gradients stay on
    the rank), every shared weight replicated (the reference's dry-run,
    ``launch/dryrun.py``'s ``lower_esrnn``)."""
    ndim = len(leaf.shape)
    if "hw" in tuple(path):
        return (dp,) + (None,) * (ndim - 1)
    return (None,) * ndim


# -- what a rank holds ---------------------------------------------------------


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf[0]) if isinstance(leaf, tuple) else tuple(leaf.shape)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One rank's shard of ``shape`` under ``spec``: each dim divided by the
    product of its axes' sizes (rounded up, as a sharded array's shard)."""
    sizes = mesh_sizes(mesh)
    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        size = 1 if ax is None else _axis_size(sizes, ax)
        out.append(-(-int(dim) // size))
    return tuple(out)


def itemsize(dtype) -> int:
    """Bytes of one element of ``dtype`` (a ``torch.dtype`` or its name)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype).element_size()


def local_bytes(shape: Sequence[int], dtype, spec: Spec, mesh) -> int:
    return int(np.prod(local_shape(shape, spec, mesh), dtype=np.int64)) * itemsize(dtype)


def tree_local_bytes(tree, specs, mesh) -> int:
    """One rank's bytes of a tree of shaped leaves (``shape`` and ``dtype``)
    under a matching tree of specs."""
    spec_of = dict(tree_leaves_with_path(specs))   # a spec (a plain tuple) is a leaf
    return sum(local_bytes(leaf.shape, leaf.dtype, spec_of[path], mesh)
               for path, leaf in tree_leaves_with_path(tree))
