"""Convert between the JAX package's params pytrees and the port's params.

ES-RNN (:func:`params_from_numpy`, :func:`params_to_numpy`): the JAX tree (with numpy leaves, e.g. after ``jax.tree_util.tree_map(
np.asarray, params)``) is ``{"hw": HWParams, "rnn": [[{wx, wh, b}]],
"head": {dense_w, dense_b, out_w, out_b}, "attn"?: {wq, wk, wv}}`` (the lstm
and esn heads) or ``{"hw", "ssm": {w_in, a_log, dt_bias, d_skip}, "head"}``
(the ssm head). The port
keeps the same keys and the same orientation, so the mapping is leaf by
leaf: no transposes, no reordering of gates, bitwise in both directions.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core.drnn import LSTMCell
from repro_torch.core.esrnn import param_leaves
from repro_torch.core.heads import SSM, Attention, Readout
from repro_torch.core.holt_winters import HWParams
from repro_torch.device import resolve_device

__all__ = ["params_from_numpy", "params_to_numpy", "params_to_device", "copy_params",
           "lm_params_from_numpy", "lm_params_to_numpy", "lm_leaves_to_numpy",
           "lm_leaves_from_numpy", "lm_opt_state_to_numpy", "lm_opt_state_from_numpy",
           "lm_stacked_layout"]

_HW_FIELDS = tuple(f.name for f in dataclasses.fields(HWParams))
_READOUT = ("dense_w", "dense_b", "out_w", "out_b")
_ATTN = ("wq", "wk", "wv")
_SSM = ("w_in", "a_log", "dt_bias", "d_skip")


def _leaf(tree, name):
    return tree.get(name) if isinstance(tree, dict) else getattr(tree, name, None)


def params_from_numpy(tree, device=None):
    """The port's params from a numpy-leaved JAX params tree, on ``device``.

    ``tree["hw"]`` may be the JAX ``HWParams`` (read by attribute) or a dict
    of its fields.
    """
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev)
    hw = HWParams(**{name: (None if _leaf(tree["hw"], name) is None
                            else t(_leaf(tree["hw"], name)))
                     for name in _HW_FIELDS})
    out = {"hw": hw}
    if "rnn" in tree:
        out["rnn"] = nn.ModuleList(
            nn.ModuleList(LSTMCell(t(cell["wx"]), t(cell["wh"]), t(cell["b"]))
                          for cell in block)
            for block in tree["rnn"])
    if "head" in tree:
        out["head"] = Readout(*(t(tree["head"][k]) for k in _READOUT))
    if "attn" in tree:
        out["attn"] = Attention(*(t(tree["attn"][k]) for k in _ATTN))
    if "ssm" in tree:
        out["ssm"] = SSM(*(t(tree["ssm"][k]) for k in _SSM))
    return out


def params_to_numpy(params):
    """The JAX-shaped tree of numpy arrays; ``hw`` becomes a dict of fields."""
    a = lambda p: p.detach().cpu().numpy().copy()
    out = {"hw": {name: (None if getattr(params["hw"], name) is None
                         else a(getattr(params["hw"], name)))
                  for name in _HW_FIELDS}}
    if "rnn" in params:
        out["rnn"] = [[{"wx": a(c.wx), "wh": a(c.wh), "b": a(c.b)} for c in block]
                      for block in params["rnn"]]
    if "head" in params:
        out["head"] = {k: a(getattr(params["head"], k)) for k in _READOUT}
    if "attn" in params:
        out["attn"] = {k: a(getattr(params["attn"], k)) for k in _ATTN}
    if "ssm" in params:
        out["ssm"] = {k: a(getattr(params["ssm"], k)) for k in _SSM}
    return out


def params_to_device(params, device):
    """``params`` on ``device``: a module already there is shared, any other
    is copied (``nn.Module.to`` would move the caller's module in place)."""
    dev = resolve_device(device)

    def move(v):
        if isinstance(v, HWParams):
            return v.to(dev)
        if all(p.device == dev for p in v.parameters()):
            return v
        return copy.deepcopy(v).to(dev)

    return {k: move(v) for k, v in params.items()}


def copy_params(params, device):
    """A copy of ``params`` on ``device`` that shares no storage with them:
    what a trainer or fine-tuner updates in place."""
    dev = resolve_device(device)
    return {k: (v.map(lambda a: a.detach().to(dev, copy=True))
                if isinstance(v, HWParams) else copy.deepcopy(v).to(dev))
            for k, v in params.items()}


def _tensor_from_numpy(a, dev) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the dtype numpy gives JAX's bf16 arrays

        return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):      # the reference's unstacked prefix_layers
        return [_map(v, fn) for v in tree]
    return fn(tree)


# the reference's stacked subtrees, by key: how many leading axes each
# stacks (the transformer's and ssm_lm's ``layers`` and the encoder-decoder's
# ``enc_layers`` and ``dec_layers``: (L, ...); the hybrid's ``mamba``: (G,
# K, ...)); the port keeps one dict per block, in nested lists
_STACKED = {"layers": 1, "enc_layers": 1, "dec_layers": 1, "mamba": 2}


def _unstack(tree, axes, dev):
    if axes == 0:
        return _map(tree, lambda a: _tensor_from_numpy(a, dev))
    n = len(next(iter(_leaves(tree))))
    return [_unstack(_map(tree, lambda a, i=i: a[i]), axes - 1, dev) for i in range(n)]


def _restack(parts, axes):
    if axes == 0:
        return _map(parts, _tensor_to_numpy)
    return _stack([_restack(p, axes - 1) for p in parts])


def lm_params_from_numpy(tree, device=None):
    """The port's LM params from a numpy-leaved JAX LM tree (``lm_init``,
    ``ssm_lm_init``, ``hybrid_init`` or ``encdec_init``), on ``device``:
    ``tree["layers"]``'s stacked leaves (MoE experts too: (L, E, ...)) and
    the encoder-decoder's ``enc_layers`` and ``dec_layers`` become a list of
    one dict per layer, the hybrid's ``mamba`` (G, K, ...) a list of G lists of K;
    ``prefix_layers``, a list of per-layer dicts in both packages, and the
    hybrid's ``shared`` block keep their layout."""
    dev = resolve_device(device)
    return {k: (_unstack(v, _STACKED[k], dev) if k in _STACKED
                else _map(v, lambda a: _tensor_from_numpy(a, dev)))
            for k, v in tree.items()}


def lm_params_to_numpy(params):
    """The JAX-shaped tree of numpy arrays: per-block leaves stacked again on
    (L, ...) or (G, K, ...)."""
    return {k: (_restack(v, _STACKED[k]) if k in _STACKED else _map(v, _tensor_to_numpy))
            for k, v in params.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers]) for k in layers[0]}
    return np.stack(layers)


def _like(params, it):
    """``params``' nest with its tensors replaced, in ``param_leaves``
    order (sorted keys, then list order), by the items of ``it``."""
    if isinstance(params, dict):
        return {k: _like(params[k], it) for k in sorted(params)}
    if isinstance(params, list):
        return [_like(v, it) for v in params]
    return next(it)


def lm_leaves_to_numpy(params, leaves):
    """``leaves`` (gradients or moments, one per ``param_leaves(params)``
    entry) as the reference's stacked tree of numpy arrays."""
    if len(leaves) != len(param_leaves(params)):
        raise ValueError(f"{len(leaves)} leaves for {len(param_leaves(params))} params")
    return lm_params_to_numpy(_like(params, iter(leaves)))


def lm_leaves_from_numpy(tree, device=None):
    """A stacked numpy tree of the reference (its grads or moments) as the
    port's list in ``param_leaves`` order, on ``device``."""
    return [t for _, t in param_leaves(lm_params_from_numpy(tree, device))]


def lm_opt_state_to_numpy(params, opt_state):
    """The port's LM Adam state (``mu``, ``nu`` lists; ``step`` an int) as
    the reference's ``{"mu", "nu", "step"}``: stacked numpy trees and a 0-d
    int32."""
    return {"mu": lm_leaves_to_numpy(params, opt_state["mu"]),
            "nu": lm_leaves_to_numpy(params, opt_state["nu"]),
            "step": np.asarray(opt_state["step"], np.int32)}


def lm_opt_state_from_numpy(tree, device=None):
    """The reference's LM Adam state (numpy leaves) as the port's."""
    return {"mu": lm_leaves_from_numpy(tree["mu"], device),
            "nu": lm_leaves_from_numpy(tree["nu"], device),
            "step": int(np.asarray(tree["step"]))}


class StackedLeaf:
    """The shape and dtype of one stacked leaf, without its data."""

    def __init__(self, shape, dtype: str):
        self.shape, self.dtype = tuple(shape), dtype


def _layout(tree, axes):
    if axes == 0:
        return _map(tree, lambda t: StackedLeaf(t.shape, str(t.dtype).removeprefix("torch.")))
    parts = [_layout(p, axes - 1) for p in tree]

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([i[k] for i in items]) for k in items[0]}
        return StackedLeaf((len(items),) + items[0].shape, items[0].dtype)

    return stack(parts)


def lm_stacked_layout(params):
    """``lm_params_to_numpy(params)``'s tree with a :class:`StackedLeaf` for
    each array: its structure and shapes, nothing copied."""
    return {k: _layout(v, _STACKED.get(k, 0)) for k, v in params.items()}
