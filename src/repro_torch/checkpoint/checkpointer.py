"""Atomic checkpoints in the JAX package's on-disk format.

PyTorch port of ``repro.checkpoint.checkpointer``, byte for byte the same
layout, so that a checkpoint written by either package restores in the
other:

* **Atomicity**: each checkpoint is written to ``step_<n>.tmp-<nonce>/`` and
  ``os.replace``d into ``step_<n>/`` only after every leaf and the manifest
  are fsynced. A crash mid-write never corrupts the latest checkpoint.
* **Leaves**: raw bytes, ``leaf_<i>.bin``, in the JAX tree's flatten order;
  with ``save(shard_rows=...)`` the per-series table leaves (any leaf under
  an ``"hw"`` or ``"t_hw"`` key) are split by rows into
  ``leaf_<i>.shard_<j>.bin``.
* **Manifest**: ``manifest.json`` with ``step``, ``metric``, ``treedef`` and
  each leaf's ``index``/``shape``/``dtype``. ``treedef`` is the text
  ``str(jax.tree_util.tree_structure(tree))`` gives for the same state in
  the JAX package; :func:`treedef_token` renders the port's objects in that
  text without importing JAX.
* **Retention**: the ``keep`` newest checkpoints are kept, and the best by
  validation metric (``best.json``) is never deleted.

A state is a nest of dicts, lists, tuples, ``None`` and leaves, where the
port's own objects stand for the JAX trees they mirror:

* ``HWParams`` is JAX's ``CustomNode(HWParams[()], [...])`` of its five
  fields, ``None`` for an absent one;
* an ``nn.ModuleList`` is a list, and any other module (``LSTMCell``,
  ``Readout``, ``Attention``) the dict of its own parameters;
* the trainer's ``(params, opt_state)``: the optimizer's ``mu`` and ``nu``
  are lists in ``param_leaves`` order of the trainable params, and render
  as that tree, as JAX's moments are: where the head freezes groups (the
  esn reservoir, ``"rnn"``), the moments cover the rest only (the JAX
  trainer's ``adam_init(split_frozen(params, frozen)[0])``), and the
  :class:`Checkpointer` is told the frozen groups; ``step`` is a Python
  int, stored as a 0-d int32 and read back as an int;
* a fit with gradient compression, ``(params, (opt_state, residuals))``:
  the residuals are a list in ``param_leaves`` order of the trainable
  shared weights and render as that tree (the reference's
  ``init_error_state`` of the trainable groups without ``hw``).

Over a series mesh (``Checkpointer(..., mesh=)``) every rank holds the same
replicated state: rank 0 alone writes, and every rank waits at a barrier
until the checkpoint is published; every rank restores.

Leaves are float32 or int32 tensors (under ``precision="bf16"`` too: the
master weights and moments stay float32). Any other dtype is refused.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import uuid
from typing import Any, Callable, FrozenSet, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.esrnn import param_leaves
from repro_torch.core.holt_winters import HWParams

__all__ = ["Checkpointer", "treedef_token", "flatten_with_path", "is_table_path"]

_DTYPES = (torch.float32, torch.int32)
_NP_DTYPES = {"float32": torch.float32, "int32": torch.int32}
_HW_FIELDS = tuple(f.name for f in dataclasses.fields(HWParams))


class _Step:
    """The optimizer's update count: a Python int, stored as a 0-d int32."""

    def __init__(self, value: int):
        self.value = int(value)


class _Moments:
    """A ``mu`` or ``nu`` list, shaped as the params tree it belongs to."""

    def __init__(self, tree):
        self.tree = tree


def _is_opt_state(obj) -> bool:
    return isinstance(obj, dict) and isinstance(obj.get("mu"), list)


def _shaped_like(params, leaves: List[torch.Tensor], frozen: FrozenSet[str]):
    """The trainable params tree (``params`` without the ``frozen`` groups)
    with ``leaves`` (its ``param_leaves`` order) in its place."""
    params = {k: v for k, v in params.items() if k not in frozen}
    want = len(param_leaves(params))
    if len(leaves) != want:
        raise ValueError(f"optimizer moments have {len(leaves)} leaves, the trainable "
                         f"params {want} (frozen groups {sorted(frozen)})")
    it = iter(leaves)

    def shape(obj):
        if isinstance(obj, HWParams):
            return HWParams(**{f: None if getattr(obj, f) is None else next(it)
                               for f in _HW_FIELDS})
        if isinstance(obj, nn.ModuleList):
            return [shape(m) for m in obj]
        if isinstance(obj, nn.Module):
            return {name: next(it) for name, _ in sorted(obj.named_parameters(recurse=False))}
        if isinstance(obj, dict):
            return {k: shape(obj[k]) for k in sorted(obj)}
        raise TypeError(f"not a params node: {type(obj).__name__}")

    return shape(params)


def _canonical(state, frozen: FrozenSet[str] = frozenset()):
    """A ``(params, opt_state)`` pair with the optimizer's moment lists
    shaped as its trainable params and its step count marked, and a
    ``(params, (opt_state, residuals))`` pair with the residuals shaped as
    the trainable shared weights too; any other state as is."""
    if not (isinstance(state, tuple) and len(state) == 2):
        return state
    params, opt = state

    def adam(opt):
        return dict(opt, mu=_Moments(_shaped_like(params, opt["mu"], frozen)),
                    nu=_Moments(_shaped_like(params, opt["nu"], frozen)),
                    step=_Step(opt["step"]))

    if _is_opt_state(opt):
        return (params, adam(opt))
    if (isinstance(opt, tuple) and len(opt) == 2 and _is_opt_state(opt[0])
            and isinstance(opt[1], list)):
        shared = {k: v for k, v in params.items() if k != "hw"}
        return (params, (adam(opt[0]), _Moments(_shaped_like(shared, opt[1], frozen))))
    return state


def _children(obj) -> Optional[List[Tuple[Any, Any]]]:
    """``[(key, child), ...]`` of an inner node in JAX's order; None for a leaf."""
    if isinstance(obj, _Moments):
        obj = obj.tree
    if isinstance(obj, HWParams):
        return [(f, getattr(obj, f)) for f in _HW_FIELDS]
    if isinstance(obj, (list, tuple, nn.ModuleList)):
        return list(enumerate(obj))
    if isinstance(obj, nn.Module):
        return sorted(obj.named_parameters(recurse=False))
    if isinstance(obj, dict):
        return [(k, obj[k]) for k in sorted(obj)]
    return None


def _render(obj) -> str:
    if obj is None:
        return "None"
    if isinstance(obj, _Moments):
        return _render(obj.tree)
    kids = _children(obj)
    if kids is None:
        return "*"
    inner = ", ".join(_render(v) for _, v in kids)
    if isinstance(obj, HWParams):
        return f"CustomNode(HWParams[()], [{inner}])"
    if isinstance(obj, tuple):
        return f"({inner},)" if len(kids) == 1 else f"({inner})"
    if isinstance(obj, (list, nn.ModuleList)):
        return f"[{inner}]"
    return "{" + ", ".join(f"{k!r}: {_render(v)}" for k, v in kids) + "}"


def treedef_token(state, frozen: FrozenSet[str] = frozenset()) -> str:
    """``str(jax.tree_util.tree_structure(state))`` of the JAX counterpart;
    ``frozen``: the param groups a ``(params, opt_state)`` state's moments
    leave out."""
    return f"PyTreeDef({_render(_canonical(state, frozen))})"


def _leaves(obj, path: Tuple) -> Iterator[Tuple[Tuple, Any]]:
    if obj is None:
        return
    kids = _children(obj)
    if kids is None:
        yield path, obj
        return
    for k, v in kids:
        yield from _leaves(v, path + (k,))


def flatten_with_path(state, frozen: FrozenSet[str] = frozenset()) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf), ...]`` in the JAX tree's flatten order; a path is a
    tuple of dict keys, field names and list indices. ``frozen`` as in
    :func:`treedef_token`."""
    return list(_leaves(_canonical(state, frozen), ()))


def _to_numpy(leaf, index: int) -> np.ndarray:
    if isinstance(leaf, _Step):
        return np.asarray(leaf.value, np.int32)
    if not isinstance(leaf, torch.Tensor):
        raise TypeError(f"leaf {index}: cannot checkpoint a {type(leaf).__name__}")
    if leaf.dtype not in _DTYPES:
        raise TypeError(f"leaf {index}: dtype {leaf.dtype} is not checkpointed "
                        f"(float32 and int32 only)")
    return leaf.detach().cpu().contiguous().numpy()


def is_table_path(path) -> bool:
    """True for leaves of the per-series state: HW rows, moments, clocks."""
    return any(k in ("hw", "t_hw") for k in path)


def _unflatten(obj, it: Iterator):
    """``obj``'s structure with its leaves taken from ``it`` in order."""
    if obj is None:
        return None
    if isinstance(obj, _Step):
        return int(next(it))
    if isinstance(obj, _Moments):
        return [t for _, t in _leaves(_unflatten(obj.tree, it), ())]
    if isinstance(obj, HWParams):
        return HWParams(**{f: _unflatten(getattr(obj, f), it) for f in _HW_FIELDS})
    if isinstance(obj, nn.ModuleList):
        return nn.ModuleList(_unflatten(m, it) for m in obj)
    if isinstance(obj, nn.Module):
        names = [name for name, _ in sorted(obj.named_parameters(recurse=False))]
        values = {name: next(it) for name in names}
        # a shallow copy, so no parameter of the template is copied or shared
        mod = copy.copy(obj)
        mod._parameters = dict(obj._parameters)
        for name in names:
            mod._parameters[name] = nn.Parameter(values[name])
        return mod
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unflatten(v, it) for v in obj)
    if isinstance(obj, dict):
        return {k: _unflatten(obj[k], it) for k in sorted(obj)}
    return next(it)


class Checkpointer:
    """``frozen``: the param groups the moments of a saved or restored
    ``(params, opt_state)`` leave out (the trainer passes its head's).
    ``mesh``: the series mesh of a data-parallel run; rank 0 writes."""

    def __init__(self, directory: str, *, keep: int = 3,
                 frozen: FrozenSet[str] = frozenset(), mesh=None):
        self.directory = directory
        self.keep = keep
        self.frozen = frozenset(frozen)
        self.mesh = mesh
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, *, metric: Optional[float] = None,
             shard_rows: Optional[int] = None) -> str:
        """Write one atomic checkpoint; returns the published directory.

        ``shard_rows``: when set, every per-series table leaf with more rows
        is split along its leading axis into ``leaf_<i>.shard_<j>.bin`` files
        of ``shard_rows`` rows each, the grid recorded in the manifest.
        Shared-weight leaves are never sharded; the treedef is the same
        either way, so both layouts restore into the same template. Over a
        mesh rank 0 writes and every rank returns after the barrier that
        follows the publish.
        """
        final = os.path.join(self.directory, f"step_{step}")
        if self.mesh is None or self.mesh.rank == 0:
            self._write(step, state, metric, shard_rows)
        if self.mesh is not None:
            self.mesh.barrier()
        return final

    def _write(self, step: int, state: Any, metric: Optional[float],
               shard_rows: Optional[int]) -> None:
        flat = flatten_with_path(state, self.frozen)
        tmp = os.path.join(self.directory, f"step_{step}.tmp-{uuid.uuid4().hex[:8]}")
        final = os.path.join(self.directory, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {
            "step": step,
            "metric": metric,
            "treedef": treedef_token(state, self.frozen),
            "leaves": [],
        }

        def _write(path, payload):
            with open(path, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())

        for i, (tpath, leaf) in enumerate(flat):
            arr = _to_numpy(leaf, i)
            entry = {"index": i, "shape": list(arr.shape), "dtype": str(arr.dtype)}
            if (shard_rows and is_table_path(tpath) and arr.ndim
                    and arr.shape[0] > shard_rows):
                n = arr.shape[0]
                bounds = [(lo, min(lo + shard_rows, n))
                          for lo in range(0, n, shard_rows)]
                for j, (lo, hi) in enumerate(bounds):
                    _write(os.path.join(tmp, f"leaf_{i}.shard_{j}.bin"),
                           np.ascontiguousarray(arr[lo:hi]).tobytes())
                entry["shard_rows"] = int(shard_rows)
                entry["n_shards"] = len(bounds)
            else:
                _write(os.path.join(tmp, f"leaf_{i}.bin"), arr.tobytes())
            manifest["leaves"].append(entry)
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        self._update_best(step, metric)
        self._gc()

    def _update_best(self, step: int, metric: Optional[float]):
        if metric is None:
            return
        best_file = os.path.join(self.directory, "best.json")
        best = None
        if os.path.exists(best_file):
            with open(best_file) as f:
                best = json.load(f)
        if best is None or metric < best["metric"]:
            with open(best_file, "w") as f:
                json.dump({"step": step, "metric": metric}, f)

    def _gc(self):
        steps = sorted(self.all_steps())
        best = self.best_step()
        for s in steps[: -self.keep] if len(steps) > self.keep else []:
            if s == best:
                continue
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and ".tmp" not in name:
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        best_file = os.path.join(self.directory, "best.json")
        if not os.path.exists(best_file):
            return None
        with open(best_file) as f:
            return json.load(f)["step"]

    def restore(
        self,
        template: Any,
        *,
        step: Optional[int] = None,
        shardings=None,
        host_paths: Optional[Callable[[Tuple], bool]] = None,
    ) -> Tuple[int, Any]:
        """Restore into the structure of ``template``: ``(step, state)``.

        Each tensor leaf lands on its template leaf's device as a new,
        writable tensor (the template is not touched); the step count comes
        back as an int. ``shardings``, a series mesh, places the leaves for
        it instead, as the reference's does: every leaf on the rank's device
        (the port's replicated layout, whatever mesh wrote the checkpoint).
        ``host_paths``: an optional predicate over leaf paths
        (:func:`flatten_with_path`, e.g. :func:`is_table_path`); the leaves
        it accepts come back as writable numpy arrays that own their memory
        instead (a table pins copies of them). Row-sharded table leaves are
        reassembled, so either save layout restores.
        """
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["treedef"] != treedef_token(template, self.frozen):
            raise ValueError("checkpoint tree structure mismatch")
        flat = flatten_with_path(template, self.frozen)
        leaves = []
        for i, (tpath, tl) in enumerate(flat):
            spec = manifest["leaves"][i]
            if spec["dtype"] not in _NP_DTYPES:
                raise TypeError(f"leaf {i}: stored dtype {spec['dtype']} is not "
                                f"supported (float32 and int32 only)")
            dtype = np.dtype(spec["dtype"])
            shape = tuple(spec["shape"])
            if spec.get("n_shards"):
                arr = np.empty(shape, dtype)
                lo = 0
                for j in range(spec["n_shards"]):
                    with open(os.path.join(d, f"leaf_{i}.shard_{j}.bin"), "rb") as f:
                        part = np.frombuffer(f.read(), dtype=dtype)
                    rows = min(spec["shard_rows"], shape[0] - lo)
                    arr[lo:lo + rows] = part.reshape((rows,) + shape[1:])
                    lo += rows
            else:
                with open(os.path.join(d, f"leaf_{i}.bin"), "rb") as f:
                    # frombuffer is read-only; the trainer updates in place
                    arr = np.frombuffer(f.read(), dtype=dtype).reshape(shape).copy()
            expect = tuple(tl.shape) if isinstance(tl, torch.Tensor) else ()
            if tuple(arr.shape) != expect:
                raise ValueError(f"leaf {i}: saved {arr.shape} != expected {expect}")
            if isinstance(tl, _Step):
                leaves.append(int(arr))
            elif host_paths is not None and host_paths(tpath):
                leaves.append(arr)
            else:
                if tl.dtype != _NP_DTYPES[spec["dtype"]]:
                    raise TypeError(f"leaf {i}: stored {spec['dtype']}, template "
                                    f"{tl.dtype}")
                leaves.append(torch.from_numpy(arr).to(
                    tl.device if shardings is None else shardings.device))
        return step, _unflatten(_canonical(template, self.frozen), iter(leaves))
