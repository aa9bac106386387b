"""Activation-sharding context: lets model code find the tensor-parallel
axis and place logical constraints ("dp", "tp", None) without knowing the
mesh.

The port of the JAX package's ``sharding/ctx.py``. The launcher installs a
context mapping the logical axes to mesh axes (``dp`` -> ``("pod",
"data")`` on the multi-pod mesh); code outside any context runs the
single-device path, bit for bit as without this module.

In the port the context carries the LM mesh itself. On a host mesh
(:class:`repro_torch.launch.mesh.HostMesh`) :func:`model_axis` gives model
code this rank's ``model`` axis: its index, its size and its counted
collectives, so a layer reduces its partial sums over its tensor-parallel
group without a new argument, and a training context (``train=True``)
gives the loss its ``data`` axis (:func:`loss_axis`). :func:`constrain`
returns its input: an eager rank-local tensor already has its layout,
where the reference's ``with_sharding_constraint`` asks XLA for one.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple, Union

_state = threading.local()

Dim = Union[None, str, Tuple[str, ...]]


@contextlib.contextmanager
def activation_sharding(mesh, *, dp, tp, train: bool = False):
    """dp/tp: mesh axis name or tuple of names for the logical axes.
    ``train``: a training context, whose loss rows are split on ``dp``
    (:func:`loss_axis`)."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = {"mesh": mesh, "dp": dp, "tp": tp, "train": train}
    try:
        yield
    finally:
        _state.ctx = prev


def current():
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def restored(saved):
    """The context ``saved`` (a :func:`current` value, None for none) in
    force: a recompute in the backward runs on the autograd engine's thread,
    where this thread's context is not set."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = saved
    try:
        yield
    finally:
        _state.ctx = prev


def logical_to_spec(dims: Sequence[Dim]) -> Optional[tuple]:
    """The mesh axes of logical ``dims`` under the current context, one
    entry per dim (a name, a tuple of names or None), as a tuple; None
    outside a context."""
    ctx = current()
    if ctx is None:
        return None
    out = []
    for d in dims:
        if d is None:
            out.append(None)
        elif isinstance(d, tuple):
            axes = []
            for name in d:
                ax = ctx.get(name, name)
                if ax is None:
                    continue
                axes.extend(ax if isinstance(ax, tuple) else (ax,))
            # a one-name tuple is that name, as a PartitionSpec normalizes it
            out.append(None if not axes else axes[0] if len(axes) == 1 else tuple(axes))
        else:
            out.append(ctx.get(d, d))
    return tuple(out)


def constrain(x, *dims: Dim):
    """The reference's ``with_sharding_constraint`` with logical dims: the
    identity here, in a context or out of one (a rank's tensor is its
    share already)."""
    return x


def model_axis():
    """This rank's tensor-parallel axis (``tp``) of the current context's
    host mesh when it spans more than one rank, else None: outside a
    context, on an abstract mesh (the dry-run's) and on a mesh whose
    ``model`` axis has one rank, model code runs the single-device path."""
    ctx = current()
    if ctx is None or not hasattr(ctx["mesh"], "axis"):
        return None
    axis = ctx["mesh"].axis(ctx["tp"])
    return axis if axis.size > 1 else None


def loss_axis():
    """This rank's ``data`` axis (``dp``) of a training context on a host
    mesh whose ``data`` axis spans more than one rank, else None: each
    rank's loss is then its rows' share of the global batch's, the ranks'
    shares summing to it (:func:`repro_torch.models.layers.cross_entropy_loss`,
    :func:`repro_torch.models.moe.moe_aux`)."""
    ctx = current()
    if ctx is None or not ctx.get("train") or not hasattr(ctx["mesh"], "axis"):
        return None
    axis = ctx["mesh"].axis(ctx["dp"])
    return axis if axis.size > 1 else None
