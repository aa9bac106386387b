"""Recorders the lints read: the ATen ops a call runs, and its autograd graph.

The port runs eagerly, so there is no program to walk before it runs (the
JAX package walks jaxprs and HLO text, ``repro.analysis.jaxpr_walk`` and
``hlo_text``). Instead a lint runs the real entry point once with these
recorders armed and reads what they saw. Both are armed only inside a
``with`` block and cost nothing outside it:

* :class:`OpRecorder`, a ``TorchDispatchMode``: every ATen op that reaches
  the dispatcher in the block, with its output shapes and dtypes, whether it
  ran in a backward pass, and for a float dtype conversion (``_to_copy``,
  which ``.to``/``.float()`` become, a ``copy_`` across dtypes, or an op
  whose inputs promote to a wider float) its source and destination dtype.
  The autograd engine carries the mode into its worker threads, so a
  backward run inside the block is recorded too.
* :class:`GraphRecorder`: the roots of every backward pass started in the
  block (``torch.autograd.grad``/``backward``, which ``Tensor.backward``
  calls), each walked from ``loss.grad_fn`` through ``next_functions``
  before the pass frees it (:func:`walk_graph`): every node, and the leaf
  tensor of every ``AccumulateGrad``.

What the recorders cannot see: the CUDA kernels K1 to K6 are bound
through ``ctypes`` (:mod:`repro_torch.kernels.build`), so no launch reaches
the dispatcher. On the card the recorder sees the ``empty`` calls that
allocate each kernel's outputs, with their shapes and dtypes, and the casts
and copies around it -- enough for the dtype and shape checks, since every
kernel output is allocated by its wrapper -- but not what a kernel reads or
computes. Which kernel launched is read from the launch counters
(:func:`repro_torch.kernels.ops.launch_counts`) and the shapes each entry
point receives from the launch-shape hook
(:class:`~repro_torch.kernels.shapes.LaunchShapeCounter`). On CPU
tensors the plain versions run as ordinary ATen ops and are recorded.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterator, List, Optional, Tuple

import torch
from torch import nn
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One ATen op as the dispatcher ran it."""

    name: str                                  # e.g. "mm", "_to_copy", "empty"
    shapes: Tuple[Tuple[int, ...], ...]        # of its tensor outputs
    dtypes: Tuple[torch.dtype, ...]
    backward: bool                             # ran inside a backward pass
    convert: Optional[Tuple[torch.dtype, torch.dtype]] = None  # float (src, dst)


def _tensors(value) -> List[torch.Tensor]:
    return [t for t in _pytree.tree_leaves(value) if isinstance(t, torch.Tensor)]


def _conversion(name, args, kwargs, outs) -> Optional[Tuple[torch.dtype, torch.dtype]]:
    """The float (source, destination) dtypes an op converts between."""
    if name == "_to_copy" and outs:
        src, dst = args[0].dtype, outs[0].dtype
    elif name == "copy_" and isinstance(args[1], torch.Tensor):
        src, dst = args[1].dtype, args[0].dtype
    else:
        # implicit promotion: float inputs narrower than a float output
        ins = [t.dtype for t in _tensors((args, kwargs)) if t.dtype.is_floating_point]
        outs_f = [t.dtype for t in outs if t.dtype.is_floating_point]
        if not ins or not outs_f:
            return None
        src = min(ins, key=lambda d: d.itemsize)
        dst = max(outs_f, key=lambda d: d.itemsize)
        return (src, dst) if dst.itemsize > src.itemsize else None
    if src != dst and src.is_floating_point and dst.is_floating_point:
        return src, dst
    return None


class OpRecorder(TorchDispatchMode):
    """Records every ATen op run in its ``with`` block (:class:`OpRecord`)."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self._lock = threading.Lock()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        outs = _tensors(out)
        rec = OpRecord(name, tuple(tuple(t.shape) for t in outs),
                       tuple(t.dtype for t in outs),
                       torch._C._current_graph_task_id() != -1,
                       _conversion(name, args, kwargs, outs))
        with self._lock:          # backward passes run on the engine's threads
            self.ops.append(rec)
        return out

    def backward_ops(self) -> List[OpRecord]:
        return [r for r in self.ops if r.backward]


def walk_graph(root) -> Iterator:
    """Every autograd node reachable from ``root`` (a tensor or a node) through
    ``next_functions``, each once, depth first."""
    node = root.grad_fn if isinstance(root, torch.Tensor) else root
    # the walked nodes are kept, so a node's id stays its own during the walk
    stack, seen = ([node] if node is not None else []), {}
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen[id(node)] = node
        yield node
        stack.extend(nxt for nxt, _ in node.next_functions if nxt is not None)


class GraphRecorder:
    """Walks the graph of every backward pass started in its ``with`` block.

    ``roots`` holds the tensors each pass started from, ``nodes`` the count
    of distinct nodes walked, ``leaves`` the tensor of every
    ``AccumulateGrad`` reached (the leaves a pass forms gradients for).
    """

    def __init__(self):
        self.roots: List[torch.Tensor] = []
        self.leaves: List[torch.Tensor] = []
        self.nodes = 0
        self._saved = None

    def _note(self, outputs) -> None:
        for root in _tensors(outputs):
            self.roots.append(root)
            for node in walk_graph(root):
                self.nodes += 1
                if type(node).__name__ == "AccumulateGrad":
                    self.leaves.append(node.variable)

    def __enter__(self) -> "GraphRecorder":
        grad, backward = self._saved = (torch.autograd.grad, torch.autograd.backward)

        def recorded_grad(outputs, *args, **kwargs):
            self._note(outputs)
            return grad(outputs, *args, **kwargs)

        def recorded_backward(tensors, *args, **kwargs):
            self._note(tensors)
            return backward(tensors, *args, **kwargs)

        torch.autograd.grad, torch.autograd.backward = recorded_grad, recorded_backward
        return self

    def __exit__(self, *exc) -> None:
        torch.autograd.grad, torch.autograd.backward = self._saved


class Trace:
    """Both recorders over one block: ``with Trace() as t: ...``, then
    ``t.ops`` (:class:`OpRecorder`) and ``t.graph`` (:class:`GraphRecorder`);
    ``outputs`` is free for what the traced call returned."""

    def __init__(self):
        self.ops, self.graph = OpRecorder(), GraphRecorder()
        self.outputs = None

    def __enter__(self) -> "Trace":
        self.graph.__enter__()
        self.ops.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        try:
            self.ops.__exit__(*exc)
        finally:
            self.graph.__exit__(*exc)


def tree_leaves(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, object]]:
    """``(path, leaf)`` of a state tree of the port, in ``jax.tree_util``'s
    order: dicts by sorted key, lists and tuples by index, ``nn.Module``
    parameters by name (``ModuleList`` by index), dataclass fields in order
    (``None`` fields are no leaves, as in JAX); anything else -- a tensor,
    or a host scalar such as Adam's step count -- is a leaf."""
    if isinstance(tree, dict):
        for key in sorted(tree, key=str):
            yield from tree_leaves(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple, nn.ModuleList)):
        for i, sub in enumerate(tree):
            yield from tree_leaves(sub, path + (i,))
    elif isinstance(tree, nn.Module):
        for name, p in sorted(tree.named_parameters(recurse=False)):
            yield path + (name,), p
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            value = getattr(tree, f.name)
            if value is not None:
                yield from tree_leaves(value, path + (f.name,))
    elif tree is not None:
        yield path, tree
