"""The rank-local training plan: FSDP on ``data``, tensor and expert
parallelism on ``model``.

The reference trains on a ``(n // mp, mp)`` mesh with the params, both Adam
moments and the fp32 masters laid out by ``param_shardings(mesh, ...,
"train")`` and the batch on ``data``; XLA inserts the collectives. Here a
:class:`TrainPlan` does it by hand, leaf by leaf over the port's per-layer
params:

* **Storage.** A leaf is cut on ``model`` as the serving plan cuts it
  (:func:`repro_torch.sharding.tp.model_cuts`: heads, hidden units, the
  vocabulary), except the MoE experts, which go on ``model`` whole (expert
  parallelism, the spec's train mode), and then on ``data`` along the dim
  that :func:`repro_torch.sharding.specs.param_spec` (mode ``"train"``)
  puts on ``dp``, after its divisibility guard: an even block a rank. The
  fp32 master, ``mu`` and ``nu`` of a leaf are cut alike, so a rank holds
  what ``launch/dryrun.py`` reckons for the mesh, but where the plan
  differs from the spec on ``model`` on purpose (:data:`DIFFERS_FROM_SPEC`).
  Any other difference raises: nothing falls back to a whole leaf.
* **Compute.** Before a microbatch each leaf is cast for compute (the
  one-device step's rule, :func:`repro_torch.launch.steps.cast_params_for_compute`)
  and then all-gathered on ``data``, so the gathers move bf16
  (:class:`_CastGather`); the model runs at the rank's heads, hidden and
  experts under a training context (:mod:`repro_torch.sharding.ctx`), its
  ``model`` collectives right under autograd (:mod:`repro_torch.models.layers`).
* **Gradients.** The gather's backward reduce-scatters the leaf's fp32
  gradient on ``data`` back to the rank's shard, a microbatch at a time; a
  leaf whole on ``data`` is all-reduced there once a step. A leaf whole on
  ``model`` gets its whole gradient on every rank (``to_model``), a leaf cut
  there its block's.
* **Clip and Adam.** The global norm sums the squares of the local shards
  over ``model`` (the leaves cut there) and over ``data`` (the leaves cut
  there); a leaf whole on an axis counts once (:meth:`TrainPlan.sq_reduce`).
  Adam is element-wise and runs on the shards.

:meth:`TrainPlan.shard` and :meth:`TrainPlan.gather` move a tree between
one device's layout and a rank's (the gather exact: float32 all-reduces of
zero-filled buffers); the checkpointer writes the gathered, whole leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.sharding import specs, tp

# leaves whose layout on ``model`` differs from the spec's on purpose, by
# name: what the spec cuts and the plan keeps whole (and computes whole)
DIFFERS_FROM_SPEC = {
    "w_concat": "zamba2's shared-block input projection (2d, d): the spec puts d on "
                "model; the plan keeps it whole and every rank computes it, as serving does",
}

# the reference's stacked rank of a per-layer leaf (``convert._STACKED``)
_STACKED = {"layers": 1, "enc_layers": 1, "dec_layers": 1, "mamba": 2}


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """One leaf: its one-device ``shape``, the spec's entries
    (``spec``), its cut on ``model`` (``(dim, lo, hi)`` or None) and the dim
    cut on ``data`` (or None), and whether compute casts it."""

    path: Tuple
    shape: Tuple[int, ...]
    spec: Tuple
    model: Optional[Tuple[int, int, int]]
    data: Optional[int]
    cast: bool

    @property
    def model_shape(self) -> Tuple[int, ...]:
        """The shape after the ``model`` cut (before the ``data`` one)."""
        shape = list(self.shape)
        if self.model is not None:
            dim, lo, hi = self.model
            shape[dim] = hi - lo
        return tuple(shape)


def _leaf_paths(tree, path=()):
    """``[(path, leaf)]`` in ``param_leaves``' order (sorted keys, then
    list order)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaf_paths(tree[k], path + (k,))
        return out
    if isinstance(tree, list):
        out = []
        for i, v in enumerate(tree):
            out += _leaf_paths(v, path + (i,))
        return out
    return [(path, tree)]


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_map(fn, tree):
    """``fn`` over every leaf of a nest of dicts and lists."""
    return _map(lambda _, t: fn(t), tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class _CastGather(torch.autograd.Function):
    """A master shard cast for compute, then gathered on ``data`` along
    ``dim`` (None: whole on ``data``, the cast alone). Backward: the
    gradient in float32, reduce-scattered on ``data`` back to the shard
    (whole on ``data``: as it is; the step all-reduces it once)."""

    @staticmethod
    def forward(ctx, master, dtype, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        c = master.to(dtype) if master.dtype != dtype else master
        if dim is None:
            return c.view_as(c) if c is master else c
        return axis.all_gather(c, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.float()
        if ctx.dim is not None:
            g = ctx.axis.reduce_scatter(g, ctx.dim)
        return g, None, None, None


class TrainPlan:
    """The training layout of ``cfg``'s params on a host ``mesh``
    (``("data", "model")``): one :class:`LeafPlan` per leaf of ``params``
    (one device's params or the ``meta`` device's shapes of them), in
    ``param_leaves`` order. Raises ``NotImplementedError`` where a layout
    cannot be cut: heads, hidden units or experts the ``model`` axis does
    not divide, a kv head shared by ranks, or a layout of the plan that
    differs from the spec but for :data:`DIFFERS_FROM_SPEC`."""

    def __init__(self, cfg, mesh, params):
        self.cfg, self.mesh = cfg, mesh
        self.model_axis, self.data_axis = mesh.axis("model"), mesh.axis("data")
        cuts = tp.model_cuts(cfg, params, self.model_axis, experts="ep", train=True)
        axes = specs.axes_for(mesh)
        self.leaves: List[LeafPlan] = []
        for path, leaf in _leaf_paths(params):
            names = tuple(specs.path_part(k) for k in path)
            spec = specs.param_spec(names, leaf, axes, mesh=mesh, mode="train")
            model = _at(cuts, path)
            spec_model = next((i for i, a in enumerate(spec) if a == axes["tp"]), None)
            plan_model = None if model is None else model[0]
            if self.model_axis.size > 1 and plan_model != spec_model and not (
                    plan_model is None and names[-1] in DIFFERS_FROM_SPEC):
                raise NotImplementedError(
                    f"the training plan cuts {'/'.join(names)} {tuple(leaf.shape)} on model "
                    f"along dim {plan_model}, the spec {spec} along {spec_model}")
            data = next((i for i, a in enumerate(spec) if a == axes["dp"]), None)
            if data is not None and self.data_axis.size == 1:
                data = None
            # the masters are float32: every float leaf of stacked rank >= 2
            cast = leaf.is_floating_point() and leaf.dim() + _STACKED.get(path[0], 0) >= 2
            self.leaves.append(LeafPlan(path, tuple(leaf.shape), spec, model, data, cast))
        self._by_path = {lp.path: lp for lp in self.leaves}

    # -- layouts ---------------------------------------------------------------

    def leaf(self, path) -> LeafPlan:
        return self._by_path[tuple(path)]

    def _local(self, lp: LeafPlan, full: torch.Tensor) -> torch.Tensor:
        t = tp.cut(full, lp.model)
        if lp.data is not None:
            t = t.narrow(lp.data, *self.data_block(lp))
        return t.clone(memory_format=torch.contiguous_format)

    def data_block(self, lp: LeafPlan) -> Tuple[int, int]:
        """(start, length) of this rank's block of the ``data`` dim."""
        n = lp.model_shape[lp.data] // self.data_axis.size
        return self.data_axis.index * n, n

    def shard(self, params):
        """One device's ``params`` (any tree of this plan's leaves: params,
        gradients, moments as a params tree) as this rank's shards, new
        tensors."""
        return _map(lambda path, t: self._local(self.leaf(path), t), params)

    def shard_list(self, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        """A ``param_leaves``-ordered list (Adam's ``mu`` or ``nu``) sharded."""
        return [self._local(lp, t) for lp, t in zip(self.leaves, leaves, strict=True)]

    def local_bytes(self, local) -> int:
        return sum(t.numel() * t.element_size() for _, t in _leaf_paths(local))

    def _gather_leaf(self, lp: LeafPlan, t: torch.Tensor) -> torch.Tensor:
        model, data = self.model_axis, self.data_axis
        owner = (lp.model is not None or model.index == 0) and (
            lp.data is not None or data.index == 0)
        buf = torch.zeros(lp.shape, dtype=torch.float32, device=t.device)
        if owner:
            index = [slice(None)] * len(lp.shape)
            if lp.model is not None:
                index[lp.model[0]] = slice(lp.model[1], lp.model[2])
            if lp.data is not None:
                lo, n = self.data_block(lp)
                index[lp.data] = slice(lo, lo + n)
            buf[tuple(index)] = t.float()
        if model.size > 1:
            model.all_reduce(buf)
        if data.size > 1:
            data.all_reduce(buf)
        return buf.to(t.dtype)

    def gather(self, local):
        """This rank's shards (a params tree) back in one device's layout, on
        every rank: exact float32 all-reduces of zero-filled buffers."""
        return _map(lambda path, t: self._gather_leaf(self.leaf(path), t), local)

    def gather_list(self, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        return [self._gather_leaf(lp, t) for lp, t in zip(self.leaves, leaves, strict=True)]

    # -- the step's parts -------------------------------------------------------

    def compute_params(self, masters, dtype):
        """The compute params of a microbatch: each master shard cast for
        compute (``cast``) and all-gathered on ``data``, in the autograd
        graph (:class:`_CastGather`)."""
        def one(path, t):
            lp = self.leaf(path)
            return _CastGather.apply(t, dtype if lp.cast else t.dtype, self.data_axis, lp.data)
        return _map(one, masters)

    def reduce_whole_on_data(self, grads: List[torch.Tensor]) -> None:
        """Sum the gradients of the leaves whole on ``data`` over it, in place
        (those cut there were reduce-scattered by the gathers' backward)."""
        if self.data_axis.size == 1:
            return
        for lp, g in zip(self.leaves, grads, strict=True):
            if lp.data is None:
                self.data_axis.all_reduce(g)

    def sq_reduce(self, sq: List[torch.Tensor]) -> torch.Tensor:
        """The global sum of squares from each leaf's local one: the leaves
        cut on ``model`` summed over it, then those cut on ``data`` over
        that; a leaf whole on an axis counted once (one all-reduce on each
        axis of more than one rank)."""
        zero = torch.zeros((), dtype=torch.float32, device=sq[0].device)
        by = {(m, d): zero.clone() for m in (True, False) for d in (True, False)}
        for lp, s in zip(self.leaves, sq, strict=True):
            by[lp.model is not None, lp.data is not None] += s
        if self.model_axis.size > 1:
            cut_m = self.model_axis.all_reduce(torch.stack([by[True, True], by[True, False]]))
            by[True, True], by[True, False] = cut_m[0], cut_m[1]
        on_data = by[True, True] + by[False, True]
        if self.data_axis.size > 1:
            on_data = self.data_axis.all_reduce(on_data)
        return on_data + by[True, False] + by[False, False]

    def rows(self, n: int) -> slice:
        """This rank's rows of a microbatch of ``n`` on ``data``."""
        if n % self.data_axis.size:
            raise NotImplementedError(
                f"a microbatch of {n} rows over {self.data_axis.size} data ranks: the "
                "training plan splits each microbatch evenly")
        return self.data_axis.block(n)

    def differs_from_spec(self) -> Dict[str, Tuple]:
        """``{path: (spec, plan's local shape)}`` of the leaves kept whole on
        ``model`` where the spec cuts them (:data:`DIFFERS_FROM_SPEC`)."""
        out = {}
        for lp in self.leaves:
            if lp.model is None and self.model_axis.size > 1 and "model" in lp.spec:
                out["/".join(specs.path_part(k) for k in lp.path)] = (lp.spec, lp.model_shape)
        return out


# -- the collectives a step makes ------------------------------------------------


def _attention_sites(cfg) -> int:
    """``to_model`` calls of one attention under a gradient: the q, k, v
    input; MLA's latents and shared RoPE key; each bias cut at use; the
    QK-norm scales."""
    if cfg.use_mla:
        return 3
    return 1 + (3 if cfg.qkv_bias else 0) + (2 if cfg.qk_norm else 0)


def backward_reduces(cfg, model_size: int) -> int:
    """The all-reduces on ``model`` of one loss's backward: one a
    ``to_model`` call (:func:`repro_torch.models.layers.to_model`). A
    transformer layer: its attention's (:func:`_attention_sites`) and one
    for a SwiGLU MLP, two for a MoE layer (its input and combine weights);
    a hybrid's shared-block application the same; none in a Mamba2 block; an
    encoder layer one for its attention and two for its GELU MLP (input and
    hidden bias), a decoder layer its self-attention's, four for its
    cross-attention (input, ``memory``, the q and v biases) and two for its
    MLP; and one for the logits' input where the vocabulary is cut."""
    attn = _attention_sites(cfg)
    if cfg.family == "ssm":
        layers = 0
    elif cfg.family == "hybrid":
        layers = (attn + 1) * (cfg.n_layers // cfg.attn_every)
    elif cfg.family == "encdec":
        layers = 3 * (cfg.n_enc_layers or cfg.n_layers) + (attn + 4 + 2) * cfg.n_layers
    else:
        prefix = cfg.first_dense_layers if cfg.family == "moe" else 0
        moe = cfg.n_layers - prefix if cfg.family == "moe" else 0
        layers = attn * cfg.n_layers + (cfg.n_layers - moe) + 2 * moe
    return layers + (0 if cfg.vocab_size % model_size else 1)


def step_collectives(cfg, plan: TrainPlan, n_micro: int, *, clip: bool = True
                     ) -> Dict[str, Dict[str, int]]:
    """The collectives of one sharded train step with remat off
    (:func:`repro_torch.launch.steps.make_sharded_train_step`), ``{axis:
    {op: n}}``. On ``data``: each microbatch one all-gather (forward) and one
    reduce-scatter (backward) a leaf cut there, an all-reduce a MoE layer
    (the aux loss's expert counts) and a vlm's one (the loss mask's count);
    a step, one all-reduce a leaf whole there (its gradient), one for the
    loss and one for the clip norm. On ``model``: each microbatch the
    forward's all-reduces (:func:`repro_torch.sharding.tp.collectives_per_call`
    of a prefill) and the backward's (:func:`backward_reduces`); a step one
    for the clip norm. Under remat a layer's recompute repeats its forward
    all-reduces. The train launcher adds one all-reduce on each axis a step
    (the stop flags)."""
    out: Dict[str, Dict[str, int]] = {}
    model, data = plan.model_axis.size, plan.data_axis.size
    if data > 1:
        cut = sum(lp.data is not None for lp in plan.leaves)
        moe = (cfg.n_layers - cfg.first_dense_layers) if cfg.family == "moe" else 0
        per_micro = moe + (1 if cfg.family == "vlm" else 0)
        out["data"] = {"all_gather": n_micro * cut, "reduce_scatter": n_micro * cut,
                       "all_reduce": len(plan.leaves) - cut + 1 + int(clip)
                       + n_micro * per_micro}
    if model > 1:
        out["model"] = {"all_reduce": n_micro * (
            tp.collectives_per_call(cfg, model, prefill=True) + backward_reduces(cfg, model))
            + int(clip)}
    return out
