"""Gradient-leak lint: frozen param groups take no gradient and no update.

The esn head's claim is that its reservoir (the ``"rnn"`` group) never
trains: ``repro_torch.train.engine`` passes a head's frozen groups with no
gradient requirement (``engine._fixed``), so autograd builds no graph to
them and, on the card, the reservoir's backward takes K5's dx-only launch
and forms no weight gradient. The JAX package proves its counterpart on the
traced step jaxpr (``repro.analysis.gradleak``); the port's step runs
eagerly and updates in place, so this lint runs one real step with the
recorders of :mod:`repro_torch.analysis.trace` armed and checks:

1. **pass-through** -- every frozen parameter is the same tensor object
   after the step, with the same ``data_ptr()``, an unchanged ``_version``
   (no in-place write) and the same bits;
2. **no moments** -- the optimizer state carries no moment laid out over a
   frozen group (the port's moments are lists in
   :func:`~repro_torch.core.esrnn.param_leaves` order of the tree they were
   made for);
3. **no gradient** -- the autograd walk of the step's loss reaches no
   ``AccumulateGrad`` of a frozen parameter, and no op recorded in the
   backward produces a float tensor shaped like a frozen weight. On the
   card K5's outputs are allocated by its wrapper, so a full K5 launch for
   frozen weights shows as the ``empty`` of its weight gradients.

Check 3's second half identifies a gradient by its shape, so the probe
batch must not make an activation look like a weight:
:func:`probe_batch_size` picks one, and the lint reports a finding when
frozen and trainable leaves share a shape.

On the card :func:`launch_findings` adds the launch check: a step with the
LSTM stack frozen launches K5's dx-only kernel once per cell step and the
full K5 never; one that trains it, the full K5 once per cell step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.trace import Trace
from repro_torch.core.esrnn import param_leaves
from repro_torch.train.engine import split_frozen


@dataclasses.dataclass
class Finding:
    """One invariant violation (shared by every lint in the package)."""

    lint: str
    message: str

    def to_dict(self):
        return {"lint": self.lint, "message": self.message}


def _frozen_shapes(params, frozen: FrozenSet[str]):
    return {tuple(t.shape) for _, t in param_leaves(split_frozen(params, frozen)[1])}


def probe_batch_size(cfg, params, candidates: Sequence[int] = (5, 7, 11, 13),
                     frozen: FrozenSet[str] = frozenset()) -> int:
    """A batch size whose activation shapes cannot shadow frozen weights.

    The reference's rule: no frozen leaf has B as a dimension. The port's
    dilated layers fold a batch of B rows into ``B * d`` rows for each
    dilation d of ``cfg`` (``core/drnn.py``), so those must miss every
    frozen dimension too (``cfg`` None: B alone).
    """
    frozen_dims = {d for shape in _frozen_shapes(params, frozen) for d in shape}
    folds = {1} if cfg is None else {1} | {d for block in cfg.dilations for d in block}
    for b in candidates:
        if not any(b * d in frozen_dims for d in folds):
            return b
    return max(frozen_dims) + 1


def _moment_findings(params, opt_state, frozen) -> List[Finding]:
    """Check 2: the moments lie over the trainable leaves alone."""
    if not frozen or not isinstance(opt_state, dict) or "mu" not in opt_state:
        return []
    train = param_leaves(split_frozen(params, frozen)[0])
    full = param_leaves(params)
    moment_shapes = [tuple(m.shape) for m in opt_state["mu"]]
    if moment_shapes == [tuple(t.shape) for _, t in train]:
        return []
    if moment_shapes == [tuple(t.shape) for _, t in full]:
        paths = [path for path, _ in full if path[0] in frozen]
        return [Finding(
            "gradient-leak",
            f"optimizer state carries moments for frozen group "
            f"{sorted({p[0] for p in paths})} at {paths[0]} and {len(paths) - 1} more: "
            f"the optimizer was built over the frozen parameters")]
    return [Finding(
        "gradient-leak",
        f"optimizer moments {moment_shapes} match neither the trainable leaves "
        f"nor the whole tree: cannot tell which parameters they cover")]


def gradient_leak_findings(step_fn, params, opt_state, idx, frozen: FrozenSet[str], *,
                           trace: Optional[Trace] = None) -> Tuple[List[Finding], dict]:
    """Run ``step_fn(params, opt_state, idx)`` once and apply checks 1-3.

    ``trace``: a :class:`~repro_torch.analysis.trace.Trace` to run the step
    in (default: a fresh one); afterwards it holds the step's ops, its
    graph, and in ``trace.outputs`` what the step returned, for the other
    lints. Returns ``(findings, metrics)``; no findings is the proof.
    """
    findings: List[Finding] = []
    frozen_before = [(path, t, t.data_ptr(), t._version, t.detach().clone())
                     for path, t in param_leaves(split_frozen(params, frozen)[1])]
    trace = trace if trace is not None else Trace()
    with trace:
        trace.outputs = step_fn(params, opt_state, idx)
    new_params = trace.outputs[0]

    # 1. pass-through
    frozen_after = param_leaves(split_frozen(new_params, frozen)[1])
    passthrough_ok = 0
    if len(frozen_after) != len(frozen_before):
        findings.append(Finding(
            "gradient-leak",
            f"frozen groups have {len(frozen_before)} leaves before the step and "
            f"{len(frozen_after)} after: the step does not return the frozen "
            f"subtree unchanged"))
    else:
        for (path, t, ptr, version, bits), (_, t2) in zip(frozen_before, frozen_after):
            same = (t2 is t and t2.data_ptr() == ptr and t2._version == version
                    and torch.equal(t2.detach(), bits))
            if same:
                passthrough_ok += 1
            else:
                findings.append(Finding(
                    "gradient-leak",
                    f"frozen leaf {path} is not passed through unchanged: an update "
                    f"is applied to a frozen param group"))

    # 2. no moments
    findings += _moment_findings(params, opt_state, frozen)

    # 3. no gradient: no AccumulateGrad of a frozen leaf...
    frozen_ids = {id(t): path for path, t, *_ in frozen_before}
    accumulate_hits = sorted({str(frozen_ids[id(t)]) for t in trace.graph.leaves
                              if id(t) in frozen_ids})
    for path in accumulate_hits:
        findings.append(Finding(
            "gradient-leak",
            f"the step's autograd graph accumulates a gradient into frozen leaf {path}"))
    # ...and no backward op producing a frozen-weight-shaped float
    frozen_shapes = _frozen_shapes(params, frozen)
    trainable_shapes = {tuple(t.shape) for _, t in param_leaves(split_frozen(params, frozen)[0])}
    collisions = frozen_shapes & trainable_shapes
    if collisions:
        findings.append(Finding(
            "gradient-leak",
            f"probe shapes are ambiguous: frozen and trainable leaves share shapes "
            f"{sorted(collisions)}; pick distinct probe dimensions (see probe_batch_size)"))
    grad_hits, seen = 0, set()
    backward_ops = trace.ops.backward_ops()
    for op in backward_ops:
        for shape, dtype in zip(op.shapes, op.dtypes):
            if dtype.is_floating_point and shape in frozen_shapes:
                grad_hits += 1
                if (op.name, shape) not in seen:
                    seen.add((op.name, shape))
                    findings.append(Finding(
                        "gradient-leak",
                        f"backward op `{op.name}` produces a frozen-weight-shaped "
                        f"value {shape}: a frozen group's weight gradient is being built"))

    metrics = {"frozen_leaves": len(frozen_before), "passthrough_ok": passthrough_ok,
               "frozen_accumulate_grads": len(accumulate_hits), "grad_op_hits": grad_hits,
               "graph_nodes": trace.graph.nodes, "ops_scanned": len(trace.ops.ops),
               "backward_ops": len(backward_ops)}
    return findings, metrics


def cell_steps(cfg, t_len: int) -> int:
    """LSTM-cell calls of one pass over ``t_len`` observations: each layer of
    dilation d walks ceil(P / d) steps over the P = T - W + 1 window
    positions (``core/drnn.py``)."""
    positions = t_len - cfg.input_size + 1
    return sum(-(-positions // d) for block in cfg.dilations for d in block)


def launch_findings(cfg, frozen: FrozenSet[str], counts: Dict[str, int],
                    steps: int) -> Tuple[List[Finding], dict]:
    """The card's launch check over a run of ``steps`` cell steps (from
    :func:`cell_steps`): with the LSTM stack (``"rnn"``) frozen, K5's
    dx-only launch once per cell step and the full K5 never; trained, the
    full K5 once per cell step. ``counts``: the launches of the run
    (:func:`~repro_torch.kernels.ops.launch_counts`), fp32 and bf16 summed.
    A head without an LSTM stack (ssm) launches neither."""
    k5 = counts.get("lstm_cell_bwd", 0) + counts.get("lstm_cell_bwd_bf16", 0)
    dx = counts.get("lstm_cell_bwd_dx", 0) + counts.get("lstm_cell_bwd_dx_bf16", 0)
    lstm = cfg.head in ("lstm", "esn")
    want = {"full": 0, "dx_only": 0}
    if lstm:
        want["dx_only" if "rnn" in frozen else "full"] = steps
    got = {"full": k5, "dx_only": dx}
    findings = []
    if got != want:
        findings.append(Finding(
            "gradient-leak",
            f"the step launched K5 {k5} times and its dx-only launch {dx} times over "
            f"{steps} cell steps; frozen groups {sorted(frozen)} want {want}"))
    return findings, {"k5_launches": got, "k5_expected": want, "cell_steps": steps}
