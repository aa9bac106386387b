"""Dtype-policy lint: no float64 and no float conversion wider than the policy.

The forward core computes in the config's policy dtype (``float32``, or
``bfloat16`` under ``precision="bf16"`` with float32 state). Two regression
classes, read off the ops an entry point ran (:mod:`repro_torch.analysis.trace`)
where the JAX package reads its jaxpr (``repro.analysis.dtypes``):

* **f64 promotion** -- a float64 constant or a numpy float64 scalar
  tensor doubles every value downstream of it; no op may produce float64;
* **silent upcast** -- a float -> float conversion (``_to_copy``, a
  ``copy_`` across dtypes, or an op whose float inputs promote to a wider
  output) to a dtype wider than the policy allows.

Integer and bool values are exempt, as are conversions down to or within
the policy's width. :func:`accumulation_findings` checks the other half of
a mixed-precision policy on the state itself.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.analysis.gradleak import Finding
from repro_torch.analysis.trace import tree_leaves


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, str(name))


def _name(dtype) -> str:
    return str(_dtype(dtype)).removeprefix("torch.")


def dtype_findings(ops, policy_dtype="float32",
                   state_dtype: Optional[str] = None) -> Tuple[List[Finding], dict]:
    """Lint the recorded ops of one call against a float compute policy.

    ``ops``: an :class:`~repro_torch.analysis.trace.OpRecorder` or its list
    of :class:`~repro_torch.analysis.trace.OpRecord`. Flags every float64
    output and every float -> float conversion wider than ``policy_dtype``.
    Under a mixed-precision policy pass ``state_dtype`` too: conversions up
    to it are the declared float32 accumulation points, anything wider (and
    any float64) still fails. With ``state_dtype=None`` every conversion
    above ``policy_dtype`` is a silent upcast.

    Returns ``(findings, metrics)``; findings are deduplicated by (op,
    dtype pair), so one leaked constant does not give hundreds of lines.
    """
    ops = getattr(ops, "ops", ops)
    policy = _dtype(policy_dtype)
    widest = policy
    if state_dtype is not None and _dtype(state_dtype).itemsize > policy.itemsize:
        widest = _dtype(state_dtype)
    findings: List[Finding] = []
    seen = set()
    f64 = upcasts = 0
    for op in ops:
        for shape, dt in zip(op.shapes, op.dtypes):
            if dt == torch.float64:
                f64 += 1
                if ("f64", op.name) not in seen:
                    seen.add(("f64", op.name))
                    findings.append(Finding(
                        "dtype-policy",
                        f"float64 value produced by `{op.name}` (shape {shape}): f64 "
                        f"promotion on a {_name(policy)}-policy path"))
        if op.convert is not None and op.convert[1].itemsize > widest.itemsize:
            upcasts += 1
            src, dst = (_name(d) for d in op.convert)
            if ("upcast", op.name, src, dst) not in seen:
                seen.add(("upcast", op.name, src, dst))
                findings.append(Finding(
                    "dtype-policy",
                    f"silent upcast {src} -> {dst} by `{op.name}` beyond the "
                    f"{_name(policy)} policy"))
    metrics = {"ops_scanned": len(ops), "f64_avals": f64, "float_upcasts": upcasts,
               "policy_dtype": _name(policy),
               "state_dtype": None if state_dtype is None else _name(state_dtype)}
    return findings, metrics


def accumulation_findings(params, opt_state, loss,
                          state_dtype="float32") -> Tuple[List[Finding], dict]:
    """The float32-*state* half of the precision policy, on the state itself.

    Whatever the compute policy, these stay ``state_dtype``: the per-series
    Holt-Winters table (``params["hw"]``, the master copy the recurrence
    trains), the Adam moments (``mu``/``nu``, dense or sparse) and the loss
    the masked-mean reduction emits (``loss``, a tensor or anything with a
    ``dtype``).
    """
    state = _dtype(state_dtype)
    findings: List[Finding] = []

    def bad_dtypes(tree):
        return sorted({_name(leaf.dtype) for _, leaf in tree_leaves(tree)
                       if isinstance(leaf, torch.Tensor) and leaf.dtype.is_floating_point
                       and leaf.dtype != state})

    hw_bad = bad_dtypes(params.get("hw") if isinstance(params, dict) else params)
    if hw_bad:
        findings.append(Finding(
            "dtype-policy",
            f"per-series HW table holds {hw_bad} leaves; the master level/seasonality "
            f"state must stay {_name(state)}"))
    moments = ({k: v for k, v in opt_state.items() if k in ("mu", "nu")}
               if isinstance(opt_state, dict) else opt_state)
    mom_bad = bad_dtypes(moments)
    if mom_bad:
        findings.append(Finding(
            "dtype-policy",
            f"Adam moments hold {mom_bad} leaves; optimizer accumulators must stay "
            f"{_name(state)}"))
    if loss.dtype != state:
        findings.append(Finding(
            "dtype-policy",
            f"loss reduction emits {_name(loss.dtype)}; the masked-mean pinball "
            f"accumulation must stay {_name(state)}"))
    metrics = {"hw_table_dtypes_bad": hw_bad, "moment_dtypes_bad": mom_bad,
               "loss_dtype": _name(loss.dtype), "state_dtype": _name(state)}
    return findings, metrics
