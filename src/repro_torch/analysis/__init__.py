"""repro_torch.analysis: the invariant auditor of the port.

The counterpart of ``repro.analysis`` and the engine of ``python -m
repro_torch.launch.forecast analyze``. The JAX package proves its
invariants on jaxprs and compiled HLO; the port runs eagerly, so each lint
runs the real entry point once with recorders armed
(:mod:`repro_torch.analysis.trace`: the ATen ops it ran, its autograd
graph) and checks what they saw:

* :mod:`repro_torch.analysis.recompile` -- the kernels' launch shapes stay
  within the serving bucket grid (:class:`LaunchShapeCounter`),
* :mod:`repro_torch.analysis.gradleak` -- frozen param groups take no
  gradient, no moment and no update,
* :mod:`repro_torch.analysis.donation` -- a superstep updates its state in
  place,
* :mod:`repro_torch.analysis.collectives` -- the sharded calls issue their
  documented collectives and nothing else,
* :mod:`repro_torch.analysis.dtypes` -- no float64, no upcast beyond the
  policy, float32 state.

:mod:`repro_torch.analysis.audit` wires the lints to the real fit, predict
and serve entry points and emits the JSON report.
"""

from repro_torch.analysis.audit import (  # noqa: F401
    AuditReport, AuditSection, audit_collectives, audit_fit, audit_predict,
    audit_serve, run_audit,
)
from repro_torch.analysis.gradleak import Finding  # noqa: F401
from repro_torch.analysis.recompile import (  # noqa: F401
    CompileBudgetExceeded, LaunchShapeCounter, check_compile_budget,
)

__all__ = [
    "AuditReport", "AuditSection", "Finding",
    "CompileBudgetExceeded", "LaunchShapeCounter", "check_compile_budget",
    "audit_collectives", "audit_fit", "audit_predict", "audit_serve",
    "run_audit",
]
