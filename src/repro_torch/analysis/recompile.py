"""Launch-shape sentinel: count the distinct shapes the kernels receive.

The serving path's claim is a bounded set of shapes: the dispatcher pads
every request group to a ``length x batch`` bucket, so the device only
ever sees the bucket grid's shapes. The JAX package counts what XLA
compiles (``repro.analysis.recompile``), because the dangerous failure is a
shape family the dispatcher does not know about: its ``fc[:n]`` bug
compiled one executable per partial fill while the bucket counters stayed
green. The port runs eagerly and compiles nothing, but the same bound is
what a CUDA graph of a bucket will capture against, so the port counts its
ground truth where it lies: every distinct ``(kernel, input shapes,
dtype)`` key that reaches a kernel entry point (the hook of
:mod:`repro_torch.kernels.shapes`; the plain versions pass through it too).
A key a :class:`LaunchShapeCounter` has not seen counts as one "compile".

``BucketDispatcher.run_bucket`` arms one around the first dispatch of each
distinct input shape (a forecast's kernel keys follow from its input
shapes, so a repeat runs unarmed and adds none), so
``ServeStats.launch_shapes`` is the ground truth beside
``ServeStats.compiles`` (the dispatcher's intent), as the reference's
``ServeStats.xla_compiles`` is. One bucket issues
:func:`bucket_launch_shapes` distinct keys, so a dispatcher's launch-shape
budget is ``compile_budget x bucket_launch_shapes(config)``.
:class:`LaunchShapeCounter` and :class:`CompileBudgetExceeded` live with
the hook in :mod:`repro_torch.kernels.shapes`, :func:`bucket_launch_shapes`
and :func:`check_compile_budget` with the dispatcher in
:mod:`repro_torch.forecast.serving`; this module re-exports them.
"""

from repro_torch.forecast.serving import bucket_launch_shapes, check_compile_budget
from repro_torch.kernels.shapes import CompileBudgetExceeded, LaunchShapeCounter

__all__ = ["CompileBudgetExceeded", "LaunchShapeCounter", "bucket_launch_shapes",
           "check_compile_budget"]
