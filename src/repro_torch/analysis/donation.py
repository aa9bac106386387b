"""In-place audit: a training step updates its state where it lies.

The JAX package donates ``(params, opt_state)`` into its superstep and
checks that the compiled module aliases every donated buffer
(``repro.analysis.donation``). The port's step has no donation: it writes
the parameters and the Adam moments in place (``train/engine.py``,
``train/optimizer.py``), which is the same claim -- the HW table and its
moments, the largest state of a fit, are never copied per step. A step that
returns a fresh tensor for a leaf ("updated but copied") breaks it, and so
would a static buffer that a captured CUDA graph of the step relies on.

:func:`state_storages` snapshots each leaf's tensor object and storage
before and after a superstep; :func:`donation_findings` compares them. A
host scalar leaf (the Adam step count, an ``int`` in the port and a donated
int32 array in the reference) holds no device storage, so it cannot be
copied and counts as kept; :func:`state_leaf_count` counts it, as the
reference's ``donated_leaf_count`` does.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.analysis.gradleak import Finding
from repro_torch.analysis.trace import tree_leaves


def state_leaf_count(*trees) -> int:
    """Leaves of the state trees (tensors and host scalars)."""
    return sum(1 for tree in trees for _ in tree_leaves(tree))


def state_storages(*trees) -> List[Tuple]:
    """``(path, leaf, storage)`` of every leaf of the state trees, the
    storage's address (None for a host scalar). The leaf itself is kept, so an
    object id cannot be reused while the snapshot lives."""
    return [((i,) + path, leaf,
             leaf.untyped_storage().data_ptr() if isinstance(leaf, torch.Tensor) else None)
            for i, tree in enumerate(trees) for path, leaf in tree_leaves(tree)]


def donation_findings(before, after, expected_aliases: int,
                      what: str = "superstep") -> Tuple[List[Finding], dict]:
    """Compare :func:`state_storages` snapshots taken before and after ``what``.

    A tensor leaf is kept when it comes back as the same object on the same
    storage. Findings: a leaf replaced or moved (updated but copied), fewer
    kept leaves than ``expected_aliases`` (:func:`state_leaf_count` of the
    state), and two leaves on one storage.
    """
    findings: List[Finding] = []
    kept = 0
    if [p for p, *_ in before] != [p for p, *_ in after]:
        findings.append(Finding(
            "donation",
            f"{what}: the state's leaves changed structure "
            f"({len(before)} leaves before, {len(after)} after)"))
    else:
        for (path, leaf, ptr), (_, leaf2, ptr2) in zip(before, after):
            if ptr is None or (leaf2 is leaf and ptr2 == ptr):
                kept += 1
            else:
                findings.append(Finding(
                    "donation",
                    f"{what}: state leaf {path} came back as a different "
                    f"{'tensor' if leaf2 is not leaf else 'storage'}: updated but "
                    f"copied instead of written in place"))
    if kept < expected_aliases:
        findings.append(Finding(
            "donation",
            f"{what}: only {kept} of {expected_aliases} state leaves were updated in "
            f"place; the rest are copied every call (updated-but-copied)"))
    ptrs = [ptr for _, leaf, ptr in after if ptr and leaf.numel()]
    if len(set(ptrs)) != len(ptrs):
        findings.append(Finding(
            "donation",
            f"{what}: two state leaves share one storage"))
    metrics = {"aliased_buffers": kept, "expected_aliases": expected_aliases}
    return findings, metrics
