"""The port's invariant auditor (``repro_torch.analysis``) on the CPU.

Every test of ``tests/analysis/`` has a counterpart here (the CLI's in
``tests/test_torch_analysis_cli.py``). The JAX package's HLO and jaxpr
text parsers have none: the port records what an eager call runs
(``analysis/trace.py``), so recorder tests stand in their place. Then:

* the port's report held against the reference's on the same smoke spec,
  the reference's probe params converted with ``repro_torch.convert``, for
  the lstm, esn and ssm heads and ``precision=bf16``: section and lint
  names, ``ok``, ``frozen_leaves``, ``passthrough_ok``, ``compile_budget``,
  ``bucket_compiles``, ``cache_hits``, ``f64_avals`` (0) and
  ``expected_aliases`` equal, and a warm wave that adds 0 to
  ``launch_shapes`` as the reference's adds 0 to ``xla_compiles``;
* one seeded violation per lint, found by the port's lint on the real entry
  point, and the matching one by the reference's lint;
* the collective audit on 2 gloo ranks through ``run_ranks``, as
  ``tests/test_torch_dp.py`` runs them.

The reference's jaxpr walk names ``jax.core.ClosedJaxpr``, which jax 0.9
no longer exports (ROADMAP F7): the fixture ``reference_jaxpr_walk`` points
the walk's ``jcore`` at ``jax._src.core`` for the comparisons.
"""

import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import torch_dp_ranks as R
from repro.analysis import audit as janalysis
from repro.analysis import collectives as jcollectives
from repro.analysis import donation as jdonation
from repro.analysis import dtypes as jdtypes
from repro.analysis import gradleak as jgradleak
from repro.analysis import jaxpr_walk as jwalk
from repro.analysis import recompile as jrecompile
from repro.forecast.spec import get_smoke_spec as jax_smoke_spec
from repro_torch.analysis import audit as A
from repro_torch.analysis import collectives as C
from repro_torch.analysis.donation import (
    donation_findings, state_leaf_count, state_storages,
)
from repro_torch.analysis.dtypes import accumulation_findings, dtype_findings
from repro_torch.analysis.gradleak import (
    gradient_leak_findings, launch_findings, probe_batch_size,
)
from repro_torch.analysis.recompile import (
    CompileBudgetExceeded, LaunchShapeCounter, bucket_launch_shapes, check_compile_budget,
)
from repro_torch.analysis.trace import GraphRecorder, OpRecorder, Trace, walk_graph
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import esrnn as tes
from repro_torch.core.heads import frozen_param_groups
from repro_torch.core.holt_winters import HWParams
from repro_torch.forecast import get_smoke_spec
from repro_torch.forecast.serving import BucketDispatcher, synthetic_request_stream
from repro_torch.kernels import ops, shapes
from repro_torch.sharding import run_ranks
from repro_torch.sharding import series as S
from repro_torch.train import engine
from repro_torch.train.optimizer import adam_init

PRESETS = {"lstm": {}, "esn": {"head": "esn"}, "ssm": {"head": "ssm"},
           "bf16": {"precision": "bf16"}}


@pytest.fixture
def launch_sentinel():
    """An armed LaunchShapeCounter: every kernel call in the test feeds it."""
    with LaunchShapeCounter() as counter:
        yield counter


@pytest.fixture
def reference_jaxpr_walk(monkeypatch):
    """The reference's jaxpr walk on jax 0.9 (ROADMAP F7)."""
    from jax._src import core as jax_core

    shim = types.SimpleNamespace(ClosedJaxpr=jax_core.ClosedJaxpr, Jaxpr=jax_core.Jaxpr,
                                 Literal=jax_core.Literal)
    monkeypatch.setattr(jwalk, "jcore", shim)
    monkeypatch.setattr(jgradleak, "jcore", shim)


# ---------------------------------------------------------------------------
# gradleak (tests/analysis/test_gradleak.py)
# ---------------------------------------------------------------------------

FROZEN = frozenset({"rnn"})
B = 5  # probe batch rows, distinct from every weight dim below


class _Weights(nn.Module):
    def __init__(self, **tensors):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, nn.Parameter(t))


def _params():
    return {"rnn": _Weights(w=torch.ones((4, 3))),
            "head": _Weights(w=torch.ones((3, 2)), b=torch.zeros((2,)))}


def _loss(p, x):
    h = torch.tanh(x @ p["rnn"].w)
    return torch.sum((h @ p["head"].w + p["head"].b) ** 2)


def _sgd(leaves, grads):
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            p.sub_(0.1 * g)


def clean_step(params, opt_state, idx):
    """Differentiates the trainable subtree only; frozen passes through."""
    x = torch.ones((B, 4)) * idx.sum()
    params["rnn"].w.requires_grad_(False)
    head = list(params["head"].parameters())
    _sgd(head, torch.autograd.grad(_loss(params, x), head))
    params["rnn"].w.requires_grad_(True)
    return params, opt_state, idx


def leaky_step(params, opt_state, idx):
    """Differentiates the whole tree: the reservoir's weight gradient is
    formed and the frozen group updated -- both checks must fire."""
    x = torch.ones((B, 4)) * idx.sum()
    leaves = [params["rnn"].w, *params["head"].parameters()]
    _sgd(leaves, torch.autograd.grad(_loss(params, x), leaves))
    return params, opt_state, idx


def _head_moments(params):
    head = [t for _, t in tes.param_leaves({"head": params["head"]})]
    return {"mu": [torch.zeros_like(t) for t in head],
            "nu": [torch.zeros_like(t) for t in head], "step": 0}


def test_clean_step_has_no_findings():
    params = _params()
    findings, metrics = gradient_leak_findings(
        clean_step, params, _head_moments(params), torch.arange(B), FROZEN)
    assert findings == []
    assert metrics["frozen_leaves"] == 1
    assert metrics["passthrough_ok"] == 1
    assert metrics["grad_op_hits"] == 0
    assert metrics["frozen_accumulate_grads"] == 0
    assert metrics["ops_scanned"] > 0


def test_leaky_step_is_flagged():
    params = _params()
    findings, metrics = gradient_leak_findings(
        leaky_step, params, _head_moments(params), torch.arange(B), FROZEN)
    assert findings, "lint failed to flag a full-tree gradient step"
    messages = " | ".join(f.message for f in findings)
    assert "passed through unchanged" in messages
    assert metrics["frozen_accumulate_grads"] == 1
    assert metrics["grad_op_hits"] >= 1


def test_frozen_moments_in_opt_state_are_flagged():
    params = _params()
    opt = {"mu": [torch.zeros_like(t) for _, t in tes.param_leaves(params)],
           "nu": [torch.zeros_like(t) for _, t in tes.param_leaves(params)], "step": 0}
    findings, _ = gradient_leak_findings(clean_step, params, opt, torch.arange(B), FROZEN)
    assert any("optimizer state carries moments" in f.message for f in findings)


def test_probe_batch_size_avoids_frozen_dims():
    params = _params()
    assert probe_batch_size(None, params, candidates=(3, 4, 5), frozen=FROZEN) == 5
    # the dilated layers fold B rows into B * d: at hidden 40 (wh (40, 160))
    # B = 5 folds to 40 rows under dilation 8 and B = 7 hits the input width 14
    cfg = tes.make_config("quarterly", head="esn")
    big = tes.esrnn_init(torch.Generator().manual_seed(0), cfg, 3, device="cpu")
    assert probe_batch_size(None, big, frozen=FROZEN) == 5
    assert probe_batch_size(cfg, big, frozen=FROZEN) == 11


# ---------------------------------------------------------------------------
# the recorders (in place of the HLO/jaxpr text parser tests)
# ---------------------------------------------------------------------------


def test_op_recorder_sees_backward_and_conversions():
    w = torch.randn(3, 4, requires_grad=True)
    with OpRecorder() as rec:
        loss = torch.tanh(torch.randn(5, 3) @ w).sum()
        torch.autograd.grad(loss, [w])
        torch.ones(2, dtype=torch.bfloat16).float()
    names = [r.name for r in rec.ops]
    assert "mm" in names and "tanh_backward" in names
    assert [r.name for r in rec.backward_ops()].count("mm") == 1
    assert any(r.backward and r.shapes == ((3, 4),) for r in rec.ops)
    assert [r.convert for r in rec.ops if r.convert] == [(torch.bfloat16, torch.float32)]
    assert len(rec.ops) == len(names)
    with OpRecorder() as idle:
        pass
    torch.ones(3) * 2                            # disarmed: nothing recorded
    assert idle.ops == []


def test_graph_recorder_walks_every_backward_root():
    a, b = torch.randn(3, requires_grad=True), torch.randn(3, requires_grad=True)
    fixed = torch.randn(3)
    grad = torch.autograd.grad
    with GraphRecorder() as rec:
        torch.autograd.grad((a * b).sum(), [a])
        (a * fixed).sum().backward()
    assert torch.autograd.grad is grad                 # restored on exit
    assert len(rec.roots) == 2
    assert {id(t) for t in rec.leaves} == {id(a), id(b)}
    nodes = list(walk_graph((a * b + a).sum()))
    assert sum(type(n).__name__ == "AccumulateGrad" for n in nodes) == 2
    assert len(nodes) == len({id(n) for n in nodes})


def test_launch_shape_hook_counts_the_plain_versions(launch_sentinel):
    """The CPU's plain versions report their keys; the launch counters stay 0."""
    cfg = tes.make_config("quarterly", hidden_size=8)
    params = tes.esrnn_init(torch.Generator().manual_seed(0), cfg, 4, device="cpu")
    y = torch.from_numpy(np.linspace(10, 20, 4 * 30, dtype=np.float32).reshape(4, 30))
    ops.reset_launch_counts()
    tes.esrnn_forecast(cfg, params, y, torch.eye(6)[:4])
    kernels = sorted({k[0] for k in launch_sentinel.seen})
    assert kernels == ["hw_scan", "lstm_cell"]
    assert launch_sentinel.count == bucket_launch_shapes(cfg) == 5
    assert ("hw_scan", ((30, 4), (4,), (4,), (4, 4)), "float32") in launch_sentinel.seen
    assert not any(ops.launch_counts().values())
    before = launch_sentinel.count
    tes.esrnn_forecast(cfg, params, y, torch.eye(6)[:4])
    assert launch_sentinel.count == before           # the same keys again
    assert shapes._armed


def test_launch_shape_hook_is_free_when_disarmed():
    assert not shapes._armed
    with LaunchShapeCounter() as outer:
        with LaunchShapeCounter() as inner:
            shapes.note("k", torch.ones(2))
        shapes.note("k", torch.ones(3))
    assert not shapes._armed
    shapes.note("k", torch.ones(4))
    assert (inner.count, outer.count) == (1, 2)


# ---------------------------------------------------------------------------
# dtypes (tests/analysis/test_dtypes.py)
# ---------------------------------------------------------------------------


def _recorded(fn, *args):
    with OpRecorder() as rec:
        fn(*args)
    return rec


def test_clean_f32_program_passes():
    rec = _recorded(lambda x: torch.tanh(x @ x.T).sum(), torch.ones((4, 3)))
    findings, metrics = dtype_findings(rec, policy_dtype="float32")
    assert findings == []
    assert metrics["f64_avals"] == 0
    assert metrics["float_upcasts"] == 0
    assert metrics["ops_scanned"] > 0


def test_f64_promotion_is_flagged():
    """Seeded violation: a program producing float64 values."""
    rec = _recorded(lambda x: x.to(torch.float64) * 2.0, torch.ones(4))
    findings, metrics = dtype_findings(rec, policy_dtype="float32")
    assert any("f64 promotion" in f.message for f in findings)
    assert metrics["f64_avals"] >= 1
    assert metrics["float_upcasts"] >= 1      # the f32 -> f64 conversion too


def test_upcast_beyond_bf16_policy_is_flagged():
    rec = _recorded(lambda x: x.float().sum(), torch.ones(4, dtype=torch.bfloat16))
    findings, metrics = dtype_findings(rec, policy_dtype="bfloat16")
    assert any("silent upcast" in f.message for f in findings)
    assert metrics["float_upcasts"] >= 1


def test_downcast_within_policy_passes():
    rec = _recorded(lambda x: x.to(torch.bfloat16).sum(), torch.ones(4))
    findings, _ = dtype_findings(rec, policy_dtype="float32")
    assert findings == []


def test_findings_dedup_by_dtype_pair():
    rec = _recorded(lambda x: x.float().sum() + (x * 2).float().sum(),
                    torch.ones(4, dtype=torch.bfloat16))
    findings, metrics = dtype_findings(rec, policy_dtype="bfloat16")
    assert metrics["float_upcasts"] >= 2
    assert len([f for f in findings if "silent upcast" in f.message]) == 1


def test_implicit_promotion_is_a_conversion():
    """A bf16 tensor meeting a float32 one promotes inside the op: recorded
    as the conversion a jaxpr would show as ``convert_element_type``."""
    rec = _recorded(lambda a, b: a + b, torch.ones(2, dtype=torch.bfloat16), torch.ones(2))
    assert [r.convert for r in rec.ops] == [(torch.bfloat16, torch.float32)]
    assert dtype_findings(rec, policy_dtype="bfloat16")[1]["float_upcasts"] == 1
    assert dtype_findings(rec, "bfloat16", state_dtype="float32")[0] == []


def test_state_dtype_allows_declared_accumulation_upcasts():
    rec = _recorded(lambda x: x.float().sum(), torch.ones(4, dtype=torch.bfloat16))
    findings, metrics = dtype_findings(rec, policy_dtype="bfloat16", state_dtype="float32")
    assert findings == []
    assert metrics["float_upcasts"] == 0
    assert metrics["state_dtype"] == "float32"


def test_state_dtype_still_flags_f64():
    rec = _recorded(lambda x: x.to(torch.float64) * 2.0, torch.ones(4))
    findings, _ = dtype_findings(rec, policy_dtype="bfloat16", state_dtype="float32")
    assert any("f64 promotion" in f.message for f in findings)


def test_bf16_esrnn_forecast_is_policy_clean():
    """The real bf16 forecast lints clean under (bf16, f32 state)."""
    cfg = tes.make_config("quarterly", precision="bf16")
    rng = np.random.default_rng(0)
    n, t = 8, 30
    y = torch.from_numpy((np.abs(rng.lognormal(2, 0.3, (n, t))) + 0.5).astype(np.float32))
    cats = torch.eye(cfg.n_categories)[torch.zeros(n, dtype=torch.long)]
    params = tes.esrnn_init(torch.Generator().manual_seed(0), cfg, n, device="cpu")
    rec = _recorded(tes.esrnn_forecast, cfg, params, y, cats)
    findings, metrics = dtype_findings(rec, policy_dtype="bfloat16", state_dtype="float32")
    assert findings == []
    assert dtype_findings(rec, policy_dtype="bfloat16")[1]["float_upcasts"] > 0


def _hw(n, dtype=torch.float32):
    z = torch.zeros(n, dtype=dtype)
    return HWParams(alpha_logit=z, gamma_logit=z.clone(), init_seas_logit=z.clone())


def test_accumulation_findings_clean_on_real_trees():
    params = {"hw": _hw(4), "rnn": _Weights(wx=torch.zeros((3, 3)))}
    opt = {"mu": [torch.zeros((3, 3))], "nu": [torch.zeros((3, 3))], "step": 0}
    findings, metrics = accumulation_findings(params, opt, torch.zeros(()))
    assert findings == []
    assert metrics["loss_dtype"] == "float32"


def test_accumulation_findings_fire_on_seeded_violations():
    params = {"hw": _hw(4, torch.bfloat16)}
    opt = {"mu": [torch.zeros(3, dtype=torch.bfloat16)], "nu": [torch.zeros(3)]}
    findings, metrics = accumulation_findings(params, opt, torch.zeros((), dtype=torch.bfloat16))
    msgs = " ".join(f.message for f in findings)
    assert "HW table" in msgs
    assert "Adam moments" in msgs
    assert "loss reduction" in msgs
    assert metrics["hw_table_dtypes_bad"] == ["bfloat16"]


# ---------------------------------------------------------------------------
# donation (tests/analysis/test_donation.py)
# ---------------------------------------------------------------------------


def _toy_state():
    return {"s": torch.zeros(128)}, {"mu": [torch.zeros(128)], "step": 0}


def _run(step):
    params, opt = _toy_state()
    before = state_storages(params, opt)
    params, opt = step(params, opt, torch.ones(128))
    return donation_findings(before, state_storages(params, opt),
                             state_leaf_count(params, opt), what="toy step")


def test_in_place_update_keeps_every_storage():
    def step(p, o, x):
        p["s"].add_(x)
        o["mu"][0].mul_(0.9).add_(x)
        return p, dict(o, step=o["step"] + 1)

    findings, metrics = _run(step)
    assert findings == []
    assert metrics == {"aliased_buffers": 3, "expected_aliases": 3}


def test_updated_but_copied_is_flagged():
    """Seeded violation: the step returns a new tensor for its state."""
    def step(p, o, x):
        return dict(p, s=p["s"] + x), o

    findings, metrics = _run(step)
    assert any("updated-but-copied" in f.message for f in findings)
    assert any("different tensor" in f.message for f in findings)
    assert metrics["aliased_buffers"] == 2


def test_state_storages_snapshot_tensors_and_host_scalars():
    params, opt = _toy_state()
    snap = state_storages(params, opt)
    assert [p for p, *_ in snap] == [(0, "s"), (1, "mu", 0), (1, "step")]
    assert snap[0][2] == params["s"].untyped_storage().data_ptr()
    assert snap[2][1:] == (0, None)


def test_state_structure_change_is_flagged():
    params, opt = _toy_state()
    before = state_storages(params, opt)
    findings, metrics = donation_findings(before, state_storages(params), 3)
    assert any("changed structure" in f.message for f in findings)
    assert metrics["aliased_buffers"] == 0


def test_shared_storage_is_flagged():
    base = torch.zeros(8)
    params = {"a": base, "b": base}
    snap = state_storages(params)
    findings, _ = donation_findings(snap, snap, 2, what="fake")
    assert any("share one storage" in f.message for f in findings)


def test_state_leaf_count_spans_trees():
    params = {"a": torch.zeros(3), "b": {"c": torch.zeros(2)}}
    opt = (torch.zeros(1), torch.zeros(1))
    assert state_leaf_count(params, opt) == 4
    # the reference's donated_leaf_count over the same esn params and moments
    cfg = tes.make_config("quarterly", hidden_size=8, head="esn")
    p = tes.esrnn_init(torch.Generator().manual_seed(0), cfg, 5, device="cpu")
    o = adam_init(engine.split_frozen(p, frozen_param_groups(cfg))[0])
    jo = {"mu": [0] * len(o["mu"]), "nu": [0] * len(o["nu"]), "step": jnp.zeros(())}
    assert state_leaf_count(p, o) == jdonation.donated_leaf_count(params_to_numpy(p), jo)


# ---------------------------------------------------------------------------
# recompile (tests/analysis/test_recompile.py)
# ---------------------------------------------------------------------------


class UnpaddedDispatcher(BucketDispatcher):
    """Seeded violation: skips the batch padding, so each partial fill
    reaches the kernels at its own row count while the bucket accounting
    still counts the padded bucket -- the port's form of ``fc[:n]``."""

    def pad_batch(self, requests, bb):
        return requests


def test_partial_fills_are_an_unbounded_shape_family(launch_sentinel):
    """Each distinct fill n is a new K1 key; host-side slicing issues none."""
    cfg = tes.make_config("quarterly", hidden_size=8)
    params = tes.esrnn_init(torch.Generator().manual_seed(0), cfg, 16, device="cpu")
    y = torch.from_numpy(np.linspace(10, 20, 16 * 30, dtype=np.float32).reshape(16, 30))
    hw = params["hw"]
    fills = (3, 5, 7, 11, 13)
    before = launch_sentinel.count
    for n in fills:
        ops.hw_scan(y[:n], hw.map(lambda a: a[:n]), seasonality=4)
    assert launch_sentinel.count - before == len(fills)
    full = ops.hw_scan(y, hw, seasonality=4)[0].numpy()
    before = launch_sentinel.count
    for n in fills:
        _ = full[:n]
    assert launch_sentinel.count - before == 0


def test_expect_raises_on_budget_overrun(launch_sentinel):
    with pytest.raises(CompileBudgetExceeded):
        with launch_sentinel.expect(budget=1, what="partial-fill scans"):
            for n in (3, 5, 7):
                shapes.note("hw_scan", torch.ones(n))


def test_expect_passes_within_budget(launch_sentinel):
    with launch_sentinel.expect(budget=8, what="nothing"):
        pass


def test_serving_stays_within_declared_grid_budget():
    """Ragged lengths and partial fills across two identical waves: the
    launch shapes stay within the grid's budget and the warm wave issues
    none; the unpadded dispatcher issues new shapes on repeated buckets."""
    spec = get_smoke_spec("esn-quarterly")
    cfg = spec.model
    params = tes.esrnn_init(torch.Generator().manual_seed(0), cfg, 15, device="cpu")
    for cls, repeats in ((BucketDispatcher, False), (UnpaddedDispatcher, True)):
        disp = cls(cfg, params, length_buckets=(32, 64), batch_buckets=(1, 8), device="cpu")
        assert disp.compile_budget == 4 and disp.stats.compile_budget == 4
        assert disp.launch_shape_budget == 4 * bucket_launch_shapes(cfg) == 20
        for wave in range(2):
            before = disp.stats.launch_shapes
            reqs = synthetic_request_stream(cfg, 16, n_known=15, seed=0, len_range=(20, 60))
            assert len(disp.forecast_batch(reqs)) == len(reqs)
            grew = disp.stats.launch_shapes - before
            if wave == 0:
                assert 0 < grew <= disp.launch_shape_budget
            else:
                assert grew == 0
        assert (disp.stats.repeat_launch_shapes > 0) == repeats
        check_compile_budget(disp.stats)              # returns, does not raise


@pytest.mark.parametrize("cls", [BucketDispatcher, UnpaddedDispatcher])
def test_dispatcher_arms_its_counter_once_per_input_shape(cls):
    """The dispatcher arms its counter on the first dispatch of each input
    shape only, and still counts every key a counter armed throughout sees."""

    class Spy(LaunchShapeCounter):
        entries = 0

        def __enter__(self):
            Spy.entries += 1
            return super().__enter__()

    cfg = get_smoke_spec("esn-quarterly").model
    params = tes.esrnn_init(torch.Generator().manual_seed(0), cfg, 15, device="cpu")
    disp = cls(cfg, params, length_buckets=(32, 64), batch_buckets=(1, 8), device="cpu")
    disp._launch_shape_counter = Spy(stats=disp.stats)
    reqs = synthetic_request_stream(cfg, 16, n_known=15, seed=0, len_range=(20, 60))
    with LaunchShapeCounter() as throughout:
        disp.forecast_batch(reqs)
        first = Spy.entries
        disp.forecast_batch(reqs)
    assert first == len(disp._counted_inputs) > 0
    assert Spy.entries == first                   # the warm wave ran unarmed
    assert disp.stats.launch_shapes == throughout.count > 0


def test_check_compile_budget_raises_on_overrun():
    class Stats:
        compiles = 9
        compile_budget = 4
        cache_hits = 5

    with pytest.raises(CompileBudgetExceeded):
        check_compile_budget(Stats())


def test_check_compile_budget_requires_a_budget():
    class Stats:
        compiles = 0
        compile_budget = None

    with pytest.raises(ValueError):
        check_compile_budget(Stats())


# ---------------------------------------------------------------------------
# collectives (tests/analysis/test_collectives.py) on 2 gloo ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def collective_ranks():
    return run_ranks(R.collective_cases, 2, device="cpu")


def test_collective_recorder_counts_by_kind(collective_ranks):
    for rank in collective_ranks:
        assert rank["kinds"] == {"all_reduce": 3, "all_gather": 1, "broadcast": 1,
                                 "barrier": 1}


def test_collective_recorder_restores_and_idles(collective_ranks):
    for rank in collective_ranks:
        assert rank["restored"]
        assert rank["idle"] == {}


def test_collective_audit_counts_equal_the_mesh(collective_ranks):
    for rank in collective_ranks:
        counts = rank["healthy"]
        assert counts["predict"] == counts["mesh_predict"] == S.FORECAST_COLLECTIVES
        assert counts["loss_grad"] == counts["mesh_loss_grad"] == S.STEP_COLLECTIVES
        findings, metrics = C.collective_findings(counts)
        assert findings == []
        assert metrics == {"devices": 2, "predict_collectives": 1, "grad_all_reduces": 2,
                           "grad_other_collectives": 0}


def test_seeded_broadcast_in_the_loss_is_found(collective_ranks):
    """The port's lint finds the broadcast (outside the mesh, and not an
    all_reduce); the reference's lint finds the matching non-psum one."""
    counts = collective_ranks[0]["broadcast"]
    assert counts["loss_grad"] == {"all_reduce": 2, "broadcast": 1}
    messages = [f.message for f in C.collective_findings(counts)[0]]
    assert any("non-all-reduce" in m for m in messages)
    assert any("bypasses the mesh" in m for m in messages)
    ref, _ = jcollectives.collective_findings(
        {"devices": 2, "predict": {}, "loss_grad": {"all-reduce": 2, "broadcast": 1}})
    assert any("non-psum" in f.message for f in ref)


def test_healthy_counts_pass():
    counts = {"devices": 8, "predict": {"all_reduce": 1}, "loss_grad": {"all_reduce": 2}}
    findings, metrics = C.collective_findings(counts)
    assert findings == []
    assert metrics == {"devices": 8, "predict_collectives": 1, "grad_all_reduces": 2,
                       "grad_other_collectives": 0}


@pytest.mark.parametrize("predict", [{}, {"all_reduce": 1, "all_gather": 2},
                                     {"all_reduce": 2}])
def test_collective_in_predict_is_flagged(predict):
    counts = {"devices": 8, "predict": predict, "loss_grad": {"all_reduce": 2}}
    findings, _ = C.collective_findings(counts)
    assert any("sharded predict" in f.message for f in findings)


def test_non_all_reduce_gradient_collective_is_flagged():
    counts = {"devices": 8, "predict": {"all_reduce": 1},
              "loss_grad": {"all_reduce": 2, "all_gather": 1}}
    findings, _ = C.collective_findings(counts)
    assert any("non-all-reduce" in f.message for f in findings)


@pytest.mark.parametrize("grad", [{}, {"all_reduce": 1}, {"all_reduce": 3}])
def test_wrong_gradient_all_reduce_count_is_flagged(grad):
    counts = {"devices": 8, "predict": {"all_reduce": 1}, "loss_grad": grad}
    findings, _ = C.collective_findings(counts)
    assert any("all_reduce, the step documents 2" in f.message for f in findings)


# ---------------------------------------------------------------------------
# the port's report against the reference's
# ---------------------------------------------------------------------------


def _reference_report(over):
    spec = jax_smoke_spec("esrnn-quarterly", **over)
    _, jparams, _, _ = janalysis._probe_model(spec)
    return janalysis.run_audit(spec).to_dict(), jax.tree_util.tree_map(np.asarray, jparams)


def _port_report(over, jparams):
    spec = get_smoke_spec("esrnn-quarterly", **over)
    sections = [fn(spec, device="cpu", params=params_from_numpy(jparams, "cpu"))
                for fn in (A.audit_fit, A.audit_predict, A.audit_serve)]
    return A.AuditReport(spec.name, sections).to_dict()


def _metric(report, section, *keys):
    value = next(s for s in report["sections"] if s["name"] == section)["metrics"]
    for k in keys:
        value = value[k]
    return value


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_report_matches_the_reference(preset, reference_jaxpr_walk):
    ref, jparams = _reference_report(PRESETS[preset])
    got = _port_report(PRESETS[preset], jparams)
    assert got.keys() == ref.keys()
    assert [s["name"] for s in got["sections"]] == [s["name"] for s in ref["sections"]]
    assert got["ok"] is ref["ok"] is True
    assert got["violations_total"] == ref["violations_total"] == 0
    for keys in (("gradient_leak", "frozen_leaves"), ("gradient_leak", "passthrough_ok"),
                 ("dtype", "f64_avals"), ("donation", "expected_aliases"),
                 ("donation", "aliased_buffers")):
        assert _metric(got, "fit", *keys) == _metric(ref, "fit", *keys), keys
    assert _metric(got, "predict", "dtype", "f64_avals") == 0
    for key in ("compile_budget", "bucket_compiles", "cache_hits"):
        assert _metric(got, "serve", key) == _metric(ref, "serve", key), key
    # a warm wave adds nothing, in both packages
    assert _metric(ref, "serve", "wave_xla_compiles")[-1] == 0
    assert _metric(got, "serve", "wave_launch_shapes")[-1] == 0
    assert _metric(got, "serve", "launch_shapes") <= _metric(got, "serve",
                                                             "launch_shape_budget")
    if preset == "esn":
        assert _metric(got, "fit", "gradient_leak", "frozen_leaves") == 12


# ---------------------------------------------------------------------------
# seeded violations through the real entry points, and the reference's
# ---------------------------------------------------------------------------


def _lints(section):
    return {f.lint for f in section.violations}


def test_seeded_trainable_reservoir(reference_jaxpr_walk):
    """The esn step built with no frozen group: the reservoir takes moments,
    gradients and updates. The port's and the reference's lints both fire."""
    spec = get_smoke_spec("esn-quarterly")
    cfg, params, y, cats = A.probe_model(spec, "cpu")
    frozen = frozen_param_groups(cfg)
    step, opt_init, _ = A.fit_step(spec, cfg, y, cats, frozenset())
    section = A.audit_step(cfg, step, params, opt_init(params), frozen)
    assert _lints(section) == {"gradient-leak"}
    leak = section.metrics["gradient_leak"]
    assert leak["passthrough_ok"] == 0
    assert leak["frozen_accumulate_grads"] == leak["frozen_leaves"] == 12
    assert leak["grad_op_hits"] > 0
    assert any("carries moments" in f.message for f in section.violations)
    # on the card the full K5 would launch where the dx-only one should
    found, _ = launch_findings(cfg, frozen, {"lstm_cell_bwd": 101}, 101)
    assert found and found[0].lint == "gradient-leak"
    assert launch_findings(cfg, frozen, {"lstm_cell_bwd_dx": 101}, 101)[0] == []

    from repro.train.engine import make_step_fn
    from repro.train.optimizer import AdamConfig as JAdam
    from repro.train.optimizer import adam_init as jadam_init

    jspec = jax_smoke_spec("esn-quarterly")
    jcfg, jparams, jy, jcats = janalysis._probe_model(jspec)
    jstep = make_step_fn(jcfg, JAdam(lr=jspec.rnn_lr), jnp.asarray(jy), jnp.asarray(jcats),
                         jnp.ones(jy.shape, jnp.float32), frozen=frozenset())
    ref, _ = jgradleak.gradient_leak_findings(
        jstep, jparams, jadam_init(jparams), jnp.arange(5) % 15, frozenset({"rnn"}))
    assert ref and {f.lint for f in ref} == {"gradient-leak"}


def test_seeded_float64_constant_in_the_loss(reference_jaxpr_walk):
    """A float64 zero added to the step's loss."""
    real = engine.esrnn_loss_fn

    def f64_loss(*args, **kwargs):
        loss = real(*args, **kwargs)
        return loss + torch.zeros((), dtype=torch.float64)

    with mock.patch.object(engine, "esrnn_loss_fn", f64_loss):
        section = A.audit_fit(get_smoke_spec("esrnn-quarterly"), device="cpu")
    assert _lints(section) == {"dtype-policy"}
    assert section.metrics["dtype"]["f64_avals"] > 0
    assert section.metrics["accumulation"]["loss_dtype"] == "float64"

    from repro.core.esrnn import esrnn_loss

    jspec = jax_smoke_spec("esrnn-quarterly")
    jcfg, jparams, jy, jcats = janalysis._probe_model(jspec)
    with jax.enable_x64(True):
        jaxpr = jax.make_jaxpr(lambda p: esrnn_loss(jcfg, p, jy, jcats)
                               + jnp.zeros((), jnp.float64))(jparams)
    ref, _ = jdtypes.dtype_findings(jaxpr, policy_dtype="float32")
    assert any("f64 promotion" in f.message for f in ref)


def test_seeded_replaced_moment():
    """A step that rebinds a moment to a fresh tensor each step."""
    spec = get_smoke_spec("esrnn-quarterly")
    cfg, params, y, cats = A.probe_model(spec, "cpu")
    step, opt_init, _ = A.fit_step(spec, cfg, y, cats, frozenset())

    def replacing(p, o, idx):
        p, o, loss = step(p, o, idx)
        o["mu"][0] = o["mu"][0].clone()
        return p, o, loss

    section = A.audit_step(cfg, replacing, params, opt_init(params), frozenset())
    assert _lints(section) == {"donation"}
    don = section.metrics["donation"]
    assert don["aliased_buffers"] == don["expected_aliases"] - 1

    def toy(donate):
        f = jax.jit(lambda s, x: (s + x, jnp.sum(x)), donate_argnums=(0,) if donate else ())
        return f.lower(jnp.zeros(128), jnp.ones(128)).compile()

    assert jdonation.donation_findings(toy(True), 1)[0] == []
    assert any("donated-but-copied" in f.message
               for f in jdonation.donation_findings(toy(False), 1)[0])


def test_seeded_unpadded_dispatcher():
    """The dispatcher that skips batch padding: its repeated buckets issue
    new kernel shapes. The reference's counter catches its fc[:n] family."""
    section = A.audit_serve(get_smoke_spec("esrnn-quarterly"), device="cpu",
                            dispatcher=UnpaddedDispatcher)
    assert _lints(section) == {"recompile"}
    assert section.metrics["repeat_launch_shapes"] > 0
    assert section.metrics["bucket_compiles"] <= section.metrics["compile_budget"]

    fc = jnp.arange(47.0) + 1.0
    with jrecompile.CompileCounter() as counter:
        with pytest.raises(jrecompile.CompileBudgetExceeded):
            with counter.expect(budget=1, what="partial-fill slices"):
                for n in (3, 5, 7):
                    _ = fc[:n]


def test_trace_holds_the_step_outputs():
    spec = get_smoke_spec("esrnn-quarterly")
    cfg, params, y, cats = A.probe_model(spec, "cpu")
    step, opt_init, _ = A.fit_step(spec, cfg, y, cats, frozenset())
    trace = Trace()
    findings, metrics = gradient_leak_findings(step, params, opt_init(params),
                                               torch.arange(5), frozenset(), trace=trace)
    assert findings == []
    new_params, new_opt, loss = trace.outputs
    assert new_params["hw"] is params["hw"] and loss.shape == ()
    assert metrics["backward_ops"] == len(trace.ops.backward_ops()) > 0
    assert trace.graph.nodes == metrics["graph_nodes"] > 0
