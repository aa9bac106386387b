"""Sharded LM training of the port (``train(model_parallel > 1)``) on the CPU.

Ranks are gloo processes spawned by ``repro_torch.sharding.run_ranks`` on a
host mesh: one 2-rank session, every arch's SMOKE config on (1, 2) and
yi-6b and qwen3-moe on (2, 1), and one 4-rank session, every arch on (2,
2). Each rank runs the sharded train step of the training plan
(``repro_torch.sharding.fsdp``: FSDP on ``data``, heads, hidden units and
the MoE experts on ``model``) in ``tests/torch_tp_train_ranks.py``, which
imports no JAX. This process holds them to (the bf16 steps against the
reference's in ``tests/test_torch_tp_train_bf16.py`` and
``tests/test_torch_tp_train_update.py``):

* fp32 compute, one step (global batch 4 in 2 microbatches) against the
  port's one-device step on the same masters and rows: the loss within rtol
  1e-5, every gradient Adam is given (gathered to one device's layout)
  within 1e-5 of its leaf's largest element, the global clip norm within
  rtol 1e-5 (a leaf whole on an axis counted once), MoE routing of each
  rank's rows identical to one device's;
* each rank's collectives by (axis, op) equal to ``fsdp.step_collectives``;
* each rank's leaf shapes equal to the partition rules' (``specs.param_spec``
  in mode ``"train"``) but for the documented ``fsdp.DIFFERS_FROM_SPEC``,
  and its bytes of masters and Adam state equal to ``launch/dryrun.py``'s
  reckoning for the mesh, that difference added;
* with remat (every layer recomputed in the backward, under the forward's
  context) the same loss and gradients, for the MoE, hybrid and encdec
  families;
* a layout the plan cannot cut (2 kv heads on 4 model ranks) raising;
* checkpoints in the reference's whole-leaf layout: written on one device
  and resumed by the train launcher on (2, 2), and written on (2, 2) and
  resumed on one device, each giving the unbroken one-device run's losses.
"""

import functools

import numpy as np
import pytest

import torch_tp_train_ranks as R
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import train as TT
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh
from repro_torch.models.model import build_model
from repro_torch.sharding import fsdp, run_ranks

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-5
RESUME_RTOL = 1e-4
EXTRA = ["yi-6b", "qwen3-moe-30b-a3b"]
REMAT = ["qwen3-moe-30b-a3b", "zamba2-2.7b", "whisper-base"]


@pytest.fixture(scope="module")
def two():
    """``two[rank]`` = ({arch: grads} on (1, 2), the same for ``EXTRA`` on
    (2, 1), that mesh's shape)."""
    return run_ranks(R.session, 2, device="cpu", args=("grads", ARCHS, EXTRA),
                     mesh_factory=functools.partial(make_host_mesh, 2))


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """``four[rank]``: the (2, 2) session; ``four["one_ckpt"]`` the
    one-device run that wrote the checkpoint the ranks resume,
    ``four["ckpt"]`` the directory they wrote."""
    one_dir = str(tmp_path_factory.mktemp("one_device_ckpt"))
    mesh_dir = str(tmp_path_factory.mktemp("mesh_ckpt"))
    kw = dict(smoke=True, batch=R.GLOBAL, seq=R.SEQ, microbatch=R.MICRO, seed=R.SEED,
              device="cpu")
    TT.train("yi-6b", steps=2, ckpt_dir=one_dir, **kw)
    out = run_ranks(R.session4, 4, device="cpu",
                    args=("grads", ARCHS, one_dir, mesh_dir, REMAT),
                    mesh_factory=functools.partial(make_host_mesh, 2))
    return dict(enumerate(out), ckpt=mesh_dir)


@functools.lru_cache(maxsize=None)
def one_device(arch, remat=False):
    return R.grads_case(make_host_mesh(1, device="cpu"), arch, remat)


@functools.lru_cache(maxsize=None)
def unbroken(steps=4):
    return TT.train("yi-6b", smoke=True, steps=steps, batch=R.GLOBAL, seq=R.SEQ,
                    microbatch=R.MICRO, seed=R.SEED, device="cpu")["losses"]


def arch_cases(two, four, arch):
    """(mesh name, rank, result) of every case of ``arch``."""
    out = []
    for rank in (0, 1):
        out += [("(1, 2)", rank, two[rank][0][arch])]
        if arch in EXTRA:
            out += [("(2, 1)", rank, two[rank][1][arch])]
    return out + [("(2, 2)", rank, four[rank]["archs"][arch]) for rank in range(4)]


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_step_matches_one_device(two, four, arch):
    want = one_device(arch)
    for mesh, rank, got in arch_cases(two, four, arch):
        _assert_like(got, want, f"{arch} on {mesh}, rank {rank}")


def _assert_like(got, want, where):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL, err_msg=where)
    np.testing.assert_allclose(got["norm"], want["norm"], rtol=LOSS_RTOL, err_msg=where)
    assert got["grads"].keys() == want["grads"].keys()
    for k, w in want["grads"].items():
        g = got["grads"][k]
        assert g.shape == w.shape, (where, k)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= GRAD_TOL * scale, (where, k)


@pytest.mark.parametrize("arch", REMAT)
def test_remat_step_matches_one_device(four, arch):
    """Every layer recomputed in the backward (a MoE layer its attention
    half) under the mesh's context: the one-device step's loss and
    gradients, the ``data`` collectives unchanged, and on ``model`` the
    recomputes' forward all-reduces added (none where a recompute stops
    before its last one: nothing after it is saved)."""
    want = one_device(arch)
    assert one_device(arch, True)["loss"] == want["loss"]
    for rank in range(4):
        got = four[rank]["remat"][arch]
        _assert_like(got, want, f"{arch} with remat on (2, 2), rank {rank}")
        assert got["collectives"]["data"] == got["want_collectives"]["data"]
        assert got["collectives"]["model"]["all_reduce"] >= \
            got["want_collectives"]["model"]["all_reduce"]


@pytest.mark.parametrize("arch", [a for a in ARCHS if get_smoke_config(a).family == "moe"])
def test_moe_routing_of_each_ranks_rows(two, four, arch):
    want = one_device(arch)["routing"]
    assert want
    for mesh, rank, got in arch_cases(two, four, arch):
        lo, hi = got["rows"]
        assert len(got["routing"]) == len(want)
        for g, w in zip(got["routing"], want):
            for f in ("top_ids", "pos", "keep"):
                np.testing.assert_array_equal(g[f], w[f][lo:hi], err_msg=f"{arch} {mesh} {rank}")


@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_as_documented(two, four, arch):
    for mesh, rank, got in arch_cases(two, four, arch):
        assert got["collectives"] == got["want_collectives"], (arch, mesh, rank)
        assert got["collectives"]["model" if mesh != "(2, 1)" else "data"]


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_bytes_equal_the_dry_run(two, four, arch):
    """Every leaf's shard as the spec lays it out, but the documented
    differences; the rank's bytes of masters, mu and nu the dry-run's for
    the mesh (less its int32 step: the port's is an int)."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    shapes = {"(1, 2)": (1, 2), "(2, 1)": (2, 1), "(2, 2)": (2, 2)}
    for mesh, rank, got in arch_cases(two, four, arch):
        extra = 0
        for k, shape in got["local_shapes"].items():
            spec_shape = tuple(got["spec_shapes"][k])
            if k in got["differs"]:
                assert k.split("/")[-1] in fsdp.DIFFERS_FROM_SPEC, (arch, k)
                extra += 3 * 4 * (int(np.prod(shape)) - int(np.prod(spec_shape)))
            else:
                assert shape == spec_shape, (arch, mesh, k)
        want = dryrun.train_state_bytes(model, AbstractMesh(shapes[mesh], ("data", "model")))
        m = shapes[mesh][1]
        assert got["state_bytes"] == want["params"] + want["opt"] - 4 + extra, (arch, mesh)
        assert bool(got["differs"]) == (cfg.family == "hybrid" and m > 1)


def test_the_meshes_were_as_named(two, four):
    assert two[0][2] == {"data": 2, "model": 1}
    assert all(four[r]["mesh"] == {"data": 2, "model": 2} for r in range(4))


def test_a_layout_the_plan_cannot_cut_raises(four):
    for rank in range(4):
        assert four[rank]["refused"] and "kv head" in four[rank]["refused"]


def test_checkpoint_from_one_device_resumes_on_the_mesh(four):
    want = unbroken()
    for rank in range(4):
        got = four[rank]["resumed"]
        assert len(got["losses"]) == 2 and got["mesh"]["backend"] == "gloo"
        np.testing.assert_allclose(got["losses"], want[2:], rtol=RESUME_RTOL)
        assert got["collectives"]["data"]["all_gather"] > 0


def test_checkpoint_from_the_mesh_resumes_on_one_device(four):
    want = unbroken()
    np.testing.assert_allclose(four[0]["written_losses"], want[:2], rtol=RESUME_RTOL)
    rest = TT.train("yi-6b", smoke=True, steps=4, batch=R.GLOBAL, seq=R.SEQ,
                    microbatch=R.MICRO, seed=R.SEED, device="cpu", ckpt_dir=four["ckpt"])
    np.testing.assert_allclose(rest["losses"], want[2:], rtol=RESUME_RTOL)
