"""The rank side of ``tests/test_torch_tp_train.py`` and
``tests/test_torch_tp_train_bf16.py``: what each rank of a gloo host mesh
on the CPU runs for sharded LM training, returning plain numpy and Python
values.

Spawned ranks import this module by name, so it imports neither JAX nor the
JAX package: the test process computes the references and compares.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import ShapeCell, get_smoke_config
from repro_torch.core.esrnn import param_leaves
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import fp32_masters, synthetic_batch, train_on_mesh
from repro_torch.models import moe as MOE
from repro_torch.models.model import build_model
from repro_torch.sharding import ctx, fsdp, specs
from repro_torch.train import optimizer as TO

SEED, SEQ, GLOBAL, MICRO, STEPS = 3, 16, 4, 2, 3
N_MICRO = GLOBAL // MICRO
# the launcher's Adam, and the one of tests/test_torch_lm_train_step.py whose
# step is about -(lr / eps) x the mean gradient (the launcher's moves each
# weight by about lr x sign(g), so a gradient that sums ranks' bf16 partials
# flips the step of the elements whose sum nearly cancels)
ADAMS = {"launcher": dict(lr=3e-4, clip_norm=1.0), "linear": dict(lr=10.0, eps=1e3)}
ADAM = ADAMS["launcher"]


def cell():
    return ShapeCell("t", "train", SEQ, GLOBAL, microbatch=MICRO)


def name(path) -> str:
    return "/".join(str(k) for k in path)


def init(arch, remat=False, device="cpu"):
    """``arch``'s SMOKE model (``remat`` as given) and its fp32 masters from
    ``SEED``, drawn on ``device``."""
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    model = build_model(cfg)
    return cfg, model, fp32_masters(model.init(torch.Generator(device=device).manual_seed(SEED)))


def _step(mesh, model, compute_dtype, adam=ADAM):
    with ctx.activation_sharding(mesh, dp="data", tp="model"):
        return S.make_train_step(model, cell(), adam=TO.AdamConfig(**adam),
                                 compute_dtype=compute_dtype)


def grads_case(mesh, arch, remat=False):
    """One fp32-compute train step of ``arch`` on ``mesh`` (on a (1, 1) mesh
    the one-device step): its loss, the gradients Adam was given (gathered
    to one device's layout), their global norm as the step's clip saw it,
    every MoE call's routing of the rank's rows, the step's collectives
    beside ``fsdp.step_collectives``, and the rank's layout: each leaf's
    local shape beside the spec's, and its bytes of masters and Adam
    state. With ``remat`` every layer is recomputed in the backward, on
    the mesh's device."""
    cfg, model, full = init(arch, remat, mesh.device)
    step = _step(mesh, model, torch.float32)
    plan = getattr(step, "plan", None)
    batch = synthetic_batch(cfg, cell(), 0, SEED, mesh.device)
    seen, real_adam, real_route = {}, S.adam_update, MOE.moe_route
    routing = []

    def adam(grads, opt_state, params, cfg_, **kw):
        seen["grads"] = [g.clone() for g in grads]
        seen["sq_reduce"] = kw.get("sq_reduce")
        return real_adam(grads, opt_state, params, cfg_, **kw)

    def route(*a, **k):
        r = real_route(*a, **k)
        routing.append({f: getattr(r, f).cpu().numpy() for f in ("top_ids", "pos", "keep")})
        return r

    masters = full if plan is None else plan.shard(full)
    S.adam_update, MOE.moe_route = adam, route
    try:
        mesh.reset_counts()
        _, _, loss = step(masters, TO.adam_init(masters), batch)
        collectives = mesh.collective_counts()
    finally:
        S.adam_update, MOE.moe_route = real_adam, real_route
    out = {"loss": float(loss), "routing": routing, "collectives": collectives}
    grads = seen["grads"]
    with torch.no_grad():
        out["norm"] = float(TO.global_norm(grads, seen["sq_reduce"]))
        if plan is not None:
            grads = plan.gather_list(grads)
    out["grads"] = {name(p): g.cpu().numpy().copy()
                    for (p, _), g in zip(param_leaves(full), grads, strict=True)}
    if plan is not None:
        out["want_collectives"] = fsdp.step_collectives(cfg, plan, N_MICRO)
        out["rows"] = (plan.rows(MICRO).start, plan.rows(MICRO).stop)
        out["local_shapes"] = {name(p): tuple(t.shape) for p, t in param_leaves(masters)}
        out["spec_shapes"] = {name(lp.path): specs.local_shape(lp.shape, lp.spec, mesh)
                              for lp in plan.leaves}
        opt = TO.adam_init(masters)
        out["state_bytes"] = plan.local_bytes(masters) + sum(
            t.numel() * t.element_size() for t in opt["mu"] + opt["nu"])
        out["differs"] = sorted(plan.differs_from_spec())
    return out


def trajectory_case(mesh, arch, adam, steps=STEPS):
    """``steps`` train steps of ``arch`` under the default bf16 compute on
    ``mesh`` from the masters of ``SEED``, on the train launcher's batches,
    at ``ADAMS[adam]``: the losses and the masters after them (one device's
    layout)."""
    cfg, model, full = init(arch)
    step = _step(mesh, model, torch.bfloat16, ADAMS[adam])
    plan = getattr(step, "plan", None)
    masters = full if plan is None else plan.shard(full)
    opt = TO.adam_init(masters)
    losses = []
    for i in range(steps):
        masters, opt, loss = step(masters, opt, synthetic_batch(cfg, cell(), i, SEED))
        losses.append(float(loss))
    if plan is not None:
        masters = plan.gather(masters)
    return {"losses": losses,
            "params": {name(p): t.numpy().copy() for p, t in param_leaves(masters)}}


def _case(mesh, arch, kind):
    return grads_case(mesh, arch) if kind == "grads" else trajectory_case(mesh, arch, kind)


def session(mesh, kind, archs, extra_archs):
    """The 2-rank session: ``kind`` (``"grads"`` or an Adam of ``ADAMS``) of
    every arch on the (1, 2) mesh the ranks were started with, then of
    ``extra_archs`` on (2, 1) over the same ranks."""
    first = {a: _case(mesh, a, kind) for a in archs}
    mesh21 = make_host_mesh(1, device="cpu")
    second = {a: _case(mesh21, a, kind) for a in extra_archs}
    return first, second, dict(mesh21.shape)


def session4(mesh, kind, archs, ckpt_from_one_device=None, ckpt_dir=None, remat_archs=()):
    """The 4-rank session on (2, 2): ``kind`` of every arch; with
    ``"grads"`` also ``remat_archs`` recomputing every layer in the
    backward, a layout the plan cannot cut (yi-6b's 2 kv heads on a (1, 4)
    mesh), and the train launcher resuming a one-device checkpoint to step 4
    and writing one at step 2 for the test process to resume."""
    out = dict(archs={a: _case(mesh, a, kind) for a in archs}, mesh=dict(mesh.shape))
    if kind != "grads":
        return out
    out["remat"] = {a: grads_case(mesh, a, remat=True) for a in remat_archs}
    mesh14 = make_host_mesh(4, device="cpu")
    try:
        grads_case(mesh14, "yi-6b")
        out["refused"] = None
    except NotImplementedError as e:
        out["refused"] = str(e)
    kw = dict(smoke=True, batch=GLOBAL, seq=SEQ, microbatch=MICRO, seed=SEED)
    resumed = train_on_mesh(mesh, "yi-6b", steps=4, ckpt_dir=ckpt_from_one_device, **kw)
    written = train_on_mesh(mesh, "yi-6b", steps=2, ckpt_dir=ckpt_dir, **kw)
    out.update(resumed={k: resumed[k] for k in ("losses", "collectives", "mesh")},
               written_losses=written["losses"])
    return out
