"""The rank side of ``tests/test_torch_tp_serve.py``: what each rank of a gloo
host mesh on the CPU runs, returning plain numpy and Python values.

Spawned ranks import this module by name, so it imports neither JAX nor the
JAX package: the test process computes the references and compares.
"""

from __future__ import annotations

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import draw_inputs, generate
from repro_torch.models import moe as MOE
from repro_torch.models.model import build_model
from repro_torch.sharding import ctx, specs, tp

BATCH, PROMPT, STEPS, SEED = 2, 12, 4, 5


def _numpy(tree, path=()):
    """{path: float32 numpy} of a cache nest (lengths as ints)."""
    out = {}
    for p, leaf in specs.tree_leaves_with_path(tree):
        out["/".join(p)] = leaf if isinstance(leaf, int) else leaf.float().numpy().copy()
    return out


def serve_case(mesh, arch, batch=BATCH, prompt_len=PROMPT, steps=STEPS, seed=SEED):
    """``arch``'s SMOKE model from ``seed`` cut to this rank's share, its
    rows of the serve launcher's inputs: the prefill and ``steps`` greedy
    decode steps under the mesh's context. Returns every step's logits and
    the caches after the prefill and after the last step (both gathered back
    to one device's layout), the greedy tokens, every MoE call's routing,
    and the collectives of the prefill and of each decode step."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = tp.shard_lm_params(
        cfg, model.init(torch.Generator().manual_seed(seed)), mesh)
    prompts, extra = draw_inputs(cfg, batch, prompt_len, seed, "cpu")
    rows = tp.batch_rows(mesh, batch)
    offset = cfg.n_patches if cfg.family == "vlm" else 0
    routing, real = [], MOE.moe_route

    def route(*a, **k):
        r = real(*a, **k)
        routing.append({f: getattr(r, f).numpy().copy() for f in ("top_ids", "pos", "keep")})
        return r

    MOE.moe_route = route
    out = {"logits": [], "collectives": []}
    try:
        with ctx.activation_sharding(mesh, dp="data", tp="model"), torch.no_grad():
            mesh.reset_counts()
            logits, caches = model.prefill(
                params, {"tokens": prompts[rows], **{k: v[rows] for k, v in extra.items()}},
                prompt_len + offset + steps + 1)
            out["collectives"].append(mesh.collective_counts())
            out["caches_prefill"] = _numpy(tp.gather_caches(cfg, mesh, caches, batch))
            tokens = []
            for i in range(steps + 1):
                full = tp.gather_rows(mesh, logits[:, -1], batch)
                out["logits"].append(full.numpy().copy())
                tok = full.argmax(dim=-1)
                tokens.append(tok.numpy().copy())
                if i == steps:
                    break
                pos = torch.full((batch, 1), prompt_len + offset + i, dtype=torch.int64)
                mesh.reset_counts()
                logits, caches = model.decode(
                    params, {"tokens": tok[rows, None], "positions": pos[rows]}, caches)
                out["collectives"].append(mesh.collective_counts())
            out["caches_last"] = _numpy(tp.gather_caches(cfg, mesh, caches, batch))
    finally:
        MOE.moe_route = real
    out["tokens"] = tokens
    out["routing"] = routing
    out["local_kv_heads"] = _local_kv_heads(cfg, params)
    return out


def _local_kv_heads(cfg, params):
    """The kv heads of this rank's first attention (None: MLA, ssm)."""
    if cfg.family == "ssm" or cfg.use_mla:
        return None
    attn = (params["shared"] if "shared" in params
            else (params.get("layers") or params["dec_layers"])[0])["attn"]
    return attn["wk"].shape[1] // cfg.hd


def generate_case(mesh, arch, batch=BATCH, prompt_len=PROMPT, gen=STEPS + 1, seed=SEED):
    """``generate`` under the mesh's context (the serve launcher's loop):
    its tokens and collectives."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    params = tp.shard_lm_params(cfg, model.init(torch.Generator().manual_seed(seed)), mesh)
    prompts, extra = draw_inputs(cfg, batch, prompt_len, seed, "cpu")
    rows = tp.batch_rows(mesh, batch)
    with ctx.activation_sharding(mesh, dp="data", tp="model"):
        out = generate(model, params, prompts[rows], gen,
                       **{k: v[rows] for k, v in extra.items()})
    return {k: out[k] for k in ("generated", "collectives", "kernel_launches")}


def session(mesh, cases):
    """Every ``(kind, arch)`` of ``cases`` on ``mesh``, in order."""
    fns = {"serve": serve_case, "generate": generate_case}
    return [fns[kind](mesh, arch) for kind, arch in cases]


def session4(mesh, cases_1x4, cases_2x2):
    """The 4-rank session: ``cases_1x4`` on the (1, 4) mesh the ranks were
    started with, then ``cases_2x2`` on a (2, 2) mesh over the same ranks."""
    first = session(mesh, cases_1x4)
    mesh22 = make_host_mesh(2, device="cpu")
    return first, session(mesh22, cases_2x2), dict(mesh22.shape)
