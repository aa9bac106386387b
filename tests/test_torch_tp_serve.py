"""Tensor-parallel serving of the port (``serve(model_parallel > 1)``) on the CPU.

Ranks are gloo processes spawned by ``repro_torch.sharding.run_ranks`` on a
host mesh (``repro_torch.launch.mesh.make_host_mesh``): one 2-rank session,
mesh (1, 2), for every arch's SMOKE config, and one 4-rank session for
chatglm3-6b's SMOKE at (1, 4) (2 kv heads over 4 ranks: each rank holds the
kv head its q head reads) and yi-6b's at (2, 2) (the batch split on
``data``). Each rank cuts the model from the seed to its share
(``repro_torch.sharding.tp.shard_lm_params``) and runs the prefill and 4
greedy decode steps under the mesh's activation context
(``tests/torch_tp_ranks.py``, which imports no JAX), returning the logits,
the caches gathered back to one device's layout, the tokens, every MoE
call's routing and its collectives. This process holds them to:

* the port's one-device run of the same weights and inputs: logits within
  rtol 1e-5 / atol 1e-6, every cache within rtol 1e-5 and an atol of 1e-6
  times the leaf's largest magnitude (fp32 partial sums over the ranks, in
  another order: the K/V and MLA latents reach 3-4 here, where 1e-6 is
  4 ulps; they sit up to 2.4e-6 apart), greedy tokens identical;
* every rank the same tokens and logits, and MoE routing (top-k ids, slots,
  keep) identical on every rank and to one device;
* the collectives of the prefill and of each decode step equal to
  ``tp.collectives_per_call`` (a dense layer: one all-reduce after ``wo``,
  one after ``w_down``; one each for the embedding and the logits where the
  vocabulary is cut), none on ``data``;
* the greedy loop against the JAX model's prefill and decode on the same
  numpy weights, as ``tests/test_torch_lm.py`` holds the one-device loop
  (the reference's serve launcher fails on the installed jax, ROADMAP F5).

``serve(model_parallel=2)`` itself spawns its ranks and returns the
one-device serve's tokens; a layout the plan cannot cut makes the call raise
(no fallback to one rank).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks as R
from repro import configs as jconfigs
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.convert import lm_params_to_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import draw_inputs
from repro_torch.models.model import build_model
from repro_torch.sharding import run_ranks, tp

TOL = dict(rtol=1e-5, atol=1e-6)
CACHE_RTOL, CACHE_ATOL_SCALE = 1e-5, 1e-6
MOE_ARCHS = [a for a in ARCHS if get_smoke_config(a).family == "moe"]
CASES_2 = [("serve", a) for a in ARCHS] + [("generate", "yi-6b"), ("generate", "whisper-base")]
CASES_1X4 = [("serve", "chatglm3-6b")]
CASES_2X2 = [("serve", "yi-6b"), ("generate", "yi-6b")]


@pytest.fixture(scope="module")
def two():
    """The 2-rank session's results: ``two[rank][case]``."""
    return run_ranks(R.session, 2, device="cpu", args=(CASES_2,),
                     mesh_factory=functools.partial(make_host_mesh, 2))


@pytest.fixture(scope="module")
def four():
    """``four[rank]`` = (the (1, 4) cases, the (2, 2) cases, that mesh's shape)."""
    return run_ranks(R.session4, 4, device="cpu", args=(CASES_1X4, CASES_2X2),
                     mesh_factory=functools.partial(make_host_mesh, 4))


@functools.lru_cache(maxsize=None)
def one_device(arch):
    """The same case on one device: a (1, 1) host mesh, whose context is the
    single-device path."""
    return R.serve_case(make_host_mesh(1, device="cpu"), arch)


def _case(results, kind, arch, cases=CASES_2):
    return results[cases.index((kind, arch))]


def _assert_like_one_device(got, arch):
    want = one_device(arch)
    assert len(got["logits"]) == len(want["logits"]) == R.STEPS + 1
    for step, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"{arch} logits, step {step}")
    for part in ("caches_prefill", "caches_last"):
        assert set(got[part]) == set(want[part])
        for k, w in want[part].items():
            if isinstance(w, int):
                assert got[part][k] == w, (arch, part, k)
            else:
                assert got[part][k].shape == w.shape, (arch, part, k)
                np.testing.assert_allclose(
                    got[part][k], w, rtol=CACHE_RTOL,
                    atol=CACHE_ATOL_SCALE * max(float(np.abs(w).max()), 1.0),
                    err_msg=f"{arch} {part} {k}")
    np.testing.assert_array_equal(np.stack(got["tokens"]), np.stack(want["tokens"]))


def _assert_collectives(got, arch, model_size):
    cfg = get_smoke_config(arch)
    want = [tp.collectives_per_call(cfg, model_size, prefill=i == 0)
            for i in range(R.STEPS + 1)]
    assert got["collectives"] == [{"model": {"all_reduce": n}} if n else {} for n in want], arch


@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_match_one_device(two, arch):
    for rank in (0, 1):
        _assert_like_one_device(_case(two[rank], "serve", arch), arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_agree(two, arch):
    a, b = (_case(two[r], "serve", arch) for r in (0, 1))
    np.testing.assert_array_equal(np.stack(a["tokens"]), np.stack(b["tokens"]))
    for la, lb in zip(a["logits"], b["logits"]):
        np.testing.assert_array_equal(la, lb)
    cfg = get_smoke_config(arch)
    if cfg.family != "ssm" and not cfg.use_mla:
        assert a["local_kv_heads"] == cfg.n_kv_heads // 2


@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_collectives_as_documented(two, arch):
    for rank in (0, 1):
        _assert_collectives(_case(two[rank], "serve", arch), arch, 2)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_routing_identical_on_every_rank(two, arch):
    want = one_device(arch)["routing"]
    assert want
    for rank in (0, 1):
        got = _case(two[rank], "serve", arch)["routing"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for f in ("top_ids", "pos", "keep"):
                np.testing.assert_array_equal(g[f], w[f])


@pytest.mark.parametrize("arch", ["yi-6b", "whisper-base"])
def test_generate_under_the_mesh_counts_its_collectives(two, arch):
    cfg = get_smoke_config(arch)
    got = _case(two[0], "generate", arch)
    want_tokens = np.stack(one_device(arch)["tokens"], axis=1)
    np.testing.assert_array_equal(got["generated"], want_tokens)
    per_step = tp.collectives_per_call(cfg, 2, prefill=False)
    assert got["collectives"] == {
        "prefill": {"model": {"all_reduce": tp.collectives_per_call(cfg, 2, prefill=True)}},
        "decode": {"model": {"all_reduce": per_step * R.STEPS}}}
    assert got["kernel_launches"]["prefill"]["flash_attention"] == 0   # the CPU path


def test_chatglm3_two_kv_heads_over_four_ranks(four):
    """(1, 4): each rank one q head and the one kv head it reads (ranks 0, 1
    kv head 0; ranks 2, 3 kv head 1)."""
    for rank in range(4):
        got = four[rank][0][0]
        assert got["local_kv_heads"] == 1
        _assert_like_one_device(got, "chatglm3-6b")
        _assert_collectives(got, "chatglm3-6b", 4)


def test_yi_on_a_two_by_two_mesh(four):
    """(2, 2): each data row serves one of the 2 prompts on 2 model ranks;
    the gathered logits and caches are one device's."""
    for rank in range(4):
        serve_rec, gen_rec = four[rank][1]
        assert four[rank][2] == {"data": 2, "model": 2}
        _assert_like_one_device(serve_rec, "yi-6b")
        _assert_collectives(serve_rec, "yi-6b", 2)
        np.testing.assert_array_equal(gen_rec["generated"][:, :],
                                      np.stack(one_device("yi-6b")["tokens"], axis=1)
                                      [R.BATCH // 2 * (rank // 2):R.BATCH // 2 * (rank // 2 + 1)])


def _jax_greedy(arch):
    """The JAX model's prefill and greedy decode on the port's weights (from
    the ranks' seed, converted) and the serve launcher's inputs."""
    cfg = get_smoke_config(arch)
    jcfg = jconfigs.get_smoke_config(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(R.SEED))
    jp = lm_params_to_numpy(params)
    jmodel = jbuild_model(jcfg, use_pallas=False)
    prompts, extra = draw_inputs(cfg, R.BATCH, R.PROMPT, R.SEED)
    jbatch = {"tokens": jnp.asarray(prompts.numpy(), jnp.int32)}
    jbatch.update({k: jnp.asarray(v.float().numpy(), jcfg.jdtype) for k, v in extra.items()})
    offset = jcfg.n_patches if jcfg.family == "vlm" else 0
    logits, caches = jax.jit(lambda p, b: jmodel.prefill(p, b, R.PROMPT + offset + R.STEPS + 1))(
        jp, jbatch)
    decode = jax.jit(jmodel.decode)
    tokens = [np.asarray(jnp.argmax(logits[:, -1], axis=-1))]
    for i in range(R.STEPS):
        pos = jnp.full((R.BATCH, 1), R.PROMPT + offset + i, jnp.int32)
        logits, caches = decode(jp, {"tokens": jnp.asarray(tokens[-1])[:, None].astype(jnp.int32),
                                     "positions": pos}, caches)
        tokens.append(np.asarray(jnp.argmax(logits[:, -1], axis=-1)))
    return np.stack(tokens)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_greedy_tokens_match_jax(two, arch):
    np.testing.assert_array_equal(np.stack(_case(two[0], "serve", arch)["tokens"]),
                                  _jax_greedy(arch))


def test_serve_model_parallel_spawns_its_ranks():
    """The launcher's entry point: the reference's keys, rank 0's result with
    every row, the one-device serve's tokens, the mesh and backend named."""
    got = tserve.serve("qwen2.5-14b", smoke=True, batch=2, prompt_len=8, gen=4, device="cpu",
                       model_parallel=2)
    want = tserve.serve("qwen2.5-14b", smoke=True, batch=2, prompt_len=8, gen=4, device="cpu")
    assert {"generated", "prefill_s", "decode_s_per_tok"} <= set(got)
    assert got["generated"].dtype == np.int32 and got["generated"].shape == (2, 4)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert got["mesh"] == {"data": 1, "model": 2, "backend": "gloo"}
    cfg = get_smoke_config("qwen2.5-14b")
    assert got["collectives"]["prefill"] == {
        "model": {"all_reduce": tp.collectives_per_call(cfg, 2, prefill=True)}}


def test_serve_model_parallel_raises_without_a_fallback():
    """4 heads over 3 ranks cannot be cut on head boundaries: every rank
    raises, and so does the call; it does not serve on one rank instead."""
    with pytest.raises(RuntimeError, match="NotImplementedError"):
        tserve.serve("yi-6b", smoke=True, batch=1, prompt_len=4, gen=2, device="cpu",
                     model_parallel=3)


def test_host_mesh_without_a_process_group():
    mesh = make_host_mesh(1, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.backend is None
    with pytest.raises(ValueError, match="init_process_group"):
        make_host_mesh(2, device="cpu")
