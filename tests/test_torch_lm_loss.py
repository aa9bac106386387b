"""The port's LM losses and their gradients against the JAX package's.

Every registry arch at its SMOKE config (fp32): the reference's
``model.init`` weights converted with ``repro_torch.convert``, the same
numpy batch (tokens, labels, a vlm's image embeddings, an encdec model's
frames) through ``jax.value_and_grad(model.loss)`` (the reference's plain
attention, ``use_pallas=False``, its training path) and through the port's
``Model.loss`` with autograd on the CPU:

* the loss within rtol 1e-5 and every gradient leaf, stacked back into the
  reference's layout by ``lm_leaves_to_numpy``, within 1e-4 of that leaf's
  largest element (fp32 sums in another order; the archs sit near 3e-6);
* remat on (``cfg.remat``: each layer recomputed in the backward, a MoE
  layer's MLP half kept) equal to remat off bit for bit, loss and
  gradients, on the CPU;
* the vlm's image positions masked out of the loss, a batch ``loss_mask``,
  and the MoE aux term (0.01 x the layers' summed load-balancing loss),
  each on its own, against the reference;
* ``_silu`` (the Mamba2 block's) and ``gelu_tanh`` (whisper's MLP): their
  gradients against ``jax.grad`` over inputs down to -1e4, where
  ``exp(-x)`` overflows and autograd through the forward's expression
  would give NaN;
* ``cross_entropy_loss`` against the reference's;
* ``rope_freqs``: bit for bit the reference's exponents and frequencies at
  widths 64, 80 and 128.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models.model import build_model as jbuild_model
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_leaves_to_numpy, lm_params_from_numpy
from repro_torch.core.esrnn import param_leaves
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models import ssm as TS
from repro_torch.models.model import build_model

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
BATCH, SEQ = 2, 12
REMAT_ARCHS = ["granite-3-2b", "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b", "internvl2-2b",
               "whisper-base", "zamba2-2.7b", "mamba2-1.3b"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, seed=1, mask=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)}
    if cfg.family == "vlm":
        b["image_embeds"] = rng.normal(0, 1, (BATCH, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "encdec":
        b["frames"] = rng.normal(0, 1, (BATCH, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if mask:
        b["loss_mask"] = (rng.random((BATCH, SEQ)) < 0.6).astype(np.float32)
    return b


def _jax_loss_and_grads(arch, batch, **changes):
    cfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **changes)
    model = jbuild_model(cfg)
    jp = _np(model.init(jax.random.PRNGKey(0)))
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return jp, float(loss), _np(grads)


def _port_loss_and_grads(arch, jp, batch, **changes):
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **changes)
    params = lm_params_from_numpy(jp, "cpu")
    leaves = [t.requires_grad_(True) for _, t in param_leaves(params)]
    loss = build_model(cfg).loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return params, loss.detach(), [t.grad for t in leaves]


def _assert_grads_close(params, grads, want):
    got_leaves, got_def = jax.tree_util.tree_flatten(lm_leaves_to_numpy(params, grads))
    want_leaves, want_def = jax.tree_util.tree_flatten(want)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_TOL * max(np.abs(w).max(), 1e-30))


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_loss_and_grads_match_jax(arch):
    batch = _batch(jconfigs.get_smoke_config(arch))
    jp, want_loss, want_grads = _jax_loss_and_grads(arch, batch)
    params, loss, grads = _port_loss_and_grads(arch, jp, batch)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    _assert_grads_close(params, grads, want_grads)


@pytest.mark.parametrize("arch", ["granite-3-2b", "internvl2-2b", "whisper-base"])
def test_batch_loss_mask_matches_jax(arch):
    batch = _batch(jconfigs.get_smoke_config(arch), seed=4, mask=True)
    jp, want_loss, want_grads = _jax_loss_and_grads(arch, batch)
    params, loss, grads = _port_loss_and_grads(arch, jp, batch)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    _assert_grads_close(params, grads, want_grads)
    # the masked mean over the kept positions only
    unmasked = dict(batch)
    del unmasked["loss_mask"]
    with torch.no_grad():
        full = build_model(tconfigs.get_smoke_config(arch)).loss(
            params, {k: torch.from_numpy(v) for k, v in unmasked.items()})
    assert float(loss) != float(full)


def test_vlm_image_positions_are_masked_out():
    """The vlm loss is the CE over the text positions alone: the logits at
    the patches do not enter it, whatever labels they would have."""
    from repro_torch.models import transformer as TF

    arch = "internvl2-2b"
    cfg = tconfigs.get_smoke_config(arch)
    batch = _batch(cfg, seed=5)
    jp = _np(jbuild_model(jconfigs.get_smoke_config(arch)).init(jax.random.PRNGKey(0)))
    params = lm_params_from_numpy(jp, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        loss = TF.lm_loss(cfg, params, tb)
        h = torch.cat([tb["image_embeds"], TF._embed_h(cfg, params, tb["tokens"])], dim=1)
        positions = torch.arange(h.shape[1])[None, :]
        for lp in params["layers"]:
            h = TF._block(cfg, lp, h, positions)[0]
        logits = TF._logits(cfg, params, h)[:, cfg.n_patches:]
        want = TL.cross_entropy_loss(logits, tb["labels"])
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"])
def test_moe_aux_term_matches_jax(arch):
    """loss - CE = 0.01 x the non-prefix layers' summed aux loss, and that
    term equals the reference's (its loss less its CE on the same logits)."""
    from repro.models import transformer as JTF
    from repro_torch.models import transformer as TF

    jcfg = jconfigs.get_smoke_config(arch)
    cfg = tconfigs.get_smoke_config(arch)
    batch = _batch(cfg, seed=6)
    jp = _np(jbuild_model(jcfg).init(jax.random.PRNGKey(0)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    positions = jnp.arange(SEQ)[None, :]
    jh = JTF._embed_h(jcfg, jp, jb["tokens"])
    jh, _ = JTF._run_prefix(jcfg, jp, jh, positions)
    jh, _, jaux = JTF._scan_layers(jcfg, jp, jh, positions)
    want_aux = float(jaux)
    params = lm_params_from_numpy(jp, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    seen = []
    real = TMOE.moe_apply

    def spy(p, c, x, **kw):
        out = real(p, c, x, **kw)
        seen.append(float(out[1]))
        return out

    TMOE.moe_apply = spy
    try:
        with torch.no_grad():
            loss = TF.lm_loss(cfg, params, tb)
    finally:
        TMOE.moe_apply = real
    n_moe = cfg.n_layers - cfg.first_dense_layers
    assert len(seen) == n_moe
    np.testing.assert_allclose(sum(seen), want_aux, rtol=1e-5)
    with torch.no_grad():
        h = TF._embed_h(cfg, params, tb["tokens"])
        pos = torch.arange(SEQ)[None, :]
        for lp in params.get("prefix_layers", []) + params["layers"]:
            h = TF._block(cfg, lp, h, pos)[0]
        ce = TL.cross_entropy_loss(TF._logits(cfg, params, h), tb["labels"])
    np.testing.assert_allclose(float(loss - ce), 0.01 * want_aux, rtol=1e-4, atol=1e-7)
    assert float(loss - ce) > 0


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_changes_no_bit(arch):
    """The loss and every gradient with remat on equal remat off exactly
    (the CPU recomputes each layer's forward to the same bits); the MoE
    layers route once."""
    cfg = jconfigs.get_smoke_config(arch)
    batch = _batch(cfg, seed=2)
    jp = _np(jbuild_model(cfg).init(jax.random.PRNGKey(0)))
    calls = []
    real = TMOE.moe_route

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    TMOE.moe_route = spy
    try:
        _, off, g_off = _port_loss_and_grads(arch, jp, batch, remat=False)
        n_off = len(calls)
        _, on, g_on = _port_loss_and_grads(arch, jp, batch, remat=True)
    finally:
        TMOE.moe_route = real
    assert len(calls) == 2 * n_off          # a MoE layer is not recomputed
    assert torch.equal(on, off)
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)


def test_remat_recomputes_every_attention():
    """Under remat each layer's attention runs twice (the forward and its
    recompute in the backward), each through the plain path of a call that
    needs a gradient: the route counter sees both."""
    from repro_torch.models import attention as TA

    arch = "granite-3-2b"
    cfg = jconfigs.get_smoke_config(arch)
    batch = _batch(cfg, seed=3)
    jp = _np(jbuild_model(cfg).init(jax.random.PRNGKey(0)))
    for remat, want in ((False, cfg.n_layers), (True, 2 * cfg.n_layers)):
        TA.reset_grad_route_calls()
        _port_loss_and_grads(arch, jp, batch, remat=remat)
        assert TA.grad_route_calls() == want
    TA.reset_grad_route_calls()
    with torch.no_grad():
        build_model(tconfigs.get_smoke_config(arch)).loss(
            lm_params_from_numpy(jp, "cpu"), {k: torch.from_numpy(v) for k, v in batch.items()})
    assert TA.grad_route_calls() == 0


EDGE = np.array([-1e4, -1000, -200, -104, -89, -88.7, -88, -87, -50, -20, -5, -1, -0.1, 0,
                 0.1, 1, 5, 20, 88, 100], np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_grad_matches_jax_at_large_negative_inputs(dtype):
    x = torch.from_numpy(EDGE).to(getattr(torch, dtype)).requires_grad_(True)
    TS._silu(x).sum().backward()
    xj = jnp.asarray(EDGE, getattr(jnp, dtype))
    want = np.asarray(jax.grad(lambda v: jnp.sum(jax.nn.silu(v)))(xj)).astype(np.float32)
    got = x.grad.float().numpy()
    assert np.isfinite(got).all()
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # the forward's bits are the reference's away from the subnormals: XLA's
    # CPU flushes a subnormal sigmoid (x below about -87.3) to zero, and a
    # product near them rounds an ulp apart
    normal = EDGE >= -50
    with torch.no_grad():
        y = TS._silu(x.detach()).float().numpy()
    np.testing.assert_array_equal(y[normal],
                                  np.asarray(jax.nn.silu(xj)).astype(np.float32)[normal])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_tanh_grad_matches_jax_at_large_negative_inputs(dtype):
    x = torch.from_numpy(EDGE).to(getattr(torch, dtype)).requires_grad_(True)
    TL.gelu_tanh(x).sum().backward()
    xj = jnp.asarray(EDGE, getattr(jnp, dtype))
    want = np.asarray(jax.grad(lambda v: jnp.sum(jax.nn.gelu(v, approximate=True)))(xj))
    got = x.grad.float().numpy()
    assert np.isfinite(got).all()
    # fp32: XLA's tanh is exactly -1 past |u| = 7.9 (its rational
    # approximation clamps there), PyTorch's only past about 9; in between
    # the gradient x (1 - tanh^2) u' / 2 is at most about 3e-6 (x = -5)
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_jax(masked):
    rng = np.random.default_rng(9)
    logits = rng.normal(0, 4, (3, 7, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.5).astype(np.float32) if masked else None
    want = JL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask))
    got = TL.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    zero = TL.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                 torch.zeros((3, 7)))
    assert float(zero) == 0.0              # sum(mask) clamped to 1


@pytest.mark.parametrize("dim", [64, 80, 128])
@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_rope_freqs_are_the_reference_bits(dim, theta):
    exps = np.asarray(jnp.arange(0, dim, 2, dtype=jnp.float32) / dim)
    got_exps = (torch.arange(0, dim, 2, dtype=torch.float32) / dim).numpy()
    np.testing.assert_array_equal(got_exps.view(np.int32), exps.view(np.int32))
    want = np.asarray(JL.rope_freqs(dim, theta))
    got = TL.rope_freqs(dim, theta).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
