"""bf16 training and the bf16 fine-tune of the port, against the JAX package (CPU).

Under ``precision="bf16"`` the training step streams y into the HW scan in
bf16 and runs the recurrent stack and the readout's hidden activations in
bf16, with float32 accumulation; the master weights, the per-series HW
table, the Adam moments and the masked-mean loss stay float32, the shared
weights are cast to bf16 at apply, and the gradients arrive float32 on the
master leaves (``tests/core/test_precision.py``).

As in ``test_torch_bf16.py``, the port follows the reference kernels'
contract on both devices, so parity is held against the JAX package with
``use_pallas=True``: its LSTM-cell kernels (forward with activations and
backward) in interpret mode, its HW-scan kernel routed through the kernel's
plain JAX reference (F3: it cannot run in interpret mode on the installed
JAX), whose gradient JAX derives.

Tolerances and their reasons:

* the plain K2 with a bf16 y: dalpha, dgamma and d init_seas within rtol
  1e-5 of ``jax.vjp`` of the reference scan with the same bf16 y, and atol
  1e-6 of each leaf's largest magnitude (float32 cotangents summed in
  another order: with y up to 400 they reach hundreds, and an element that
  cancels to a few units keeps the rounding of its larger terms, 3e-6 at
  (5, 24, 4)). dy within 1 bf16 ulp of
  that vjp on y widened to float32, rounded to bf16 once: the reference
  kernel computes dy_t in float32 and emits it in y's dtype once
  (``src/repro/kernels/hw_scan.py:195-216``). ``jax.vjp`` with the bf16 y
  itself rounds each use's cotangent to bf16 before summing them (one
  convert per use of y_t), so near-cancelling terms land many ulps away;
  that gap is printed, not bounded;
* the plain K4 and K5 in bf16: h', c', act, dx, dh_prev, dc_prev within 1
  bf16 ulp of the JAX kernels, or within atol 1e-5 where a value is so near
  zero that float32's sum-order error spans more than one bf16 ulp; the
  float32 weight-gradient sums within 1e-5 * sqrt(B) (B rows summed in
  another order), and rounded to bf16, within 1 ulp or that atol;
* the loss and its gradients: the loss within rtol 1e-4 (``LOSS_RTOL``)
  and each gradient leaf float32, finite and within a relative L2 error
  of 2e-2 (``GRAD_REL_L2``): both sides run the same kernel contract, so
  only float32 sum orders and the bf16 roundings they tip differ (the
  loss held 1.1e-7 relative, the worst leaf 5.3e-3; printed with ``-s``);
  the bf16 serving bound (rtol 2e-2) would not see a wrong rounding point;
* 12-step trajectories: per-step losses and validation sMAPE within rtol
  1e-3 of JAX's bf16 ``train_esrnn`` (``TRAJ_RTOL``; held 3.1e-5: a
  gradient component at rounding level can take Adam's sign-like step the
  other way) and within rtol 0.05 of the port's own fp32 trajectory
  (``tests/core/test_precision.py``'s bound);
* the fine-tuning server: forecasts after the fine-tune within rtol 2e-2 /
  atol 1e-3 of the JAX server's, the last loss within rtol 2e-2;
* the port's copy of ``repro.core.comb``: equal to the reference, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import comb as jcomb
from repro.core import esrnn as jes
from repro.core import holt_winters as jhw
from repro.data import pipeline as jpipe
from repro.forecast.server import ForecastServer as JServer
from repro.forecast.server import ServerConfig as JServerConfig
from repro.kernels import hw_scan as jhw_kernel
from repro.kernels import lstm_cell as jlstm
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.train import trainer as jtrainer
from repro_torch.convert import params_from_numpy
from repro_torch.core import comb as tcomb
from repro_torch.core import esrnn as tes
from repro_torch.core.esrnn import param_leaves
from repro_torch.data import pipeline as tpipe
from repro_torch.data.synthetic_m4 import generate
from repro_torch.forecast import ForecastRequest
from repro_torch.forecast.server import ForecastServer, ServerConfig
from repro_torch.kernels import lstm_cell as tlstm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.train import trainer as ttrainer
from repro_torch.train.engine import make_step_fn, split_frozen
from repro_torch.train.optimizer import AdamConfig, adam_init

BF16 = dict(precision="bf16", use_pallas=True)
RTOL, ATOL = 2e-2, 1e-3            # bf16 forecasts against the JAX package
FP32_RTOL = 0.05                   # bf16 against fp32 (tests/core/test_precision.py)
LOSS_RTOL = 1e-4                   # the bf16 loss against JAX's
GRAD_REL_L2 = 2e-2                 # each gradient leaf's relative L2 error
TRAJ_RTOL = 1e-3                   # 12-step losses and sMAPE against JAX's
K45_ATOL = 1e-5


def _hw_scan_via_reference(y_tm, alpha, gamma, init_seas_tm, *, interpret=False):
    levels, seas = jref.hw_scan_ref(y_tm.T, alpha, gamma, init_seas_tm.T)
    return levels.T, seas.T


@pytest.fixture
def jax_hw_scan_via_reference(monkeypatch):
    """The JAX K1 call routed through its plain JAX reference (F3)."""
    monkeypatch.setattr(jhw_kernel, "hw_scan_tm", _hw_scan_via_reference)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _bf16_np(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)


def _t(a):
    """A numpy array (bf16 included) as a CPU tensor of its dtype."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _ulps_or_atol(got, want, atol, what):
    """Every element within 1 bf16 ulp, or within ``atol``; returns the
    largest ulp distance seen."""
    got, want = _t(got) if not isinstance(got, torch.Tensor) else got, _t(want)
    assert got.dtype == want.dtype == torch.bfloat16, what
    ulps = tref.bf16_ulps(got, want)
    past = (ulps > 1) & ((got.float() - want.float()).abs() > atol)
    assert not past.any(), f"{what}: {int(past.sum())} values past 1 bf16 ulp and atol {atol}"
    return int(ulps.max())


# ---------------------------------------------------------------------------
# the plain K2 with a bf16 y


@pytest.mark.parametrize("n,t,m", [(5, 24, 4), (3, 30, 1), (4, 40, 12)])
def test_plain_hw_scan_bwd_with_bf16_y_matches_jax(n, t, m):
    rng = np.random.default_rng(n + t + m)
    y = _bf16_np(rng.uniform(20, 400, (n, t)))
    alpha = rng.uniform(0.05, 0.95, n).astype(np.float32)
    if m > 1:
        gamma = rng.uniform(0.05, 0.95, n).astype(np.float32)
        init_seas = rng.uniform(0.6, 1.4, (n, m)).astype(np.float32)
    else:                       # the m == 1 convention of kernels/ops.py
        gamma, init_seas = np.zeros(n, np.float32), np.ones((n, 1), np.float32)
    dlev = rng.normal(0, 1, (n, t)).astype(np.float32)
    dseas = rng.normal(0, 1, (n, t + m)).astype(np.float32)
    cot = (jnp.asarray(dlev), jnp.asarray(dseas))
    _, vjp = jax.vjp(jref.hw_scan_ref, jnp.asarray(y), jnp.asarray(alpha),
                     jnp.asarray(gamma), jnp.asarray(init_seas))
    want_dy16, want_da, want_dg, want_ds = vjp(cot)
    _, vjp32 = jax.vjp(lambda y32: jref.hw_scan_ref(y32, jnp.asarray(alpha), jnp.asarray(gamma),
                                                    jnp.asarray(init_seas)),
                       jnp.asarray(y, jnp.float32))
    (want_dy32,) = vjp32(cot)

    ty, ta, tg, ts = (_t(a) for a in (y, alpha, gamma, init_seas))
    lev, seas = tref.hw_scan_ref(ty, ta, tg, ts)
    dy, da, dg, ds = tref.hw_scan_bwd_ref(ty, ta, tg, lev, seas, _t(dlev), _t(dseas))
    assert dy.dtype == torch.bfloat16
    assert da.dtype == dg.dtype == ds.dtype == torch.float32
    for name, got, want in (("dalpha", da, want_da), ("dgamma", dg, want_dg),
                            ("d init_seas", ds, want_ds)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want).max()), err_msg=name)
    _ulps_or_atol(dy, np.asarray(want_dy32).astype(ml_dtypes.bfloat16), 0.0, "dy")
    # the state and the cotangents are float32 and y_t is widened exactly:
    # the same bits as the adjoint on y widened first, dy rounded once
    wide = tref.hw_scan_bwd_ref(ty.float(), ta, tg, lev, seas, _t(dlev), _t(dseas))
    assert torch.equal(dy, wide[0].to(torch.bfloat16))
    for got, want in zip((da, dg, ds), wide[1:]):
        assert torch.equal(got, want)
    gap = int(tref.bf16_ulps(dy, _t(np.asarray(want_dy16))).max())
    print(f"K2 bf16 {(n, t, m)}: dy {gap} bf16 ulps from jax.vjp with the bf16 y "
          f"(which rounds each use's cotangent)")


# ---------------------------------------------------------------------------
# the plain K4 and K5 in bf16


def _pad_cell(wx, wh, b, x, h, c, hp, ip):
    """The JAX kernels' lane-padded operands (``repro.kernels.ops``)."""
    hidden, in_size = h.shape[1], x.shape[1]
    return (jnp.pad(jops._pad_gates(wx, hidden, hp), ((0, ip - in_size), (0, 0))),
            jnp.pad(jops._pad_gates(wh, hidden, hp), ((0, hp - hidden), (0, 0))),
            jops._pad_gates(b[None, :], hidden, hp)[0],
            jnp.pad(x, ((0, 0), (0, ip - in_size))),
            jnp.pad(h, ((0, 0), (0, hp - hidden))), jnp.pad(c, ((0, 0), (0, hp - hidden))))


def _unpad_gates(a, hidden, hp):
    return np.asarray(a, np.float32).reshape(a.shape[0], 4, hp)[:, :, :hidden].reshape(
        a.shape[0], 4 * hidden)


@pytest.mark.parametrize("rows,in_size,hidden", [(128, 14, 40), (256, 40, 40), (128, 7, 50)])
def test_plain_lstm_cell_fwd_bwd_in_bf16_within_one_ulp_of_the_jax_kernels(rows, in_size,
                                                                          hidden):
    rng = np.random.default_rng(rows + in_size + hidden)
    u = lambda *s, scale=1.0: _bf16_np(rng.uniform(-scale, scale, s))
    wx, wh = u(in_size, 4 * hidden, scale=in_size ** -0.5), u(hidden, 4 * hidden,
                                                              scale=hidden ** -0.5)
    b, x, h, c = u(4 * hidden, scale=0.1), u(rows, in_size), u(rows, hidden), u(rows, hidden,
                                                                                scale=2.0)
    dh, dc = u(rows, hidden), u(rows, hidden)
    hp, ip = 128, 128
    padded = _pad_cell(*(jnp.asarray(a) for a in (wx, wh, b, x, h, c)), hp, ip)
    jh, jc, jact = jlstm._lstm_fwd_call(*padded, interpret=True, with_acts=True,
                                        block_b=jlstm.BLOCK_B)
    pad_h = lambda a: jnp.pad(jnp.asarray(a), ((0, 0), (0, hp - hidden)))
    jdwx, jdwh, jdb, jdx, jdhp, jdcp = jlstm._lstm_bwd_call(
        padded[0], padded[1], padded[3], padded[4], padded[5], jc, jact, pad_h(dh), pad_h(dc),
        interpret=True, block_b=jlstm.BLOCK_B)
    assert jact.dtype == jdx.dtype == jnp.bfloat16 and jdwx.dtype == jnp.float32

    tw = [_t(a) for a in (wx, wh, b, x, h, c)]
    th, tc, tact = tref.lstm_cell_fwd_ref(*tw)
    assert th.dtype == tc.dtype == tact.dtype == torch.bfloat16
    want_act = _bf16_np(_unpad_gates(jact, hidden, hp))
    ulps = {"h": _ulps_or_atol(th, np.asarray(jh)[:, :hidden], K45_ATOL, "h'"),
            "c": _ulps_or_atol(tc, np.asarray(jc)[:, :hidden], K45_ATOL, "c'"),
            "act": _ulps_or_atol(tact, want_act, K45_ATOL, "act")}
    # K5 on the JAX forward's residuals, so that only the backward differs
    res = [_t(np.asarray(jc)[:, :hidden]), _t(want_act)]
    dx, dhp, dcp, dwx, dwh, db = tref.lstm_cell_bwd_ref(
        tw[0], tw[1], tw[3], tw[4], tw[5], *res, _t(dh), _t(dc))
    ulps.update(dx=_ulps_or_atol(dx, np.asarray(jdx)[:, :in_size], K45_ATOL, "dx"),
                dh_prev=_ulps_or_atol(dhp, np.asarray(jdhp)[:, :hidden], K45_ATOL, "dh_prev"),
                dc_prev=_ulps_or_atol(dcp, np.asarray(jdcp)[:, :hidden], K45_ATOL, "dc_prev"))
    atol = K45_ATOL * rows ** 0.5
    wants = (_unpad_gates(jdwx, hidden, hp)[:in_size], _unpad_gates(jdwh, hidden, hp)[:hidden],
             _unpad_gates(jdb[None, :], hidden, hp)[0])
    for name, got, want in zip(("dwx", "dwh", "db"), (dwx, dwh, db), wants):
        assert got.dtype == torch.float32           # the sums, before any rounding
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol, err_msg=name)
        ulps[name] = _ulps_or_atol(got.to(torch.bfloat16), _bf16_np(want), atol, name)
    print(f"K4/K5 bf16 {(rows, in_size, hidden)}: max bf16 ulps {ulps}")


def test_lstm_cell_function_in_bf16_matches_the_jax_vjp():
    # the Function rounds the weight gradients to the weight dtype once, as
    # the reference's custom_vjp does; dh and dc enter K5 in bf16
    rows, in_size, hidden = 64, 14, 40
    rng = np.random.default_rng(3)
    u = lambda *s, scale=1.0: _bf16_np(rng.uniform(-scale, scale, s))
    args = [u(in_size, 4 * hidden, scale=0.3), u(hidden, 4 * hidden, scale=0.2),
            u(4 * hidden, scale=0.1), u(rows, in_size), u(rows, hidden), u(rows, hidden)]
    dh, dc = u(rows, hidden), u(rows, hidden)
    (jh, jc), vjp = jax.vjp(jops.lstm_cell, *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dh), jnp.asarray(dc)))
    targs = [_t(a).requires_grad_(True) for a in args]
    tops.reset_launch_counts()
    th, tc = tlstm.LSTMCell.apply(*targs)
    grads = torch.autograd.grad((th, tc), targs, (_t(dh), _t(dc)))
    assert tops.launch_counts()["lstm_cell_fwd_bf16"] == 0          # the plain versions ran
    _ulps_or_atol(th, np.asarray(jh), K45_ATOL, "h'")
    _ulps_or_atol(tc, np.asarray(jc), K45_ATOL, "c'")
    for name, g, w, a in zip(("dwx", "dwh", "db", "dx", "dh", "dc"), grads, want, targs):
        assert g.dtype == a.dtype == torch.bfloat16, name
        atol = K45_ATOL * rows ** 0.5 if name.startswith(("dw", "db")) else K45_ATOL
        _ulps_or_atol(g, np.asarray(w), atol, name)


# ---------------------------------------------------------------------------
# the loss and its gradients


MODEL = dict(hidden_size=8)


def _jax_params(cfg, n, seed=0):
    return jax.tree_util.tree_map(np.asarray, jes.esrnn_init(jax.random.PRNGKey(seed), cfg, n))


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.astype(np.float64) - want) / max(np.linalg.norm(want), 1e-30))


def test_bf16_loss_and_grads_match_jax(jax_hw_scan_via_reference):
    over = dict(MODEL, level_penalty=0.3, cstate_penalty=0.2)
    jcfg = jes.make_config("quarterly", **over, **BF16)
    tcfg = tes.make_config("quarterly", **over, precision="bf16")
    d = tpipe.synthetic_prepared(5, series_length=24, seed=4)
    mask = d.mask.copy()
    mask[0, :5] = 0.0                              # a left-padded series
    jp = _jax_params(jcfg, 5, seed=2)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jes.esrnn_loss(jcfg, p, d.train, d.cats, mask))(jp)
    tp = params_from_numpy(jp, "cpu")
    for _, t in param_leaves(tp):
        t.requires_grad_(True)
    loss, grads = tes.esrnn_loss_and_grad(
        tcfg, tp, torch.from_numpy(d.train), torch.from_numpy(d.cats), torch.from_numpy(mask))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    want = jax.tree_util.tree_leaves(want_grads)
    assert len(want) == len(grads)
    errs = {}
    for (path, _), g, w in zip(param_leaves(tp), grads, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), path
        errs[path] = _rel_l2(g.numpy(), w)
        assert errs[path] <= GRAD_REL_L2, (path, errs[path])
    print(f"bf16 loss rel err {abs(float(loss) / float(want_loss) - 1):.3g}; gradient rel L2 "
          f"max {max(errs.values()):.3g} ({max(errs, key=errs.get)})")


# ---------------------------------------------------------------------------
# 12-step trajectories


N_SERIES, T_LEN, BATCH, STEPS = 12, 24, 8, 12


@pytest.fixture(scope="module")
def data():
    return tpipe.synthetic_prepared(N_SERIES, series_length=T_LEN, seed=2)


def _train_cfg(cls, sparse, scan_steps):
    return cls(batch_size=BATCH, n_steps=STEPS, eval_every=6, ckpt_every=1000,
               seed=3, sparse_adam=sparse, scan_steps=scan_steps)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX bf16 trajectories (``use_pallas=True``, the HW scan through its
    plain reference), computed once per (sparse, scan_steps)."""
    cfg = jes.make_config("quarterly", **MODEL, **BF16)
    jdata = jpipe.synthetic_prepared(N_SERIES, series_length=T_LEN, seed=2)
    init = _jax_params(cfg, N_SERIES, seed=1)
    cache = {}

    def run(sparse, scan_steps):
        if (sparse, scan_steps) not in cache:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jhw_kernel, "hw_scan_tm", _hw_scan_via_reference)
                jax.clear_caches()
                cache[sparse, scan_steps] = jtrainer.train_esrnn(
                    cfg, jdata, _train_cfg(jtrainer.TrainConfig, sparse, scan_steps),
                    params=init)
            jax.clear_caches()
        return cache[sparse, scan_steps]

    return init, run


@pytest.mark.parametrize("sparse,scan_steps", [(False, 1), (False, 4), (True, 1), (True, 4)])
def test_bf16_train_trajectory_matches_jax_and_tracks_fp32(data, jax_runs, sparse, scan_steps):
    init, run = jax_runs
    want = run(sparse, scan_steps)
    tcfg = _train_cfg(ttrainer.TrainConfig, sparse, scan_steps)
    cfg16 = tes.make_config("quarterly", **MODEL, precision="bf16")
    got = ttrainer.train_esrnn(cfg16, data, tcfg, params=params_from_numpy(init, "cpu"),
                               device="cpu")
    fp32 = ttrainer.train_esrnn(dataclasses.replace(cfg16, precision="fp32"), data, tcfg,
                                params=params_from_numpy(init, "cpu"), device="cpu")
    losses = np.asarray(got["history"]["loss"])
    assert losses.shape == (STEPS,) and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, want["history"]["loss"], rtol=TRAJ_RTOL)
    np.testing.assert_allclose(losses, fp32["history"]["loss"], rtol=FP32_RTOL)
    g_steps, g_smape = zip(*got["history"]["val_smape"])
    w_steps, w_smape = zip(*want["history"]["val_smape"])
    assert g_steps == w_steps == (6, 12)
    np.testing.assert_allclose(g_smape, w_smape, rtol=TRAJ_RTOL)
    assert got["opt_state"]["step"] == int(want["opt_state"]["step"]) == STEPS
    for (path, t), w in zip(param_leaves(got["params"]),
                            jax.tree_util.tree_leaves(want["params"]), strict=True):
        assert t.dtype == torch.float32 and np.asarray(w).dtype == np.float32, path
    print(f"bf16 trajectory sparse={sparse} K={scan_steps}: max rel loss err "
          f"{np.max(np.abs(losses / np.asarray(want['history']['loss']) - 1)):.3g} vs JAX, "
          f"{np.max(np.abs(losses / np.asarray(fp32['history']['loss']) - 1)):.3g} vs fp32")


# ---------------------------------------------------------------------------
# the fp32 half of the policy (tests/core/test_precision.py's mirrors)


def _fit(cfg, y, cats, steps):
    n = y.shape[0]
    params = tes.esrnn_init(torch.Generator().manual_seed(0), cfg, n, device="cpu")
    step = make_step_fn(cfg, AdamConfig(lr=1e-3), y, cats, torch.ones(y.shape))
    opt = adam_init(split_frozen(params, frozenset())[0])
    for k in range(steps):
        idx = (torch.arange(16) + 16 * k) % n
        params, opt, loss = step(params, opt, idx)
    return params, opt, loss


def _quarterly():
    d = tpipe.prepare(generate("quarterly", scale=0.002, seed=0))
    return torch.from_numpy(d.train), torch.from_numpy(d.cats)


def test_bf16_state_stays_fp32_through_training():
    """The fp32-accumulation half: table, moments, loss, master params."""
    y, cats = _quarterly()
    cfg = tes.make_config("quarterly", precision="bf16")
    params, opt, loss = _fit(cfg, y, cats, steps=4)
    assert loss.dtype == torch.float32
    assert all(t.dtype == torch.float32 for _, t in param_leaves(params))
    assert all(t.dtype == torch.float32 for k in ("mu", "nu") for t in opt[k])
    idx = torch.arange(8)
    loss = tes.esrnn_loss_fn(cfg, tes.gather_series(params, idx), y[:8], cats[:8],
                             torch.ones(y[:8].shape))
    assert loss.dtype == torch.float32


def test_bf16_gradients_arrive_fp32():
    """Grads flow through the policy cast back to the fp32 master leaves."""
    y, cats = _quarterly()
    cfg = tes.make_config("quarterly", precision="bf16")
    params = tes.esrnn_init(torch.Generator().manual_seed(0), cfg, y.shape[0], device="cpu")
    leaves = [t.requires_grad_(True) for _, t in param_leaves(params)]
    idx = torch.arange(8)
    loss, grads = tes.value_and_grad(
        lambda: tes.esrnn_loss_fn(cfg, tes.gather_series(params, idx), y[:8], cats[:8],
                                  torch.ones(y[:8].shape)), leaves)
    assert loss.dtype == torch.float32
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)
    # the shared weights got a gradient through the cast, the HW rows through the scan
    assert all(bool(g.abs().sum() > 0) for (path, _), g in zip(param_leaves(params), grads)
               if path[0] in ("rnn", "head"))


# ---------------------------------------------------------------------------
# the bf16 fine-tuning server


N_KNOWN = 6
LENGTHS, BATCHES = (16, 32), (2, 4)


def _series(t, seed):
    rng = np.random.default_rng(seed)
    return (80.0 * np.exp(rng.normal(0, 0.02, t).cumsum())).astype(np.float32)


def test_bf16_idle_finetune_matches_jax(jax_hw_scan_via_reference):
    over = dict(hidden_size=8, dilations=((1, 2), (4,)))
    cfg = jes.make_config("quarterly", **over, **BF16)
    params = jes.esrnn_init(jax.random.PRNGKey(0), cfg, N_KNOWN)
    rng = np.random.default_rng(4)
    params["hw"] = jhw.HWParams(
        alpha_logit=rng.normal(0, 1, N_KNOWN).astype(np.float32),
        gamma_logit=rng.normal(-1, 1, N_KNOWN).astype(np.float32),
        init_seas_logit=rng.normal(0, 0.1, (N_KNOWN, 4)).astype(np.float32))
    jp = jax.tree_util.tree_map(np.asarray, params)
    tcfg = tes.make_config("quarterly", **over, precision="bf16")
    buckets = dict(length_buckets=LENGTHS, batch_buckets=BATCHES)
    knobs = dict(finetune_steps=2, finetune_batch=4)
    jsrv = JServer(cfg, jp, server_config=JServerConfig(**knobs), **buckets)
    tsrv = ForecastServer(tcfg, params_from_numpy(jp, "cpu"),
                          server_config=ServerConfig(**knobs), device="cpu", **buckets)
    sids = (0, 2, 3, 5)
    for srv in (jsrv, tsrv):
        for sid in sids:
            for v in _series(24 + sid, 20 + sid):
                srv.observe(sid, float(v), category=sid % 6)
    from repro.forecast import ForecastRequest as JRequest

    asks = [(ForecastRequest(series_id=s, category=s % 6), JRequest(series_id=s, category=s % 6))
            for s in sids]
    t_before, j_before = tsrv.submit(asks[0][0]), jsrv.submit(asks[0][1])
    tsrv.drain()
    jsrv.drain()
    np.testing.assert_allclose(t_before.result(timeout=30), j_before.result(timeout=30),
                               rtol=RTOL, atol=ATOL)
    assert jsrv.stats.finetunes == tsrv.stats.finetunes == 1
    np.testing.assert_allclose(tsrv.tuner.last_loss, jsrv.tuner.last_loss, rtol=RTOL)
    t_fut = [tsrv.submit(t) for t, _ in asks]
    j_fut = [jsrv.submit(j) for _, j in asks]
    tsrv.drain()
    jsrv.drain()
    gap = 0.0
    for g, w in zip(t_fut, j_fut):
        np.testing.assert_allclose(g.result(timeout=30), w.result(timeout=30),
                                   rtol=RTOL, atol=ATOL)
        gap = max(gap, float(np.max(np.abs(g.result() / w.result() - 1))))
    print(f"bf16 fine-tune: forecasts {gap:.3g} relative from JAX's, last loss "
          f"{abs(tsrv.tuner.last_loss / jsrv.tuner.last_loss - 1):.3g}")
    assert not np.array_equal(t_fut[0].result(), t_before.result())
    assert all(t.dtype == torch.float32 for _, t in param_leaves(tsrv.tuner.params))


# ---------------------------------------------------------------------------
# the port's copy of the Naive2 and Comb baselines


@pytest.mark.parametrize("m", [1, 4, 12])
def test_comb_and_naive_baselines_equal_the_reference(m):
    rng = np.random.default_rng(m)
    t = 6 * m + 11
    y = (100.0 * np.exp(rng.normal(0, 0.05, (7, t)).cumsum(axis=1))
         * np.tile(rng.uniform(0.7, 1.3, (7, m)), (1, t // m + 1))[:, :t]).astype(np.float32)
    h = 8
    for name, args in (("naive2_forecast", (y, h, m)), ("comb_forecast", (y, h, m)),
                       ("seasonal_naive_forecast", (y, h, m)), ("naive_forecast", (y, h)),
                       ("classical_seasonal_factors", (y, m))):
        got, want = getattr(tcomb, name)(*args), getattr(jcomb, name)(*args)
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert got.dtype == want.dtype
