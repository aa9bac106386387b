"""ESRNNForecaster: the estimator-style entry point (PyTorch port).

Counterpart of ``repro.forecast.estimator``, verb for verb:

    f = ESRNNForecaster("esrnn-quarterly")          # or a ForecastSpec
    f.fit(data)                                     # joint two-group training
    yhat = f.predict()                              # (N, H) point forecast
    bands = f.predict_quantiles(taus=(0.1, 0.5, 0.9))
    scores = f.evaluate(split="test")               # sMAPE/MASE/OWA vs
                                                    # Comb / Naive2
    bt = f.backtest(origins=(72, 80))               # rolling-origin scores,
                                                    # one forward pass
    f.save(path);  g = ESRNNForecaster.load(path)   # the shared Checkpointer
    srv = f.serve()                                 # continuous-batching
                                                    # online server

Everything runs on ``device`` (default: the card; ``device="cpu"`` for the
CPU), through the CUDA kernels on the card. A saved directory has the JAX
estimator's layout (params under ``<dir>/params/`` in the JAX checkpoint
format, plus ``forecaster.json``), so a forecaster saved by either package
loads in the other.

``spec.series_chunk > 0`` is the out-of-core path: ``fit`` streams the
per-series table through the device in chunks of rows
(:func:`repro_torch.train.trainer.train_esrnn`), after which the fitted
table stays in host memory (pinned on the card), and ``predict``,
``predict_quantiles``, ``evaluate`` and ``backtest`` stream it the same way:
each chunk's rows are copied to the device on the table's copy stream while
the chunk before computes, and scores add up exact per-chunk terms.

Series data parallelism: every verb takes ``mesh=`` (a
:class:`~repro_torch.sharding.series.SeriesMesh`; without one,
``spec.data_parallel > 1`` builds one over the initialized process group).
``fit`` trains series-data-parallel (:mod:`repro_torch.train.trainer`);
``predict``, ``predict_quantiles``, ``evaluate`` and ``backtest`` give each
rank its contiguous block of the rows (or, streamed, of every chunk's rows),
the blocks of ``numpy.array_split`` so no row count need divide the mesh,
and return the full result on every rank after one all-reduce of the
rows' outputs and score terms. ``save`` writes on rank 0. With no process group, ``spec.data_parallel > 1`` runs inference on one
device with a warning and makes ``fit`` raise, as in the reference.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer, is_table_path
from repro_torch.core import losses as L
from repro_torch.core.comb import comb_forecast, naive2_forecast
from repro_torch.core.esrnn import (
    esrnn_forecast, esrnn_forecast_at, esrnn_init, esrnn_loss,
    esrnn_loss_and_grad, esrnn_predict_stats, param_leaves,
)
from repro_torch.core.holt_winters import hw_init_params
from repro_torch.data.pipeline import PreparedData, chunk_bounds, prepare
from repro_torch.data.synthetic_m4 import M4Dataset, generate
from repro_torch.device import resolve_device
from repro_torch.forecast.spec import ForecastSpec, get_spec
from repro_torch.sharding.series import make_series_mesh
from repro_torch.train.host_table import (
    HostStateTable, pinned_copy, stream_chunks, to_device,
)
from repro_torch.train.trainer import train_from_spec

log = logging.getLogger("repro_torch.forecast")

_META_FILE = "forecaster.json"


class NotFittedError(RuntimeError):
    pass


class ESRNNForecaster:
    """Scikit-style estimator over the vectorized ES-RNN, on one device or
    the ranks of a series mesh."""

    def __init__(self, spec: Union[str, ForecastSpec] = "esrnn-quarterly",
                 *, device=None, **overrides):
        if isinstance(spec, str):
            spec = get_spec(spec, **overrides)
        elif overrides:
            spec = spec.replace(**overrides)
        self.spec = spec
        self.device = device                     # resolved at first use
        self.params_: Optional[Dict] = None
        self.history_: Optional[Dict] = None
        self.resumed_from_: Optional[int] = None
        self.n_series_: Optional[int] = None
        self.data_: Optional[PreparedData] = None
        self.cats_: Optional[np.ndarray] = None   # fitted one-hots, persisted
        self.mesh_ = None                        # the series mesh of the fit

    # -- config shortcuts ----------------------------------------------------

    @property
    def config(self):
        return self.spec.model

    @property
    def horizon(self) -> int:
        return self.spec.horizon

    @property
    def _dev(self) -> torch.device:
        return resolve_device(self.device)

    def _check_fitted(self):
        if self.params_ is None:
            raise NotFittedError(
                "this ESRNNForecaster has no params; call fit(), "
                "init_params(), or load() first")

    def _resolve_mesh(self, mesh):
        """Explicit mesh, else one over the process group when
        ``spec.data_parallel > 1``. An estimator fitted data-parallel must
        still predict where no process group of that size runs: inference
        is the same on any device count, so it runs on one device with a
        warning. A 1-rank mesh is the single-device path."""
        if mesh is None and self.spec.data_parallel > 1:
            try:
                mesh = make_series_mesh(self.spec.data_parallel, device=self._dev)
            except ValueError as e:
                log.warning("spec.data_parallel=%d: inference runs on one device (%s): %s",
                            self.spec.data_parallel, self._dev, e)
                mesh = None
        if mesh is not None and mesh.size == 1:
            mesh = None
        return mesh

    @staticmethod
    def _blocks(ranges, mesh):
        """The ``[lo, hi)`` ranges, or this rank's block of each over a mesh
        (empty blocks left out)."""
        if mesh is None:
            return ranges
        return [b for b in (mesh.block(lo, hi) for lo, hi in ranges) if b[1] > b[0]]

    @staticmethod
    def _sum_ranks(a: np.ndarray, mesh) -> np.ndarray:
        """The host array ``a`` summed over the ranks: one all-reduce. A
        zero-filled output in which each rank wrote its own rows comes back
        with every rank's rows."""
        return mesh.all_reduce(torch.from_numpy(a).to(mesh.device)).cpu().numpy()

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(a).to(self._dev, dtype or self.config.tdtype)

    # -- data ----------------------------------------------------------------

    def make_data(self) -> PreparedData:
        """Spec-driven synthetic M4 slice (Tables 2/3 profile, section 5)."""
        spec = self.spec
        ds = generate(spec.frequency, scale=spec.data_scale, seed=spec.data_seed)
        return prepare(ds, min_length=spec.min_length,
                       variable_length=spec.variable_length)

    def _coerce_data(self, data) -> PreparedData:
        if data is None:
            return self.make_data()
        if isinstance(data, M4Dataset):
            return prepare(data, min_length=self.spec.min_length,
                           variable_length=self.spec.variable_length)
        if isinstance(data, PreparedData):
            return data
        raise TypeError(f"cannot fit on {type(data).__name__}; "
                        "pass PreparedData, M4Dataset, or None")

    # -- fit -----------------------------------------------------------------

    def init_params(self, n_series: int, seed: Optional[int] = None):
        """Primer initialization without training (cold-start serving)."""
        seed = self.spec.seed if seed is None else seed
        self.params_ = esrnn_init(torch.Generator().manual_seed(seed), self.config,
                                  n_series, device=self._dev)
        self.n_series_ = n_series
        return self.params_

    def fit(self, data=None, *, ckpt_dir: Optional[str] = None,
            n_steps: Optional[int] = None, hooks=None,
            mesh=None) -> "ESRNNForecaster":
        """Joint two-group training (the spec's rnn_lr / hw_lr); returns self.

        From ``self.params_`` when set, else from the spec's seed (a CPU
        generator, so the init is the same on every device). ``ckpt_dir``
        checkpoints the fit and resumes it from the latest checkpoint there.
        ``spec.scan_steps > 1`` runs the superstep engine, and
        ``spec.sparse_adam`` the segment update of the per-series table;
        ``spec.series_chunk > 0`` the streamed chunked fit, which leaves the
        fitted table in host memory. ``mesh`` (or ``spec.data_parallel >
        1``, which raises without a process group of that size) trains
        series-data-parallel; ``save`` then writes on rank 0.
        """
        dev = self._dev
        if mesh is None and self.spec.data_parallel > 1:
            mesh = make_series_mesh(self.spec.data_parallel, device=dev)
        self.mesh_ = mesh if mesh is not None and mesh.size > 1 else None
        pdata = self._coerce_data(data)
        out = train_from_spec(self.spec, pdata, ckpt_dir=ckpt_dir,
                              n_steps=n_steps, params=self.params_, hooks=hooks,
                              mesh=self.mesh_, device=dev)
        self.params_ = out["params"]
        self.history_ = out["history"]
        self.resumed_from_ = out["resumed_from"]
        self.n_series_ = pdata.n_series
        self.data_ = pdata
        self.cats_ = np.asarray(pdata.cats, np.float32)
        return self

    # -- predict -------------------------------------------------------------

    def _resolve_inputs(self, y, cats, series_idx, *, host: bool = False):
        """Resolve ``(params, y, cats)``: on the estimator's device, or with
        ``host=True`` as host float32 arrays and the params as they are (the
        chunked verbs slice rows out before any copy, so an out-of-core table
        never lands on the device whole)."""
        self._check_fitted()
        if y is None:
            if self.data_ is None:
                raise NotFittedError("predict() without y requires fit(data)")
            y = self.data_.train
        y = np.asarray(y, np.float32) if host else self._tensor(y)
        if cats is None and self.cats_ is not None:
            # fitted categories: the rows of y are (a subset of) the fitted
            # series, so reuse their one-hots rather than zeroing the feature
            if series_idx is not None:
                cats = self.cats_[np.asarray(series_idx)]
            elif y.shape[0] == self.cats_.shape[0]:
                cats = self.cats_
        if cats is None:
            cats = np.zeros((y.shape[0], self.config.n_categories), np.float32)
        cats = np.asarray(cats, np.float32) if host else self._tensor(cats)
        params = self.params_
        hw = params["hw"]
        if series_idx is not None:
            rows = torch.as_tensor(np.asarray(series_idx), device=hw.alpha_logit.device)
            hw = hw.map(lambda a: a[rows])
        if not host:
            # a table fitted out of core lives on the host: its rows move here
            hw = hw.map(lambda a: a if a.device == self._dev else to_device(a, self._dev))
        params = {**params, "hw": hw}
        n_hw = hw.alpha_logit.shape[0]
        if y.shape[0] != n_hw:
            raise ValueError(
                f"y has {y.shape[0]} series but the fitted per-series table "
                f"has {n_hw}; pass series_idx to select rows")
        return params, y, cats

    # -- the out-of-core verbs -----------------------------------------------

    def _chunk_ranges(self, n: int):
        """``[lo, hi)`` series chunks when the spec streams, else None."""
        c = self.spec.series_chunk
        if c and c > 0 and n > c:
            return chunk_bounds(n, c)
        return None

    def _each_chunk(self, params, arrays, ranges, compute, finish) -> None:
        """:func:`~repro_torch.train.host_table.stream_chunks` over the
        fitted table: ``compute(params_c, arrays_c)`` on the device for each
        chunk (its HW rows and the rows of ``arrays``, host arrays with the
        series axis leading, copied there on the table's copy stream), then
        ``finish(lo, hi, result)`` on the host, one chunk behind."""
        dev = self._dev
        hw = params["hw"]
        if hw.alpha_logit.device.type == "cpu" and (
                dev.type == "cpu" or hw.alpha_logit.is_pinned()):
            table = HostStateTable(hw, device=dev)
        else:   # a table on the device, or unpinned: one pinned host copy
            table = HostStateTable.adopt(hw.map(lambda a: a.detach().cpu()), device=dev)
        shared = {k: v for k, v in params.items() if k != "hw"}
        stream_chunks(
            table, ranges, lambda lo, hi: [pinned_copy(a[lo:hi], dev) for a in arrays],
            lambda rows: compute({"hw": rows.state["hw"], **shared}, rows.extra), finish)

    def _each_block(self, params, arrays, ranges, mesh, compute, finish) -> None:
        """``compute(params_b, arrays_b)`` on the device for each ``[lo, hi)``
        of ``ranges`` (this rank's block of each over a mesh), then
        ``finish(lo, hi, result)`` on the host. ``ranges`` None is one
        resident block of every row; otherwise the chunks stream
        (:meth:`_each_chunk`)."""
        if ranges:
            return self._each_chunk(params, arrays, self._blocks(ranges, mesh), compute, finish)
        for lo, hi in self._blocks([(0, arrays[0].shape[0])], mesh):
            finish(lo, hi, compute({**params, "hw": params["hw"].map(lambda a: a[lo:hi])},
                                   [a[lo:hi] for a in arrays]))

    def predict(self, y=None, cats=None, *,
                series_idx: Optional[Sequence[int]] = None,
                mesh=None) -> np.ndarray:
        """Point forecast (N, H) from the end of each series (Eq. 5).

        With no arguments, forecasts the fitted training series. ``y`` may be
        any history for the fitted series (e.g. train+val to forecast the test
        window); ``series_idx`` selects per-series HW rows when y is a subset.
        ``spec.series_chunk > 0`` streams the forecast chunk by chunk.
        ``mesh`` shards the rows (see the module docstring).
        """
        mesh = self._resolve_mesh(mesh)
        n_in = self.n_series_ if y is None else np.shape(y)[0]
        ranges = self._chunk_ranges(n_in or 0) if series_idx is None else None
        params, y, cats = self._resolve_inputs(y, cats, series_idx, host=bool(ranges))
        if not ranges and mesh is None:
            return esrnn_forecast(self.config, params, y, cats).cpu().numpy()
        out = np.zeros((y.shape[0], self.horizon), np.float32)

        def finish(lo, hi, fc):
            out[lo:hi] = fc.cpu().numpy()

        self._each_block(params, (y, cats), ranges, mesh,
                         lambda p_b, a: esrnn_forecast(self.config, p_b, *a), finish)
        return out if mesh is None else self._sum_ranks(out, mesh)

    def predict_quantiles(
        self, y=None, cats=None, *, taus: Tuple[float, ...] = (0.1, 0.5, 0.9),
        series_idx: Optional[Sequence[int]] = None, mesh=None,
    ) -> Dict[float, np.ndarray]:
        """Quantile bands around the point forecast.

        The model is trained on one pinball quantile (spec ``tau``), so its
        output is one quantile path. Bands come from the fitted Holt-Winters
        in-sample residuals: the per-series log-residual spread sigma gives
        q_tau(h) = yhat * exp(z_tau * sigma * sqrt(h)) (tau = 0.5 returns the
        point forecast exactly). Point and sigma come off one forward pass;
        ``mesh`` shards it like ``predict``.
        """
        mesh = self._resolve_mesh(mesh)
        n_in = self.n_series_ if y is None else np.shape(y)[0]
        ranges = self._chunk_ranges(n_in or 0) if series_idx is None else None
        params, y, cats = self._resolve_inputs(y, cats, series_idx, host=bool(ranges))
        if not ranges and mesh is None:
            return self._bands(*esrnn_predict_stats(self.config, params, y, cats), taus)
        bands = np.zeros((len(taus), y.shape[0], self.horizon), np.float32)

        def finish(lo, hi, stats):
            for k, band in enumerate(self._bands(*stats, taus).values()):
                bands[k, lo:hi] = band

        self._each_block(params, (y, cats), ranges, mesh,
                         lambda p_b, a: esrnn_predict_stats(self.config, p_b, *a), finish)
        if mesh is not None:
            bands = self._sum_ranks(bands, mesh)
        return dict(zip(taus, bands))

    def _bands(self, point, sigma, taus) -> Dict[float, np.ndarray]:
        steps = torch.sqrt(torch.arange(1, self.horizon + 1, dtype=torch.float32,
                                        device=point.device))[None, :]
        out = {}
        for tau in taus:
            z = torch.special.ndtri(torch.tensor(tau, dtype=torch.float32,
                                                 device=point.device))
            out[tau] = (point * torch.exp(z * sigma * steps)).cpu().numpy()
        return out

    # -- loss (golden-equivalence surface + benchmarks) ----------------------

    def loss(self, y, cats):
        """Training loss through the estimator (the function the fit uses)."""
        self._check_fitted()
        with torch.no_grad():
            return esrnn_loss(self.config, self.params_, self._tensor(y),
                              self._tensor(cats))

    def loss_and_grad(self, y, cats):
        """``(loss, grads)``, ``grads`` in ``param_leaves`` order."""
        self._check_fitted()
        for _, t in param_leaves(self.params_):
            t.requires_grad_(True)
        return esrnn_loss_and_grad(self.config, self.params_, self._tensor(y),
                                   self._tensor(cats))

    # -- evaluate ------------------------------------------------------------

    def evaluate(self, data: Optional[PreparedData] = None,
                 split: str = "test", *, mesh=None) -> Dict[str, float]:
        """M4-style scores: sMAPE/MASE/OWA vs the Comb and Naive2 benchmarks.

        ``split="test"`` forecasts from train+val and scores on the test
        window (Eq. 7); ``split="val"`` forecasts from train and scores on
        the validation window. Scores are taken on the host in float32.
        ``mesh`` scores each rank's rows (the model on its device, the Comb
        / Naive2 baselines on the host) and reduces the metric terms once.
        """
        self._check_fitted()
        data = data if data is not None else self.data_
        if data is None:
            raise NotFittedError("evaluate() needs PreparedData (fit or pass)")
        if split == "test":
            insample, target = data.val_input, data.test_target
        elif split == "val":
            insample, target = data.train, data.val_target
        else:
            raise ValueError(f"split must be 'val' or 'test', got {split!r}")
        m, h = data.seasonality, min(self.horizon, target.shape[1])
        mesh = self._resolve_mesh(mesh)
        ranges = self._chunk_ranges(insample.shape[0])
        if ranges or mesh is not None:
            return self._evaluate_blocks(data, insample, target, m, h, split, mesh, ranges)
        host = lambda a: torch.from_numpy(np.asarray(a, np.float32))
        target_t, insample_t = host(target[:, :h]), host(insample)

        def score(f):
            f = host(f)
            return (float(L.smape(f, target_t)),
                    float(L.mase(f, target_t, insample_t, m)))

        s_es, m_es = score(self.predict(insample, data.cats)[:, :h])
        s_cb, m_cb = score(comb_forecast(insample, h, m))
        s_n2, m_n2 = score(naive2_forecast(insample, h, m))
        return {
            "split": split,
            "smape": s_es, "mase": m_es,
            "owa": float(L.owa(s_es, m_es, s_n2, m_n2)),
            "smape_comb": s_cb, "mase_comb": m_cb,
            "owa_comb": float(L.owa(s_cb, m_cb, s_n2, m_n2)),
            "smape_naive2": s_n2, "mase_naive2": m_n2,
        }

    def _evaluate_blocks(self, data, insample, target, m, h, split, mesh, ranges):
        """Scores by blocks of rows: the model and the Comb / Naive2
        baselines block by block (:meth:`_each_block`; streamed chunk by
        chunk when ``ranges``). sMAPE and MASE are sums over counts and
        every per-series scale is row-local, so each block's
        ``smape_terms`` / ``mase_terms`` (on the host in float32, as the
        resident scores), added in float64 and divided once, give the
        resident means. Over a mesh each rank scores its block of the rows
        (of every chunk) and the sums are reduced once."""
        params, y, cats = self._resolve_inputs(insample, data.cats, None, host=bool(ranges))
        ins = np.asarray(insample, np.float32)
        tgt = np.asarray(target[:, :h], np.float32)
        acc = {k: np.zeros(4, np.float64) for k in ("esrnn", "comb", "naive2")}
        host = lambda a: torch.from_numpy(np.asarray(a, np.float32))

        def add(name, fc, tgt_c, ins_c):
            fc, tgt_c, ins_c = host(fc), host(tgt_c), host(ins_c)
            s0, s1 = L.smape_terms(fc, tgt_c)
            m0, m1 = L.mase_terms(fc, tgt_c, ins_c, m)
            acc[name] += np.array([float(s0), float(s1), float(m0), float(m1)])

        def finish(lo, hi, fc):
            # the baselines' fits on the host run while the next chunk's
            # forecast runs on the device
            ins_c = ins[lo:hi]
            add("esrnn", fc[:, :h].cpu().numpy(), tgt[lo:hi], ins_c)
            add("comb", comb_forecast(ins_c, h, m), tgt[lo:hi], ins_c)
            add("naive2", naive2_forecast(ins_c, h, m), tgt[lo:hi], ins_c)

        self._each_block(params, (y, cats), ranges, mesh,
                         lambda p_b, a: esrnn_forecast(self.config, p_b, *a), finish)
        if mesh is not None:
            acc = dict(zip(acc, self._sum_ranks(np.stack(list(acc.values())), mesh)))

        def score(name):
            s0, s1, m0, m1 = acc[name]
            return 200.0 * s0 / max(s1, 1.0), m0 / max(m1, 1.0)

        s_es, m_es = score("esrnn")
        s_cb, m_cb = score("comb")
        s_n2, m_n2 = score("naive2")
        return {
            "split": split,
            "smape": s_es, "mase": m_es,
            "owa": float(L.owa(s_es, m_es, s_n2, m_n2)),
            "smape_comb": s_cb, "mase_comb": m_cb,
            "owa_comb": float(L.owa(s_cb, m_cb, s_n2, m_n2)),
            "smape_naive2": s_n2, "mase_naive2": m_n2,
        }

    # -- rolling-origin backtest ---------------------------------------------

    def backtest(self, data: Optional[PreparedData] = None, *,
                 origins: Optional[Sequence[int]] = None,
                 y=None, cats=None, mesh=None) -> Dict:
        """Rolling-origin backtest: forecast at several origins, no refit.

        For each origin ``o`` (an observation count) the model forecasts as
        if only ``y[:, :o]`` had been observed and is scored on the next
        ``H`` actuals. All origins are read off one forward pass
        (``esrnn_forecast_at``): the causal HW recurrence makes the states
        at position ``o - 1`` the truncated history's states.

        Defaults: the full fitted history (train+val+test) with origins at
        the end of train and the end of val. Horizons that run past the
        series end are masked out of the metrics; an origin with no
        scorable target reports NaN. Returns per-origin and overall
        sMAPE/MASE plus the (N, K, H) forecasts.
        """
        self._check_fitted()
        if y is None:
            data = data if data is not None else self.data_
            if data is None:
                raise NotFittedError(
                    "backtest() needs PreparedData (fit or pass data=)")
            y = np.concatenate([data.val_input, data.test_target], axis=1)
            cats = data.cats if cats is None else cats
            if origins is None:
                train_len = data.train.shape[1]
                origins = (train_len, train_len + data.horizon)
        elif origins is None:
            raise ValueError("backtest(y=...) needs explicit origins")
        mesh = self._resolve_mesh(mesh)
        ranges = self._chunk_ranges(np.shape(y)[0])
        params, y, cats = self._resolve_inputs(y, cats, None, host=bool(ranges))
        m = max(self.config.seasonality, 1)
        h = self.horizon
        n, t_len = y.shape
        origins = tuple(int(o) for o in origins)

        # per-origin scoring windows + validity masks (numpy, host-side)
        y_np = y if ranges else y.cpu().numpy()
        target = np.zeros((n, len(origins), h), np.float32)
        tmask = np.zeros((n, len(origins), h), np.float32)
        for k, o in enumerate(origins):
            avail = max(0, min(h, t_len - o))
            target[:, k, :avail] = y_np[:, o:o + avail]
            tmask[:, k, :avail] = 1.0

        if ranges or mesh is not None:
            # blocks of rows through the one-pass multi-origin forecast; the
            # per-origin metric terms are exact sums, so they add up
            fc = np.zeros((n, len(origins), h), np.float32)
            acc = np.zeros((4, len(origins)), np.float64)

            def compute(p_b, a):
                y_b, c_b, t_b, tm_b = a
                fc_b = esrnn_forecast_at(self.config, p_b, y_b, c_b, origins)
                return fc_b, L.rolling_metric_terms(fc_b, t_b, tm_b, y_b, origins, m)

            def finish(lo, hi, out):
                fc[lo:hi] = out[0].cpu().numpy()
                acc[:] += np.stack([t.cpu().numpy().astype(np.float64) for t in out[1]])

            windows = (target, tmask) if ranges else (self._tensor(target, torch.float32),
                                                      self._tensor(tmask, torch.float32))
            self._each_block(params, (y, cats, *windows), ranges, mesh, compute, finish)
            if mesh is not None:
                # the ranks' forecast rows and their terms in one buffer
                both = self._sum_ranks(np.concatenate([fc.ravel(), acc.ravel()]), mesh)
                fc = both[:fc.size].reshape(fc.shape).astype(np.float32)
                acc = both[fc.size:].reshape(acc.shape)
            s_sum, s_cnt, m_sum, m_cnt = acc
        else:
            fc = esrnn_forecast_at(self.config, params, y, cats, origins)
            terms = L.rolling_metric_terms(
                fc, self._tensor(target, torch.float32),
                self._tensor(tmask, torch.float32), y, origins, m)
            s_sum, s_cnt, m_sum, m_cnt = (t.cpu().numpy().astype(np.float64)
                                          for t in terms)
            fc = fc.cpu().numpy()

        def ratio(num, cnt):
            # an origin with no scorable targets (e.g. origin == T) is
            # unscored: NaN, not a perfect-looking 0.0
            return float(num / cnt) if cnt > 0 else float("nan")

        per_origin = [
            {"origin": o,
             "smape": ratio(200.0 * s_sum[k], s_cnt[k]),
             "mase": ratio(m_sum[k], m_cnt[k])}
            for k, o in enumerate(origins)]
        return {
            "origins": list(origins),
            "horizon": h,
            "per_origin": per_origin,
            "smape": ratio(200.0 * s_sum.sum(), s_cnt.sum()),
            "mase": ratio(m_sum.sum(), m_cnt.sum()),
            "forecasts": fc,
        }

    # -- serving -------------------------------------------------------------

    def serve(self, *, server_config=None,
              length_buckets: Tuple[int, ...] = (32, 64, 128, 256),
              batch_buckets: Tuple[int, ...] = (1, 4, 16, 64),
              mesh=None, seed_histories: bool = False):
        """Continuous-batching online server over the fitted params.

        Returns an (unstarted) :class:`repro_torch.forecast.server.ForecastServer`
        on the estimator's device -- ``start()`` it for threaded serving or
        drive ``step()``/``drain()`` synchronously. ``seed_histories=True``
        pre-registers every fitted series' training history in the online
        store (masked left-padding stripped), so ``observe`` and
        history-less forecasts work for known ids from the first request.
        ``mesh`` shards every dispatched bucket over the ranks (a sharded
        server is driven synchronously: ``step``/``drain``).
        """
        self._check_fitted()
        from repro_torch.forecast.server import ForecastServer

        srv = ForecastServer(
            self.config, self.params_, server_config=server_config,
            length_buckets=length_buckets, batch_buckets=batch_buckets,
            mesh=self._resolve_mesh(mesh), device=self._dev)
        if seed_histories:
            if self.data_ is None:
                raise NotFittedError(
                    "serve(seed_histories=True) needs fitted data; call "
                    "fit(data) first")
            y = np.asarray(self.data_.train, np.float32)
            mask = np.asarray(self.data_.mask, np.float32)
            for sid in range(y.shape[0]):
                real = y[sid][mask[sid] > 0]
                srv.store.seed(
                    sid, real, row=srv.dispatcher.resolve_row(sid),
                    category=int(np.argmax(self.cats_[sid]))
                    if self.cats_ is not None else None)
        return srv

    # -- persistence (the shared Checkpointer) -------------------------------

    def save(self, directory: str) -> str:
        """Persist spec + params atomically via the shared Checkpointer.

        Params live under ``<directory>/params/`` so a saved estimator can
        share a directory with trainer checkpoints (``fit(ckpt_dir=...)``
        writes ``step_<n>/`` trees of (params, opt_state) at the top level).
        After a fit over a series mesh rank 0 writes and every rank returns
        once the directory is complete.
        """
        self._check_fitted()
        if self.mesh_ is None or self.mesh_.rank == 0:
            self._write(directory)
        if self.mesh_ is not None:
            self.mesh_.barrier()
        return directory

    def _write(self, directory: str) -> None:
        ckpt = Checkpointer(os.path.join(directory, "params"), keep=self.spec.keep)
        step = len(self.history_["loss"]) if self.history_ else 0
        ckpt.save(step, self.params_)
        meta = {
            "spec": self.spec.to_dict(),
            "n_series": int(self.n_series_),
            "step": step,
            "cats": self.cats_.tolist() if self.cats_ is not None else None,
        }
        tmp = os.path.join(directory, _META_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(tmp, os.path.join(directory, _META_FILE))

    @classmethod
    def load(cls, directory: str, *, device=None) -> "ESRNNForecaster":
        """A saved forecaster (either package's), its params on ``device``
        (default: the card). Under ``spec.series_chunk > 0`` the per-series
        table stays in host memory (pinned on the card) for the chunked
        verbs to stream."""
        with open(os.path.join(directory, _META_FILE)) as f:
            meta = json.load(f)
        spec = ForecastSpec.from_dict(meta["spec"])
        f = cls(spec, device=device)
        n, gen = meta["n_series"], torch.Generator().manual_seed(spec.seed)
        ckpt = Checkpointer(os.path.join(directory, "params"))
        if spec.series_chunk and spec.series_chunk > 0:
            template = {**esrnn_init(gen, spec.model, 1, device=f._dev),
                        "hw": hw_init_params(n, spec.model.seasonality,
                                             seasonality2=spec.model.seasonality2,
                                             dtype=spec.model.tdtype, device="cpu")}
            _, params = ckpt.restore(template, step=meta["step"], host_paths=is_table_path)
            f.params_ = {**params, "hw": HostStateTable.adopt(params["hw"], device=f._dev).hw}
        else:
            template = esrnn_init(gen, spec.model, n, device=f._dev)
            _, f.params_ = ckpt.restore(template, step=meta["step"])
        f.n_series_ = meta["n_series"]
        if meta.get("cats") is not None:
            f.cats_ = np.asarray(meta["cats"], np.float32)
        return f
