#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, holds every kernel against its plain PyTorch version on the card,
drives the forecast-serving path at the full width of the paper's quarterly
model (hidden 40, dilations ((1, 2), (4, 8)), 6 categories; random weights
from a fixed seed) and checks it against the same calls on the CPU, then
serves requests through ``ForecastServer`` on the card. Each phase prints one
JSON line; any failed check raises and the script exits non-zero. The last
line is ``{"ok": true, "device": {...}}``.

It needs one CUDA device and the ``src/`` tree beside it, and imports
nothing of the JAX package. fp32 parity: TF32 is switched off for matmuls
and convolutions before anything runs.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the quarterly M4 cell: 24,000 series (M4's quarterly count), T = 128
N_SERIES, T_LEN = 24_000, 128
ORIGINS = (64, 96, 128)
# the server's buckets (ForecastServer's defaults, passed explicitly)
LENGTH_BUCKETS, BATCH_BUCKETS = (32, 64, 128, 256), (1, 4, 16, 64)
N_REQUESTS = 96
N_OBSERVED = 4
OBS_LEN = 40

# tolerances, with their reasons:
# K1 runs the plain version's operations in the same order with IEEE
# rounding, so only a contracted multiply-add could differ: rtol 1e-5.
K1_RTOL = 1e-5
# K3 sums the gate dots in another order than the plain matmul: atol 1e-5.
K3_ATOL = 1e-5
# the whole forecast, card against CPU (sums in other orders, through exp)
FC_RTOL, FC_ATOL = 1e-4, 1e-5

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 CUDA-core flop/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Device time per call from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_flops: float):
    """Least time on the card: the larger of the byte and the flop term."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_rel(a, b) -> float:
    return float(((a - b).abs() / b.abs()).max())


def check_close(name, got, want, *, rtol, atol) -> float:
    import torch

    got = got.detach().float().cpu()
    want = want.detach().float().cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = float((got - want).abs().max())
        raise AssertionError(f"{name}: max abs err {err} outside rtol {rtol}, atol {atol}")
    return float((got - want).abs().max())


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version, on the card
# ---------------------------------------------------------------------------


def main_path_shapes(cfg):
    """The shapes the forecast and serve phases hand each kernel.

    K1 gets (series, length, m): the forecast batch and every serve bucket.
    K3 gets (rows, input width): each layer of dilation d folds d chains into
    the batch, so rows = batch * d, for the forecast batch and every batch
    bucket.
    """
    m = max(cfg.seasonality, 1)
    layers, width = [], cfg.input_size + cfg.n_categories
    for block in cfg.dilations:
        for d in block:
            layers.append((d, width))
            width = cfg.hidden_size
    k1 = [(N_SERIES, T_LEN, m)] + [(bb, t, m) for bb in BATCH_BUCKETS
                                   for t in LENGTH_BUCKETS]
    k3 = list(dict.fromkeys((n * d, i) for n in (N_SERIES,) + BATCH_BUCKETS
                            for d, i in layers))
    return k1, k3


def check_hw_scan(n, t_len, m, gen):
    import torch

    from repro_torch.kernels import hw_scan, ref

    dev = torch.device("cuda")
    y = (torch.rand((n, t_len), generator=gen) * 400 + 50).to(dev)
    alpha = torch.rand(n, generator=gen).to(dev)
    if m > 1:
        gamma = torch.rand(n, generator=gen).to(dev)
        init_seas = (torch.rand((n, m), generator=gen) + 0.5).to(dev)
    else:   # the m == 1 convention of kernels/ops.py: flat ring, gamma 0
        gamma = torch.zeros(n, device=dev)
        init_seas = torch.ones((n, 1), device=dev)
    y_tm, s_tm = y.t().contiguous(), init_seas.t().contiguous()
    kernel = lambda: hw_scan.hw_scan_tm(y_tm, alpha, gamma, s_tm)
    plain = lambda: ref.hw_scan_ref(y, alpha, gamma, init_seas)
    lev_k, seas_k = kernel()
    torch.cuda.synchronize()
    lev_p, seas_p = plain()
    err = max(check_close("hw_scan levels", lev_k.t(), lev_p, rtol=K1_RTOL, atol=0.0),
              check_close("hw_scan seas", seas_k.t(), seas_p, rtol=K1_RTOL, atol=0.0))
    rel = max(max_rel(lev_k.t(), lev_p), max_rel(seas_k.t(), seas_p))
    ms, plain_ms = time_ms(kernel), time_ms(plain, iters=5)
    n_bytes = 4 * n * (t_len + 2 + m) + 4 * n * (t_len + t_len + m)
    n_flops = 8 * n * t_len
    bound_ms, bound_by = bound(n_bytes, n_flops)
    return dict(name="hw_scan", shape=dict(N=n, T=t_len, m=m), max_abs_err=err,
                max_rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by)


def check_lstm_cell(rows, in_size, hidden, gen):
    import torch

    from repro_torch.kernels import lstm_cell, ref

    dev = torch.device("cuda")
    u = lambda *shape: ((torch.rand(shape, generator=gen) * 2 - 1)).to(dev)
    wx = u(in_size, 4 * hidden) / in_size ** 0.5
    wh = u(hidden, 4 * hidden) / hidden ** 0.5
    b = u(4 * hidden) * 0.1
    x, h, c = u(rows, in_size), u(rows, hidden), u(rows, hidden) * 2
    kernel = lambda: lstm_cell.lstm_cell(wx, wh, b, x, h, c)
    plain = lambda: ref.lstm_cell_ref(wx, wh, b, x, h, c)
    # one PyTorch call computing the same function (timed only, never used by
    # the port): torch.lstm_cell takes the weights transposed, two biases
    w_ih, w_hh, zero_b = wx.t().contiguous(), wh.t().contiguous(), torch.zeros_like(b)
    library = lambda: torch.lstm_cell(x, [h, c], w_ih, w_hh, b, zero_b)
    h_k, c_k = kernel()
    torch.cuda.synchronize()
    h_p, c_p = plain()
    err = max(check_close("lstm_cell h", h_k, h_p, rtol=0.0, atol=K3_ATOL),
              check_close("lstm_cell c", c_k, c_p, rtol=0.0, atol=K3_ATOL))
    h_l, c_l = library()
    check_close("torch.lstm_cell h", h_l, h_p, rtol=0.0, atol=K3_ATOL)
    ms, plain_ms, library_ms = time_ms(kernel), time_ms(plain), time_ms(library)
    g4 = 4 * hidden
    n_bytes = 4 * (rows * in_size + 4 * rows * hidden + (in_size + hidden) * g4 + g4)
    n_flops = 2 * rows * (in_size + hidden) * g4
    bound_ms, bound_by = bound(n_bytes, n_flops)
    return dict(name="lstm_cell", shape=dict(B=rows, I=in_size, H=hidden),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# phase 3: the forecast entry points at full quarterly width
# ---------------------------------------------------------------------------


def make_model(n_series: int, seed: int = 0):
    """Quarterly config and CPU params: random weights, per-series HW rows."""
    import torch

    from repro_torch.core.esrnn import esrnn_init, make_config
    from repro_torch.core.holt_winters import HWParams

    cfg = make_config("quarterly")
    params = esrnn_init(torch.Generator().manual_seed(seed), cfg, n_series,
                        device="cpu")
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))
    params["hw"] = HWParams(
        alpha_logit=f32(rng.normal(0.0, 1.0, n_series)),
        gamma_logit=f32(rng.normal(-1.0, 1.0, n_series)),
        init_seas_logit=f32(rng.normal(0.0, 0.1, (n_series, cfg.seasonality))))
    return cfg, params


def make_batch(cfg, n_series: int, t_len: int, seed: int = 1):
    """Positive seasonal series (N, T) and one-hot categories, from a seed."""
    rng = np.random.default_rng(seed)
    m = cfg.seasonality
    level = np.exp(rng.normal(5.0, 1.0, (n_series, 1))
                   + rng.normal(0.0, 0.02, (n_series, t_len)).cumsum(axis=1))
    seas = np.exp(rng.normal(0.0, 0.1, (n_series, m)))
    seas = np.tile(seas, (1, t_len // m + 1))[:, :t_len]
    y = level * seas * np.exp(rng.normal(0.0, 0.03, (n_series, t_len)))
    cats = np.eye(cfg.n_categories, dtype=np.float32)[
        rng.integers(0, cfg.n_categories, n_series)]
    return y.astype(np.float32), cats


def run_forecast(cfg, params_cpu, params_dev, y, cats, dev):
    """Card entry points vs the same forward pass on the CPU."""
    import torch

    from repro_torch.core import forward as F
    from repro_torch.core.esrnn import (
        esrnn_forecast, esrnn_forecast_at, esrnn_predict_stats,
    )

    y_d, c_d = torch.from_numpy(y).to(dev), torch.from_numpy(cats).to(dev)
    calls = {
        "esrnn_forecast": lambda: esrnn_forecast(cfg, params_dev, y_d, c_d),
        "esrnn_predict_stats": lambda: esrnn_predict_stats(cfg, params_dev, y_d, c_d),
        "esrnn_forecast_at": lambda: esrnn_forecast_at(cfg, params_dev, y_d, c_d, ORIGINS),
    }
    outs, ms = {}, {}
    for name, call in calls.items():
        call()                                    # first call: allocator warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[name] = call()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3

    # the CPU reference: one forward pass read three ways, exactly what the
    # three entry points compute (each runs its own pass on the card)
    t0 = time.perf_counter()
    with torch.no_grad():
        y_c, c_c = torch.from_numpy(y), torch.from_numpy(cats)
        states = F.esrnn_states(cfg, params_cpu, y_c, c_c)
        want_fc = F.forecast_from_states(cfg, states, y.shape[1])
        want_sigma = F.quantile_sigma(states, y_c)
        want_at = F.forecast_at_origins(cfg, states, ORIGINS, y.shape[1])
    cpu_s = time.perf_counter() - t0

    n, h = y.shape[0], cfg.output_size
    errs = {
        "esrnn_forecast": check_close("esrnn_forecast", outs["esrnn_forecast"],
                                      want_fc, rtol=FC_RTOL, atol=FC_ATOL),
        "esrnn_predict_stats": max(
            check_close("predict_stats fc", outs["esrnn_predict_stats"][0],
                        want_fc, rtol=FC_RTOL, atol=FC_ATOL),
            check_close("predict_stats sigma", outs["esrnn_predict_stats"][1],
                        want_sigma, rtol=FC_RTOL, atol=FC_ATOL)),
        "esrnn_forecast_at": check_close("esrnn_forecast_at", outs["esrnn_forecast_at"],
                                         want_at, rtol=FC_RTOL, atol=FC_ATOL),
    }
    if tuple(outs["esrnn_forecast"].shape) != (n, h):
        raise AssertionError(f"forecast shape {tuple(outs['esrnn_forecast'].shape)}")
    if tuple(outs["esrnn_forecast_at"].shape) != (n, len(ORIGINS), h):
        raise AssertionError("forecast_at shape")
    # the last origin is the end of the series: it must be the forecast
    check_close("forecast_at[-1] == forecast", outs["esrnn_forecast_at"][:, -1],
                outs["esrnn_forecast"], rtol=1e-6, atol=0.0)
    return dict(ms=ms, max_abs_err=errs, cpu_reference_s=cpu_s)


def profile_forecast(cfg, params_dev, y, cats, dev, top: int = 8):
    """Where one ``esrnn_forecast`` call spends the card's time.

    torch.profiler (CUPTI) over one warm call: device time by kernel name,
    and the device-busy share of the call's wall time (the union of kernel
    and copy intervals over the host-clock wall). ``None`` fields when the
    profiler saw no device activity.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.esrnn import esrnn_forecast

    y_d, c_d = torch.from_numpy(y).to(dev), torch.from_numpy(cats).to(dev)
    esrnn_forecast(cfg, params_dev, y_d, c_d)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        esrnn_forecast(cfg, params_dev, y_d, c_d)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        calls, us = by_name.get(evt.name, (0, 0.0))
        by_name[evt.name] = (calls + 1, us + (end - start))
    if not spans:
        return dict(wall_ms=wall_ms, device_busy_ms=None, busy_share=None, kernels=None)
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            busy_us += 0.0 if cur_end is None else cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
                busy_share=busy_us / 1e3 / wall_ms,
                kernels=[dict(name=name[:90], calls=calls, ms=us / 1e3)
                         for name, (calls, us) in ranked])


# ---------------------------------------------------------------------------
# phase 4: the server on the card, against a CPU dispatcher
# ---------------------------------------------------------------------------


def run_serve(cfg, params_cpu, params_dev, dev, n_requests: int, seed: int = 2):
    from repro_torch.forecast import (
        BucketDispatcher, ForecastRequest, synthetic_request_stream,
    )
    from repro_torch.forecast.server import ForecastServer, ServerConfig

    n_known = params_cpu["hw"].alpha_logit.shape[0]
    reqs = synthetic_request_stream(cfg, n_requests, n_known=n_known, seed=seed)
    reference = BucketDispatcher(cfg, params_cpu, length_buckets=LENGTH_BUCKETS,
                                 batch_buckets=BATCH_BUCKETS, device="cpu")
    want = reference.forecast_batch(reqs)

    server = ForecastServer(cfg, params_dev, device=dev,
                            length_buckets=LENGTH_BUCKETS, batch_buckets=BATCH_BUCKETS,
                            server_config=ServerConfig(max_wait_ms=2.0))
    server.forecast_batch(reqs)                    # warm wave (synchronous)
    bucket_shapes = server.stats.compiles
    if bucket_shapes > server.stats.compile_budget:
        raise AssertionError(
            f"{bucket_shapes} bucket shapes > budget {server.stats.compile_budget}")
    server.stats.reset()
    server.start()
    try:
        t0 = time.perf_counter()
        futures = [server.submit(r) for r in reqs]
        got = [f.result(timeout=300) for f in futures]
        wall_s = time.perf_counter() - t0
    finally:
        server.stop()
    stats = server.stats
    if stats.requests != n_requests:
        raise AssertionError(f"served {stats.requests} of {n_requests} requests")
    err = max(check_close(f"serve request {i}", _t(g), _t(w), rtol=FC_RTOL, atol=FC_ATOL)
              for i, (g, w) in enumerate(zip(got, want)))
    lat = stats.latency_percentiles()

    # observe round-trips: read-your-writes on known series
    rng = np.random.default_rng(seed + 1)
    sids = [int(s) for s in rng.choice(n_known, N_OBSERVED, replace=False)]
    obs_err = 0.0
    for sid in sids:
        hist = (100.0 * np.exp(rng.normal(0, 0.02, OBS_LEN + 1).cumsum())).astype(np.float32)
        cat = sid % cfg.n_categories
        for v in hist[:-1]:
            server.observe(sid, float(v), category=cat)
        ask = ForecastRequest(series_id=sid, category=cat)   # no y: the store's
        first = server.forecast_batch([ask])[0]
        server.observe(sid, float(hist[-1]))
        second = server.forecast_batch([ask])[0]
        for got_fc, seen in ((first, hist[:-1]), (second, hist)):
            want_fc = reference.forecast_batch([ForecastRequest(
                y=seen, category=cat, series_id=sid)])[0]
            obs_err = max(obs_err, check_close(
                f"observe series {sid}", _t(got_fc), _t(want_fc),
                rtol=FC_RTOL, atol=FC_ATOL))
        if np.array_equal(first, second):
            raise AssertionError(f"observe on series {sid} did not change its forecast")
        if server.store.get(sid).t != OBS_LEN + 1:
            raise AssertionError(f"series {sid} absorbed {server.store.get(sid).t} writes")
    return dict(requests=n_requests, wall_s=wall_s,
                requests_per_s=n_requests / wall_s, **lat,
                batches=stats.batches, bucket_shapes=bucket_shapes,
                bucket_budget=stats.compile_budget, padded_series=stats.padded_series,
                truncated_series=stats.truncated_series,
                kernel_launches=dict(stats.kernel_launches),
                max_abs_err=err, observed_series=sids,
                observe_round_trips=2 * len(sids), observe_max_abs_err=obs_err)


def _t(a):
    import torch

    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is missing under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch import strict_fp32
    from repro_torch.convert import params_to_device
    from repro_torch.kernels import build, ops

    strict_fp32()
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)

    # phase 1: the card and the kernel build
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    regs = {name: [int(r) for r in re.findall(r"Used (\d+) registers", rep)]
            for name, rep in build.build_info.get("ptxas", {}).items()}
    emit(dict(phase="device", nvidia_smi=smi, name=kind,
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda, build_s=build_s, registers=regs,
              allow_tf32=[torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32]))

    # phase 2: kernels against their plain versions, at the main path's
    # shapes (the first of each list is the forecast batch's first launch),
    # plus the m == 1 convention of the yearly and other non-seasonal models
    cfg, params_cpu = make_model(N_SERIES)
    k1_shapes, k3_shapes = main_path_shapes(cfg)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        k1 = [check_hw_scan(n, t, m, gen) for n, t, m in k1_shapes]
        k1.append(check_hw_scan(N_SERIES, T_LEN, 1, gen))
        k3 = [check_lstm_cell(rows, width, cfg.hidden_size, gen)
              for rows, width in k3_shapes]
    for rec in k1 + k3:
        emit(dict(phase="kernel", **rec))

    # phases 3 and 4 are the main path: count launches from zero through both
    params_dev = params_to_device(params_cpu, dev)
    y, cats = make_batch(cfg, N_SERIES, T_LEN)
    ops.reset_launch_counts()
    fc = run_forecast(cfg, params_cpu, params_dev, y, cats, dev)
    fc_launches = ops.launch_counts()
    if min(fc_launches.values()) == 0:
        raise AssertionError(f"the forecast missed a kernel: {fc_launches}")
    emit(dict(phase="forecast", config="quarterly", N=N_SERIES, T=T_LEN,
              hidden=cfg.hidden_size, dilations=cfg.dilations, origins=ORIGINS,
              launches=fc_launches, **fc))
    emit(dict(phase="profile", call="esrnn_forecast", N=N_SERIES, T=T_LEN,
              **profile_forecast(cfg, params_dev, y, cats, dev)))
    fc_launches = ops.launch_counts()

    serve = run_serve(cfg, params_cpu, params_dev, dev, N_REQUESTS)
    launches = ops.launch_counts()
    serve_launches = {k: launches[k] - fc_launches[k] for k in launches}
    if min(serve_launches.values()) == 0:
        raise AssertionError(f"serving missed a kernel: {serve_launches}")
    emit(dict(phase="serve", card=smi, launches=serve_launches, **serve))

    # phase 5: summary, one entry per ported kernel; times at the forecast
    # batch's first launch of each (N = 24,000; K3: layer 0, I = 14)
    main_k1, main_k3 = k1[0], k3[0]
    kernels = [
        dict(name="hw_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/hw_scan.cu",
             replaces="src/repro/kernels/hw_scan.py:56",
             launches=launches["hw_scan"],
             max_abs_err=max(r["max_abs_err"] for r in k1),
             ms=main_k1["ms"], plain_ms=main_k1["plain_ms"],
             bound_ms=main_k1["bound_ms"], bound_by=main_k1["bound_by"],
             library_ms=None),
        dict(name="lstm_cell", route="cuda",
             source="src/repro_torch/kernels/csrc/lstm_cell.cu",
             replaces="src/repro/kernels/lstm_cell.py:56",
             launches=launches["lstm_cell"],
             max_abs_err=max(r["max_abs_err"] for r in k3),
             ms=main_k3["ms"], plain_ms=main_k3["plain_ms"],
             bound_ms=main_k3["bound_ms"], bound_by=main_k3["bound_by"],
             library_ms=main_k3["library_ms"]),
    ]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
