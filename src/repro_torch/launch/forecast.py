"""Forecast launcher: the one CLI over the port's ESRNNForecaster.

    PYTHONPATH=src python -m repro_torch.launch.forecast specs
    PYTHONPATH=src python -m repro_torch.launch.forecast fit      --spec esrnn-quarterly --smoke --out-dir /tmp/fq
    PYTHONPATH=src python -m repro_torch.launch.forecast predict  --dir /tmp/fq --quantiles 0.1,0.5,0.9
    PYTHONPATH=src python -m repro_torch.launch.forecast eval     --dir /tmp/fq --split test
    PYTHONPATH=src python -m repro_torch.launch.forecast backtest --dir /tmp/fq --origins 72,80
    PYTHONPATH=src python -m repro_torch.launch.forecast serve    --dir /tmp/fq --requests 64
    echo '{"op":"observe","series_id":0,"y":105.2}' | \\
        PYTHONPATH=src python -m repro_torch.launch.forecast observe --dir /tmp/fq
    PYTHONPATH=src python -m repro_torch.launch.forecast analyze  --smoke --set head=esn --json-out /tmp/a.json

The PyTorch counterpart of ``repro.launch.forecast``, subcommand for
subcommand and flag for flag, plus ``--device`` (default ``cuda``: every
subcommand runs on the card, and raises on a host without one; ``--device
cpu`` runs on the CPU). A directory saved by either package's ``fit
--out-dir`` serves every other subcommand of both.

``specs`` lists the registry (name, frequency, horizon, head). ``fit``
trains on the spec's synthetic M4 slice, checkpoints to and resumes from
``--ckpt-dir``, and saves the estimator to ``--out-dir``; ``predict``/``eval``/``backtest`` run on a saved estimator
(``--dir``) or fit a fresh one; ``serve`` runs the continuous-batching
server (``--engine batch``: the synchronous bucket dispatcher) over a
synthetic ragged request stream and reports latency percentiles and
throughput; ``observe`` drives the same server as a JSONL op loop over
stdin (online ``observe`` ingestion, read-your-writes forecasts, stats).
``backtest`` forecasts at each ``--origins`` observation count as if the
rest of the series were unseen, all origins off one forward pass.
``--json`` prints what ``specs``, ``fit``, ``predict``, ``eval`` and
``backtest`` give as one JSON object at full precision (``fit``: the
per-step losses and the validation sMAPE; ``predict``: every forecast or
band).

``--set KEY=VAL`` overrides any spec or model field (``--set
precision=bf16`` runs the bf16 policy; ``--set scan_steps=K`` the
superstep engine; ``--set sparse_adam=true`` the segment update). The
heads: ``--spec esn-quarterly`` or ``--spec ssm-quarterly`` (or ``--set
head=esn|ssm`` on any spec) drive every subcommand through the esn head
(a frozen reservoir; only the readout and the HW table train) or the ssm
head.
``--set series_chunk=K`` turns on the out-of-core path: ``fit`` streams
the per-series table through the device in K-row chunks (it implies
``sparse_adam`` and logs "streaming chunked fit"; its ``--ckpt-dir``
checkpoints hold the table as ``leaf_*.shard_*.bin`` row shards), and
``predict``, ``eval``, ``backtest``, ``serve`` and ``observe`` on the saved
directory keep the table in host memory, streaming it chunk by chunk.
``--devices N`` applies to every subcommand: with N > 1 one command spawns
N ranks (:func:`repro_torch.sharding.run_ranks`; NCCL when each rank has a
card of its own, else gloo), which run the subcommand over a series mesh --
``fit`` trains series-data-parallel (it sets ``data_parallel``), and
``predict``, ``eval``, ``backtest``, ``serve`` and ``observe`` shard their
rows. Rank 0 alone writes files and prints. A sharded ``serve`` drives the
server synchronously, wave by wave.

``analyze`` is the invariant auditor (:mod:`repro_torch.analysis`): it
runs the spec's fit step, forecast and serving dispatcher once each
(``--entries``, default ``fit,predict,serve``) on the probe's 15 series
with recorders armed, and lints five invariants -- ``recompile`` (kernel
launch shapes within the bucket grid), ``gradient-leak`` (frozen groups take
no gradient; on the card the esn step launches K5's dx-only kernel and
never the full K5), ``donation`` (the superstep updates its state in
place), ``collectives`` (with ``--devices N > 1``, or the entry
``collectives``: the sharded predict and loss gradient on N spawned ranks
issue their documented collectives) and ``dtype-policy``. It prints the
JSON report (``--json-out`` writes it too) and exits 0 when the report is
``ok``, else 1.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
import sys
import time

import numpy as np

from repro_torch.forecast import (
    BucketDispatcher, ESRNNForecaster, get_smoke_spec, get_spec,
    list_specs, synthetic_request_stream,
)

log = logging.getLogger("repro_torch.launch.forecast")


def _parse_overrides(pairs):
    out = {}
    for pair in pairs or []:
        key, eq, val = pair.partition("=")
        if not eq or not key or not val:
            raise SystemExit(
                f"error: --set expects KEY=VAL, got {pair!r}")
        if val.lower() in ("true", "false"):
            out[key] = val.lower() == "true"
            continue
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


def _mesh(args):
    """The series mesh of a sharded run (``--devices N > 1``), else None."""
    return getattr(args, "mesh", None)


def _build(args) -> ESRNNForecaster:
    over = _parse_overrides(getattr(args, "set", None))
    if getattr(args, "steps", None) is not None:
        over["n_steps"] = args.steps
    if getattr(args, "devices", None) is not None:
        over["data_parallel"] = args.devices
    spec = (get_smoke_spec(args.spec, **over) if args.smoke
            else get_spec(args.spec, **over))
    return ESRNNForecaster(spec, device=args.device)


def _fitted(args) -> ESRNNForecaster:
    """Saved estimator if --dir given, else a freshly fitted one."""
    if getattr(args, "dir", None):
        f = ESRNNForecaster.load(args.dir, device=args.device)
        f.data_ = f.make_data()
        return f
    f = _build(args)
    log.info("no --dir: fitting %s for %d steps", f.spec.name, f.spec.n_steps)
    return f.fit(mesh=_mesh(args))


def cmd_specs(args):
    """List the spec registry: one row per name, with the head made visible."""
    rows = [dict(name=n, frequency=(s := get_spec(n)).frequency,
                 horizon=s.horizon, head=s.model.head)
            for n in list_specs()]
    if args.json:
        print(json.dumps(rows, indent=2))
        return 0
    w = max(len(r["name"]) for r in rows)
    print(f"{'name':{w}s}  {'frequency':9s}  {'horizon':>7s}  head")
    for r in rows:
        print(f"{r['name']:{w}s}  {r['frequency']:9s}  "
              f"{r['horizon']:7d}  {r['head']}")
    return 0


def cmd_fit(args):
    f = _build(args)
    f.fit(ckpt_dir=args.ckpt_dir, mesh=_mesh(args))
    h = f.history_["loss"]
    if args.json:
        out = {"spec": f.spec.name, "n_series": f.n_series_,
               "resumed_from": f.resumed_from_, "loss": h,
               "val_smape": f.history_["val_smape"]}
        if args.out_dir:
            out["saved_to"] = f.save(args.out_dir)
        print(json.dumps(out))
        return 0
    if h:
        print(f"{f.spec.name}: {len(h)} steps, loss {h[0]:.4f} -> {h[-1]:.4f}, "
              f"{f.n_series_} series")
    else:
        print(f"{f.spec.name}: resumed from a finished checkpoint, "
              f"{f.n_series_} series")
    if f.history_["val_smape"]:
        step, vs = f.history_["val_smape"][-1]
        print(f"val sMAPE @ step {step}: {vs:.3f}")
    if args.out_dir:
        print("saved to", f.save(args.out_dir))
    return 0


def cmd_predict(args):
    f = _fitted(args)
    if args.quantiles:
        taus = tuple(float(t) for t in args.quantiles.split(","))
        bands = f.predict_quantiles(taus=taus, mesh=_mesh(args))
        if args.json:
            print(json.dumps({"quantiles": {str(t): bands[t].tolist() for t in taus}}))
            return 0
        for tau in taus:
            print(f"tau={tau}: first series", np.round(bands[tau][0], 2))
    else:
        fc = f.predict(mesh=_mesh(args))
        if args.json:
            print(json.dumps({"forecast": fc.tolist()}))
            return 0
        print(f"forecast {fc.shape}; first series", np.round(fc[0], 2))
    return 0


def cmd_eval(args):
    f = _fitted(args)
    scores = f.evaluate(split=args.split, mesh=_mesh(args))
    if args.json:
        print(json.dumps(scores))
        return 0
    print(f"{f.spec.name} [{args.split}]")
    for suffix, label in (("", "esrnn"), ("_comb", "comb"), ("_naive2", "naive2")):
        smape = scores[f"smape{suffix}"]
        mase = scores[f"mase{suffix}"]
        owa = scores.get(f"owa{suffix}")
        owa_s = f"  owa {owa:7.3f}" if owa is not None else ""
        print(f"  {label:8s} smape {smape:7.3f}  mase {mase:7.3f}{owa_s}")
    return 0


def cmd_backtest(args):
    f = _fitted(args)
    origins = (tuple(int(o) for o in args.origins.split(","))
               if args.origins else None)
    out = f.backtest(origins=origins, mesh=_mesh(args))
    if args.json:
        print(json.dumps(dict(out, forecasts=out["forecasts"].tolist())))
        return 0
    print(f"{f.spec.name} rolling-origin backtest "
          f"(horizon {out['horizon']}, one forward pass)")
    for row in out["per_origin"]:
        print(f"  origin {row['origin']:5d}  smape {row['smape']:7.3f}  "
              f"mase {row['mase']:7.3f}")
    print(f"  {'overall':>12s}  smape {out['smape']:7.3f}  "
          f"mase {out['mase']:7.3f}")
    return 0


def cmd_serve(args):
    f = _fitted(args)
    buckets = dict(
        length_buckets=tuple(int(b) for b in args.length_buckets.split(",")),
        batch_buckets=tuple(int(b) for b in args.batch_buckets.split(",")),
    )
    mesh = _mesh(args)
    if args.engine == "batch":
        srv = BucketDispatcher(
            f.config, f.params_, max_batch=args.max_batch, mesh=mesh, device=f.device,
            **buckets)
        t0 = time.perf_counter()
        for w in range(args.waves):
            reqs = synthetic_request_stream(
                f.config, args.requests, n_known=f.n_series_ or 0, seed=w)
            out = srv.forecast_batch(reqs)
            assert all(np.isfinite(o).all() for o in out)
        wall = time.perf_counter() - t0
    else:
        from repro_torch.forecast.server import ServerConfig

        srv = f.serve(
            server_config=ServerConfig(
                max_queue=args.queue_size, max_wait_ms=args.max_wait_ms,
                max_batch=args.max_batch),
            mesh=mesh, **buckets)
        t0 = time.perf_counter()
        # a sharded server runs synchronously, a wave at a time
        with srv if mesh is None else contextlib.nullcontext():
            for w in range(args.waves):
                reqs = synthetic_request_stream(
                    f.config, args.requests, n_known=f.n_series_ or 0, seed=w)
                futs = [srv.submit(r) for r in reqs]
                if mesh is not None:
                    srv.drain()
                for fut in futs:
                    assert np.isfinite(fut.result(timeout=120)).all()
        wall = time.perf_counter() - t0
    s = srv.stats
    pct = s.latency_percentiles()
    print(f"[{args.engine}] served {s.requests} requests in {s.batches} "
          f"batches over {args.waves} waves: {s.requests / wall:.0f} "
          f"series/s wall ({s.requests_per_s:.0f} req/s dispatch)")
    print(f"latency p50 {pct['p50_ms']:.1f} ms  p95 {pct['p95_ms']:.1f} ms  "
          f"p99 {pct['p99_ms']:.1f} ms; queue peak {s.queue_peak}")
    print(f"bucket shapes: {s.compiles} distinct, {s.cache_hits} repeats "
          f"({s.padded_series} padded lanes, {s.truncated_series} truncated)")
    return 0


def cmd_observe(args):
    """JSONL op loop over a continuous server (scripted round-trips).

    stdin lines:  {"op": "observe", "series_id": 3, "y": 105.2}
                  {"op": "forecast", "series_id": 3}          (online history)
                  {"op": "forecast", "y": [..], "series_id": 3}  (explicit)
                  {"op": "stats"}
    One JSON result line per op; forecasts drain synchronously, so every
    forecast reads all earlier observes (read-your-writes, no thread).
    """
    from repro_torch.forecast import ForecastRequest
    from repro_torch.forecast.server import ServerConfig

    f = _fitted(args)
    srv = f.serve(
        server_config=ServerConfig(
            max_queue=args.queue_size, max_wait_ms=args.max_wait_ms,
            finetune_steps=args.finetune_steps),
        mesh=_mesh(args), seed_histories=args.seed_histories)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            op = json.loads(line)
            kind = op["op"]
            if kind == "observe":
                srv.observe(int(op["series_id"]), float(op["y"]),
                            op.get("category"))
                out = {"op": "observe", "series_id": op["series_id"],
                       "ok": True}
            elif kind == "forecast":
                y = (np.asarray(op["y"], np.float32)
                     if op.get("y") is not None else None)
                fut = srv.submit(ForecastRequest(
                    y=y, category=int(op.get("category", 0)),
                    series_id=(int(op["series_id"])
                               if op.get("series_id") is not None else None)))
                srv.drain()
                out = {"op": "forecast",
                       "series_id": op.get("series_id"),
                       "forecast": [float(v) for v in fut.result(timeout=120)]}
            elif kind == "stats":
                s = srv.stats
                out = {"op": "stats", "requests": s.requests,
                       "observes": s.observes, "batches": s.batches,
                       "write_batches": s.write_batches,
                       "finetunes": s.finetunes, "compiles": s.compiles,
                       "cache_hits": s.cache_hits,
                       "truncated_series": s.truncated_series,
                       "queue_peak": s.queue_peak,
                       "tracked_series": len(srv.store),
                       **s.latency_percentiles()}
            else:
                out = {"ok": False, "error": f"unknown op {kind!r}"}
        except Exception as err:   # one bad line must not kill the loop
            out = {"ok": False, "error": f"{type(err).__name__}: {err}"}
        print(json.dumps(out), flush=True)
    srv.drain()
    return 0


def cmd_analyze(args):
    """The invariant auditor: a JSON report of every lint on this spec."""
    from repro_torch.analysis import run_audit

    over = _parse_overrides(args.set)
    if args.steps is not None:
        over["n_steps"] = args.steps
    spec = (get_smoke_spec(args.spec, **over) if args.smoke
            else get_spec(args.spec, **over))
    entries = tuple(e.strip() for e in args.entries.split(",") if e.strip())
    report = run_audit(spec, entries=entries, devices=args.devices, device=args.device)
    text = json.dumps(report.to_dict(), indent=2)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            fh.write(text + "\n")
        log.info("report written to %s", args.json_out)
    print(text)
    for f in report.violations:
        log.error("violation [%s]: %s", f.lint, f.message)
    return 0 if report.ok else 1


def _rank_cli(mesh, argv, stdin_text):
    """One rank of a sharded command: the subcommand over ``mesh``, its
    standard output returned (the launcher prints rank 0's)."""
    if mesh.rank == 0:
        logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    args.mesh = mesh
    out = io.StringIO()
    stdin, sys.stdin = sys.stdin, io.StringIO(stdin_text)
    try:
        with contextlib.redirect_stdout(out):
            rc = args.fn(args)
    finally:
        sys.stdin = stdin
    return rc, out.getvalue()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.forecast",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--spec", default="esrnn-quarterly",
                       help=f"registry name; one of {list_specs()}")
        p.add_argument("--smoke", action="store_true",
                       help="tiny model + tiny data, seconds on CPU")
        p.add_argument("--steps", type=int, help="override spec n_steps")
        p.add_argument("--device", default="cuda",
                       help="torch device to run on (default cuda; cpu for the CPU)")
        p.add_argument("--devices", type=int, metavar="N",
                       help="shard the series axis over N ranks (spawned by "
                            "this command; rank 0 writes and prints): fit "
                            "trains data-parallel, the other subcommands shard "
                            "their rows; analyze audits the collectives of the "
                            "sharded calls on N ranks")
        p.add_argument("--set", action="append", metavar="KEY=VAL",
                       help="spec/model override, e.g. --set hidden_size=16, "
                            "--set precision=bf16, --set scan_steps=8 "
                            "(superstep engine), --set sparse_adam=true "
                            "(segment per-series Adam), --set series_chunk=65536 "
                            "(out-of-core table, streamed in chunks)")

    p_specs = sub.add_parser(
        "specs", help="list the spec registry (name/frequency/horizon/head)")
    p_specs.add_argument("--json", action="store_true",
                         help="machine-readable JSON rows")
    p_specs.set_defaults(fn=cmd_specs)

    p_fit = sub.add_parser("fit", help="train an estimator")
    common(p_fit)
    p_fit.add_argument("--ckpt-dir", help="mid-training checkpoint/restart dir")
    p_fit.add_argument("--out-dir", help="save the fitted estimator here")
    p_fit.add_argument("--json", action="store_true",
                       help="print the per-step losses and val sMAPE as one JSON object")
    p_fit.set_defaults(fn=cmd_fit)

    p_pred = sub.add_parser("predict", help="point/quantile forecasts")
    common(p_pred)
    p_pred.add_argument("--dir", help="load a saved estimator")
    p_pred.add_argument("--quantiles", help="comma list of taus, e.g. 0.1,0.5,0.9")
    p_pred.add_argument("--json", action="store_true",
                        help="print every forecast (or band) as one JSON object")
    p_pred.set_defaults(fn=cmd_predict)

    p_eval = sub.add_parser("eval", help="sMAPE/MASE/OWA vs Comb/Naive2")
    common(p_eval)
    p_eval.add_argument("--dir", help="load a saved estimator")
    p_eval.add_argument("--split", default="test", choices=["val", "test"])
    p_eval.add_argument("--json", action="store_true",
                        help="print the scores as one JSON object")
    p_eval.set_defaults(fn=cmd_eval)

    p_bt = sub.add_parser(
        "backtest",
        help="rolling-origin sMAPE/MASE at several forecast origins, all "
             "from one forward pass (no refitting)")
    common(p_bt)
    p_bt.add_argument("--dir", help="load a saved estimator")
    p_bt.add_argument("--origins", metavar="O1,O2,...",
                      help="comma list of observation counts to forecast "
                           "from (each in [input_size, T]); default: end of "
                           "train and end of validation")
    p_bt.add_argument("--json", action="store_true",
                      help="print the scores and forecasts as one JSON object")
    p_bt.set_defaults(fn=cmd_backtest)

    p_srv = sub.add_parser("serve", help="continuous-batching forecast serving")
    common(p_srv)
    p_srv.add_argument("--dir", help="load a saved estimator")
    p_srv.add_argument("--requests", type=int, default=64, help="per wave")
    p_srv.add_argument("--waves", type=int, default=2,
                       help="request waves (wave 2+ repeats bucket shapes)")
    p_srv.add_argument("--length-buckets", default="32,64,128,256")
    p_srv.add_argument("--batch-buckets", default="1,4,16,64")
    p_srv.add_argument("--max-batch", type=int, default=64)
    p_srv.add_argument("--engine", choices=["continuous", "batch"],
                       default="continuous",
                       help="continuous: bounded queue + deadline-driven "
                            "bucket fill (the serving engine); batch: the "
                            "synchronous batch-at-a-time dispatcher")
    p_srv.add_argument("--queue-size", type=int, default=1024,
                       help="bounded request queue (submit backpressure)")
    p_srv.add_argument("--max-wait-ms", type=float, default=5.0,
                       help="max hold before a partial bucket dispatches")
    p_srv.set_defaults(fn=cmd_serve)

    p_an = sub.add_parser(
        "analyze",
        help="invariant auditor: lints (launch-shape budget, gradient leaks, "
             "in-place state, collectives, dtype policy) over the real fit, "
             "predict and serve entry points; exits 1 on any violation")
    common(p_an)
    p_an.add_argument("--entries", default="fit,predict,serve",
                      help="comma list from fit,predict,serve,collectives "
                           "(collectives also implied by --devices N > 1)")
    p_an.add_argument("--json-out", metavar="PATH",
                      help="also write the JSON report to PATH")
    p_an.set_defaults(fn=cmd_analyze)

    p_obs = sub.add_parser(
        "observe",
        help="JSONL op loop: online observe/forecast/stats over stdin")
    common(p_obs)
    p_obs.add_argument("--dir", help="load a saved estimator")
    p_obs.add_argument("--queue-size", type=int, default=1024)
    p_obs.add_argument("--max-wait-ms", type=float, default=5.0)
    p_obs.add_argument("--finetune-steps", type=int, default=0,
                       help="idle fine-tune steps per drained busy period "
                            "(0 = off)")
    p_obs.add_argument("--seed-histories", action="store_true",
                       help="pre-register every fitted series' training "
                            "history in the online store")
    p_obs.set_defaults(fn=cmd_observe)
    return ap


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    d = getattr(args, "devices", None)
    # analyze spawns the ranks of its collective audit itself
    if d is not None and d > 1 and args.cmd != "analyze":
        from repro_torch.sharding import run_ranks

        stdin_text = sys.stdin.read() if args.cmd == "observe" else ""
        (rc, text), *_ = run_ranks(_rank_cli, d, device=args.device,
                                   args=(argv, stdin_text))
        sys.stdout.write(text)
        sys.stdout.flush()
        return rc
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
