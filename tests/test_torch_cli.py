"""The port's forecast CLI (``repro_torch.launch.forecast``) on the CPU.

``main([..., "--device", "cpu"])`` runs every subcommand in process: ``specs``
(its ``--json`` rows equal the JAX CLI's, every head), ``fit --out-dir``,
``predict`` (point and ``--quantiles``), ``eval``, ``backtest`` (default and
explicit origins), ``serve`` (both engines), ``observe`` over stdin, and
``fit --ckpt-dir`` resuming a finished checkpoint. ``predict --dir`` on a
directory the JAX CLI saved prints the JAX CLI's first-series forecast.
The esn and ssm heads (``--spec esn-quarterly``, ``--set head=ssm``) fit,
resume and predict through the same subcommands.
"""

import io
import json
import os
import re

import numpy as np
import pytest

from repro.launch import forecast as jcli
from repro_torch.launch import forecast as cli

FIT = ["--smoke", "--steps", "4", "--set", "eval_every=2", "--set", "ckpt_every=2"]


def _run(capsys, argv, main=cli.main):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


def _cpu(*argv):
    return list(argv) + ["--device", "cpu"]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    out, ckpt = str(root / "fq"), str(root / "ckpt")
    assert cli.main(_cpu("fit", *FIT, "--out-dir", out, "--ckpt-dir", ckpt)) == 0
    return out, ckpt


def test_specs_match_the_jax_cli(capsys):
    rows = json.loads(_run(capsys, ["specs", "--json"]))
    want = json.loads(_run(capsys, ["specs", "--json"], main=jcli.main))
    assert rows == want
    assert {r["head"] for r in rows} == {"lstm", "esn", "ssm"}
    table = _run(capsys, ["specs"])
    assert "esrnn-quarterly" in table and "lstm" in table
    assert "esn-quarterly" in table and "ssm-monthly" in table


def test_fit_saves_and_resumes(capsys, saved):
    out, ckpt = saved
    assert sorted(os.listdir(out)) == ["forecaster.json", "params"]
    text = _run(capsys, _cpu("fit", *FIT, "--ckpt-dir", ckpt))
    assert "resumed from a finished checkpoint" in text


def test_json_output_is_full_precision(capsys, saved):
    from repro_torch.forecast import ESRNNForecaster

    out, _ = saved
    fit = json.loads(_run(capsys, _cpu("fit", *FIT, "--json")))
    assert len(fit["loss"]) == 4 and [s for s, _ in fit["val_smape"]] == [2, 4]
    f = ESRNNForecaster.load(out, device="cpu")
    f.data_ = f.make_data()
    fc = json.loads(_run(capsys, _cpu("predict", "--dir", out, "--json")))["forecast"]
    np.testing.assert_array_equal(np.asarray(fc, np.float32), f.predict())
    bands = json.loads(_run(capsys, _cpu("predict", "--dir", out, "--json",
                                         "--quantiles", "0.1,0.9")))["quantiles"]
    want = f.predict_quantiles(taus=(0.1, 0.9))
    np.testing.assert_array_equal(np.asarray(bands["0.9"], np.float32), want[0.9])
    scores = json.loads(_run(capsys, _cpu("eval", "--dir", out, "--json")))
    assert scores == f.evaluate()
    bt = json.loads(_run(capsys, _cpu("backtest", "--dir", out, "--json")))
    np.testing.assert_array_equal(np.asarray(bt["forecasts"], np.float32),
                                  f.backtest()["forecasts"])


def test_predict_point_and_quantiles(capsys, saved):
    out, _ = saved
    text = _run(capsys, _cpu("predict", "--dir", out))
    assert text.startswith("forecast (18, 8); first series")
    text = _run(capsys, _cpu("predict", "--dir", out, "--quantiles", "0.1,0.5,0.9"))
    lines = text.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["tau=0.1", "tau=0.5", "tau=0.9"]


@pytest.mark.parametrize("split", ["val", "test"])
def test_eval(capsys, saved, split):
    text = _run(capsys, _cpu("eval", "--dir", saved[0], "--split", split))
    assert f"[{split}]" in text
    for label in ("esrnn", "comb", "naive2"):
        assert label in text


@pytest.mark.parametrize("origins", [None, "60,72,80"])
def test_backtest(capsys, saved, origins):
    argv = _cpu("backtest", "--dir", saved[0])
    text = _run(capsys, argv + (["--origins", origins] if origins else []))
    want = origins.split(",") if origins else ["72", "80"]
    got = [ln.split()[1] for ln in text.splitlines() if ln.strip().startswith("origin ")]
    assert got == want and "overall" in text


@pytest.mark.parametrize("engine", ["continuous", "batch"])
def test_serve(capsys, saved, engine):
    text = _run(capsys, _cpu("serve", "--dir", saved[0], "--engine", engine,
                             "--requests", "12", "--waves", "2"))
    assert f"[{engine}] served 24 requests" in text


def test_observe_over_stdin(capsys, monkeypatch, saved):
    lines = [{"op": "observe", "series_id": 0, "y": 105.2},
             {"op": "forecast", "series_id": 0},
             {"op": "stats"}, {"op": "nope"}]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(map(json.dumps, lines)) + "\n"))
    out = [json.loads(ln) for ln in _run(capsys, _cpu("observe", "--dir", saved[0]))
           .strip().splitlines()]
    assert out[0] == {"op": "observe", "series_id": 0, "ok": True}
    assert len(out[1]["forecast"]) == 8 and np.isfinite(out[1]["forecast"]).all()
    assert out[2]["observes"] == 1 and out[2]["requests"] == 1
    assert out[3]["ok"] is False


def test_predict_on_a_jax_saved_dir(capsys, tmp_path):
    d = str(tmp_path / "jax")
    _run(capsys, ["fit", *FIT, "--out-dir", d], main=jcli.main)
    want = _run(capsys, ["predict", "--dir", d], main=jcli.main)
    got = _run(capsys, _cpu("predict", "--dir", d))
    head = lambda text: text.split("[")[0]
    numbers = lambda text: np.array(re.findall(r"[-\d.]+", text.split("[")[1]), float)
    assert head(got) == head(want) == "forecast (18, 8); first series "
    # the forecasts agree within rtol 1e-4; the print rounds to 0.01, so a
    # value on a rounding boundary may print one step apart
    np.testing.assert_allclose(numbers(got), numbers(want), rtol=1e-4, atol=0.01)


def test_devices_and_bad_overrides_exit(saved, capsys):
    # --devices 2 spawns two ranks (rank 0 prints): the same forecasts
    # (tests/test_torch_dp.py holds every subcommand to 1e-6)
    one = _run(capsys, _cpu("predict", "--dir", saved[0], "--devices", "1"))
    two = _run(capsys, _cpu("predict", "--dir", saved[0], "--devices", "2"))
    assert one == two
    with pytest.raises(SystemExit, match="KEY=VAL"):
        cli.main(_cpu("fit", "--smoke", "--set", "hidden_size"))


@pytest.mark.parametrize("head,args", [("esn", ["--spec", "esn-quarterly"]),
                                       ("ssm", ["--set", "head=ssm"])])
def test_heads_fit_resume_and_predict(capsys, tmp_path, head, args):
    out, ckpt = str(tmp_path / "fq"), str(tmp_path / "ckpt")
    fit = json.loads(_run(capsys, _cpu("fit", *FIT, *args, "--out-dir", out,
                                       "--ckpt-dir", ckpt, "--json")).strip().splitlines()[-1])
    assert len(fit["loss"]) == 4 and np.isfinite(fit["loss"]).all()
    with open(os.path.join(out, "forecaster.json")) as f:
        saved = json.load(f)
    assert saved["spec"]["model"]["head"] == head
    text = _run(capsys, _cpu("fit", *FIT, *args, "--ckpt-dir", ckpt))
    assert "resumed from a finished checkpoint" in text
    pred = json.loads(_run(capsys, _cpu("predict", "--dir", out, "--json")).strip()
                      .splitlines()[-1])
    fc = np.asarray(pred["forecast"])
    assert fc.shape == (fit["n_series"], 8) and np.isfinite(fc).all()
