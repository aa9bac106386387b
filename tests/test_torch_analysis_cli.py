"""The port's ``analyze`` subcommand and ``run_audit`` plumbing on the CPU.

Counterpart of ``tests/analysis/test_audit_cli.py``, plus what the JAX
package leaves to its CI job: ``analyze --smoke --device cpu`` exits 0
with ``"ok": true`` for the lstm, esn and ssm heads, ``precision=bf16``
and the chunked step, with the reference's top-level keys and the
sections fit, predict and serve (and collectives with ``--devices 2``, two
gloo ranks); a seeded violation makes it exit 1.
"""

import json
import os
import subprocess
import sys
from unittest import mock

import pytest
import torch

from repro_torch.analysis import run_audit
from repro_torch.forecast import get_smoke_spec
from repro_torch.launch import forecast as cli
from repro_torch.train import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"spec", "ok", "violations_total", "sections"}


def test_run_audit_predict_entry_is_clean():
    report = run_audit(get_smoke_spec("esn-quarterly"), entries=("predict",), device="cpu")
    assert report.ok
    d = report.to_dict()
    assert d["ok"] is True
    assert d["violations_total"] == 0
    (sec,) = d["sections"]
    assert sec["name"] == "predict"
    assert sec["metrics"]["dtype"]["ops_scanned"] > 0
    json.loads(report.to_json())  # round-trips


def test_run_audit_rejects_unknown_entry():
    with pytest.raises(ValueError, match="nope"):
        run_audit(get_smoke_spec("esn-quarterly"), entries=("fit", "nope"), device="cpu")


def test_analyze_cli_writes_report_and_exits_zero(tmp_path):
    out = tmp_path / "audit.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.join(REPO, "src") + os.pathsep
                         + env.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.forecast", "analyze",
         "--smoke", "--device", "cpu", "--set", "head=esn", "--entries", "predict",
         "--json-out", str(out)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(out.read_text())
    assert report["ok"] is True
    assert [s["name"] for s in report["sections"]] == ["predict"]


def _analyze(tmp_path, *argv):
    out = tmp_path / "report.json"
    rc = cli.main(["analyze", "--smoke", "--device", "cpu", "--json-out", str(out), *argv])
    return rc, json.loads(out.read_text())


@pytest.mark.parametrize("sets", [(), ("head=esn",), ("head=ssm",), ("precision=bf16",),
                                  ("series_chunk=8",)],
                         ids=["lstm", "esn", "ssm", "bf16", "chunked"])
def test_analyze_exits_zero_on_every_preset(tmp_path, capsys, sets):
    rc, report = _analyze(tmp_path, *(a for s in sets for a in ("--set", s)))
    assert rc == 0
    assert report.keys() == KEYS
    assert report["ok"] is True and report["violations_total"] == 0
    assert [s["name"] for s in report["sections"]] == ["fit", "predict", "serve"]
    assert json.loads(capsys.readouterr().out) == report
    fit = report["sections"][0]["metrics"]
    assert fit["engine"] == ("chunked" if sets == ("series_chunk=8",) else "dense")
    assert fit["frozen_groups"] == (["rnn"] if sets == ("head=esn",) else [])


def test_analyze_devices_2_adds_the_collectives(tmp_path, capsys):
    rc, report = _analyze(tmp_path, "--devices", "2", "--entries", "predict")
    assert rc == 0 and report["ok"] is True
    assert [s["name"] for s in report["sections"]] == ["predict", "collectives"]
    counts = report["sections"][1]["metrics"]["counts"]
    assert counts["predict"] == counts["mesh_predict"] == {"all_reduce": 1}
    assert counts["loss_grad"] == counts["mesh_loss_grad"] == {"all_reduce": 2}
    assert counts["backend"] == "gloo"


def test_analyze_exits_one_on_a_violation(tmp_path, capsys, caplog):
    """A float64 constant in the step's loss: the report lists the
    dtype-policy violation and the CLI exits 1."""
    real = engine.esrnn_loss_fn

    def f64_loss(*args, **kwargs):
        return real(*args, **kwargs) + torch.zeros((), dtype=torch.float64)

    with mock.patch.object(engine, "esrnn_loss_fn", f64_loss):
        rc, report = _analyze(tmp_path, "--entries", "fit")
    assert rc == 1
    assert report["ok"] is False and report["violations_total"] > 0
    lints = {v["lint"] for s in report["sections"] for v in s["violations"]}
    assert lints == {"dtype-policy"}
    assert "violation [dtype-policy]" in caplog.text
