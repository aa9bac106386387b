"""The Torch versions of the examples, on the CPU.

``examples/quickstart_torch.py``, ``forecast_m4_torch.py`` and
``serve_decode_torch.py`` are their reference files with ``repro`` replaced
by ``repro_torch``: each makes the same ``print`` calls as its reference
(held on the two files' syntax trees) and, run in a fresh interpreter with
``--device cpu`` at a cut (``--steps``, ``--gen``), exits 0 and prints the
lines its reference prints, in their order and format (held by patterns of
the reference's f-strings). ``tests/test_torch_package.py`` holds that they
import neither ``jax`` nor ``repro``.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
NUM = r"-?\d+\.\d+"
INT_LIST = r"\[[\d, ]*\]"

CASES = {
    "quickstart": (["--steps", "3"], [
        rf"\d+ series, horizon \d+; loss {NUM} -> {NUM}",
        r"first series forecast: \['[-\d.]+', '[-\d.]+', '[-\d.]+', '[-\d.]+'\]",
        rf"80% band \(h=1\): \[{NUM}, {NUM}\]",
        rf"val sMAPE  ES-RNN: {NUM}   comb: {NUM}   naive2: {NUM}   OWA: {NUM}",
    ]),
    "forecast_m4": (["--steps", "3", "--freq", "quarterly"], [
        r"",
        r"=== quarterly ===",
        rf"test sMAPE: esrnn {NUM} \| comb {NUM} \| naive2 {NUM}",
        rf"test OWA:   esrnn {NUM} \| comb {NUM}",
        r"",
        r"summary \(test sMAPE, esrnn vs comb\):",
        rf"  quarterly +{NUM} vs +{NUM}  \((BEATS|trails) Comb\)",
    ]),
    "serve_decode": (["--gen", "3"], [
        rf"{arch:24s} prefill +{NUM} ms \| decode +{NUM} ms/token \| sample {INT_LIST}"
        for arch in ("yi-6b", "deepseek-v2-lite-16b", "mamba2-1.3b")
    ]),
}


def _prints(path):
    """The source of every ``print`` call of ``path``, in order."""
    tree = ast.parse(path.read_text())
    return [ast.unparse(n) for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "print"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_prints_as_the_reference(name):
    ref = _prints(ROOT / "examples" / f"{name}.py")
    assert ref and _prints(ROOT / "examples" / f"{name}_torch.py") == ref


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name, tmp_path):
    argv, patterns = CASES[name]
    if name == "forecast_m4":
        argv = argv + ["--ckpt-root", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}_torch.py"),
                          "--device", "cpu", *argv], capture_output=True, text=True,
                         env=env, cwd=tmp_path, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.splitlines()
    assert len(lines) == len(patterns), run.stdout
    for line, pattern in zip(lines, patterns):
        assert re.fullmatch(pattern, line), (line, pattern)
