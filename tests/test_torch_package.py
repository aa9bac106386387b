"""The port as a package: isolation from JAX, device rules, conversion, build.

* ``src/repro_torch``, ``chip_smoke.py`` and the Torch examples
  (``examples/*_torch.py``) import neither ``jax`` nor the JAX package
  ``repro`` (an AST scan; the package also imported with ``jax`` blocked);
* entry points run on the card unless told otherwise, and on a host without
  one they raise instead of running on the CPU;
* CPU tensors take the plain versions, forward and backward: the kernel
  launch counters stay 0, and the CUDA wrappers refuse CPU tensors;
* ``convert`` round-trips the JAX params pytree bitwise;
* a kernel build without nvcc raises.

The kernels themselves are held against their plain versions on the card by
``tests/test_torch_kernels_cuda.py``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import esrnn as jes
from repro_torch.convert import params_from_numpy, params_to_device, params_to_numpy
from repro_torch.core import esrnn as tes
from repro_torch.data.pipeline import synthetic_prepared
from repro_torch.forecast import BucketDispatcher, ESRNNForecaster, get_smoke_spec
from repro_torch.forecast.server import ForecastServer, IdleFineTuner
from repro_torch.kernels import build, flash_attention, hw_scan, lstm_cell, ops
from repro_torch.launch import forecast as forecast_cli
from repro_torch.launch import train as lm_train
from repro_torch.train.trainer import TrainConfig, train_esrnn

ROOT = Path(__file__).resolve().parents[1]
NO_LAUNCHES = {"hw_scan": 0, "hw_scan_bf16": 0, "hw_scan_bwd": 0, "hw_scan_bwd_bf16": 0,
               "lstm_cell": 0, "lstm_cell_bf16": 0, "lstm_cell_fwd": 0,
               "lstm_cell_fwd_bf16": 0, "lstm_cell_bwd": 0, "lstm_cell_bwd_bf16": 0,
               "lstm_cell_bwd_dx": 0, "lstm_cell_bwd_dx_bf16": 0,
               "flash_attention": 0}
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
EXAMPLE_FILES = sorted((ROOT / "examples").glob("*_torch.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES + EXAMPLE_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_the_scan_covers_the_examples():
    assert [p.name for p in EXAMPLE_FILES] == [
        "forecast_m4_torch.py", "quickstart_torch.py", "serve_decode_torch.py",
        "train_lm_torch.py"]


def test_the_scan_covers_the_auditor():
    auditor = sorted(p.name for p in PORT_FILES if p.parent.name == "analysis")
    assert auditor == ["__init__.py", "audit.py", "collectives.py", "donation.py",
                       "dtypes.py", "gradleak.py", "recompile.py", "trace.py"]


def test_port_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES if p.name != "chip_smoke.py")
    code = ("import sys\nsys.modules['jax'] = None\n"
            + "".join(f"import {m}\n" for m in modules)
            + "assert not any(k == 'repro' or k.startswith('repro.') for k in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    cfg = tes.make_config("quarterly", hidden_size=8)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tes.esrnn_init(gen, cfg, 3)
    params = tes.esrnn_init(gen, cfg, 3, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BucketDispatcher(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ForecastServer(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_to_device(params, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_esrnn(cfg, synthetic_prepared(3, series_length=20),
                    TrainConfig(n_steps=1, batch_size=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IdleFineTuner(cfg, params)
    spec = get_smoke_spec("esrnn-quarterly", n_steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ESRNNForecaster(spec).fit()
    saved = ESRNNForecaster(spec, device="cpu")
    saved.init_params(3)
    saved.save(str(tmp_path / "fq"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ESRNNForecaster.load(str(tmp_path / "fq"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        forecast_cli.main(["fit", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_train.train("granite-3-2b", smoke=True, steps=1, batch=2, seq=8)


def test_cpu_tensors_take_the_plain_versions():
    cfg = tes.make_config("quarterly", hidden_size=8)
    params = tes.esrnn_init(torch.Generator().manual_seed(0), cfg, 4, device="cpu")
    y = torch.from_numpy(np.linspace(10, 20, 4 * 30, dtype=np.float32).reshape(4, 30))
    cats = torch.eye(6)[:4]
    ops.reset_launch_counts()
    fc = tes.esrnn_forecast(cfg, params, y, cats)
    assert torch.isfinite(fc).all()
    out = train_esrnn(cfg, synthetic_prepared(4, series_length=20),
                      TrainConfig(n_steps=2, batch_size=2), device="cpu")
    assert np.isfinite(out["history"]["loss"]).all()
    assert ops.launch_counts() == NO_LAUNCHES


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.ones((2, 3))
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        hw_scan.hw_scan_tm(x, x[0], x[0], x)
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        lstm_cell.lstm_cell(torch.ones((3, 8)), torch.ones((2, 8)), torch.ones(8),
                            x, torch.ones((2, 2)), torch.ones((2, 2)))
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        hw_scan.hw_scan_bwd_tm(x, x[0], x[0], x, torch.ones((3, 3)), x, torch.ones((3, 3)))
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        lstm_cell.lstm_cell_fwd(torch.ones((3, 8)), torch.ones((2, 8)), torch.ones(8),
                                x, torch.ones((2, 2)), torch.ones((2, 2)))
    h = torch.ones((2, 2))
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        lstm_cell.lstm_cell_bwd(torch.ones((3, 8)), torch.ones((2, 8)), x, h, h, h,
                                torch.ones((2, 8)), h, h)
    qkv = torch.ones((1, 2, 4, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA kernel got a tensor on cpu"):
        flash_attention.flash_attention(qkv, qkv, qkv, causal=True)
    assert ops.launch_counts() == NO_LAUNCHES


@pytest.mark.parametrize("attention", [False, True])
def test_convert_round_trips_jax_params_bitwise(attention):
    cfg = jes.make_config("hourly", hidden_size=8, attention=attention)
    jp = jax.tree_util.tree_map(np.asarray, jes.esrnn_init(jax.random.PRNGKey(3), cfg, 5))
    back = params_to_numpy(params_from_numpy(jp, "cpu"))
    want = dict(jp, hw={k: v for k, v in vars(jp["hw"]).items()})
    w_leaves, w_def = jax.tree_util.tree_flatten(want)
    g_leaves, g_def = jax.tree_util.tree_flatten(back)
    assert w_def == g_def
    for w, g in zip(w_leaves, g_leaves):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


def test_params_to_device_copies_instead_of_moving():
    cfg = tes.make_config("quarterly", hidden_size=8)
    params = tes.esrnn_init(torch.Generator().manual_seed(0), cfg, 2, device="cpu")
    same = params_to_device(params, "cpu")
    assert same["rnn"] is params["rnn"] and same["head"] is params["head"]


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.library()
    assert build._lib is None
