"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources in ``csrc/*.cu`` have a plain C interface (``void*`` pointers,
ints and the stream; each returns ``cudaGetLastError()``), so they build in
seconds without PyTorch's headers. At first use :func:`library` compiles
every source to an object file, one ``nvcc`` process per source started
together, links them into one shared library under ``_build/`` (listed in
``.gitignore``) and loads it. The library is keyed by a hash of the sources
and the flags: an edited kernel rebuilds, an unchanged one loads the file a
previous process left.

No ``--use_fast_math``: ``/``, ``expf`` and ``tanhf`` stay IEEE and match the
plain PyTorch versions. A failed build raises with nvcc's output; nothing
falls back to another path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel entry points: name -> (pointer args, int args, float args), in that
# order; each one ends with the stream pointer and returns its cudaError_t
# as an int
_SIGNATURES = {
    "hw_scan_f32": (8, 4, 0),              # K1 (the last pointer and first int: its plan)
    "hw_scan_bf16": (8, 4, 0),             # K1, bf16 y
    "hw_scan_bwd_f32": (13, 4, 0),         # K2 (likewise)
    "hw_scan_bwd_bf16": (13, 4, 0),        # K2, bf16 y and dy
    "lstm_cell_f32": (9, 4, 0),            # K3 (the last pointer and first int: its plan)
    "lstm_cell_bf16": (9, 4, 0),           # K3, bf16, tensor cores (lstm_cell_tc.cu)
    "lstm_cell_wide_bf16": (9, 4, 0),      # K3, bf16, past the presets' widths
    "lstm_cell_fwd_f32": (10, 4, 0),       # K4
    "lstm_cell_fwd_bf16": (10, 4, 0),      # K4, bf16, tensor cores (lstm_cell_tc.cu)
    "lstm_cell_fwd_wide_bf16": (10, 4, 0),  # K4, bf16, past the presets' widths
    "lstm_cell_bwd_f32": (18, 4, 0),       # K5
    "lstm_cell_bwd_bf16": (18, 4, 0),      # K5, bf16, tensor cores (lstm_cell_bwd_tc.cu;
                                           # float32 weight gradients)
    "lstm_cell_bwd_wide_bf16": (18, 4, 0),  # K5, bf16, past the presets' widths
    "lstm_cell_bwd_dx_f32": (11, 4, 0),    # K5's dx-only launch (no weight gradients)
    "lstm_cell_bwd_dx_bf16": (11, 4, 0),   # the same, bf16, tensor cores
    "lstm_cell_bwd_dx_wide_bf16": (11, 4, 0),  # the same, bf16, past the presets' widths
    "flash_attention_f32": (4, 8, 1),      # K6, fp32
    "flash_attention_bf16": (4, 8, 1),     # K6, bf16
    "flash_attention_decode_bf16": (6, 8, 1),  # K6, bf16, G * Tq <= 16 rows a kv head at D 64
                                           # (the last two pointers: its workspace)
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build in this process did: seconds, per-source ptxas report
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of repro_torch cannot be built on this host")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):       # the sources and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_parallel(cmds):
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            for other in procs:
                if other.poll() is None:
                    other.kill()
                    other.wait()
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
        outs.append(out)
    return outs


def _build(target: Path) -> None:
    nvcc = _nvcc()
    work = target.parent / f"tmp.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs, cmds = [], []
    for src in _sources():
        obj = work / (src.stem + ".o")
        objs.append(obj)
        cmds.append([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)])
    reports = _run_parallel(cmds)
    tmp_so = work / target.name
    _run_parallel([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
                    *map(str, objs)]])
    os.replace(tmp_so, target)          # atomic: readers never see a half file
    shutil.rmtree(work, ignore_errors=True)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["ptxas"] = {src.name: rep for src, rep in zip(_sources(), reports)}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = BUILD_DIR / f"librepro_torch_kernels.{source_hash()}.so"
        if target.exists():
            build_info.setdefault("seconds", 0.0)
        else:
            _build(target)
        lib = ctypes.CDLL(str(target))
        for name, (n_ptr, n_int, n_float) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + [ctypes.c_float] * n_float + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_device_limits.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                            ctypes.POINTER(ctypes.c_int)]
        lib.repro_device_limits.restype = ctypes.c_int
        for name in ("repro_lstm_cell_constants", "repro_lstm_cell_tc_constants",
                     "repro_lstm_cell_bwd_tc_constants"):
            getattr(lib, name).argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_int
        _lib = lib
        return lib


@functools.lru_cache(maxsize=4096)
def plan_ints(plan) -> ctypes.Array:
    """A launch plan (a NamedTuple of ints) as the C array a kernel's entry
    point reads."""
    return (ctypes.c_int * len(plan))(*plan)


class DeviceLimits(NamedTuple):
    sm_count: int
    smem_optin: int      # dynamic shared memory one block may opt in to, bytes


_limits: Dict[int, DeviceLimits] = {}


def device_limits(device) -> DeviceLimits:
    """The SM count and opt-in shared memory of a CUDA device, which the
    kernels' launch plans are made for; kept per device index."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    found = _limits.get(index)
    if found is None:
        sm, optin = ctypes.c_int(), ctypes.c_int()
        check(library().repro_device_limits(index, ctypes.byref(sm), ctypes.byref(optin)),
              "device limits")
        found = _limits[index] = DeviceLimits(sm.value, optin.value)
    return found


def check_inputs(kernel: str, named_shapes, device, dtypes=(torch.float32,)) -> None:
    """Refuse what a kernel does not take, before any pointer is passed.

    ``named_shapes`` is ``[(name, tensor, expected_shape), ...]``; every
    tensor must be of one of ``dtypes`` (float32 unless the kernel takes
    more), contiguous and on ``device`` (a CUDA device).
    A launch wrapper's outputs are outside autograd, so it refuses a tensor
    that needs a gradient while grad mode is on: differentiable calls go
    through the ``torch.autograd.Function``s (``hw_scan.HWScan``,
    ``lstm_cell.LSTMCell``), which ``kernels.ops`` routes to, and whose
    forward and backward run with grad mode off.
    """
    if device.type != "cuda":
        raise ValueError(f"{kernel}: the CUDA kernel got a tensor on {device}")
    for name, t, shape in named_shapes:
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, expected {device}")
        if t.dtype not in dtypes:
            takes = " or ".join(str(dt).removeprefix("torch.") for dt in dtypes)
            only = " only" if len(dtypes) == 1 else ""
            raise TypeError(f"{kernel}: {name} is {t.dtype}; the kernel takes {takes}{only}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(
                f"{kernel}: {name} needs a gradient; call the kernel through "
                f"repro_torch.kernels.ops (its autograd.Function) or under "
                f"torch.no_grad()")


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err} ({msg})")
