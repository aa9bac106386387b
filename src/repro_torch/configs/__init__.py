"""Architecture + shape-cell registry (a copy of the JAX package's).

``get_config(arch)`` / ``get_smoke_config(arch)`` return the exact assigned
configs; ``SHAPES`` defines the four assigned input-shape cells and
``cell_applicable`` encodes the skip rules from the task spec (long_500k
only for sub-quadratic archs; decode shapes only for archs with a decoder).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

from repro_torch.models.config import ArchConfig

_MODULES = {
    "granite-3-2b": "granite_3_2b",
    "yi-6b": "yi_6b",
    "qwen2.5-14b": "qwen2_5_14b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "internvl2-2b": "internvl2_2b",
    "whisper-base": "whisper_base",
    "zamba2-2.7b": "zamba2_2_7b",
    "mamba2-1.3b": "mamba2_1_3b",
}

ARCHS: List[str] = list(_MODULES)

# ES-RNN (the paper's own model) lives behind the JAX package's unified
# forecasting registry (``get_spec("esrnn-<freq>")``, where these legacy m4-*
# aliases also resolve); in the port its presets are ``core.esrnn.make_config``.
ESRNN_CONFIGS = ("m4-yearly", "m4-quarterly", "m4-monthly", "m4-hourly")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatch: Optional[int] = None   # grad-accumulation slice (train only)


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256, microbatch=32),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

# archs with sub-quadratic sequence mixing (long_500k runs only for these)
SUBQUADRATIC = {"zamba2-2.7b", "mamba2-1.3b"}


def cell_applicable(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, "full-attention arch: 500k decode skipped per spec"
    return True, ""


def all_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in SHAPES if cell_applicable(a, s)[0]]


def get_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE
