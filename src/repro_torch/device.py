"""Device resolution and the fp32 switches of the PyTorch port.

Every entry point of the port takes an explicit ``device``. ``None`` means
the card: the port is written for one NVIDIA GPU, and a caller that wants
the CPU (the parity tests do) says so with ``device="cpu"``. Asking for CUDA
on a host without a card raises; nothing drops to the CPU on its own.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "strict_fp32"]


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names another device; raise if unusable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on cuda or cpu, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless told otherwise, and "
            "this host has none (torch.cuda.is_available() is False); pass "
            "device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        # name the card, so device comparisons with tensors' devices hold
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def strict_fp32() -> None:
    """Turn TF32 off for float32 matrix products and convolutions.

    The JAX reference computes in true float32. On the card a float32
    convolution goes through cuDNN in TF32 by default (about three decimal
    digits), and a matmul does so whenever a caller enabled it; fp32 parity
    runs (the tests, ``chip_smoke.py``) call this first so that neither does.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
