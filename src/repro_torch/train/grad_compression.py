"""Error-feedback gradient compression (port of ``repro.train.grad_compression``).

Int8 stochastic quantization or top-k sparsification of the shared-weight
gradients, with error feedback: the residual is added back into the next
step's gradient, which keeps convergence (Karimireddy et al. 2019, "Error
Feedback Fixes SignSGD"). The per-series HW rows are never compressed.

As in the reference, the engine applies it to the reduced gradient: every
rank of a series mesh compresses the same all-reduced gradient with the same
noise and carries the same residual, so their states stay bit-identical.
The noise comes from an explicit ``torch.Generator`` on the CPU, which the
engine seeds from the sum of the batch's row indices -- the reference's key
is ``fold_in(PRNGKey(0), sum(idx))`` -- so a resumed run draws the same
noise at the same step on every rank and every device. JAX's threefry bits
are not reproduced; given the same noise, the arithmetic is the
reference's bit for bit.

Gradients and residuals are lists of tensors (the engine's leaf order).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def _noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Uniform noise in [-0.5, 0.5), drawn on the CPU from ``generator``."""
    return torch.rand(shape, generator=generator, dtype=torch.float32) - 0.5


def _int8_compress_with_noise(g: torch.Tensor, err: torch.Tensor, noise: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`int8_compress`'s arithmetic given the noise (tests hand in the
    reference's draw)."""
    g = g.float() + err
    scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / 127.0
    scaled = g / scale
    q = torch.clamp(torch.round(scaled + noise.to(g.device)), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, g - deq


def int8_compress(g: torch.Tensor, err: torch.Tensor, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stochastic int8 quantization with error feedback.

    Returns ``(q_int8, scale, new_err)`` with ``g + err == q * scale +
    new_err``.
    """
    return _int8_compress_with_noise(g, err, _noise(g.shape, generator))


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_compress(g: torch.Tensor, err: torch.Tensor, k_frac: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (by magnitude) sparsification with error feedback.

    Returns ``(sparse_g, new_err)``; ``sparse_g`` has ``g``'s shape with the
    entries below the k-th largest magnitude zeroed.
    """
    g = g.float() + err
    flat = torch.abs(g.reshape(-1))
    k = max(1, int(k_frac * flat.shape[0]))
    thresh = torch.topk(flat, k).values[-1]
    sparse = g * (torch.abs(g) >= thresh).float()
    return sparse, g - sparse


def compress_tree_int8(grads: Sequence[torch.Tensor], errs: Sequence[torch.Tensor],
                       generator: torch.Generator
                       ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Int8 error-feedback compression of every gradient, the noise of each
    drawn in turn from ``generator``. Returns ``(dequantized gradients,
    residuals)``: the values as they leave the collective."""
    out, new_errs = [], []
    for g, e in zip(grads, errs, strict=True):
        q, s, ne = int8_compress(g, e, generator)
        out.append(int8_decompress(q, s))
        new_errs.append(ne)
    return out, new_errs


def init_error_state(leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Float32 zero residuals, one per gradient leaf, on each leaf's device."""
    return [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in leaves]


def batch_generator(idx: torch.Tensor) -> torch.Generator:
    """The quantization noise of the batch ``idx``: a CPU generator seeded
    with the sum of its row indices."""
    return torch.Generator().manual_seed(int(idx.sum()))
