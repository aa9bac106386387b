"""PyTorch/CUDA port of the Fast ES-RNN reproduction.

The JAX package ``repro`` is the reference; this package grows beside it,
slice by slice, and imports nothing of it. This slice carries the
forecast-serving path: Holt-Winters smoothing (CUDA kernel K1), the dilated
residual LSTM (fused-cell CUDA kernel K3), the lstm head, the forecast entry
points, and the continuous-batching server. Entry points run on the card
unless the caller passes ``device="cpu"``.
"""

from repro_torch.device import resolve_device, strict_fp32

__all__ = ["resolve_device", "strict_fp32"]
