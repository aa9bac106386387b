"""PyTorch/CUDA port of the Fast ES-RNN reproduction.

The JAX package ``repro`` is the reference; this package grows beside it,
slice by slice, and imports nothing of it. It carries the forecast-serving
path -- Holt-Winters smoothing (CUDA kernel K1), the dilated residual LSTM
(fused-cell CUDA kernel K3), the lstm head, the forecast entry points and
the continuous-batching server -- and the training path: the loss, two-group
Adam, the engines and ``train_esrnn``, and the server's idle fine-tune,
whose backward runs the CUDA kernels K2 (HW-scan adjoint), K4 and K5 (the
cell's training forward and backward). Entry points run on the card unless
the caller passes ``device="cpu"``.
"""

from repro_torch.device import resolve_device, strict_fp32

__all__ = ["resolve_device", "strict_fp32"]
