"""openpvsg_torch.kernels — see the package docstring."""
import torch


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """The CUDA kernels have no backward. Launched on a tensor that requires
    grad, with grad mode on, a kernel's output would silently carry no
    gradient, so the wrapper raises instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward and an input requires "
            "grad; run it under torch.no_grad() (inference), or build the "
            "model with train=True, which runs the unfused module chain")


def check_tensor(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    """Raises unless ``t`` is a contiguous, 16-byte aligned ``dtype`` tensor
    of ``shape`` on ``device``: what the kernels read through raw pointers."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")
