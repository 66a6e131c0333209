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
