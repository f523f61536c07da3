"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version."""

import torch


def records_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record a gradient through ``tensors`` here: a
    kernel launched through ctypes returns outputs with no ``grad_fn``, so
    its wrapper refuses such inputs rather than cut the gradient silently."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
