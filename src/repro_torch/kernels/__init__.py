"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version."""

import torch


def records_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record a gradient through ``tensors`` here: a
    kernel launched through ctypes returns outputs with no ``grad_fn``, so
    its wrapper refuses such inputs rather than cut the gradient silently."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def row_alignment(*tensors: torch.Tensor) -> int:
    """The widest copy (16, 8, 4 or 2 bytes, else 1) that moves every row of
    these tensors whole: each data pointer, the stride of every dimension
    longer than 1 but the last, and the last dimension's bytes must all be
    multiples of it (pure Python on ``data_ptr``, ``stride`` and ``shape``).
    The bf16 kernels copy rows asynchronously, so their wrappers check it
    against what the kernel needs before they launch."""
    for vec in (16, 8, 4, 2):
        if all(
            t.data_ptr() % vec == 0
            and (t.shape[-1] * t.element_size()) % vec == 0
            and all(t.shape[d] == 1 or (t.stride(d) * t.element_size()) % vec == 0
                    for d in range(t.dim() - 1))
            for t in tensors
        ):
            return vec
    return 1
