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


def kernel_path(*tensors: torch.Tensor) -> bool:
    """Whether the model takes a hand-written kernel for these tensors: they
    lie on the card, or on the meta device (the dry run's stand-in for the
    card, ``repro_torch.launch.dryrun``), and no gradient is recorded through
    them (the kernels have no backward, so training takes the plain
    differentiable functions on either)."""
    return tensors[0].device.type in ("cuda", "meta") and not records_grad(*tensors)


# The dry run's analyzers (``repro_torch.launch.hlo_analysis``) listening for
# the kernels' launches on the meta device, innermost last; empty otherwise.
META_SINKS: list = []


def report_meta_launch(name: str, *, flops: float, nbytes: int, shape: str) -> None:
    """A kernel wrapper's shape function reports one launch on the meta
    device, with the operations the kernel would do, the bytes it would read
    and write once, and a description of its shapes, to the innermost
    active analyzer."""
    if META_SINKS:
        META_SINKS[-1](name, flops, nbytes, shape)
