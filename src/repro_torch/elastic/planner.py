"""Elastic-capacity planning: healthy-device count → new mesh proposal
(port of ``repro.elastic.planner``).

The paper's headline scenario (§1, Fig. 1): ranks fail mid-run and the job
continues on whatever is left.  The planner proposes the largest feasible
``data × model`` mesh for the surviving devices, subject to a per-device
memory budget for the model's training state; the trainer then resumes
through UCP (the Source layout never constrains the choice).

The budget is the caller's: ``hbm_budget`` in bytes, or, given a CUDA
``device``, 0.8 of that card's memory as PyTorch reports it.  No device's
memory size is built in.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.layout import MeshSpec

__all__ = ["device_budget", "param_count", "propose_mesh", "state_bytes_per_chip"]

_STATE_BYTES_PER_PARAM = {
    # fp32 master + 2 moments (+bf16 live copy amortized into activations)
    "float32": 12.0,
    "bfloat16": 8.0,      # fp32 master + 2 bf16 moments
}


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (matches the registry within ~1%)."""
    from repro_torch.models.lm import build_param_defs

    reg = build_param_defs(cfg, cfg.vocab_size)
    return reg.num_params()


def state_bytes_per_chip(
    cfg: ModelConfig, mesh: MeshSpec, *, moment_dtype: str = "float32"
) -> float:
    n = param_count(cfg)
    per_param = _STATE_BYTES_PER_PARAM.get(moment_dtype, 12.0)
    return n * per_param / mesh.size  # fully sharded (ZeRO-3 + TP)


def device_budget(device: str | torch.device) -> float:
    """0.8 of a CUDA device's total memory, as PyTorch reports it."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no memory budget to read from device {device}: pass hbm_budget")
    return 0.8 * torch.cuda.get_device_properties(device).total_memory


def _pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n > 0 else 0


def propose_mesh(
    cfg: ModelConfig,
    healthy_devices: int,
    *,
    moment_dtype: str = "float32",
    max_model: int = 16,
    hbm_budget: float | None = None,
    device: str | torch.device | None = None,
) -> MeshSpec:
    """Largest power-of-two ``data × model`` mesh on the healthy devices.

    The model axis is sized so per-device weight shards stay comfortable
    (wider TP for wider models), the data axis takes the rest; a proposal
    whose state does not fit ``hbm_budget`` bytes per device moves toward
    more devices per replica.  ``hbm_budget`` defaults to
    :func:`device_budget` of ``device``; with neither this raises.
    """
    if healthy_devices < 1:
        raise ValueError("no healthy devices")
    if hbm_budget is None:
        if device is None:
            raise ValueError("propose_mesh needs hbm_budget or a CUDA device to read it from")
        hbm_budget = device_budget(device)
    usable = _pow2_floor(healthy_devices)
    model = min(max_model, usable, max(1, _pow2_floor(cfg.d_model // 512)))
    while model <= usable:
        data = usable // model
        mesh = MeshSpec((("data", data), ("model", model)))
        if state_bytes_per_chip(cfg, mesh, moment_dtype=moment_dtype) <= hbm_budget:
            return mesh
        model *= 2
    # even full TP doesn't fit: the flattest mesh, and the caller escalates
    # (e.g. bf16 moments or parameter offload)
    return MeshSpec((("data", 1), ("model", usable)))
