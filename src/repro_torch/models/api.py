"""Public model API (port of ``repro.models.api``): build models, and load
the JAX package's weights into the port."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pytree import unflatten_from_paths

from .lm import LM, build_lm

__all__ = ["build_model", "params_from_reference", "LM"]


def build_model(cfg: ModelConfig, **kw) -> LM:
    return build_lm(cfg, **kw)


def params_from_reference(
    flat: Mapping[str, np.ndarray], lm: LM, device: str | torch.device
) -> dict:
    """The JAX package's flat params (numpy, from ``flatten_with_paths``) as
    the port's nested params on ``device``.

    Raises on any name, shape or dtype that disagrees with the port's
    :class:`~repro_torch.models.common.ParamRegistry`, so both packages are
    known to compute from identical weights.
    """
    want = {d.path: d.shape for d in lm.registry}
    if set(flat) != set(want):
        raise ValueError(
            f"parameter names differ: reference-only {sorted(set(flat) - set(want))}, "
            f"port-only {sorted(set(want) - set(flat))}"
        )
    out = {}
    for name, arr in flat.items():
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(want[name]):
            raise ValueError(f"{name}: shape {arr.shape} != port shape {want[name]}")
        if arr.dtype != np.float32:
            raise ValueError(f"{name}: dtype {arr.dtype} != float32")
        out[name] = torch.from_numpy(np.array(arr)).to(device)
    return unflatten_from_paths(out)
