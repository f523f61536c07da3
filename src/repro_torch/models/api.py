"""Public model API (port of ``repro.models.api``): build models, describe
their inputs per shape, and load the JAX package's weights into the port.

``input_specs`` and ``cache_specs`` return meta tensors (shapes and dtypes,
no storage on any device): what the dry run (``repro_torch.launch.dryrun``)
traces a cell's program against."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.pytree import unflatten_from_paths

from .lm import LM, build_lm

__all__ = ["build_model", "input_specs", "cache_specs", "params_from_reference", "LM"]


def build_model(cfg: ModelConfig, **kw) -> LM:
    return build_lm(cfg, **kw)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta tensors for the batch of one (arch × shape) cell, the
    reference's shapes and dtypes:

    * train   — ``tokens [B, S+1]`` int32 (shift happens inside the loss)
    * prefill — ``tokens [B, S]``
    * decode  — ``tokens [B, 1]`` (the cache carries the S-token history)

    vlm and encdec archs also get the stubbed frontend's bf16
    ``source_embeds`` (precomputed patches or frames), except for decode."""
    b = shape.global_batch
    rows = {"train": shape.seq_len + 1, "prefill": shape.seq_len}.get(shape.kind, 1)
    specs = {"tokens": torch.empty((b, rows), dtype=torch.int32, device="meta")}
    if shape.kind != "decode":
        if cfg.cross_attn is not None:
            specs["source_embeds"] = torch.empty(
                (b, cfg.cross_attn.source_len, cfg.cross_attn.source_dim),
                dtype=torch.bfloat16, device="meta")
        if cfg.encoder is not None:
            specs["source_embeds"] = torch.empty(
                (b, cfg.encoder.source_len, cfg.d_model), dtype=torch.bfloat16, device="meta")
    return specs


def cache_specs(lm: LM, batch: int, cache_len: int) -> dict:
    """The decode cache on the meta device; under a rank context
    (``lm.tp``) the rank's shard of it."""
    from . import decode as decode_lib  # it imports the sharding, which imports this package

    return decode_lib.init_cache(lm, batch, cache_len, device="meta")


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
