"""Deterministic, reshard-invariant data pipeline (a copy of
``repro.train.data``: numpy only, so its batches equal the reference's).

Elastic resume (the paper's headline capability) silently requires the
*data loader* to be reconfigurable too: after moving from DP=8 to DP=4 the
run must continue consuming the exact same global sample sequence.  We get
this by making the pipeline **stateless**: sample ``g`` of the run is a pure
function of ``(seed, g)``, and step ``t`` consumes samples
``[t·B, (t+1)·B)``.  Any DP layout can compute exactly its slice, and the
only checkpointed state is the step counter (a manifest scalar).

Content: a mixture of per-sample modular-stride walks over a per-sample
alphabet plus noise — cheap to generate and genuinely learnable, so the
paper's loss-curve comparisons (Fig. 6/7) show real convergence rather
than flat noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeSpec

__all__ = ["DataSpec", "sample_tokens", "global_batch", "batch_for_step"]


@dataclasses.dataclass(frozen=True)
class DataSpec:
    vocab_size: int
    seq_len: int
    seed: int = 0
    noise: float = 0.15


def sample_tokens(spec: DataSpec, g: int) -> np.ndarray:
    """Sample ``g`` of the stream: [seq_len+1] int32 (inputs+shifted labels)."""
    rng = np.random.default_rng(np.random.SeedSequence([spec.seed, int(g)]))
    n = spec.seq_len + 1
    v = spec.vocab_size
    start = int(rng.integers(v))
    stride = int(rng.integers(1, min(v, 64)))
    walk = (start + stride * np.arange(n, dtype=np.int64)) % v
    noise_mask = rng.random(n) < spec.noise
    noise = rng.integers(0, v, size=n)
    return np.where(noise_mask, noise, walk).astype(np.int32)


def global_batch(spec: DataSpec, step: int, batch: int) -> np.ndarray:
    """The full global batch for one step: [batch, seq_len+1]."""
    if batch == 0:  # np.stack rejects an empty list; the shape is still known
        return np.empty((0, spec.seq_len + 1), np.int32)
    base = step * batch
    return np.stack([sample_tokens(spec, base + i) for i in range(batch)])


def batch_for_step(
    cfg: ModelConfig,
    shape: ShapeSpec,
    step: int,
    *,
    seed: int = 0,
    batch_override: int | None = None,
    seq_override: int | None = None,
) -> dict:
    """Materialized training batch (tokens + stubbed frontend embeddings).

    Each frontend branch draws from its own seed domain (the second
    SeedSequence word) and lands under its own key — a model with both a
    cross-attention frontend and an encoder gets two *independent* streams
    instead of two correlated draws silently overwriting one key.
    ``source_embeds`` is the model-facing stream ``LM.forward`` consumes:
    the encoder frames when an encoder exists (matching forward's
    precedence), else the cross-attention embeddings.
    """
    b = shape.global_batch if batch_override is None else batch_override
    s = shape.seq_len if seq_override is None else seq_override
    spec = DataSpec(cfg.vocab_size, s, seed)
    out: dict = {"tokens": global_batch(spec, step, b)}
    if cfg.cross_attn is not None:
        rng = np.random.default_rng(np.random.SeedSequence([seed, 7, step]))
        out["cross_attn_embeds"] = rng.standard_normal(
            (b, cfg.cross_attn.source_len, cfg.cross_attn.source_dim), np.float32
        )
    if cfg.encoder is not None:
        rng = np.random.default_rng(np.random.SeedSequence([seed, 11, step]))
        out["encoder_embeds"] = rng.standard_normal(
            (b, cfg.encoder.source_len, cfg.d_model), np.float32
        )
    if cfg.encoder is not None:
        out["source_embeds"] = out["encoder_embeds"]
    elif cfg.cross_attn is not None:
        out["source_embeds"] = out["cross_attn_embeds"]
    return out
