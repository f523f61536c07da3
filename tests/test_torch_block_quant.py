"""The port's block quantization, held against the JAX package bit for bit.

The format is hashed (served digests and the delta diff hash the decoded
bytes), so the plain PyTorch version must equal what the reference's codec
writes: its jitted ``block_quantize`` / ``block_dequantize`` (the jnp
``ref.py`` under ``jax.jit``) and its Pallas kernels under
``interpret=True``.  The sweep is ``tests/test_codec.py``'s (counts 1, 7,
256, 1000; blocks 64, 128, 256 and a non-power-of-two 100), plus zero
blocks, values up to 1e30 and magnitudes spread over 1e-13..1e13.

The reference's jitted scale is ``absmax · fl32(1/fmax)`` — XLA folds the
division by the constant — and an eager call of its ``ref.quantize_blocks``
divides instead; the test that pins the port to the jitted form also shows
the two differ.

NaN and inf (``NONFINITE``) are held apart from the sweep: q and scales
equal the reference byte for byte (e5m2 stores its NaN as ``0x7e | sign``),
but the decoded fp32 NaNs carry payloads that differ even between the
reference's own paths, so decoded values are compared by NaN class: NaN at
the same places, every other byte equal.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.block_quant import block_dequantize as ref_dequantize  # noqa: E402
from repro.kernels.block_quant import block_quantize as ref_quantize  # noqa: E402
from repro.kernels.block_quant import ref as jref  # noqa: E402
from repro.kernels.block_quant.kernel import (  # noqa: E402
    dequantize_blocks_pallas,
    quantize_blocks_pallas,
)

from repro_torch.kernels.block_quant import kernel, ref  # noqa: E402
from repro_torch.kernels.block_quant.ops import block_dequantize, block_quantize  # noqa: E402

QDTYPES = ["int8", "float8_e4m3fn", "float8_e5m2"]


def _rand(n, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) * scale).astype(np.float32)


def _spread(rows, block, seed=0):
    """Rows whose magnitudes span 1e-13..1e13: every rounding path."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, block)) * np.exp(rng.uniform(-30, 30, (rows, 1)))
    return x.astype(np.float32).reshape(-1)


CASES = {
    "normal-1": _rand(1, seed=1),
    "normal-7": _rand(7, seed=7),
    "normal-256": _rand(256, seed=256),
    "normal-1000": _rand(1000, seed=1000),
    "spread": _spread(600, 256),
    "zeros": np.zeros(300, np.float32),
    "zero-block-inside": np.concatenate([_rand(256), np.zeros(256, np.float32), _rand(50)]),
    "large": np.float32([1e30, -1e30, 0.5, 0.0, 3e29, -7.0]),
}


def _nonfinite():
    """±NaN and ±inf among normals, and 512:768 all NaN: a whole block at
    each tested block size (64, 100, 128, 256)."""
    x = _rand(800, seed=11)
    x[3], x[50], x[300], x[420] = np.nan, -np.nan, np.inf, -np.inf
    x[512:768] = np.nan
    return x


NONFINITE = _nonfinite()


def _same_by_nan_class(got: np.ndarray, want: np.ndarray):
    """NaN at the same places, every other element byte-equal."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert got[~nan].tobytes() == want[~nan].tobytes()


def _bytes(t):
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def _port(x, block, qdtype):
    q, s = block_quantize(torch.from_numpy(x), block=block, dtype=qdtype)
    return q, s, block_dequantize(q, s, count=x.size)


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("block", [64, 100, 128, 256])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_equals_reference_codec_core(case, block, qdtype):
    x = CASES[case]
    q, s, d = _port(x, block, qdtype)
    rq, rs = ref_quantize(x, block=block, dtype=qdtype)
    rd = np.asarray(ref_dequantize(rq, rs, count=x.size))
    assert _bytes(q) == np.asarray(rq).view(np.uint8).tobytes()
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    assert d.numpy().tobytes() == rd.tobytes()


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("block", [64, 100, 128, 256])
def test_plain_equals_reference_on_nonfinite(block, qdtype):
    x = NONFINITE
    q, s, d = _port(x, block, qdtype)
    rq, rs = ref_quantize(x, block=block, dtype=qdtype)
    rd = np.asarray(ref_dequantize(rq, rs, count=x.size))
    assert _bytes(q) == np.asarray(rq).view(np.uint8).tobytes()
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    _same_by_nan_class(d.numpy(), rd)
    assert np.isnan(d.numpy()[512:768]).all()  # the all-NaN block decodes to NaN


@pytest.mark.parametrize("qdtype", QDTYPES)
@pytest.mark.parametrize("n", [1, 7, 256, 1000])
def test_plain_equals_pallas_kernels_interpreted(qdtype, n):
    x = np.concatenate([_rand(n, seed=n), _spread(4, 128, seed=n)])
    blocks = np.asarray(jref.blocked(jnp.asarray(x), block=128))
    kq, ks = quantize_blocks_pallas(jnp.asarray(blocks), dtype=jnp.dtype(qdtype), interpret=True)
    kd = np.asarray(dequantize_blocks_pallas(kq, ks, interpret=True)).reshape(-1)[: x.size]
    q, s, d = _port(x, 128, qdtype)
    assert _bytes(q) == np.asarray(kq).view(np.uint8).tobytes()
    assert s.numpy().tobytes() == np.asarray(ks).tobytes()
    assert d.numpy().tobytes() == kd.tobytes()


@pytest.mark.parametrize("qdtype", QDTYPES)
def test_plain_equals_pallas_kernels_interpreted_on_nonfinite(qdtype):
    x = NONFINITE
    blocks = np.asarray(jref.blocked(jnp.asarray(x), block=128))
    kq, ks = quantize_blocks_pallas(jnp.asarray(blocks), dtype=jnp.dtype(qdtype), interpret=True)
    kd = np.asarray(dequantize_blocks_pallas(kq, ks, interpret=True)).reshape(-1)[: x.size]
    q, s, d = _port(x, 128, qdtype)
    assert _bytes(q) == np.asarray(kq).view(np.uint8).tobytes()
    assert s.numpy().tobytes() == np.asarray(ks).tobytes()
    _same_by_nan_class(d.numpy(), kd)


@pytest.mark.parametrize("qdtype", QDTYPES)
def test_scale_is_absmax_times_rounded_reciprocal(qdtype):
    """The reference codec's scale is the jitted one; the eager jnp ref
    (a true division) differs from it in the last bit of some scales."""
    x = _spread(2000, 256, seed=3)
    blocks = x.reshape(-1, 256)
    _, s = block_quantize(torch.from_numpy(x), block=256, dtype=qdtype)
    absmax = np.abs(blocks).max(axis=1)
    assert np.array_equal(s.numpy(), absmax * np.float32(ref.reciprocal(qdtype)))
    jitted = np.asarray(jax.jit(jref.quantize_blocks, static_argnames="dtype")(
        jnp.asarray(blocks), dtype=jnp.dtype(qdtype))[1])
    assert np.array_equal(s.numpy(), jitted)
    divided = (absmax / np.float32(ref.FMAX[qdtype])).astype(np.float32)
    assert not np.array_equal(divided, jitted)


def test_zero_rows_give_zero_scale_and_codes():
    q, s, d = _port(np.zeros(300, np.float32), 128, "int8")
    assert s.tolist() == [0.0, 0.0, 0.0]
    assert not q.any() and not d.any()


@pytest.mark.parametrize("qdtype", QDTYPES)
def test_large_values_clip_not_nan(qdtype):
    _, _, d = _port(CASES["large"], 4, qdtype)
    assert torch.isfinite(d).all()


def test_wrappers_refuse_other_devices_without_counting():
    x = torch.zeros(256, device="meta")
    before = (block_quantize.launches, block_dequantize.launches)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        block_quantize(x)
    with pytest.raises(ValueError):
        block_dequantize(torch.zeros(1, 256, dtype=torch.int8, device="meta"),
                         torch.zeros(1, device="meta"), count=256)
    _port(_rand(300), 256, "int8")  # the plain version does not count either
    assert (block_quantize.launches, block_dequantize.launches) == before


def test_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="not CUDA"):
        kernel.quantize_blocks(torch.zeros(2, 256), dtype="int8")
    with pytest.raises(ValueError, match="not CUDA"):
        kernel.dequantize_blocks(torch.zeros(2, 256, dtype=torch.int8), torch.zeros(2))


def test_variant_is_picked_by_width_and_alignment():
    """The vector kernels take rows of 8k <= 1024 elements with 16-byte
    aligned pointers; every other launch takes the general kernels."""
    v = kernel.variant
    assert v(256, 0x7F0000000000, 0x7F0000000200) == "vector"
    assert v(64, 0x1000, 0x2010) == "vector"
    assert v(128, 0x1000) == v(1024, 0x1000) == v(8, 0x1000) == "vector"
    assert v(100, 0x1000, 0x2000) == "general"
    assert v(256, 0x1004, 0x2000) == "general"  # a view one fp32 element off
    assert v(256, 0x1000, 0x2001) == "general"  # codes one byte off
    assert v(kernel.VECTOR_MAX_N + 8, 0x1000, 0x2000) == "general"
    assert v(2048, 0x1000, 0x2000) == "general"


def test_unknown_format_is_refused():
    with pytest.raises(ValueError, match="no block-quant format"):
        block_quantize(torch.zeros(4), dtype="float16")
