"""The port's flash attention held against the JAX package's.

On CPU tensors ``repro_torch.kernels.flash_attention.ops.flash_attention``
computes its plain version; it must match the reference Pallas kernel run
in interpret mode and the reference oracle ``attention_ref`` over the whole
sweep of ``tests/test_kernels.py``, at that file's tolerances (fp32 atol
2e-5 / rtol 1e-5; bf16 2e-2).  Inputs are drawn by numpy from a seed and
handed to both packages.  The CUDA kernel itself is checked on the card
(``tests/test_torch_kernel_cuda.py`` and ``chip_smoke.py``)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as ref_oracle  # noqa: E402
from repro_torch.kernels.flash_attention import ref as port_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402

SWEEP = [  # tests/test_kernels.py:24-33
    (1, 64, 2, 2, 16, 0, True),
    (2, 128, 4, 2, 32, 0, True),
    (1, 128, 6, 3, 16, 32, True),
    (2, 64, 2, 1, 64, 16, True),
    (1, 64, 2, 2, 32, 0, False),
    (1, 256, 8, 8, 8, 128, True),
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bfloat16" else dict(atol=2e-5, rtol=1e-5)


def _inputs(b, sq, hq, hkv, d, dtype_name, seed=0, skv=None):
    """q/k/v in model layout [B,S,H,D], rounded to the dtype once, as
    (jax arrays, torch tensors) holding identical values."""
    rng = np.random.default_rng(seed)
    skv = skv or sq
    arrs = [
        rng.standard_normal((b, s, h, d)).astype(np.float32)
        for s, h in ((sq, hq), (skv, hkv), (skv, hkv))
    ]
    jdt, tdt = DTYPES[dtype_name]
    js = [jnp.asarray(a).astype(jdt) for a in arrs]
    ts = [torch.from_numpy(np.array(j, np.float32)).to(tdt) for j in js]
    return js, ts


def _oracle(js, causal, window):
    q, k, v = (x.transpose(0, 2, 1, 3) for x in js)
    return ref_oracle(q, k, v, causal=causal, window=window).transpose(0, 2, 1, 3)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,hq,hkv,d,window,causal", SWEEP)
def test_plain_matches_reference_kernel_sweep(b, s, hq, hkv, d, window, causal, dtype):
    js, ts = _inputs(b, s, hq, hkv, d, dtype)
    launches = flash_attention.launches
    out = flash_attention(*ts, causal=causal, window=window)
    assert flash_attention.launches == launches  # the plain version is not a launch
    assert out.dtype == ts[0].dtype and out.shape == ts[0].shape
    pallas = ref_flash(*js, causal=causal, window=window, block_q=32, block_k=32,
                       interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(_oracle(js, causal, window)), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 16), (False, 0)])
def test_ragged_sequence_matches_oracle(causal, window, dtype):
    """S = 50 divides no tile: the Pallas kernel refuses it
    (kernel.py:115-117); the port takes it, held against the oracle."""
    js, ts = _inputs(2, 50, 6, 2, 16, dtype, seed=1)
    out = flash_attention(*ts, causal=causal, window=window)
    np.testing.assert_allclose(_np(out), _np(_oracle(js, causal, window)), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_15_to_5_head_dim_64(dtype):
    """The serving slice's head layout: groups = 3, not a power of two."""
    js, ts = _inputs(2, 64, 15, 5, 64, dtype, seed=2)
    out = flash_attention(*ts, causal=True)
    pallas = ref_flash(*js, causal=True, block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(_oracle(js, True, 0)), **_tol(dtype))


def test_plain_version_takes_kernel_layout():
    """ref.attention_ref is the counterpart of the reference oracle, in the
    same [B, H, S, D] layout, and agrees with it at fp32 tolerance."""
    js, ts = _inputs(1, 40, 4, 2, 16, "float32", seed=3, skv=40)
    q, k, v = (t.transpose(1, 2) for t in ts)
    out = port_ref.attention_ref(q, k, v, causal=True, window=8)
    rq, rk, rv = (x.transpose(0, 2, 1, 3) for x in js)
    want = ref_oracle(rq, rk, rv, causal=True, window=8)
    np.testing.assert_allclose(_np(out), _np(want), atol=2e-5, rtol=1e-5)
