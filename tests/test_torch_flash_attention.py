"""The port's flash attention held against the JAX package's.

On CPU tensors ``repro_torch.kernels.flash_attention.ops.flash_attention``
computes its plain version; it must match the reference Pallas kernel run
in interpret mode and the reference oracle ``attention_ref`` over the whole
sweep of ``tests/test_kernels.py``, and with a value head dim other than
the key's (deepseek-v2's MLA: D = 192, Dv = 128), and with k and v of
their own length (cross-attention: Sq != Skv, causal and not), at that
file's tolerances (fp32 atol 2e-5 / rtol 1e-5; bf16 2e-2).  Inputs are drawn by numpy from a seed and
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


def _inputs(b, sq, hq, hkv, d, dtype_name, seed=0, skv=None, dv=None):
    """q/k/v in model layout [B,S,H,D] (v's head dim ``dv``, default D),
    rounded to the dtype once, as (jax arrays, torch tensors) holding
    identical values."""
    rng = np.random.default_rng(seed)
    skv = skv or sq
    arrs = [
        rng.standard_normal((b, s, h, w)).astype(np.float32)
        for s, h, w in ((sq, hq, d), (skv, hkv, d), (skv, hkv, dv or d))
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,hq,hkv,d,dv,window", [
    (1, 128, 4, 4, 192, 128, 0),   # deepseek-v2's MLA prefill (nope 128 + rope 64, v 128)
    (2, 64, 2, 2, 24, 16, 0),      # reduced deepseek-v2 (nope 16 + rope 8, v 16)
    (1, 128, 4, 2, 192, 128, 32),  # GQA and a window, with Dv != D
])
def test_value_head_dim_other_than_the_keys(b, s, hq, hkv, d, dv, window, dtype):
    """v [B, Skv, Hkv, Dv] with Dv != D gives o [B, Sq, Hq, Dv], scaled by
    1/sqrt(D): the plain version against the reference Pallas kernel in
    interpret mode (which takes Dv, kernel.py:96-110) and its oracle."""
    js, ts = _inputs(b, s, hq, hkv, d, dtype, seed=5, dv=dv)
    out = flash_attention(*ts, causal=True, window=window)
    assert out.shape == (b, s, hq, dv) and out.dtype == ts[0].dtype
    pallas = ref_flash(*js, causal=True, window=window, block_q=32, block_k=32, interpret=True)
    assert pallas.shape == out.shape
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(_oracle(js, True, window)), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,causal", [
    (32, 96, False),   # a cross-attention layer: fewer queries than source rows
    (96, 32, False),   # more queries than keys
    (64, 160, True),   # causal at Sq < Skv: row i sees columns 0..i
    (96, 32, True),    # causal at Sq > Skv: rows past Skv see every column
    (1, 96, False),    # one decode query against the source
])
def test_query_and_key_lengths_differ(sq, skv, causal, dtype):
    """q [B, Sq, Hq, D] against k, v [B, Skv, Hkv, D]: the plain version
    against the reference Pallas kernel in interpret mode, with blocks that
    divide both lengths, and against its oracle."""
    js, ts = _inputs(2, sq, 4, 2, 16, dtype, seed=7, skv=skv)
    out = flash_attention(*ts, causal=causal)
    assert out.shape == (2, sq, 4, 16)
    pallas = ref_flash(*js, causal=causal, block_q=min(32, sq), block_k=32, interpret=True)
    np.testing.assert_allclose(_np(out), _np(pallas), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(_oracle(js, causal, 0)), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_cross_shape_matches_oracle(dtype):
    """whisper-tiny's cross-attention: 432 decoder positions against the
    1500 encoder frames, 6:6 heads of 64, no mask (1500 divides no tile of
    the card kernel's 64: a ragged last tile)."""
    js, ts = _inputs(1, 432, 6, 6, 64, dtype, seed=8, skv=1500)
    out = flash_attention(*ts, causal=False)
    np.testing.assert_allclose(_np(out), _np(_oracle(js, False, 0)), **_tol(dtype))


def test_plain_version_takes_kernel_layout():
    """ref.attention_ref is the counterpart of the reference oracle, in the
    same [B, H, S, D] layout, and agrees with it at fp32 tolerance."""
    js, ts = _inputs(1, 40, 4, 2, 16, "float32", seed=3, skv=40)
    q, k, v = (t.transpose(1, 2) for t in ts)
    out = port_ref.attention_ref(q, k, v, causal=True, window=8)
    rq, rk, rv = (x.transpose(0, 2, 1, 3) for x in js)
    want = ref_oracle(rq, rk, rv, causal=True, window=8)
    np.testing.assert_allclose(_np(out), _np(want), atol=2e-5, rtol=1e-5)


def _emulate_tensor_core_kernel(q, k, v, *, causal, window, scale, tile=64):
    """The bf16 tensor-core kernel's arithmetic in plain torch, on [B,S,H,D]
    bf16 tensors: fp32 scores of the bf16 inputs, an online softmax over
    64-column tiles in base 2 (scores times scale·log2(e), exp2), each tile's
    P rounded to bf16 before P·V while l sums the fp32 P, and
    O = acc / max(l, 1e-37) rounded once to bf16.  Tiles the kernel skips
    are wholly masked here and change nothing."""
    g = q.shape[2] // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(g, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, 2).transpose(1, 2)
    sq, skv = qf.shape[2], kf.shape[2]
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * torch.tensor(np.log2(np.e), dtype=torch.float32)
    m = torch.full(qf.shape[:3], -torch.inf)
    l = torch.zeros(qf.shape[:3])
    acc = torch.zeros(qf.shape[:3] + (vf.shape[-1],))
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, skv, tile):
        cols = torch.arange(k0, min(k0 + tile, skv))[None, :]
        s = (qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2)) * scale_log2
        ok = torch.ones((sq, cols.shape[1]), dtype=torch.bool)
        if causal:
            ok &= rows - cols >= 0
        if window > 0:
            ok &= rows - cols < window
        s = torch.where(ok, s, -torch.inf)
        mx = torch.maximum(m, s.amax(-1))
        base = torch.where(mx == -torch.inf, 0.0, mx)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s - base[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.bfloat16().float() @ vf[:, :, k0:k0 + tile]
        m = mx
    return (acc / l.clamp_min(1e-37)[..., None]).to(torch.bfloat16).transpose(1, 2)


@pytest.mark.parametrize("s", [512, 500])
@pytest.mark.parametrize("window", [0, 128])
def test_tensor_core_rounding_within_reference_tolerance(s, window):
    """The error budget of the bf16 kernel, proved before it runs on a card:
    its rounding (P to bf16 before P·V, base-2 softmax) emulated in plain
    torch at the serving slice's head layout (15:5 heads, D = 64), held
    against the reference oracle within the bf16 tolerance of
    tests/test_kernels.py (atol = rtol = 2e-2)."""
    js, ts = _inputs(1, s, 15, 5, 64, "bfloat16", seed=4)
    got = _emulate_tensor_core_kernel(*ts, causal=True, window=window, scale=0.125)
    q, k, v = (x.transpose(0, 2, 1, 3) for x in js)
    want = ref_oracle(q, k, v, causal=True, window=window, scale=0.125).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("bfloat16"))


def test_tensor_core_rounding_at_the_mla_head_dims():
    """The same error budget at deepseek-v2's MLA prefill: 8:8 heads (of
    its 128), q and k of 192, v of 128, scale 1/sqrt(192)."""
    js, ts = _inputs(1, 512, 8, 8, 192, "bfloat16", seed=6, dv=128)
    scale = 192 ** -0.5
    got = _emulate_tensor_core_kernel(*ts, causal=True, window=0, scale=scale)
    assert got.shape == (1, 512, 8, 128)
    q, k, v = (x.transpose(0, 2, 1, 3) for x in js)
    want = ref_oracle(q, k, v, causal=True, scale=scale).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("bfloat16"))


@pytest.mark.parametrize("sq,skv,hq,hkv,d", [
    (512, 1600, 4, 1, 128),   # llama-vision's cross layer (4 of its 32:8 heads)
    (432, 1500, 6, 6, 64),    # whisper's cross layers
    (1500, 1500, 6, 6, 64),   # whisper's encoder
])
def test_tensor_core_rounding_at_the_cross_attention_shapes(sq, skv, hq, hkv, d):
    """The bf16 kernel's error budget at Sq != Skv with no mask, and over a
    ragged last tile of 1500 = 23 x 64 + 28 columns."""
    js, ts = _inputs(1, sq, hq, hkv, d, "bfloat16", seed=9, skv=skv)
    scale = d ** -0.5
    got = _emulate_tensor_core_kernel(*ts, causal=False, window=0, scale=scale)
    q, k, v = (x.transpose(0, 2, 1, 3) for x in js)
    want = ref_oracle(q, k, v, causal=False, scale=scale).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("bfloat16"))


def test_alignment_check_takes_the_models_views_and_refuses_an_offset_one():
    """The bf16 kernel copies rows 16 bytes at a time.  smollm's fused-QKV
    split (byte offsets 1920 and 2560, rows of 3200 bytes) passes the pure
    Python check; a view one element off, or rows of an odd stride, fail it."""
    from repro_torch.kernels import row_alignment
    from repro_torch.kernels.flash_attention import kernel

    qkv = torch.zeros(4, 512, (15 + 5 + 5) * 64, dtype=torch.bfloat16)
    assert qkv.data_ptr() % 16 == 0
    q, k, v = (t.reshape(4, 512, -1, 64) for t in torch.split(qkv, [960, 320, 320], dim=-1))
    assert (k.data_ptr() - qkv.data_ptr(), v.data_ptr() - qkv.data_ptr()) == (1920, 2560)
    assert row_alignment(q, k, v) == kernel.ROW_ALIGN == 16
    off = qkv[..., 1:961].reshape(4, 512, 15, 64)
    assert row_alignment(off, k, v) == 2
    odd_rows = torch.zeros(4, 512, 15 * 64 + 1, dtype=torch.bfloat16)[..., :960].reshape(4, 512, 15, 64)
    assert row_alignment(odd_rows, k, v) == 2


def test_alignment_check_takes_the_mla_value_view():
    """MLA's v is the [nope | v] view of kv_b's output, 256 bytes past each
    head's row start: 16-byte aligned rows, so the bf16 kernel takes it."""
    from repro_torch.kernels import row_alignment
    from repro_torch.kernels.flash_attention import kernel

    kvb = torch.zeros(4, 512, 128, 128 + 128, dtype=torch.bfloat16)
    v = kvb[..., 128:]
    assert v.data_ptr() - kvb.data_ptr() == 256 and not v.is_contiguous()
    q = k = torch.zeros(4, 512, 128, 192, dtype=torch.bfloat16)
    assert row_alignment(q, k, v) == kernel.ROW_ALIGN
    assert (192, 128) in kernel.HEAD_DIMS and (24, 16) not in kernel.HEAD_DIMS
