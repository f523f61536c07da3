"""The SSD chunk-scan wrapper on the CPU, held against the JAX package.

``repro_torch.kernels.ssd_scan.ops.ssd_scan`` on CPU tensors computes the
plain version of the kernel's function (``models.ssm.ssd_chunked``).  On the
sweep and with the tolerances of ``tests/test_kernels.py:83-128`` it is held
against the reference wrapper ``ssd_scan(..., interpret=True)`` (the Pallas
kernel run by the interpreter) and the reference oracle ``ssd_ref``: y
within 5e-2 (bf16) or 5e-4/1e-4 (fp32), h_final within 5e-3.  The
chunk-invariance case holds the reference kernel at chunks 8..64 against the
port's wrapper.  The port's O(S) oracle ``ref.ssd_ref`` is held against the
reference's.  The CUDA kernel itself is held against these plain versions
on the card (``tests/test_torch_kernel_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.ops import ssd_scan as ref_ssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref as ref_ssd_ref  # noqa: E402

from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

SWEEP = [  # tests/test_kernels.py:85-92
    (1, 32, 2, 8, 1, 16, 8),
    (2, 64, 4, 16, 2, 8, 16),
    (1, 64, 6, 8, 3, 32, 32),
    (1, 128, 2, 32, 1, 8, 64),
]


def _inputs(b, s, h, p, g, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = {
        "x": rng.standard_normal((b, s, h, p)),
        "dt": np.log1p(np.exp(rng.standard_normal((b, s, h)))),
        "a": -np.exp(rng.standard_normal(h)),
        "b": rng.standard_normal((b, s, g, n)),
        "c": rng.standard_normal((b, s, g, n)),
    }
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    low = ("x", "b", "c")
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    ref = [jnp.asarray(arrs[k], jdt if k in low else jnp.float32) for k in arrs]
    port = [torch.from_numpy(arrs[k]).to(tdt if k in low else torch.float32) for k in arrs]
    return ref, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SWEEP)
def test_ssd_scan_sweep_matches_reference(b, s, h, p, g, n, chunk, dtype):
    ref, port = _inputs(b, s, h, p, g, n, dtype)
    launches = ssd_scan.launches
    y, hT = ssd_scan(*port, chunk=chunk)
    assert ssd_scan.launches == launches  # the plain version does not count
    assert y.shape == (b, s, h, p) and y.dtype == port[0].dtype
    assert hT.shape == (b, h, p, n) and hT.dtype == torch.float32
    ry, rh = ref_ssd_scan(*ref, chunk=chunk, interpret=True)
    x, dt, a, bm, cm = ref
    rep = h // g
    oy, oh = ref_ssd_ref(
        x.transpose(0, 2, 1, 3), dt.transpose(0, 2, 1), a,
        jnp.repeat(bm, rep, 2).transpose(0, 2, 1, 3),
        jnp.repeat(cm, rep, 2).transpose(0, 2, 1, 3),
    )
    tol = dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else dict(atol=5e-4, rtol=1e-4)
    for want_y, want_h in ((ry, rh), (oy.transpose(0, 2, 1, 3), oh)):
        np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y, np.float32), **tol)
        np.testing.assert_allclose(hT.numpy(), np.asarray(want_h), atol=5e-3, rtol=5e-3)


def test_ssd_scan_chunk_invariance():
    """tests/test_kernels.py::test_ssd_scan_chunk_invariance, with the port's
    wrapper (on the CPU exactly ``ssd_chunked``) beside the reference kernel."""
    ref, port = _inputs(1, 64, 2, 8, 1, 8, "float32")
    y0, _ = ssd_scan(*port, chunk=8)
    for c in (8, 16, 32, 64):
        ry = np.asarray(ref_ssd_scan(*ref, chunk=c, interpret=True)[0])
        y, _ = ssd_scan(*port, chunk=c)
        yc, _ = ssd_chunked(*port, chunk=c)
        assert torch.equal(y, yc)
        np.testing.assert_allclose(y.numpy(), ry, atol=1e-4)
        np.testing.assert_allclose(y.numpy(), y0.numpy(), atol=1e-4)


def test_ssd_ref_matches_reference_oracle():
    """The plain version in kernel layout [B,H,S,·], against the reference's."""
    ref, port = _inputs(2, 16, 3, 4, 3, 5, "float32", seed=5)
    to_k = lambda t: t.transpose(1, 2)  # noqa: E731
    y, hT = ssd_ref(to_k(port[0]), to_k(port[1]), port[2], to_k(port[3]), to_k(port[4]))
    jk = lambda t: jnp.swapaxes(t, 1, 2)  # noqa: E731
    ry, rh = ref_ssd_ref(jk(ref[0]), jk(ref[1]), ref[2], jk(ref[3]), jk(ref[4]))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(hT.numpy(), np.asarray(rh), atol=1e-5, rtol=1e-5)


def test_ssd_scan_chunk_rules_follow_the_reference():
    """chunk > S is cut to S; a chunk that does not divide S raises."""
    _, port = _inputs(1, 24, 2, 4, 1, 4, "float32")
    y_big, _ = ssd_scan(*port, chunk=256)
    y_full, _ = ssd_scan(*port, chunk=24)
    assert torch.equal(y_big, y_full)
    with pytest.raises(ValueError, match="not divisible"):
        ssd_scan(*port, chunk=16)


def test_ssd_scan_refuses_a_recorded_gradient():
    """The CUDA kernel's ctypes output has no grad_fn: the wrapper refuses
    inputs that record a gradient (on the card it raises before launching;
    on the CPU the plain version is differentiable)."""
    _, port = _inputs(1, 8, 2, 4, 1, 4, "float32")
    x = port[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.refuse_grad(x, *port[1:])
    with torch.no_grad():
        ops.refuse_grad(x, *port[1:])  # nothing recorded: allowed
    ops.refuse_grad(*port)
    y, _ = ssd_scan(x, *port[1:], chunk=8)
    assert y.requires_grad  # the CPU path is the differentiable plain version


def test_ssd_scan_refuses_mixed_devices():
    _, port = _inputs(1, 8, 2, 4, 1, 4, "float32")
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        ssd_scan(port[0].to("meta"), *port[1:], chunk=8)


def _emulate_tensor_core_kernel(x, dt, a, b, c, *, chunk, single=False):
    """The bf16 tensor-core kernel's arithmetic in plain torch (model layout,
    bf16 x/B/C): per chunk, C·Bᵀ of the bf16 inputs in fp32, then
    (C·Bᵀ ⊙ exp(cum_i - cum_j) ⊙ dt_j) split into bf16 hi + lo and each
    multiplied by x; the inter term C·h_prevᵀ with h_prev split into bf16
    hi + lo, times exp(cum_i); the update h·exp(total) + (w ⊙ x)ᵀ·B with
    w = dt·exp(total - cum) and w ⊙ x split into bf16 hi + lo.  y is rounded
    once to bf16; h stays fp32.  With ``single=True`` the first operand is
    rounded to bf16 once instead of split."""
    bsz, s, h, p = x.shape
    rep = h // b.shape[2]
    bf = b.float().repeat_interleave(rep, 2)
    cf = c.float().repeat_interleave(rep, 2)
    xf = x.float()
    state = torch.zeros(bsz, h, p, b.shape[3])
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))

    def split(t):
        hi = t.bfloat16().float()
        return hi, (t - hi).bfloat16().float()

    ys = []
    for t0 in range(0, s, chunk):
        sl = slice(t0, t0 + chunk)
        dtc = dt[:, sl]                                    # [B,Q,H]
        cum = torch.cumsum(dtc * a, dim=1)
        total = cum[:, -1]                                 # [B,H]
        cc, bc, xc = cf[:, sl], bf[:, sl], xf[:, sl]
        cum_h = cum.transpose(1, 2)                        # [B,H,Q]
        seg = cum_h[..., :, None] - cum_h[..., None, :]
        lmat = torch.where(tri, torch.exp(seg), 0.0)
        cb = torch.einsum("bihn,bjhn->bhij", cc, bc)
        op = cb * lmat * dtc.transpose(1, 2)[..., None, :]
        parts = (op.bfloat16().float(),) if single else split(op)
        y = sum(torch.einsum("bhij,bjhp->bihp", part, xc) for part in parts)
        hi, lo = split(state)
        inter = torch.einsum("bihn,bhpn->bihp", cc, hi) + torch.einsum("bihn,bhpn->bihp", cc, lo)
        ys.append(inter * torch.exp(cum)[..., None] + y)
        w = dtc * torch.exp(total[:, None] - cum)
        whi, wlo = split(xc * w[..., None])
        state = (state * torch.exp(total)[..., None, None]
                 + torch.einsum("bqhp,bqhn->bhpn", whi, bc) + torch.einsum("bqhp,bqhn->bhpn", wlo, bc))
    return torch.cat(ys, 1).to(x.dtype), state


def test_tensor_core_rounding_within_reference_tolerance():
    """The error budget of the bf16 kernel, proved before it runs on a card:
    its rounding (C·Bᵀ ⊙ L ⊙ dt, h_prev and w ⊙ x each as bf16 hi + lo)
    emulated in plain torch at the serving shapes of one sequence (H = 24,
    P = 64, N = 128, S = 512, chunk 256, two chunks, so the carried state
    is exercised), held against the reference oracle ``ssd_ref`` within the
    tolerances of tests/test_kernels.py: y atol = rtol = 5e-2, h_final
    atol = rtol = 5e-3.  Rounding C·Bᵀ ⊙ L ⊙ dt to bf16 once instead, as a
    plain bf16 operand would, misses y's tolerance on the same inputs."""
    ref, port = _inputs(1, 512, 24, 64, 1, 128, "bfloat16", seed=6)
    x, dt, a, bm, cm = ref
    oy, oh = ref_ssd_ref(
        x.transpose(0, 2, 1, 3), dt.transpose(0, 2, 1), a,
        jnp.repeat(bm, 24, 2).transpose(0, 2, 1, 3), jnp.repeat(cm, 24, 2).transpose(0, 2, 1, 3),
    )
    want_y = np.asarray(oy.transpose(0, 2, 1, 3), np.float32)
    y, hT = _emulate_tensor_core_kernel(*port, chunk=256)
    np.testing.assert_allclose(y.float().numpy(), want_y, atol=5e-2, rtol=5e-2)
    np.testing.assert_allclose(hT.numpy(), np.asarray(oh), atol=5e-3, rtol=5e-3)
    y1, _ = _emulate_tensor_core_kernel(*port, chunk=256, single=True)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(y1.float().numpy(), want_y, atol=5e-2, rtol=5e-2)


def test_alignment_check_takes_the_models_views_and_refuses_an_offset_one():
    """mamba2's conv output split into x, B and C (byte offsets 3072 and
    3328, rows of 3584 bytes) allows 16-byte copies; N = 100 (200-byte rows)
    allows 8; a view one element off allows 2, under the bf16 kernel's 4."""
    from repro_torch.kernels import row_alignment
    from repro_torch.kernels.ssd_scan import kernel

    xbc = torch.zeros(4, 512, 1536 + 2 * 128, dtype=torch.bfloat16)
    x, bm, cm = torch.split(xbc, [1536, 128, 128], dim=-1)
    x, bm, cm = x.reshape(4, 512, 24, 64), bm.reshape(4, 512, 1, 128), cm.reshape(4, 512, 1, 128)
    assert (bm.data_ptr() - xbc.data_ptr(), cm.data_ptr() - xbc.data_ptr()) == (3072, 3328)
    assert row_alignment(x, bm, cm) == 16
    assert row_alignment(torch.zeros(1, 8, 1, 100, dtype=torch.bfloat16)) == 8
    off = xbc[..., 1:1537].reshape(4, 512, 24, 64)
    assert row_alignment(off, bm, cm) == 2 < kernel.ROW_ALIGN
