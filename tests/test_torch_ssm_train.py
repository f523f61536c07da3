"""SSM training (mamba2-130m, reduced), held against the JAX package, and
the repair of ``ssd_chunked``'s gradient.

* ``ssd_chunked``'s forward is bit-equal to the form it had before the
  repair (the reference's ``where(tri, exp(seg), 0)``, kept here as
  :func:`_unmasked_form`) on the sweep of ``tests/test_torch_ssm.py`` and at
  the overflowing shape below.
* At B=1, S=256, 4 heads of P=8, one group of N=16, A = -(1, 4, 8, 16),
  dt = 0.1 and one chunk of 256, ``seg = cum_i - cum_j`` above the diagonal
  passes 88 and ``exp`` overflows to inf.  The port's float32 gradients of
  ``y.sum() + h_final.sum()`` are finite and within 1e-4 of the float64
  ``ssd_recurrent``'s, relative to each gradient's largest magnitude.  The
  reference's ``jax.grad`` gives NaN for ``dt`` and ``a`` there (a fact of
  the reference, asserted), and so does the unrepaired form.
* Where nothing overflows, the port's gradients equal the reference's
  ``jax.grad`` within 1e-5 (float32, relative to each gradient's largest
  magnitude).
* Three ``make_train_step`` steps of reduced mamba2 against the reference's
  jitted step: float32 losses and gradient norms within 1e-5, bf16 within
  2e-2 and 5% (the bounds of ``tests/test_torch_moe.py``).
* The train CLI with ``--codec int8:b256`` under data=2,model=2, resumed
  under data=1,model=1 (RESHARD_STREAM: the fused ``in_proj`` of the
  weights and both coded moments consolidated), and the serve CLI on the
  resharded checkpoint.
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.core.pytree import flatten_with_paths  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import ssm as RM  # noqa: E402
from repro.train.optimizer import init_state as ref_init_state  # noqa: E402
from repro.train.steps import make_train_step as ref_make_step  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402
from repro_torch.models import ssm as TM  # noqa: E402
from repro_torch.train.optimizer import init_state  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402

ARCH = "mamba2-130m"
INPUTS = ("x", "dt", "a", "B", "C")


def _unmasked_form(x, dt, a, bmat, cmat, *, chunk, h0=None):
    """``ssd_chunked`` as it was before the repair, the reference's form:
    the intra-chunk decay is ``where(tri, exp(seg), 0)``, exp taken of
    every entry and masked after."""
    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    nc = s // chunk
    bmat = TM._broadcast_groups(bmat, h)
    cmat = TM._broadcast_groups(cmat, h)
    xq = x.reshape(bsz, nc, chunk, h, p)
    dtq = dt.reshape(bsz, nc, chunk, h)
    bq = bmat.reshape(bsz, nc, chunk, h, n).float()
    cq = cmat.reshape(bsz, nc, chunk, h, n).float()
    da = (dtq * a[None, None, None, :]).float()
    cum = torch.cumsum(da, dim=2)
    total = cum[:, :, -1, :]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    l_mask = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    cb = torch.einsum("bcqhn,bckhn->bcqkh", cq, bq)
    xdt = xq.float() * dtq[..., None]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", cb * l_mask, xdt)
    decay_to_end = torch.exp(total[:, :, None, :] - cum)
    s_chunk = torch.einsum("bcqhp,bcqhn->bchpn", xdt * decay_to_end[..., None], bq)
    hprev = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hprev)
        hprev = hprev * torch.exp(total[:, c])[:, :, None, None] + s_chunk[:, c]
    h_prevs = torch.stack(h_prevs, 1)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", cq * torch.exp(cum)[..., None], h_prevs)
    return (y_intra + y_inter).reshape(bsz, s, h, p).to(x.dtype), hprev


def _sweep_inputs(b=2, s=32, h=4, p=8, g=2, n=8, seed=0):
    """The inputs of ``tests/test_torch_ssm.py``'s ``ssd_chunked`` sweep."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dt, a, bm, cm), h0


def _overflow_inputs(seed=0):
    """The shape where the unmasked decay overflows: one chunk of 256 rows
    with dt·A down to -1.6 a row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 256, 4, 8)).astype(np.float32)
    dt = np.full((1, 256, 4), 0.1, np.float32)
    a = -np.array([1.0, 4.0, 8.0, 16.0], np.float32)
    bm = rng.standard_normal((1, 256, 1, 16)).astype(np.float32)
    cm = rng.standard_normal((1, 256, 1, 16)).astype(np.float32)
    return x, dt, a, bm, cm


def _torch_inputs(arrays, dtype=torch.float32):
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in arrays)
    return x.to(dtype), dt, a, bm.to(dtype), cm.to(dtype)


def _port_grads(fn, arrays, chunk, dtype=torch.float64):
    ins = [t.to(dtype).requires_grad_(True) for t in _torch_inputs(arrays)]
    y, h = fn(*ins, chunk=chunk) if chunk else fn(*ins)
    (y.sum() + h.sum()).backward()
    return [t.grad for t in ins]


def _ref_grads(arrays, chunk):
    def loss(*args):
        y, h = RM.ssd_chunked(*args, chunk=chunk)
        return y.sum() + h.sum()

    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(5)))(
        *(jnp.asarray(v) for v in arrays))]


# ---------------------------------------------------------------------------
# ssd_chunked: the forward unchanged, the gradient repaired
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [1, 4, 8, 16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_bit_equal_to_the_unmasked_form(dtype, chunk, with_h0):
    arrays, h0 = _sweep_inputs()
    ins = _torch_inputs(arrays, getattr(torch, dtype))
    th0 = torch.from_numpy(h0) if with_h0 else None
    y, h = TM.ssd_chunked(*ins, chunk=chunk, h0=th0)
    y0, h00 = _unmasked_form(*ins, chunk=chunk, h0=th0)
    assert torch.equal(y, y0) and torch.equal(h, h00)


def test_forward_bit_equal_where_the_unmasked_decay_overflows():
    ins = _torch_inputs(_overflow_inputs())
    seg_max = float(-(0.1 * ins[2]).min()) * 255  # the largest seg above the diagonal
    assert seg_max > 88.8  # past float32 exp's range
    y, h = TM.ssd_chunked(*ins, chunk=256)
    y0, h0 = _unmasked_form(*ins, chunk=256)
    assert torch.isfinite(y).all() and torch.equal(y, y0) and torch.equal(h, h0)


def test_gradients_finite_where_the_reference_overflows():
    arrays = _overflow_inputs()
    port = _port_grads(TM.ssd_chunked, arrays, 256, torch.float32)
    oracle = _port_grads(TM.ssd_recurrent, arrays, 0, torch.float64)
    for name, g, want in zip(INPUTS, port, oracle):
        assert torch.isfinite(g).all(), name
        scale = float(want.abs().max())
        err = float((g.double() - want).abs().max()) / scale
        assert err <= 1e-4, (name, err)
    # facts of the reference's form: jax.grad, and the port's unrepaired copy
    ref = dict(zip(INPUTS, _ref_grads(arrays, 256)))
    assert np.isnan(ref["dt"]).any() and np.isnan(ref["a"]).any()
    old = dict(zip(INPUTS, _port_grads(_unmasked_form, arrays, 256, torch.float32)))
    assert torch.isnan(old["dt"]).any() and torch.isnan(old["a"]).any()


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_gradients_match_reference_where_finite(chunk):
    arrays, _ = _sweep_inputs()
    port = _port_grads(TM.ssd_chunked, arrays, chunk, torch.float32)
    ref = _ref_grads(arrays, chunk)
    for name, g, want in zip(INPUTS, port, ref):
        assert np.isfinite(want).all(), name
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# reduced mamba2: train steps against the reference
# ---------------------------------------------------------------------------


def _pair(dtype, seed=0):
    rlm = ref_build(RC.reduced(RC.get_config(ARCH)), compute_dtype=getattr(jnp, dtype))
    tlm = build_model(TC.reduced(TC.get_config(ARCH)), compute_dtype=getattr(torch, dtype))
    rparams = rlm.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(rparams).items()}
    return rlm, rparams, tlm, params_from_reference(flat, tlm, "cpu")


STEP_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_reference_jit(dtype):
    tol, norm_rtol = STEP_TOL[dtype]
    rlm, rp, tlm, tp = _pair(dtype)
    rstep = jax.jit(ref_make_step(rlm, RC.TrainConfig(), RC.ParallelismConfig()))
    tstep = make_train_step(tlm, TC.TrainConfig(), TC.ParallelismConfig())
    rstate, tstate = ref_init_state(rp), init_state(tp)
    for i in range(3):
        toks = np.random.default_rng(10 + i).integers(0, 256, (4, 33)).astype(np.int32)
        rstate, rm = rstep(rstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(toks).long()})
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= tol
        assert float(tm["aux"]) == float(rm["aux"]) == 0.0
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=norm_rtol)
    assert tstate.step == int(rstate.step) == 3


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_train_cli_coded_resume_under_another_layout_and_serve(tmp_path, capsys):
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_cli

    common = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--seq", "32",
              "--ckpt-dir", str(tmp_path), "--sync-save", "--log-json", "--codec", "int8:b256"]
    assert train_cli.main(common + ["--mesh", "data=2,model=2", "--steps", "2",
                                    "--save-interval", "2"]) == 0
    manifest = T.DistCheckpoint.open(tmp_path / "step_00000002").manifest
    assert manifest.shard_codecs
    capsys.readouterr()
    assert train_cli.main(common + ["--mesh", "data=1,model=1", "--steps", "4",
                                    "--save-interval", "4"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert recs[0]["event"] == "restored" and recs[0]["mode"] == "reshard_stream"
    steps = [r for r in recs if r.get("event") == "step"]
    assert [r["step"] for r in steps] == [3, 4]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in steps)
    outs = {}
    for mesh in ("data=2,model=2", "data=1,model=1"):
        assert serve.main(["--arch", ARCH, "--reduced", "--ckpt-dir", str(tmp_path),
                           "--mesh", mesh, "--device", "cpu", "--batch", "2",
                           "--prompt-len", "12", "--gen", "6"]) == 0
        outs[mesh] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert outs[mesh]["step"] == 4
    assert outs["data=2,model=2"]["mode"] == "reshard_stream"
    assert outs["data=1,model=1"]["mode"] == "direct"
    assert outs["data=2,model=2"]["tokens"] == outs["data=1,model=1"]["tokens"]
