"""The training slice, held against the JAX package on reduced smollm.

Both packages compute from one set of weights (the reference's
``lm.init(PRNGKey(0))``, loaded through ``params_from_reference``) and one
batch (numpy), unsharded:

* ``train/data.py`` batches equal the reference's;
* ``LM.loss_fn`` and its gradients against ``jax.value_and_grad`` of the
  reference's: fp32 compute within 1e-5 (loss) and atol 1e-5 / rtol 1e-4
  (each gradient); bf16 compute within 2e-2 (the two frameworks round to
  bf16 at different places);
* ``adamw_update`` from the same state and gradients: params and moments
  within 1e-6 relative (plus 1e-10 absolute: one fused multiply-add), ``lr``
  and ``grad_norm`` within 1e-6;
* 3 steps of ``make_train_step`` against the reference's step under plain
  ``jax.jit`` with no mesh (which runs in this container: the
  ``ShardingTypeError`` of ROADMAP queue 3 needs a mesh);
* ``chunked_attention`` against ``full_attention`` and the reference's;
* the flash-attention wrapper refuses tensors for which a gradient is
  recorded (its kernel has no backward), and the model then takes the
  differentiable plain attention.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
from repro.core.pytree import flatten_with_paths  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.train import data as rdata  # noqa: E402
from repro.train.optimizer import adamw_update as ref_adamw  # noqa: E402
from repro.train.optimizer import init_state as ref_init_state  # noqa: E402
from repro.train.steps import make_train_step as ref_make_step  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths as tflat  # noqa: E402
from repro_torch.core.pytree import unflatten_from_paths  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train.optimizer import TrainState, adamw_update, init_state  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402

ARCH = "smollm-360m"


def _pair(jdt, tdt, remat="full"):
    rlm = ref_build(RC.reduced(RC.get_config(ARCH)), compute_dtype=jdt, remat=remat)
    tlm = build_model(TC.reduced(TC.get_config(ARCH)), compute_dtype=tdt, remat=remat)
    rparams = rlm.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(rparams).items()}
    return rlm, rparams, tlm, params_from_reference(flat, tlm, "cpu")


def _tokens(vocab, b=4, s=33, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ["smollm-360m", "gpt3-350m"])
@pytest.mark.parametrize("step", [0, 3, 17])
def test_data_batches_equal_reference(arch, step):
    rcfg, tcfg = RC.reduced(RC.get_config(arch)), TC.reduced(TC.get_config(arch))
    shape_r = RC.ShapeSpec("train", 32, 4, "train")
    shape_t = TC.ShapeSpec("train", 32, 4, "train")
    a = rdata.batch_for_step(rcfg, shape_r, step, seed=5)
    b = tdata.batch_for_step(tcfg, shape_t, step, seed=5)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def _port_value_and_grad(tlm, tparams, toks):
    leaves = {k: v.detach().requires_grad_(True) for k, v in tflat(tparams).items()}
    loss, _ = tlm.loss_fn(unflatten_from_paths(leaves), {"tokens": torch.from_numpy(toks).long()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, (g.numpy() for g in grads)))


@pytest.mark.parametrize("remat", ["full", "none"])
def test_loss_and_grads_fp32(remat):
    rlm, rp, tlm, tp = _pair(jnp.float32, torch.float32, remat=remat)
    toks = _tokens(tlm.cfg.vocab_size)
    (rl, _), rg = jax.value_and_grad(rlm.loss_fn, has_aux=True)(rp, {"tokens": jnp.asarray(toks)})
    tl, tg = _port_value_and_grad(tlm, tp, toks)
    assert abs(tl - float(rl)) <= 1e-5
    rg = {k: np.asarray(v) for k, v in flatten_with_paths(rg).items()}
    assert set(rg) == set(tg)
    for name, g in tg.items():
        np.testing.assert_allclose(g, rg[name], atol=1e-5, rtol=1e-4, err_msg=name)


def test_loss_and_grads_bf16():
    rlm, rp, tlm, tp = _pair(jnp.bfloat16, torch.bfloat16)
    toks = _tokens(tlm.cfg.vocab_size)
    (rl, _), rg = jax.value_and_grad(rlm.loss_fn, has_aux=True)(rp, {"tokens": jnp.asarray(toks)})
    tl, tg = _port_value_and_grad(tlm, tp, toks)
    assert abs(tl - float(rl)) <= 2e-2
    for name, g in flatten_with_paths(rg).items():
        np.testing.assert_allclose(tg[name], np.asarray(g, np.float32), atol=2e-2, err_msg=name)


def test_adamw_update_matches_reference():
    rlm, rp, tlm, tp = _pair(jnp.float32, torch.float32)
    toks = _tokens(tlm.cfg.vocab_size)
    _, rg = jax.value_and_grad(rlm.loss_fn, has_aux=True)(rp, {"tokens": jnp.asarray(toks)})
    # a state one step in: nonzero moments, step 1
    rng = np.random.default_rng(2)
    flat_p = {k: np.asarray(v) for k, v in flatten_with_paths(rp).items()}
    m = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32) for k, v in flat_p.items()}
    v = {k: (rng.random(v.shape) * 1e-6).astype(np.float32) for k, v in flat_p.items()}
    rstate = ref_init_state(rp)
    rstate.exp_avg = jax.tree.map(jnp.asarray, unflatten_from_paths(m))
    rstate.exp_avg_sq = jax.tree.map(jnp.asarray, unflatten_from_paths(v))
    rstate.step = jnp.asarray(1, jnp.int32)
    tcfg = RC.TrainConfig()
    rnew, rmet = jax.jit(ref_adamw, static_argnums=2)(rstate, rg, tcfg)
    tstate = TrainState(
        tp,
        unflatten_from_paths({k: torch.from_numpy(a) for k, a in m.items()}),
        unflatten_from_paths({k: torch.from_numpy(a) for k, a in v.items()}),
        1,
    )
    tgrads = unflatten_from_paths(
        {k: torch.from_numpy(np.array(g)) for k, g in flatten_with_paths(rg).items()})
    tnew, tmet = adamw_update(tstate, tgrads, TC.TrainConfig())
    assert tnew.step == 2
    for key in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(tmet[key]), float(rmet[key]), rtol=1e-6)
    # atol: XLA contracts ``m·b1 + (1-b1)·g`` into one fused multiply-add,
    # PyTorch rounds twice; at the moments' scale (1e-3) that is ~1e-10, which
    # an element where the two terms nearly cancel shows as a relative error.
    for what, rtree, ttree in (("params", rnew.params, tnew.params),
                               ("exp_avg", rnew.exp_avg, tnew.exp_avg),
                               ("exp_avg_sq", rnew.exp_avg_sq, tnew.exp_avg_sq)):
        tt = tflat(ttree)
        for name, a in flatten_with_paths(rtree).items():
            np.testing.assert_allclose(tt[name].numpy(), np.asarray(a), rtol=1e-6, atol=1e-10,
                                       err_msg=f"{what} {name}")


def test_three_train_steps_match_reference_jit():
    rlm, rp, tlm, tp = _pair(jnp.float32, torch.float32)
    rstep = jax.jit(ref_make_step(rlm, RC.TrainConfig(), RC.ParallelismConfig()))
    tstep = make_train_step(tlm, TC.TrainConfig(), TC.ParallelismConfig())
    rstate, tstate = ref_init_state(rp), init_state(tp)
    for i in range(3):
        toks = _tokens(tlm.cfg.vocab_size, seed=10 + i)
        rstate, rm = rstep(rstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(toks).long()})
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= 1e-5
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]), rtol=1e-6)
    assert tstate.step == int(rstate.step) == 3
    # AdamW's first steps move each weight by about lr·sign(g): a gradient
    # within rounding of 0 may take the other sign, so the bound is the
    # summed lr of the 3 steps (3e-5 + 6e-5 + 9e-5), twice.
    tt = tflat(tstate.params)
    for name, a in flatten_with_paths(rstate.params).items():
        np.testing.assert_allclose(tt[name].numpy(), np.asarray(a), atol=3.6e-4, err_msg=name)


def test_dense_aux_is_exactly_zero_and_the_loss_unchanged():
    """A dense model has no MoE layer: its aux is exactly 0, and the loss it
    differentiates is the bare cross-entropy (the reference's loss), so the
    smollm train path keeps its numbers."""
    rlm, rp, tlm, tp = _pair(jnp.float32, torch.float32)
    toks = _tokens(tlm.cfg.vocab_size)
    _, aux = tlm.forward(tp, torch.from_numpy(toks[:, :-1]).long())
    assert aux.dtype == torch.float32 and float(aux) == 0.0
    total, metrics = tlm.loss_fn(tp, {"tokens": torch.from_numpy(toks).long()})
    assert float(metrics["aux"]) == 0.0 and torch.equal(total, metrics["loss"])
    rtotal, _ = rlm.loss_fn(rp, {"tokens": jnp.asarray(toks)})
    assert abs(float(total) - float(rtotal)) <= 1e-5


@pytest.mark.parametrize("variant,loss_tol,norm_rtol", [
    # two microbatches of 2 average to the batch of 4 (bf16 sums reassociate)
    ({"grad_accum": 2}, 2e-2, 2e-2),
    # one cast of the master per step gives the same forward; the tied
    # embedding's two gradients then add in bf16 on the cast copy
    ({"cast_params_once": True}, 0.0, 1e-4),
], ids=["grad_accum", "cast_params_once"])
def test_step_variants_equal_the_plain_step(variant, loss_tol, norm_rtol):
    _, _, tlm, tp = _pair(jnp.bfloat16, torch.bfloat16)
    toks = torch.from_numpy(_tokens(tlm.cfg.vocab_size)).long()
    plain = make_train_step(tlm, TC.TrainConfig(), TC.ParallelismConfig())
    other = make_train_step(tlm, TC.TrainConfig(), TC.ParallelismConfig(**variant))
    _, m1 = plain(init_state(tp), {"tokens": toks})
    _, m2 = other(init_state(tp), {"tokens": toks})
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= loss_tol
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=norm_rtol)


@pytest.mark.parametrize("sq,window,qb,kb", [(64, 0, 16, 32), (96, 24, 32, 32), (128, 0, 128, 64)])
def test_chunked_attention_matches_full_and_reference(sq, window, qb, kb):
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((2, sq, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, sq, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, sq, 2, 16)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = TA.chunked_attention(tq, tk, tv, window=window, q_block=qb, kv_block=kb)
    full = TA.full_attention(tq, tk, tv, window=window)
    ref = RA.chunked_attention(q, k, v, window=window, q_block=qb, kv_block=kb)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_flash_wrapper_refuses_a_recorded_gradient():
    q = torch.zeros(1, 8, 2, 16, requires_grad=True)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_ops.refuse_grad(q, k, k)
    with torch.no_grad():
        flash_ops.refuse_grad(q, k, k)  # nothing recorded: allowed
    flash_ops.refuse_grad(q.detach(), k, k)


def test_model_trains_through_differentiable_attention(monkeypatch):
    """With a gradient recorded the model never calls the kernel wrapper;
    ``wqkv`` gets a nonzero gradient from attention."""
    _, _, tlm, tp = _pair(jnp.float32, torch.float32, remat="none")
    calls = []
    monkeypatch.setattr("repro_torch.models.lm.flash_attention",
                        lambda *a, **k: calls.append(1) or flash_ops.flash_attention(*a, **k))
    leaves = {k: v.detach().requires_grad_(True) for k, v in tflat(tp).items()}
    toks = torch.from_numpy(_tokens(tlm.cfg.vocab_size)).long()
    loss, _ = tlm.loss_fn(unflatten_from_paths(leaves), {"tokens": toks})
    (g,) = torch.autograd.grad(loss, [leaves["layers.blk.wqkv"]])
    assert not calls
    assert g.abs().sum() > 0
