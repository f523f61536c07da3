"""The MoE slice (mixtral-8x22b, reduced), held against the JAX package.

Every comparison feeds both packages the same inputs (numpy, seeded) or
the same weights (the reference's ``lm.init``, loaded with
``params_from_reference``):

* ``moe_block`` against ``repro.models.moe.moe_block`` in float32, with
  random routing, a capacity factor that drops tokens, router logits with
  exact ties, several groups: outputs within 1e-5, the aux loss within
  1e-6, the gradients of ``sum(out²) + aux`` with respect to x and every
  weight within 1e-4 (atol, float32 sums in another order); the chosen
  experts equal the reference's ``jax.lax.top_k``, index for index, and on
  ties the lower index comes first.  The shared experts (``num_shared``)
  go through ``LM._mlp`` of both packages.
* The parameter tables of reduced mixtral and reduced deepseek-v2 (with
  and without MLA: the dense ``head`` stage and the shared experts) equal
  the reference's field for field; the sharding plans of both equal it
  under expert parallelism (data=1,model=4) and expert-TP (data=2,model=2,
  no EP).  The MLA slice itself is ``tests/test_torch_mla.py``, the hybrid
  family (jamba) ``tests/test_torch_hybrid.py``.
* ``forward`` and ``loss_fn`` (aux included) in float32 within 1e-5, and
  three ``make_train_step`` steps against the reference's jitted step on
  one device: float32 losses within 1e-5, bf16 ones within the 2e-2 of
  ``tests/test_reconfig_e2e.py`` (``STEP_TOL``).
* Serving: prefill and decode past the reduced window of 8, float32
  logits within 1e-4 and equal greedy tokens, bf16 logits within 0.1.
* Checkpoints: a save under EP is the reference's ``write_distributed``
  byte for byte (float32 and bfloat16 moments); an EP → expert-TP resume
  through RESHARD_STREAM equals a forced VIA_UCP and the saved state bit
  for bit; a checkpoint the reference wrote restores in the port bit-equal.
"""

import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.core as R  # noqa: E402
import repro.dist.sharding as RS  # noqa: E402
from repro.ckpt.saver import write_distributed as ref_write  # noqa: E402
from repro.core.pytree import flatten_with_paths  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import decode as RD  # noqa: E402
from repro.models import lm as RL  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.train.optimizer import init_state as ref_init_state  # noqa: E402
from repro.train.steps import make_train_step as ref_make_step  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.dist.sharding as TS  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.ckpt.policy import CheckpointPolicy  # noqa: E402
from repro_torch.ckpt.saver import write_distributed as port_write  # noqa: E402
from repro_torch.core.plan import ResumeMode  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths as tflat  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.train.optimizer import init_state  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

ARCH = "mixtral-8x22b"
EP = ({"data": 1, "model": 4}, {})
TP = ({"data": 2, "model": 2}, {"expert_parallel": False})


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------


def _moe_inputs(seed, b=2, s=16, d=32, e=4, f=24, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) * 0.3).astype(np.float32)
    if ties:  # experts 1 and 2 score alike, as do 0 and 3: every token ties twice
        router[:, 2] = router[:, 1]
        router[:, 3] = router[:, 0]
    wg = (rng.standard_normal((e, d, f)) * 0.2).astype(np.float32)
    wu = (rng.standard_normal((e, d, f)) * 0.2).astype(np.float32)
    wd = (rng.standard_normal((e, f, d)) * 0.2).astype(np.float32)
    return x, router, wg, wu, wd


MOE_CASES = {
    "random": dict(cf=1.25, groups=None),
    "capacity_drop": dict(cf=0.5, groups=None),
    "ties": dict(cf=1.25, groups=None, ties=True),
    "ties_and_drop": dict(cf=0.75, groups=None, ties=True),
    "groups4": dict(cf=1.25, groups=4),
    "groups8_top1": dict(cf=1.0, groups=8, k=1),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_block_matches_reference(case):
    spec = dict(MOE_CASES[case])
    cf, groups, k = spec.pop("cf"), spec.pop("groups"), spec.pop("k", 2)
    arrays = _moe_inputs(3, **spec)
    x, router, *_ = arrays
    e, f = router.shape[1], arrays[2].shape[2]
    rcfg = RC.MoEConfig(num_experts=e, top_k=k, d_ff_expert=f, capacity_factor=cf)
    tcfg = TC.MoEConfig(num_experts=e, top_k=k, d_ff_expert=f, capacity_factor=cf)

    jin = [jnp.asarray(a) for a in arrays]
    rout, raux = RM.moe_block(*jin, rcfg, groups=groups)
    tin = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tout, taux = TM.moe_block(*tin, tcfg, groups=groups)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(rout), atol=1e-5, rtol=0)
    assert taux.dtype == torch.float32
    np.testing.assert_allclose(float(taux.detach()), float(raux), atol=1e-6, rtol=0)

    # the routing itself: the same experts in the same order, ties to the lower index
    b, _, d = x.shape
    g = groups or b
    xg = x.reshape(g, -1, d)
    rprobs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xg, router), axis=-1)
    _, ridx = jax.lax.top_k(rprobs, k)
    _, gate_k, tidx = TM.route(torch.from_numpy(xg), torch.from_numpy(router), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(ridx))
    if spec.get("ties"):
        assert bool((tidx[..., 0] < tidx[..., 1]).all())  # every token tied: lower first
        assert bool((gate_k[..., 0] == gate_k[..., 1]).all())
    c = TM.capacity_per_group(xg.shape[1], tcfg)
    assert c == RM.capacity_per_group(xg.shape[1], rcfg)
    _, keep, _ = TM.assign_slots(tidx, e, c)
    if case in ("capacity_drop", "ties_and_drop"):
        assert not bool(keep.all())  # the case really drops tokens

    def rloss(*a):
        o, au = RM.moe_block(*a, rcfg, groups=groups)
        return jnp.sum(o * o) + au

    rgrads = jax.grad(rloss, argnums=tuple(range(5)))(*jin)
    tgrads = torch.autograd.grad((tout * tout).sum() + taux, tin)
    for name, rg, tg in zip(("x", "router", "w_gate", "w_up", "w_down"), rgrads, tgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(rg), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_stable_top_k_takes_the_lowest_experts_on_a_full_tie():
    """All equal probabilities: the chosen experts are 0..k-1, in order."""
    xg = torch.zeros(1, 5, 8)
    _, gate_k, idx = TM.route(xg, torch.randn(8, 6), 3)
    assert idx.tolist() == [[[0, 1, 2]] * 5]
    torch.testing.assert_close(gate_k, torch.full((1, 5, 3), 1 / 3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_experts_mlp_matches_reference(dtype):
    """``LM._mlp`` of a MoE layer with shared experts (reduced deepseek-v2
    without MLA): output and aux against the reference's ``_mlp``."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rlm, rp, tlm, tp = _pair("deepseek-v2-236b", jdt, tdt, mla=None)
    assert tlm.cfg.moe.num_shared == 1
    p = {k: v[0] for k, v in tp["layers"]["blk"].items()}
    rpl = {k: v[0] for k, v in rp["layers"]["blk"].items()}
    x = np.random.default_rng(5).standard_normal((2, 12, tlm.cfg.d_model)).astype(np.float32)
    rout, raux = rlm._mlp(rpl, jnp.asarray(x, jdt), moe=True)
    tout, taux = tlm._mlp(p, torch.from_numpy(x).to(tdt), moe=True)
    atol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(tout.float().numpy(), np.asarray(rout, np.float32), atol=atol)
    np.testing.assert_allclose(float(taux), float(raux), atol=1e-6 if dtype == "float32" else 1e-3)


# ---------------------------------------------------------------------------
# registry and plan
# ---------------------------------------------------------------------------


def _cfgs(arch, **overrides):
    return (dataclasses.replace(RC.reduced(RC.get_config(arch)), **overrides),
            dataclasses.replace(TC.reduced(TC.get_config(arch)), **overrides))


def _fields(d):
    return (d.path, tuple(d.shape), tuple(d.axes), d.init, d.fan_in_dim, d.parts, d.parts_dim,
            d.kind, d.stacked)


@pytest.mark.parametrize("arch,overrides", [(ARCH, {}), ("deepseek-v2-236b", {"mla": None}),
                                           ("deepseek-v2-236b", {})],
                         ids=["mixtral", "deepseek-v2-no-mla", "deepseek-v2"])
def test_param_defs_equal_reference(arch, overrides):
    rcfg, tcfg = _cfgs(arch, **overrides)
    assert tcfg.fingerprint() == rcfg.fingerprint()
    rstages, tstages = RL.plan_stages(rcfg), TL.plan_stages(tcfg)
    assert [(s.name, s.count, s.windows) for s in tstages] == \
        [(s.name, s.count, s.windows) for s in rstages]
    assert [[(ld.name, ld.kind, ld.window, ld.moe) for ld in s.body] for s in tstages] == \
        [[(ld.name, ld.kind, ld.window, ld.moe) for ld in s.body] for s in rstages]
    rdefs = RL.build_param_defs(rcfg, 256)
    tdefs = TL.build_param_defs(tcfg, 256)
    assert [_fields(d) for d in tdefs] == [_fields(d) for d in rdefs]
    names = {d.path for d in tdefs}
    assert {"layers.blk.router", "layers.blk.we_gate", "layers.blk.we_up",
            "layers.blk.we_down"} <= names
    if arch != ARCH:  # the dense head stage and the shared experts
        assert {"head.blk.w_gate", "layers.blk.ws_gate", "layers.blk.ws_down"} <= names


def test_jamba_hybrid_still_refused():
    """The hybrid family (jamba: Mamba-2 and attention layers, MoE) builds
    since its slice (the name is the one this test had while it was
    refused; tests/test_torch_hybrid.py holds it against the reference):
    one ``periods`` stage of 2 × 8 layers, MoE on every second."""
    lm = build_model(TC.reduced(TC.get_config("jamba-1.5-large-398b")))
    (stage,) = lm.stages
    assert (stage.name, stage.count, len(stage.body)) == ("periods", 2, 8)
    assert [ld.moe for ld in stage.body] == [True, False] * 4
    assert lm.registry["periods.p4_attn.we_gate"].kind == "moe_expert"


def _plans(mesh_d, kw, arch=ARCH):
    rcfg, tcfg = _cfgs(arch)
    rmesh, tmesh = R.MeshSpec.from_dict(mesh_d), T.MeshSpec.from_dict(mesh_d)
    rpar, tpar = RC.ParallelismConfig(**kw), TC.ParallelismConfig(**kw)
    rlm = ref_build(rcfg, vocab_multiple=RS.vocab_multiple(rpar, rmesh))
    tlm = build_model(tcfg, vocab_multiple=TS.vocab_multiple(tpar, tmesh))
    return (RS.make_plan(rcfg, rlm.registry, rpar, rmesh),
            TS.make_plan(tcfg, tlm.registry, tpar, tmesh))


@pytest.mark.parametrize("arch,layout,mode,axis", [
    (ARCH, EP, "ep", "expert"), (ARCH, TP, "tp", "expert_mlp"),
    ("deepseek-v2-236b", EP, "ep", "expert"), ("deepseek-v2-236b", TP, "tp", "expert_mlp"),
], ids=["ep", "tp", "deepseek-v2-ep", "deepseek-v2-tp"])
def test_plan_equals_reference(arch, layout, mode, axis):
    rplan, tplan = _plans(*layout, arch=arch)
    assert tplan.moe_mode == rplan.moe_mode == mode
    assert {n: s.to_json() for n, s in tplan.param_specs.items()} == \
        {n: s.to_json() for n, s in rplan.param_specs.items()}
    # the model axis lands on the expert dim under EP, on the expert MLP under TP
    spec = tplan.param_specs["layers.blk.we_gate"]
    axes = ("layers", "expert", "embed", "expert_mlp")
    for kind in spec.states:
        dims = spec.states[kind].dims
        assert "model" in dims[axes.index(axis)].axes
        assert all("model" not in dims[i].axes for i in range(4) if axes[i] != axis)
    router = tplan.param_specs["layers.blk.router"].states[T.StateKind.FP32].dims
    assert all("model" not in dim.axes for dim in router)  # expert_router: no TP rule


# ---------------------------------------------------------------------------
# the model: forward, loss, train steps, serving
# ---------------------------------------------------------------------------


def _pair(arch, jdt, tdt, seed=0, remat="full", **overrides):
    rcfg, tcfg = _cfgs(arch, **overrides)
    rlm = ref_build(rcfg, compute_dtype=jdt, remat=remat)
    tlm = build_model(tcfg, compute_dtype=tdt, remat=remat)
    rparams = rlm.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(rparams).items()}
    return rlm, rparams, tlm, params_from_reference(flat, tlm, "cpu")


def _tokens(vocab, b=4, s=17, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch,overrides", [(ARCH, {}), ("deepseek-v2-236b", {"mla": None})],
                         ids=["mixtral", "deepseek-v2-no-mla"])
def test_forward_and_loss_match_reference(arch, overrides):
    rlm, rp, tlm, tp = _pair(arch, jnp.float32, torch.float32, **overrides)
    toks = _tokens(tlm.cfg.vocab_size)
    rlogits, raux = rlm.forward(rp, jnp.asarray(toks[:, :-1]))
    tlogits, taux = tlm.forward(tp, torch.from_numpy(toks[:, :-1]).long())
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(rlogits), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(taux), float(raux), atol=1e-6)
    assert float(taux) > 0  # a real load-balancing term, summed over the MoE layers
    rtotal, rmet = rlm.loss_fn(rp, {"tokens": jnp.asarray(toks)})
    ttotal, tmet = tlm.loss_fn(tp, {"tokens": torch.from_numpy(toks).long()})
    for a, b in ((ttotal, rtotal), (tmet["loss"], rmet["loss"]), (tmet["aux"], rmet["aux"])):
        np.testing.assert_allclose(float(a), float(b), atol=1e-5)
    weight = tlm.cfg.moe.router_aux_weight
    torch.testing.assert_close(ttotal, tmet["loss"] + weight * tmet["aux"])


# (loss and aux, grad norm relative): float32 is the same arithmetic (1e-5);
# in bf16 the two frameworks round the router logits at different places,
# so a few near-tied tokens pick another second expert: the losses stay
# within the 2e-2 of tests/test_reconfig_e2e.py, the gradient norm within 5%.
STEP_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_reference_jit(dtype):
    tol, norm_rtol = STEP_TOL[dtype]
    rlm, rp, tlm, tp = _pair(ARCH, getattr(jnp, dtype), getattr(torch, dtype))
    rstep = jax.jit(ref_make_step(rlm, RC.TrainConfig(), RC.ParallelismConfig()))
    tstep = make_train_step(tlm, TC.TrainConfig(), TC.ParallelismConfig())
    rstate, tstate = ref_init_state(rp), init_state(tp)
    for i in range(3):
        toks = _tokens(tlm.cfg.vocab_size, seed=10 + i)
        rstate, rm = rstep(rstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(toks).long()})
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= tol
        assert abs(float(tm["aux"]) - float(rm["aux"])) <= tol
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=norm_rtol)
    assert tstate.step == int(rstate.step) == 3
    if dtype == "float32":
        # AdamW's first steps move a weight by about lr·sign(g): the bound is
        # twice the summed lr of the 3 steps, as tests/test_torch_train.py
        tt = tflat(tstate.params)
        for name, a in flatten_with_paths(rstate.params).items():
            np.testing.assert_allclose(tt[name].numpy(), np.asarray(a), atol=3.6e-4,
                                       err_msg=name)


def test_accumulated_step_reports_the_cross_entropy_as_the_reference_jit():
    """With ``grad_accum=2`` the reference's step reports the microbatches'
    mean cross-entropy (its ``m["loss"]``), without the MoE aux loss it
    differentiates: the port's reported loss and updated weights equal its
    jitted step's in fp32 (a reported total misses by the whole aux)."""
    rlm, rp, tlm, tp = _pair(ARCH, jnp.float32, torch.float32)
    rstep = jax.jit(ref_make_step(rlm, RC.TrainConfig(), RC.ParallelismConfig(grad_accum=2)))
    tstep = make_train_step(tlm, TC.TrainConfig(), TC.ParallelismConfig(grad_accum=2))
    toks = _tokens(tlm.cfg.vocab_size, seed=10)
    rstate, rm = rstep(ref_init_state(rp), {"tokens": jnp.asarray(toks)})
    tstate, tm = tstep(init_state(tp), {"tokens": torch.from_numpy(toks).long()})
    _, aux = tlm.forward(tp, torch.from_numpy(toks[:, :-1]).long())
    assert float(aux) > 1e-3  # the aux a reported total would add
    assert abs(float(tm["loss"]) - float(rm["loss"])) <= 1e-5
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-5)
    # one AdamW step moves a weight by about lr·sign(g): twice its lr bounds it
    tt = tflat(tstate.params)
    for name, a in flatten_with_paths(rstate.params).items():
        np.testing.assert_allclose(tt[name].numpy(), np.asarray(a), atol=6e-5, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_past_the_window_match_reference(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rlm, rp, tlm, tp = _pair(ARCH, jdt, tdt, remat="none")
    assert tlm.stages[0].body[0].window == 8  # the reduced sliding window
    b, s, steps = 2, 12, 7  # positions up to 18: the 8-slot ring wraps twice
    toks = _tokens(tlm.cfg.vocab_size, b=b, s=s, seed=4)
    rc, tc = RD.init_cache(rlm, b, s + steps + 1), D.init_cache(tlm, b, s + steps + 1)
    assert tc["layers"]["blk"]["k"].shape[2] == 8
    rl, rc = RD.prefill(rlm, rp, rc, jnp.asarray(toks))
    tl, tc = D.prefill(tlm, tp, tc, torch.from_numpy(toks).long())
    # bf16 logits within 0.1, as the dense serving test; the greedy tokens
    # are compared in float32 (a near-tie may rank otherwise in bf16), and
    # both packages decode the reference's tokens
    exact = dtype == "float32"
    atol = 1e-4 if exact else 0.1
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(rl, np.float32), atol=atol)
    cur = np.asarray(jnp.argmax(rl, -1))[:, None]
    assert not exact or np.array_equal(tl.argmax(-1)[:, None].numpy(), cur)
    for _ in range(steps):
        rl, rc = RD.decode_step(rlm, rp, rc, jnp.asarray(cur, jnp.int32))
        tl, tc = D.decode_step(tlm, tp, tc, torch.from_numpy(cur.copy()).long())
        np.testing.assert_allclose(tl.float().numpy(), np.asarray(rl, np.float32), atol=atol)
        nxt = np.asarray(jnp.argmax(rl[:, -1], -1))[:, None]
        assert not exact or np.array_equal(tl[:, -1].argmax(-1)[:, None].numpy(), nxt)
        cur = nxt
    np.testing.assert_array_equal(tc["layers"]["blk"]["slot_pos"].numpy(),
                                  np.asarray(rc["layers"]["blk"]["slot_pos"]))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _snapshot(seed=0):
    """Reference params (``lm.init``) with seeded random moments, as numpy."""
    rcfg, _ = _cfgs(ARCH)
    params = flatten_with_paths(ref_build(rcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return {
        n: {R.StateKind.FP32: np.asarray(p),
            R.StateKind.EXP_AVG: rng.standard_normal(p.shape).astype(np.float32),
            R.StateKind.EXP_AVG_SQ: rng.random(p.shape).astype(np.float32)}
        for n, p in params.items()
    }


def _same_checkpoints(a, b):
    """Every shard file byte-equal, manifests equal apart from created_at."""
    fa = sorted(p.relative_to(a) for p in a.glob("ranks/**/*.npy"))
    fb = sorted(p.relative_to(b) for p in b.glob("ranks/**/*.npy"))
    assert fa == fb and fa
    for rel in fa:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    ja, jb = (json.loads((d / "MANIFEST.json").read_text()) for d in (a, b))
    ja.pop("created_at"), jb.pop("created_at")
    assert ja == jb


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_save_under_ep_is_the_reference_bytes(tmp_path, moment_dtype):
    """A numpy snapshot written by both packages under EP: the same files;
    bf16 moments are cast through torch on the port's numpy path, as the
    reference casts through ``ml_dtypes``, and the reference reads them."""
    mesh_d, kw = EP
    kw = dict(kw, moment_dtype=moment_dtype)
    rplan, tplan = _plans(mesh_d, kw)
    assert tplan.moe_mode == "ep"
    snap = _snapshot()
    tsnap = {n: {T.StateKind(k.value): a for k, a in kinds.items()} for n, kinds in snap.items()}
    rcfg, tcfg = _cfgs(ARCH)
    port_write(tsnap, tplan, 4, tmp_path / "port", config_fingerprint=tcfg.fingerprint())
    ref_write(snap, rplan, 4, tmp_path / "ref", workers=1, config_fingerprint=rcfg.fingerprint())
    _same_checkpoints(tmp_path / "port", tmp_path / "ref")
    ck = R.DistCheckpoint.open(tmp_path / "port")
    assert ck.validate() == []
    spec = ck.manifest.params["layers.blk.we_up"]
    atom = R.assemble_atom(ck, spec, R.StateKind.EXP_AVG)
    want = snap["layers.blk.we_up"][R.StateKind.EXP_AVG]
    assert str(atom.dtype) == moment_dtype
    np.testing.assert_array_equal(atom, want.astype(atom.dtype))


def _train_and_save(root, steps=2):
    mesh_d, kw = EP
    tr = Trainer.create(
        TC.reduced(TC.get_config(ARCH)), TC.ParallelismConfig(**kw), TC.TrainConfig(),
        T.MeshSpec.from_dict(mesh_d), batch_size=4, seq_len=16, ckpt_dir=str(root),
        policy=CheckpointPolicy(save_interval=steps, async_save=False), device="cpu",
    )
    assert tr.plan.moe_mode == "ep"
    state, hist = tr.run(tr.init_state(), 0, steps)
    tr.manager.close()
    assert all(np.isfinite(h["loss"]) and h["aux"] > 0 for h in hist)
    return state


def _tp_manager(root):
    mesh_d, kw = TP
    tcfg = TC.reduced(TC.get_config(ARCH))
    mesh, parallel = T.MeshSpec.from_dict(mesh_d), TC.ParallelismConfig(**kw)
    lm = build_model(tcfg, vocab_multiple=TS.vocab_multiple(parallel, mesh))
    plan = TS.make_plan(tcfg, lm.registry, parallel, mesh)
    assert plan.moe_mode == "tp"
    return CheckpointManager(root, plan, policy=CheckpointPolicy(async_save=False))


def _trees(state):
    return [tflat(t) for t in (state.params, state.exp_avg, state.exp_avg_sq)]


def _assert_same_state(a, b):
    for ta, tb in zip(_trees(a), _trees(b)):
        assert ta.keys() == tb.keys()
        for name, t in ta.items():
            region = tuple(slice(0, min(x, y)) for x, y in zip(t.shape, tb[name].shape))
            assert t.dtype == tb[name].dtype and torch.equal(t[region], tb[name][region]), name


def test_ep_to_tp_stream_resume_equals_via_ucp_and_the_save(tmp_path):
    saved = _train_and_save(tmp_path / "ck")
    mgr = _tp_manager(tmp_path / "ck")
    stream, info = mgr.restore("cpu")
    assert info.mode is ResumeMode.RESHARD_STREAM, info.reason
    # the expert tensors change which dim the model axis shards: consolidated in memory
    rp = T.plan_resume(T.DistCheckpoint.open(mgr.step_dir(2)).manifest,
                       T.TargetSpec(mgr.plan.mesh, mgr.plan.param_specs))
    assert {"layers.blk.we_gate", "layers.blk.we_up", "layers.blk.we_down"} <= \
        set(rp.consolidate_params)
    via, vinfo = mgr.restore("cpu", force_mode=ResumeMode.VIA_UCP)
    assert vinfo.mode is ResumeMode.VIA_UCP
    _assert_same_state(stream, via)
    _assert_same_state(stream, saved)
    assert stream.step == via.step == saved.step == 2


def test_reference_written_moe_checkpoint_restores_in_port(tmp_path):
    """The reference writes under EP; the port restores it under expert-TP
    (RESHARD_STREAM) and under EP (DIRECT), every kind bit-equal."""
    snap = _snapshot(seed=2)
    rplan, tplan = _plans(*EP)
    rcfg, _ = _cfgs(ARCH)
    ref_write(snap, rplan, 3, tmp_path / "ck" / "step_00000003", workers=1,
              config_fingerprint=rcfg.fingerprint())
    kinds = (R.StateKind.FP32, R.StateKind.EXP_AVG, R.StateKind.EXP_AVG_SQ)
    for mgr, mode in ((_tp_manager(tmp_path / "ck"), ResumeMode.RESHARD_STREAM),
                      (CheckpointManager(tmp_path / "ck", tplan), ResumeMode.DIRECT)):
        state, info = mgr.restore("cpu")
        assert info.mode is mode, info.reason
        for kind, tree in zip(kinds, _trees(state)):
            for name, t in tree.items():
                want = snap[name][kind]
                got = t[tuple(slice(0, n) for n in want.shape)].numpy()
                assert got.tobytes() == want.tobytes(), (name, kind)


def test_serve_cli_serves_a_resharded_moe_checkpoint(tmp_path, capsys):
    """Weights-only serving of the EP save under data=1,model=1 and under
    the saving layout: RESHARD_STREAM and DIRECT, the same tokens."""
    from repro_torch.launch import serve

    _train_and_save(tmp_path / "ck", steps=1)
    outs = {}
    for mesh in ("data=1,model=1", "data=1,model=4"):
        assert serve.main(["--arch", ARCH, "--reduced", "--ckpt-dir", str(tmp_path / "ck"),
                           "--mesh", mesh, "--device", "cpu", "--batch", "2",
                           "--prompt-len", "12", "--gen", "6"]) == 0
        outs[mesh] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert outs["data=1,model=1"]["mode"] == "reshard_stream"
    assert outs["data=1,model=4"]["mode"] == "direct"
    assert outs["data=1,model=1"]["tokens"] == outs["data=1,model=4"]["tokens"]


def test_train_cli_bf16_moments_ep_to_tp(tmp_path, capsys):
    """The CLI flags of the slice: ``--moment-dtype bfloat16`` with coded
    saves under EP, then ``--no-ep``: RESHARD_STREAM, bf16 moments on disk,
    and the step records carry ``aux``."""
    from repro_torch.launch import train as train_cli

    common = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
              "--ckpt-dir", str(tmp_path), "--moment-dtype", "bfloat16", "--sync-save",
              "--log-json"]
    assert train_cli.main(common + ["--mesh", "data=1,model=4", "--steps", "2",
                                    "--save-interval", "2", "--codec", "int8:b256"]) == 0
    manifest = T.DistCheckpoint.open(tmp_path / "step_00000002").manifest
    assert manifest.params["layers.blk.we_gate"].states[T.StateKind.EXP_AVG].dtype == "bfloat16"
    assert manifest.shard_codecs
    capsys.readouterr()
    assert train_cli.main(common + ["--mesh", "data=2,model=2", "--no-ep", "--steps", "3",
                                    "--save-interval", "100"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert recs[0]["event"] == "restored" and recs[0]["mode"] == "reshard_stream"
    (step,) = [r for r in recs if r.get("event") == "step"]
    assert step["step"] == 3 and np.isfinite(step["loss"]) and step["aux"] > 0


def test_stream_assembles_each_consolidated_atom_once(tmp_path, monkeypatch):
    """EP → expert-TP consolidates the expert tensors in memory.  Each
    ``(param, kind)`` atom is assembled once per restore and cut for all
    its Target regions in one job, even when the engine's atom cache keeps
    nothing (a full-width mixtral expert atom, 1.6-3.2 GB, outgrows its
    1 GiB bound): its coded shards are then decoded once."""
    from repro_torch.ckpt import restore as R_
    from repro_torch.core.engine import CheckpointEngine, HandleCache

    class KeepsNothing(HandleCache):  # an atom cache whose bound no atom fits under
        def get(self, key, loader):
            return loader()

    saved = _train_and_save(tmp_path / "ck")
    mgr = _tp_manager(tmp_path / "ck")
    ckpt = T.DistCheckpoint.open(mgr.step_dir(2))
    target = T.TargetSpec(mgr.plan.mesh, mgr.plan.param_specs)
    transforms = T.plan_resume(ckpt.manifest, target).transforms
    consolidated = {n for n, t in transforms.items() if t.cls is T.TransformClass.CONSOLIDATE}
    built = []
    assemble = R_.assemble_atom
    monkeypatch.setattr(R_, "assemble_atom",
                        lambda src, spec, kind, **kw: built.append((spec.name, kind))
                        or assemble(src, spec, kind, **kw))
    with CheckpointEngine(workers=4) as engine:
        engine.atoms = KeepsNothing()
        state = R_.state_from_stream(ckpt, mgr.plan, "cpu", transforms, engine=engine)
    assert sorted(built) == sorted((n, k) for n in consolidated for k in T.STATE_KINDS)
    _assert_same_state(state, saved)
