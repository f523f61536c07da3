"""The cross-attention slice, vlm family (llama-3.2-vision-11b), held
against the JAX package.

The reduced config keeps every structural feature: 10 layers, 2 periods of
5 (``self0..self3`` and a gated non-causal ``cross`` layer), d 64, 8:2
heads of 16, a source of 8 embeddings of 64.  Both packages get the same
inputs (numpy, seeded) and the same weights (the reference's ``lm.init``,
loaded with ``params_from_reference``).  The reference initialises
``cross_gate`` to zeros, and tanh(0) = 0 would make the cross layer add
nothing, so every comparison first sets each layer's gate to a nonzero
value drawn from the seed (in both packages' weights).

* The stage plan and the parameter table equal the reference's, reduced,
  with ``source_dim`` 48 (!= d_model, so a transposed ``cross_wkv`` shows)
  and at full width cut to one period (5 layers: 2,141,237,249 params).
* ``forward`` and the loss in float32 within 1e-5 (logits relative to the
  largest), bf16 losses within 2e-2; the logits move with the source.
* Serving: prefill and 8 decode steps in float32 against the reference's,
  logits within 1e-4, tokens and caches equal; in the port, prefill +
  decode equal ``forward`` within 1e-4.
* Plans and RESHARD_STREAM transforms equal the reference's; ``cross_wkv``
  is consolidated by part (k, v) when the model axis changes size.
* Checkpoint bytes both ways under data=2,model=2; data=2,model=2 →
  data=1,model=1 RESHARD_STREAM == forced VIA_UCP == the save.
* Three train steps against the reference's jitted step (float32 within
  1e-5, bf16 within 2e-2 and 5% on the gradient norm); the trained state
  of a one-period model saved with ``int8:b256`` moments by both packages
  is the same bytes, its one-element ``cross_gate`` rows coded.
* The train CLI under data=2,model=2 (coded), resumed under
  data=1,model=1, then the serve CLI on the resharded checkpoint.
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
from repro.core.codec import CodecPolicy as RefCodecPolicy  # noqa: E402
from repro.core.pytree import flatten_with_paths, unflatten_from_paths  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import decode as RD  # noqa: E402
from repro.models import lm as RL  # noqa: E402
from repro.train.optimizer import init_state as ref_init_state  # noqa: E402
from repro.train.steps import make_train_step as ref_make_step  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.dist.sharding as TS  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.ckpt.policy import CheckpointPolicy  # noqa: E402
from repro_torch.ckpt.saver import write_distributed as port_write  # noqa: E402
from repro_torch.core.codec import CodecPolicy  # noqa: E402
from repro_torch.core.plan import ResumeMode  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths as tflat  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.train.optimizer import init_state  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

ARCH = "llama-3.2-vision-11b"
LAYOUTS = {"dp2mp2": {"data": 2, "model": 2}, "single": {"data": 1, "model": 1}}
FULL_PARAMS = 2_141_237_249  # at full width, one period (self0..self3, cross)
# (loss, grad norm relative) of three train steps, as the other slices' tests
STEP_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2)}


def _cfgs(*, full=False, **cross):
    """(reference, port) configs: reduced, or at full width cut to one
    period; ``cross`` replaces fields of ``cross_attn`` (e.g. source_dim)."""
    rcfg, tcfg = RC.get_config(ARCH), TC.get_config(ARCH)
    if full:
        return (dataclasses.replace(rcfg, num_layers=5), dataclasses.replace(tcfg, num_layers=5))
    rcfg, tcfg = RC.reduced(rcfg), TC.reduced(tcfg)
    if cross:
        rcfg = dataclasses.replace(rcfg, cross_attn=dataclasses.replace(rcfg.cross_attn, **cross))
        tcfg = dataclasses.replace(tcfg, cross_attn=dataclasses.replace(tcfg.cross_attn, **cross))
    return rcfg, tcfg


def _gated(flat: dict, seed: int) -> dict:
    """The reference's zero gates replaced by nonzero ones from ``seed``."""
    rng = np.random.default_rng(seed + 100)
    out = dict(flat)
    for name, arr in flat.items():
        if name.endswith(".cross_gate"):
            mag = rng.uniform(0.5, 1.5, arr.shape)
            out[name] = (mag * rng.choice([-1.0, 1.0], arr.shape)).astype(np.float32)
    return out


def _pair(dtype, seed=0, remat="full", **cross):
    rcfg, tcfg = _cfgs(**cross)
    rlm = ref_build(rcfg, compute_dtype=getattr(jnp, dtype), remat=remat)
    tlm = build_model(tcfg, compute_dtype=getattr(torch, dtype), remat=remat)
    flat = _gated({k: np.asarray(v) for k, v in
                   flatten_with_paths(rlm.init(jax.random.PRNGKey(seed))).items()}, seed)
    rparams = unflatten_from_paths({k: jnp.asarray(v) for k, v in flat.items()})
    return rlm, rparams, tlm, params_from_reference(flat, tlm, "cpu")


def _tokens(vocab, b=4, s=17, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _source(cfg, b=4, seed=2):
    ca = cfg.cross_attn
    return np.random.default_rng(seed).standard_normal(
        (b, ca.source_len, ca.source_dim)).astype(np.float32)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _fields(d):
    return (d.path, tuple(d.shape), tuple(d.axes), d.init, d.fan_in_dim, d.parts, d.parts_dim,
            d.kind, d.stacked)


# ---------------------------------------------------------------------------
# the stage plan and the parameter table
# ---------------------------------------------------------------------------


def test_plan_stages_equal_reference():
    rcfg, tcfg = _cfgs()
    (rs,), (ts,) = RL.plan_stages(rcfg), TL.plan_stages(tcfg)
    assert (ts.name, ts.count, ts.windows) == (rs.name, rs.count, rs.windows) == \
        ("periods", 2, ())
    fields = ("name", "kind", "window", "moe", "with_mlp", "with_cross", "causal")
    assert [tuple(getattr(ld, f) for f in fields) for ld in ts.body] == \
        [tuple(getattr(ld, f) for f in fields) for ld in rs.body]
    assert [(ld.name, ld.kind, ld.causal) for ld in ts.body] == [
        ("self0", "attn", True), ("self1", "attn", True), ("self2", "attn", True),
        ("self3", "attn", True), ("cross", "cross", False)]


@pytest.mark.parametrize("case", ["reduced", "source48", "full-width-cut"])
def test_param_defs_equal_reference(case):
    rcfg, tcfg = _cfgs(full=case == "full-width-cut",
                       **({"source_dim": 48} if case == "source48" else {}))
    assert tcfg.fingerprint() == rcfg.fingerprint()
    rdefs = RL.build_param_defs(rcfg, tcfg.vocab_size)
    tdefs = TL.build_param_defs(tcfg, tcfg.vocab_size)
    assert [_fields(d) for d in tdefs] == [_fields(d) for d in rdefs]
    wkv, gate = tdefs["periods.cross.cross_wkv"], tdefs["periods.cross.cross_gate"]
    assert wkv.kind == "fused_qkv" and [n for n, _ in wkv.parts] == ["k", "v"]
    assert (gate.axes, gate.init) == (("layers", "scalar"), "zeros")
    assert "periods.self0.cross_gate" not in {d.path for d in tdefs}
    if case == "full-width-cut":
        assert tdefs.num_params() == rdefs.num_params() == FULL_PARAMS
        assert wkv.shape == (1, 4096, 2 * 8 * 128) and gate.shape == (1, 1)
    elif case == "source48":
        assert wkv.shape == (2, 48, 2 * 2 * 16)


def test_params_from_reference_round_trip():
    """The reference's flat params load into the port and come back the
    same bytes; a wrong shape is refused."""
    rlm, rp, tlm, tp = _pair("float32")
    want = {k: np.asarray(v) for k, v in flatten_with_paths(rp).items()}
    got = {k: v.numpy() for k, v in tflat(tp).items()}
    assert got.keys() == want.keys()
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    assert np.all(got["periods.cross.cross_gate"] != 0)
    bad = dict(want, **{"periods.cross.cross_wkv": want["periods.cross.cross_wkv"][:, :48]})
    with pytest.raises(ValueError, match="cross_wkv"):
        params_from_reference(bad, tlm, "cpu")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,cross", [("float32", {}), ("bfloat16", {}),
                                         ("float32", {"source_dim": 48})],
                         ids=["float32", "bfloat16", "float32-source48"])
def test_forward_and_loss_match_reference(dtype, cross):
    rlm, rp, tlm, tp = _pair(dtype, **cross)
    toks, src = _tokens(tlm.cfg.vocab_size), _source(tlm.cfg)
    rtotal, rmet = rlm.loss_fn(rp, {"tokens": jnp.asarray(toks), "source_embeds": jnp.asarray(src)})
    ttotal, tmet = tlm.loss_fn(tp, {"tokens": torch.from_numpy(toks).long(),
                                    "source_embeds": torch.from_numpy(src)})
    tol = 1e-5 if dtype == "float32" else 2e-2
    for a, b in ((ttotal, rtotal), (tmet["loss"], rmet["loss"])):
        np.testing.assert_allclose(float(a), float(b), atol=tol)
    if dtype == "float32":
        rlogits, _ = rlm.forward(rp, jnp.asarray(toks), source_embeds=jnp.asarray(src))
        tlogits, _ = tlm.forward(tp, torch.from_numpy(toks).long(),
                                 source_embeds=torch.from_numpy(src))
        want = np.asarray(rlogits)
        np.testing.assert_allclose(_np(tlogits), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_logits_move_with_the_source():
    """Another source changes the logits (the gated cross layers read it);
    with the gates back at zero it changes nothing."""
    _, _, tlm, tp = _pair("float32")
    toks = torch.from_numpy(_tokens(tlm.cfg.vocab_size)).long()
    a, b = (torch.from_numpy(_source(tlm.cfg, seed=s)) for s in (2, 3))
    with torch.no_grad():
        la, _ = tlm.forward(tp, toks, source_embeds=a)
        lb, _ = tlm.forward(tp, toks, source_embeds=b)
        assert (la - lb).abs().max() > 1e-2
        tp["periods"]["cross"]["cross_gate"].zero_()
        la, _ = tlm.forward(tp, toks, source_embeds=a)
        lb, _ = tlm.forward(tp, toks, source_embeds=b)
        assert torch.equal(la, lb)


def test_prefill_and_decode_match_reference():
    """Prefill 16 tokens with the source, then 8 decode steps fed the
    reference's greedy tokens, float32; the cache (the self layers' rings,
    the cross layer's ``ck``/``cv``) equal to the reference's."""
    rlm, rp, tlm, tp = _pair("float32", remat="none")
    b, s, steps = 2, 16, 8
    toks = _tokens(tlm.cfg.vocab_size, b=b, s=s, seed=4)
    src = _source(tlm.cfg, b=b, seed=5)
    rc, tc = RD.init_cache(rlm, b, s + steps), D.init_cache(tlm, b, s + steps)
    st = tc["periods"]
    assert set(st["cross"]) == {"ck", "cv"} and set(st["self0"]) == {"k", "v", "slot_pos"}
    assert st["cross"]["ck"].shape == (2, b, 8, 2, 16)  # [count, B, S_src, Hkv, hd]
    rl, rc = RD.prefill(rlm, rp, rc, jnp.asarray(toks), source_embeds=jnp.asarray(src))
    tl, tc = D.prefill(tlm, tp, tc, torch.from_numpy(toks).long(),
                       source_embeds=torch.from_numpy(src))
    np.testing.assert_allclose(_np(tl), _np(rl), atol=1e-4, rtol=0)
    cur = np.asarray(jnp.argmax(rl, -1))[:, None]
    assert np.array_equal(tl.argmax(-1)[:, None].numpy(), cur)
    for _ in range(steps):
        rl, rc = RD.decode_step(rlm, rp, rc, jnp.asarray(cur, jnp.int32))
        tl, tc = D.decode_step(tlm, tp, tc, torch.from_numpy(cur.copy()).long())
        np.testing.assert_allclose(_np(tl), _np(rl), atol=1e-4, rtol=0)
        nxt = np.asarray(jnp.argmax(rl[:, -1], -1))[:, None]
        assert np.array_equal(tl[:, -1].argmax(-1)[:, None].numpy(), nxt)
        cur = nxt
    for name, entry in tc["periods"].items():
        for k, t in entry.items():
            want = np.asarray(rc["periods"][name][k])
            if k == "slot_pos":
                np.testing.assert_array_equal(t.numpy(), want)
            else:
                np.testing.assert_allclose(_np(t), want.astype(np.float32), atol=1e-4, rtol=0,
                                           err_msg=f"{name}.{k}")


def test_prefill_then_decode_equals_forward():
    _, _, tlm, tp = _pair("float32", remat="none")
    b, s, n = 2, 12, 8
    toks = torch.from_numpy(_tokens(tlm.cfg.vocab_size, b=b, s=s, seed=9)).long()
    src = torch.from_numpy(_source(tlm.cfg, b=b, seed=10))
    with torch.no_grad():
        full, _ = tlm.forward(tp, toks, source_embeds=src)
        full = full[..., : tlm.cfg.vocab_size]
        cache = D.init_cache(tlm, b, s)
        lp, cache = D.prefill(tlm, tp, cache, toks[:, :n], source_embeds=src)
        np.testing.assert_allclose(lp.numpy(), full[:, n - 1].numpy(), atol=1e-4, rtol=0)
        for t in range(n, s):
            lt, cache = D.decode_step(tlm, tp, cache, toks[:, t:t + 1])
            np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t].numpy(), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_reference_jit(dtype):
    """The gradient through the gated cross layers (into the gates and
    ``cross_wkv``), three AdamW steps, each batch with its own source."""
    tol, norm_rtol = STEP_TOL[dtype]
    rlm, rp, tlm, tp = _pair(dtype)
    rstep = jax.jit(ref_make_step(rlm, RC.TrainConfig(), RC.ParallelismConfig()))
    tstep = make_train_step(tlm, TC.TrainConfig(), TC.ParallelismConfig())
    rstate, tstate = ref_init_state(rp), init_state(tp)
    for i in range(3):
        toks = _tokens(tlm.cfg.vocab_size, b=2, s=17, seed=10 + i)
        src = _source(tlm.cfg, b=2, seed=20 + i)
        rstate, rm = rstep(rstate, {"tokens": jnp.asarray(toks), "source_embeds": jnp.asarray(src)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(toks).long(),
                                    "source_embeds": torch.from_numpy(src)})
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= tol
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=norm_rtol)
    assert tstate.step == int(rstate.step) == 3
    if dtype == "float32":
        np.testing.assert_allclose(_np(tstate.params["periods"]["cross"]["cross_gate"]),
                                   np.asarray(rstate.params["periods"]["cross"]["cross_gate"]),
                                   atol=1e-5, rtol=0)


def test_coded_save_of_the_one_element_gate_rows_is_the_reference_bytes(tmp_path):
    """A one-period model (``cross_gate`` is [1, 1]) trained 3 steps in the
    port, its state saved with ``int8:b256`` moments under data=2,model=2 by
    both packages: the same files and manifests; each gate moment is a
    one-element coded row, and the reference decodes it within half a
    block scale of the value saved."""
    rcfg, tcfg = _cfgs()
    rcfg, tcfg = (dataclasses.replace(c, num_layers=5) for c in (rcfg, tcfg))
    tlm = build_model(tcfg, compute_dtype=torch.float32)
    tp = tlm.init(torch.Generator().manual_seed(0))
    step = make_train_step(tlm, TC.TrainConfig(), TC.ParallelismConfig())
    state = init_state(tp)
    for i in range(3):
        state, _ = step(state, {"tokens": torch.from_numpy(_tokens(256, b=2, seed=30 + i)).long(),
                                "source_embeds": torch.from_numpy(_source(tcfg, b=2, seed=40 + i))})
    kinds = (T.StateKind.FP32, T.StateKind.EXP_AVG, T.StateKind.EXP_AVG_SQ)
    trees = [tflat(t) for t in (state.params, state.exp_avg, state.exp_avg_sq)]
    snap = {n: {k: tree[n].numpy() for k, tree in zip(kinds, trees)} for n in trees[0]}
    gate = "periods.cross.cross_gate"
    assert snap[gate][T.StateKind.FP32].shape == (1, 1)
    assert np.all(snap[gate][T.StateKind.EXP_AVG] != 0)
    mesh = LAYOUTS["dp2mp2"]
    tplan = TS.make_plan(tcfg, tlm.registry, TC.ParallelismConfig(), T.MeshSpec.from_dict(mesh))
    rplan = RS.make_plan(rcfg, ref_build(rcfg).registry, RC.ParallelismConfig(),
                         R.MeshSpec.from_dict(mesh))
    port_write(snap, tplan, 3, tmp_path / "port", workers=1, codec=CodecPolicy.moments("int8:b256"),
               config_fingerprint=tcfg.fingerprint())
    rsnap = {n: {R.StateKind(k.value): a for k, a in kinds.items()} for n, kinds in snap.items()}
    ref_write(rsnap, rplan, 3, tmp_path / "ref", workers=1,
              codec=RefCodecPolicy.moments("int8:b256"), config_fingerprint=rcfg.fingerprint())
    _same_checkpoints(tmp_path / "port", tmp_path / "ref")
    ck = R.DistCheckpoint.open(tmp_path / "port")
    coded = [k for k in ck.manifest.shard_codecs if gate in k]
    assert coded and all("exp_avg" in k for k in coded), coded
    spec = ck.manifest.params[gate]
    for kind in (R.StateKind.EXP_AVG, R.StateKind.EXP_AVG_SQ):
        got = R.assemble_atom(ck, spec, kind)
        want = snap[gate][T.StateKind(kind.value)]
        assert got.shape == (1, 1)
        # one element: its block's scale is |x| / 127, so it decodes to x within rounding
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# plans and checkpoints
# ---------------------------------------------------------------------------


def _plans(layout):
    mesh = LAYOUTS[layout]
    rcfg, tcfg = _cfgs()
    rmesh, tmesh = R.MeshSpec.from_dict(mesh), T.MeshSpec.from_dict(mesh)
    rpar, tpar = RC.ParallelismConfig(), TC.ParallelismConfig()
    rlm = ref_build(rcfg, vocab_multiple=RS.vocab_multiple(rpar, rmesh))
    tlm = build_model(tcfg, vocab_multiple=TS.vocab_multiple(tpar, tmesh))
    return (RS.make_plan(rcfg, rlm.registry, rpar, rmesh),
            TS.make_plan(tcfg, tlm.registry, tpar, tmesh))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plan_equals_reference(layout):
    rplan, tplan = _plans(layout)
    assert {n: s.to_json() for n, s in tplan.param_specs.items()} == \
        {n: s.to_json() for n, s in rplan.param_specs.items()}
    if layout == "dp2mp2":
        dims = tplan.param_specs["periods.cross.cross_wkv"].states[T.StateKind.FP32].dims
        assert "model" in dims[2].axes  # the fused k/v dim


@pytest.mark.parametrize("src,tgt", [("dp2mp2", "single"), ("single", "dp2mp2")])
def test_stream_transforms_equal_reference(src, tgt):
    """Where the model axis changes size, ``cross_wkv`` is consolidated
    (its k and v parts regrouped), as every self layer's ``wqkv``."""
    rows = []
    for pkg, i in ((R, 0), (T, 1)):
        s, t = _plans(src)[i], _plans(tgt)[i]
        manifest = pkg.DistManifest(step=1, mesh=s.mesh, params=s.param_specs, scalars={},
                                    config_fingerprint={})
        rp = pkg.plan_resume(manifest, pkg.TargetSpec(t.mesh, t.param_specs))
        assert rp.mode.value == "reshard_stream", rp.reason
        rows.append((sorted(rp.consolidate_params),
                     {n: tr.cls.value for n, tr in rp.transforms.items()}))
    assert rows[0] == rows[1]
    assert {"periods.cross.cross_wkv", "periods.self0.wqkv"} <= set(rows[1][0])


def _snapshot(seed=0):
    rcfg, _ = _cfgs()
    params = _gated({k: np.asarray(v) for k, v in
                     flatten_with_paths(ref_build(rcfg).init(jax.random.PRNGKey(seed))).items()},
                    seed)
    rng = np.random.default_rng(seed)
    return {
        n: {R.StateKind.FP32: p,
            R.StateKind.EXP_AVG: rng.standard_normal(p.shape).astype(np.float32),
            R.StateKind.EXP_AVG_SQ: rng.random(p.shape).astype(np.float32)}
        for n, p in params.items()
    }


def _same_checkpoints(a, b):
    fa = sorted(p.relative_to(a) for p in a.glob("ranks/**/*.npy"))
    fb = sorted(p.relative_to(b) for p in b.glob("ranks/**/*.npy"))
    assert fa == fb and fa
    for rel in fa:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel
    ja, jb = (json.loads((d / "MANIFEST.json").read_text()) for d in (a, b))
    ja.pop("created_at"), jb.pop("created_at")
    assert ja == jb  # the shard digests included


def test_port_checkpoint_is_the_reference_bytes_and_restores_in_reference(tmp_path):
    rplan, tplan = _plans("dp2mp2")
    snap = _snapshot()
    tsnap = {n: {T.StateKind(k.value): a for k, a in kinds.items()} for n, kinds in snap.items()}
    rcfg, tcfg = _cfgs()
    port_write(tsnap, tplan, 4, tmp_path / "port", config_fingerprint=tcfg.fingerprint())
    ref_write(snap, rplan, 4, tmp_path / "ref", workers=1, config_fingerprint=rcfg.fingerprint())
    _same_checkpoints(tmp_path / "port", tmp_path / "ref")
    ck = R.DistCheckpoint.open(tmp_path / "port")
    assert ck.validate() == []
    for name, spec in ck.manifest.params.items():
        for kind in R.STATE_KINDS:
            assert R.assemble_atom(ck, spec, kind).tobytes() == snap[name][kind].tobytes(), \
                (name, kind)


def _trees(state):
    return [tflat(t) for t in (state.params, state.exp_avg, state.exp_avg_sq)]


def test_reference_checkpoint_restores_in_port(tmp_path):
    snap = _snapshot(seed=2)
    rplan, _ = _plans("dp2mp2")
    rcfg, _ = _cfgs()
    ref_write(snap, rplan, 3, tmp_path / "ck" / "step_00000003", workers=1,
              config_fingerprint=rcfg.fingerprint())
    kinds = (R.StateKind.FP32, R.StateKind.EXP_AVG, R.StateKind.EXP_AVG_SQ)
    for layout, mode in (("single", ResumeMode.RESHARD_STREAM), ("dp2mp2", ResumeMode.DIRECT)):
        state, info = CheckpointManager(tmp_path / "ck", _plans(layout)[1]).restore("cpu")
        assert info.mode is mode, (layout, info.reason)
        for kind, tree in zip(kinds, _trees(state)):
            for name, t in tree.items():
                assert t.numpy().tobytes() == snap[name][kind].tobytes(), (layout, name, kind)


def test_stream_resume_equals_via_ucp_and_the_save(tmp_path):
    """Train 2 steps under data=2,model=2 and save; restore under
    data=1,model=1 streamed (``cross_wkv`` and ``wqkv`` consolidated) and
    through UCP atoms: both bit-equal to the saved state."""
    tr = Trainer.create(
        TC.reduced(TC.get_config(ARCH)), TC.ParallelismConfig(), TC.TrainConfig(),
        T.MeshSpec.from_dict(LAYOUTS["dp2mp2"]), batch_size=2, seq_len=16,
        ckpt_dir=str(tmp_path / "ck"), policy=CheckpointPolicy(save_interval=2, async_save=False),
        device="cpu",
    )
    saved, hist = tr.run(tr.init_state(), 0, 2)
    tr.manager.close()
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert float(saved.params["periods"]["cross"]["cross_gate"].abs().min()) > 0  # trained off 0
    mgr = CheckpointManager(tmp_path / "ck", _plans("single")[1],
                            policy=CheckpointPolicy(async_save=False))
    stream, info = mgr.restore("cpu")
    assert info.mode is ResumeMode.RESHARD_STREAM, info.reason
    via, vinfo = mgr.restore("cpu", force_mode=ResumeMode.VIA_UCP)
    assert vinfo.mode is ResumeMode.VIA_UCP
    for a, b, c in zip(_trees(stream), _trees(via), _trees(saved)):
        assert a.keys() == b.keys() == c.keys()
        for name in a:
            assert torch.equal(a[name], b[name]) and torch.equal(a[name], c[name]), name
    assert stream.step == via.step == saved.step == 2


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_train_cli_coded_resume_and_serve_cli(tmp_path, capsys):
    """Train reduced llama-vision under data=2,model=2 with coded moments,
    resume under data=1,model=1 (RESHARD_STREAM), then serve the newest
    step under data=2,model=2 (RESHARD_STREAM) and data=1,model=1 (DIRECT):
    the same tokens."""
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_cli

    common = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
              "--ckpt-dir", str(tmp_path), "--sync-save", "--log-json", "--codec", "int8:b256"]
    assert train_cli.main(common + ["--mesh", "data=2,model=2", "--steps", "2",
                                    "--save-interval", "2"]) == 0
    capsys.readouterr()
    assert train_cli.main(common + ["--mesh", "data=1,model=1", "--steps", "3",
                                    "--save-interval", "3"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert recs[0]["event"] == "restored" and recs[0]["mode"] == "reshard_stream"
    (step,) = [r for r in recs if r.get("event") == "step"]
    assert step["step"] == 3 and np.isfinite(step["loss"])
    outs = {}
    for mesh, mode in (("data=2,model=2", "reshard_stream"), ("data=1,model=1", "direct")):
        assert serve.main(["--arch", ARCH, "--reduced", "--ckpt-dir", str(tmp_path),
                           "--mesh", mesh, "--device", "cpu", "--batch", "2",
                           "--prompt-len", "12", "--gen", "6"]) == 0
        outs[mesh] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert (outs[mesh]["step"], outs[mesh]["mode"]) == (3, mode)
    assert outs["data=2,model=2"]["tokens"] == outs["data=1,model=1"]["tokens"]
