"""The hybrid slice (jamba-1.5-large-398b: Mamba-2, attention and MoE in one
period), held against the JAX package.

The reduced config keeps every structural feature: 16 layers, 2 periods of
8 (attention at position 4, Mamba-2 elsewhere; the MoE MLP on every second
layer), d 64, 16:2 heads of 16, Mamba-2 with 8 heads of 16 and state 16
(chunk 16), 4 experts top-2.  Both packages get the same inputs (numpy,
seeded) and the same weights (the reference's ``lm.init``, loaded with
``params_from_reference``); the JAX side runs unsharded, with no mesh.

* The parameter table equals the reference's field for field, reduced and
  at full width cut to the period's layers 4 and 5 (``("attn", "mamba")``:
  11,898,463,872 params); ``a_log``/``dt_bias`` of every Mamba layer are
  kept in float32 when serving.
* ``forward`` in float32: the logits within 1e-5 of the largest reference
  logit (16 layers of float32 sums in another order: 4.9e-6 here), the loss
  within 1e-5, the aux within 1e-6; bf16 losses within 2e-2.
* Serving: prefill and 8 decode steps through the mixed cache (Mamba ``h``
  and ``conv`` beside the attention ring in one ``periods`` stage) in
  float32, logits within 1e-4 and the greedy tokens equal, with every
  expert chosen so no rounding flips a route; in the port itself, prefill +
  decode equal ``forward`` within 1e-4 with the capacity raised, as
  ``tests/test_models.py`` does.
* The sharding plans under expert parallelism (data=2,model=2), expert-TP
  (``--no-ep``) and data=1,model=1, and the RESHARD_STREAM transforms
  between them, equal the reference's.
* Checkpoint bytes both ways; EP → expert-TP RESHARD_STREAM == forced
  VIA_UCP == the save.
* Three train steps against the reference's jitted step: float32 losses
  and gradient norms within 1e-5, bf16 within 2e-2 and 5% (the aux, a sum
  over 8 MoE layers, within those bounds relative to its size).
* The train CLI under EP, resumed with ``--no-ep``; the serve CLI on the
  resharded checkpoint.
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
from repro_torch.train.optimizer import init_state  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

ARCH = "jamba-1.5-large-398b"
EP = ({"data": 2, "model": 2}, {})                          # 4 experts over model = 2
TP = ({"data": 2, "model": 2}, {"expert_parallel": False})  # expert-TP
SINGLE = ({"data": 1, "model": 1}, {})
LAYOUTS = {"ep": EP, "tp": TP, "single": SINGLE}
EXPERTS = ("we_gate", "we_up", "we_down")


def _cfgs(*, full=False, **moe):
    rcfg, tcfg = RC.get_config(ARCH), TC.get_config(ARCH)
    if full:  # the depth cut of the card: a real period's layers 4 and 5
        cut = {"num_layers": 2, "hybrid_pattern": ("attn", "mamba")}
        return dataclasses.replace(rcfg, **cut), dataclasses.replace(tcfg, **cut)
    rcfg, tcfg = RC.reduced(rcfg), TC.reduced(tcfg)
    if moe:  # e.g. top_k=4 (every expert: no route can flip) or a raised capacity
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe, **moe))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **moe))
    return rcfg, tcfg


def _pair(dtype, seed=0, remat="full", **moe):
    rcfg, tcfg = _cfgs(**moe)
    rlm = ref_build(rcfg, compute_dtype=getattr(jnp, dtype), remat=remat)
    tlm = build_model(tcfg, compute_dtype=getattr(torch, dtype), remat=remat)
    rparams = rlm.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(rparams).items()}
    return rlm, rparams, tlm, params_from_reference(flat, tlm, "cpu")


def _tokens(vocab, b=4, s=33, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _fields(d):
    return (d.path, tuple(d.shape), tuple(d.axes), d.init, d.fan_in_dim, d.parts, d.parts_dim,
            d.kind, d.stacked)


# ---------------------------------------------------------------------------
# the stage plan and the parameter table
# ---------------------------------------------------------------------------


def test_plan_stages_equal_reference():
    """16 reduced layers are 2 repetitions of the 8-layer period, attention
    at position 4, the MoE MLP on the even positions."""
    rcfg, tcfg = _cfgs()
    (rs,), (ts,) = RL.plan_stages(rcfg), TL.plan_stages(tcfg)
    assert (ts.name, ts.count, ts.windows) == (rs.name, rs.count, rs.windows) == \
        ("periods", 2, ())
    assert [(ld.name, ld.kind, ld.window, ld.moe, ld.with_mlp, ld.causal) for ld in ts.body] == \
        [(ld.name, ld.kind, ld.window, ld.moe, ld.with_mlp, ld.causal) for ld in rs.body]
    assert [ld.name for ld in ts.body] == [
        "p0_mamba", "p1_mamba", "p2_mamba", "p3_mamba", "p4_attn", "p5_mamba", "p6_mamba",
        "p7_mamba"]
    assert [ld.moe for ld in ts.body] == [True, False] * 4
    assert all(ld.with_mlp for ld in ts.body)


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full-width-cut"])
def test_param_defs_equal_reference(full):
    rcfg, tcfg = _cfgs(full=full)
    assert tcfg.fingerprint() == rcfg.fingerprint()
    rdefs = RL.build_param_defs(rcfg, tcfg.vocab_size)
    tdefs = TL.build_param_defs(tcfg, tcfg.vocab_size)
    assert [_fields(d) for d in tdefs] == [_fields(d) for d in rdefs]
    assert {d.path for d in tdefs if d.keep_fp32} == {
        d.path for d in tdefs if d.path.endswith((".a_log", ".dt_bias"))}
    if full:
        assert tdefs.num_params() == rdefs.num_params() == 11_898_463_872
        assert tdefs["periods.p0_attn.wqkv"].shape == (1, 8192, (64 + 16) * 128)
        assert tdefs["periods.p0_attn.we_gate"].shape == (1, 16, 8192, 24576)
        assert tdefs["periods.p1_mamba.in_proj"].shape == (1, 8192, 2 * 16384 + 2 * 128 + 128)
        assert tdefs["periods.p1_mamba.w_gate"].shape == (1, 8192, 24576)
        return
    names = {d.path for d in tdefs}
    assert tdefs["periods.p4_attn.we_gate"].kind == "moe_expert"
    assert tdefs["periods.p0_mamba.in_proj"].kind == "fused_qkv"
    assert {"periods.p0_mamba.router", "periods.p1_mamba.w_gate",
            "periods.p1_mamba.conv_w"} <= names
    assert "periods.p1_mamba.router" not in names


def test_serving_cast_keeps_a_log_and_dt_bias_float32():
    _, _, tlm, tp = _pair("float32")
    cast = tflat(tlm.registry.cast(tp, torch.bfloat16))
    for name, t in cast.items():
        want = torch.float32 if name.endswith((".a_log", ".dt_bias")) else torch.bfloat16
        assert t.dtype == want, name


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_reference(dtype):
    rlm, rp, tlm, tp = _pair(dtype)
    toks = _tokens(tlm.cfg.vocab_size)
    rtotal, rmet = rlm.loss_fn(rp, {"tokens": jnp.asarray(toks)})
    ttotal, tmet = tlm.loss_fn(tp, {"tokens": torch.from_numpy(toks).long()})
    tol = 1e-5 if dtype == "float32" else 2e-2
    for a, b in ((ttotal, rtotal), (tmet["loss"], rmet["loss"])):
        np.testing.assert_allclose(float(a), float(b), atol=tol)
    np.testing.assert_allclose(float(tmet["aux"]), float(rmet["aux"]),
                               atol=1e-6 if dtype == "float32" else tol)
    assert float(tmet["aux"]) > 0  # four MoE layers' load-balancing terms
    if dtype == "float32":
        rlogits, _ = rlm.forward(rp, jnp.asarray(toks[:, :-1]))
        tlogits, _ = tlm.forward(tp, torch.from_numpy(toks[:, :-1]).long())
        want = np.asarray(rlogits)
        np.testing.assert_allclose(_np(tlogits), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_prefill_and_decode_match_reference():
    """Prefill 16 tokens, then 8 decode steps fed the reference's greedy
    tokens, float32, every expert chosen; the mixed cache equal to the
    reference's, entry for entry."""
    rlm, rp, tlm, tp = _pair("float32", remat="none", top_k=4)
    b, s, steps = 2, 16, 8
    toks = _tokens(tlm.cfg.vocab_size, b=b, s=s, seed=4)
    rc, tc = RD.init_cache(rlm, b, s + steps), D.init_cache(tlm, b, s + steps)
    assert list(tc) == ["pos", "periods"]
    st = tc["periods"]
    assert set(st["p4_attn"]) == {"k", "v", "slot_pos"}
    assert set(st["p0_mamba"]) == {"h", "conv"}
    assert st["p0_mamba"]["h"].shape == (2, b, 8, 16, 16)         # [count, B, H, P, N]
    assert st["p0_mamba"]["conv"].shape == (2, b, 3, 128 + 2 * 16)
    assert st["p4_attn"]["k"].shape == (2, b, s + steps, 2, 16)
    rl, rc = RD.prefill(rlm, rp, rc, jnp.asarray(toks))
    tl, tc = D.prefill(tlm, tp, tc, torch.from_numpy(toks).long())
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
    """In the port itself: prefill 8 tokens and decode 4 give the logits of
    one forward over the 12, with the capacity raised so nothing drops
    (capacity drops differ between an 8-token group and a 1-token one)."""
    _, _, tlm, tp = _pair("float32", remat="none", capacity_factor=16.0)
    b, s, n = 2, 12, 8
    toks = torch.from_numpy(_tokens(tlm.cfg.vocab_size, b=b, s=s, seed=9)).long()
    with torch.no_grad():
        full, _ = tlm.forward(tp, toks)
        full = full[..., : tlm.cfg.vocab_size]
        cache = D.init_cache(tlm, b, s)
        lp, cache = D.prefill(tlm, tp, cache, toks[:, :n])
        np.testing.assert_allclose(lp.numpy(), full[:, n - 1].numpy(), atol=1e-4, rtol=0)
        for t in range(n, s):
            lt, cache = D.decode_step(tlm, tp, cache, toks[:, t:t + 1])
            np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t].numpy(), atol=1e-4, rtol=0)


# (loss and aux, grad norm relative): as tests/test_torch_moe.py (STEP_TOL)
STEP_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_reference_jit(dtype):
    """The gradient through ``ssd_chunked``, the attention and the MoE of
    every period, three AdamW steps."""
    tol, norm_rtol = STEP_TOL[dtype]
    rlm, rp, tlm, tp = _pair(dtype)
    rstep = jax.jit(ref_make_step(rlm, RC.TrainConfig(), RC.ParallelismConfig()))
    tstep = make_train_step(tlm, TC.TrainConfig(), TC.ParallelismConfig())
    rstate, tstate = ref_init_state(rp), init_state(tp)
    for i in range(3):
        toks = _tokens(tlm.cfg.vocab_size, b=2, s=33, seed=10 + i)
        rstate, rm = rstep(rstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(toks).long()})
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= tol
        # the aux sums 8 MoE layers' terms (~1 each): held relative to its size
        assert abs(float(tm["aux"]) - float(rm["aux"])) <= tol * float(rm["aux"])
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=norm_rtol)
    assert tstate.step == int(rstate.step) == 3


# ---------------------------------------------------------------------------
# plans and checkpoints
# ---------------------------------------------------------------------------


def _plans(layout):
    mesh_d, kw = LAYOUTS[layout]
    rcfg, tcfg = _cfgs()
    rmesh, tmesh = R.MeshSpec.from_dict(mesh_d), T.MeshSpec.from_dict(mesh_d)
    rpar, tpar = RC.ParallelismConfig(**kw), TC.ParallelismConfig(**kw)
    rlm = ref_build(rcfg, vocab_multiple=RS.vocab_multiple(rpar, rmesh))
    tlm = build_model(tcfg, vocab_multiple=TS.vocab_multiple(tpar, tmesh))
    return (RS.make_plan(rcfg, rlm.registry, rpar, rmesh),
            TS.make_plan(tcfg, tlm.registry, tpar, tmesh))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plan_equals_reference(layout):
    rplan, tplan = _plans(layout)
    assert tplan.moe_mode == rplan.moe_mode
    assert {n: s.to_json() for n, s in tplan.param_specs.items()} == \
        {n: s.to_json() for n, s in rplan.param_specs.items()}
    assert tplan.mesh.to_json() == rplan.mesh.to_json()
    if layout != "single":
        fp32 = T.StateKind.FP32
        expert_dim = {"ep": 1, "tp": 3}[layout]  # [L, expert, embed, expert_mlp]
        dims = tplan.param_specs["periods.p4_attn.we_gate"].states[fp32].dims
        assert dims[expert_dim].axes == ("model",), dims
        dims = tplan.param_specs["periods.p0_mamba.in_proj"].states[fp32].dims
        assert "model" in dims[2].axes  # the fused z/x/B/C/dt dim


@pytest.mark.parametrize("src,tgt", [("ep", "tp"), ("ep", "single"), ("tp", "single"),
                                     ("single", "ep")])
def test_stream_transforms_equal_reference(src, tgt):
    """The per-parameter RESHARD_STREAM table between two layouts: the same
    classes as the reference's; every fused ``in_proj`` consolidated where
    the model axis changes size, every expert tensor where it moves between
    the expert dim and the expert MLP."""
    rows = []
    for pkg, plans in ((R, [_plans(src)[0], _plans(tgt)[0]]), (T, [_plans(src)[1],
                                                                    _plans(tgt)[1]])):
        s, t = plans
        manifest = pkg.DistManifest(step=1, mesh=s.mesh, params=s.param_specs, scalars={},
                                    config_fingerprint={})
        rp = pkg.plan_resume(manifest, pkg.TargetSpec(t.mesh, t.param_specs))
        assert rp.mode.value == "reshard_stream", rp.reason
        rows.append((sorted(rp.consolidate_params),
                     {n: tr.cls.value for n, tr in rp.transforms.items()}))
    assert rows[0] == rows[1]
    consolidated = set(rows[1][0])
    in_proj = {f"periods.p{i}_mamba.in_proj" for i in (0, 1, 2, 3, 5, 6, 7)}
    if "single" in (src, tgt):  # the model axis changes size: z/x/B/C/dt regrouped
        assert in_proj <= consolidated
    else:
        assert not in_proj & consolidated
    if {src, tgt} == {"ep", "tp"}:
        assert {f"periods.p{i}_{k}.{e}" for i, k in ((0, "mamba"), (2, "mamba"), (4, "attn"),
                                                     (6, "mamba")) for e in EXPERTS} \
            <= consolidated


def _snapshot(seed=0):
    rcfg, _ = _cfgs()
    params = flatten_with_paths(ref_build(rcfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return {
        n: {R.StateKind.FP32: np.asarray(p),
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
    """A snapshot written by both packages under EP: the same files; the
    reference consolidates every atom of the port's checkpoint bit-equal."""
    rplan, tplan = _plans("ep")
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
    """The reference writes under EP; the port restores it under expert-TP
    and data=1,model=1 (RESHARD_STREAM) and under EP (DIRECT), every kind
    bit-equal."""
    snap = _snapshot(seed=2)
    rplan, tplan = _plans("ep")
    rcfg, _ = _cfgs()
    ref_write(snap, rplan, 3, tmp_path / "ck" / "step_00000003", workers=1,
              config_fingerprint=rcfg.fingerprint())
    kinds = (R.StateKind.FP32, R.StateKind.EXP_AVG, R.StateKind.EXP_AVG_SQ)
    for layout, mode in (("tp", ResumeMode.RESHARD_STREAM), ("single", ResumeMode.RESHARD_STREAM),
                         ("ep", ResumeMode.DIRECT)):
        state, info = CheckpointManager(tmp_path / "ck", _plans(layout)[1]).restore("cpu")
        assert info.mode is mode, (layout, info.reason)
        for kind, tree in zip(kinds, _trees(state)):
            for name, t in tree.items():
                want = snap[name][kind]
                got = t[tuple(slice(0, n) for n in want.shape)].numpy()
                assert got.tobytes() == want.tobytes(), (layout, name, kind)


def _train_and_save(root, steps=2):
    mesh_d, kw = EP
    tr = Trainer.create(
        TC.reduced(TC.get_config(ARCH)), TC.ParallelismConfig(**kw), TC.TrainConfig(),
        T.MeshSpec.from_dict(mesh_d), batch_size=2, seq_len=16, ckpt_dir=str(root),
        policy=CheckpointPolicy(save_interval=steps, async_save=False), device="cpu",
    )
    assert tr.plan.moe_mode == "ep"
    state, hist = tr.run(tr.init_state(), 0, steps)
    tr.manager.close()
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) and h["aux"] > 0
               for h in hist)
    return state


def _assert_same_state(a, b):
    for ta, tb in zip(_trees(a), _trees(b)):
        assert ta.keys() == tb.keys()
        for name, t in ta.items():
            region = tuple(slice(0, min(x, y)) for x, y in zip(t.shape, tb[name].shape))
            assert t.dtype == tb[name].dtype and torch.equal(t[region], tb[name][region]), name


def test_ep_to_tp_stream_resume_equals_via_ucp_and_the_save(tmp_path):
    saved = _train_and_save(tmp_path / "ck")
    mgr = CheckpointManager(tmp_path / "ck", _plans("tp")[1],
                            policy=CheckpointPolicy(async_save=False))
    stream, info = mgr.restore("cpu")
    assert info.mode is ResumeMode.RESHARD_STREAM, info.reason
    via, vinfo = mgr.restore("cpu", force_mode=ResumeMode.VIA_UCP)
    assert vinfo.mode is ResumeMode.VIA_UCP
    _assert_same_state(stream, via)
    _assert_same_state(stream, saved)
    assert stream.step == via.step == saved.step == 2


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_train_cli_ep_then_no_ep_and_serve_cli(tmp_path, capsys):
    """Train reduced jamba under EP with coded moments, resume it with
    ``--no-ep`` (RESHARD_STREAM), then serve the newest step, saved under
    expert-TP, resharded twice: under data=1,model=1 and under the serve
    CLI's expert parallelism at data=2,model=2; the same tokens."""
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_cli

    common = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
              "--ckpt-dir", str(tmp_path), "--sync-save", "--log-json", "--mesh",
              "data=2,model=2"]
    assert train_cli.main(common + ["--steps", "2", "--save-interval", "2",
                                    "--codec", "int8:b256"]) == 0
    capsys.readouterr()
    assert train_cli.main(common + ["--no-ep", "--steps", "3", "--save-interval", "3"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert recs[0]["event"] == "restored" and recs[0]["mode"] == "reshard_stream"
    (step,) = [r for r in recs if r.get("event") == "step"]
    assert step["step"] == 3 and np.isfinite(step["loss"]) and step["aux"] > 0
    outs = {}
    for mesh in ("data=1,model=1", "data=2,model=2"):
        assert serve.main(["--arch", ARCH, "--reduced", "--ckpt-dir", str(tmp_path),
                           "--mesh", mesh, "--device", "cpu", "--batch", "2",
                           "--prompt-len", "12", "--gen", "6"]) == 0
        outs[mesh] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert outs[mesh]["step"] == 3
        assert outs[mesh]["mode"] == "reshard_stream"
    assert outs["data=1,model=1"]["tokens"] == outs["data=2,model=2"]["tokens"]
