"""The cross-attention slice, encdec family (whisper-tiny), held against the
JAX package.

The reduced config keeps every structural feature: an encoder of 2
bidirectional layers over 8 source frames (``encoder.blk.*``, stacked over
its layers and in no stage, then ``encoder.norm``), 2 decoder layers of
causal self-attention, ungated cross-attention to the encoder's output and
a GELU MLP (``w1``/``w2``), d 64, 2:2 heads of 16.  Both packages get the
same inputs (numpy, seeded) and the same weights (the reference's
``lm.init``, loaded with ``params_from_reference``).  The checkpoint tests
give the reduced model whisper's own vocabulary of 51,865, which pads to
51,866 under data=2,model=2: a restore under data=1,model=1 strips it.

* The stage plan and the parameter table equal the reference's, reduced
  and at full width and depth (56,355,840 params).
* ``encode`` and ``forward`` in float32 within 1e-5 (relative to the
  largest value), the loss within 1e-5, bf16 losses within 2e-2; the
  logits move with the source frames.
* Serving: prefill (the source encoded once) and 8 decode steps in
  float32 against the reference's, logits within 1e-4, tokens and caches
  (``k``/``v``/``slot_pos`` and the source's ``ck``/``cv``) equal; in the
  port, prefill + decode equal ``forward`` within 1e-4.
* Plans and RESHARD_STREAM transforms equal the reference's; checkpoint
  bytes both ways under data=2,model=2; data=2,model=2 → data=1,model=1
  RESHARD_STREAM == forced VIA_UCP == the save, the vocab padding stripped.
* Three train steps against the reference's jitted step (float32 within
  1e-5, bf16 within 2e-2 and 5% on the gradient norm).
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

ARCH = "whisper-tiny"
LAYOUTS = {"dp2mp2": {"data": 2, "model": 2}, "single": {"data": 1, "model": 1}}
FULL_PARAMS = 56_355_840  # whisper-tiny as configured: 4 + 4 layers, no cut
VOCAB = 51_865  # whisper's, odd: padded to 51,866 under model=2
STEP_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2)}


def _cfgs(*, full=False, vocab=None):
    rcfg, tcfg = RC.get_config(ARCH), TC.get_config(ARCH)
    if full:
        return rcfg, tcfg
    rcfg, tcfg = RC.reduced(rcfg), TC.reduced(tcfg)
    if vocab:
        rcfg, tcfg = (dataclasses.replace(c, vocab_size=vocab) for c in (rcfg, tcfg))
    return rcfg, tcfg


def _pair(dtype, seed=0, remat="full"):
    rcfg, tcfg = _cfgs()
    rlm = ref_build(rcfg, compute_dtype=getattr(jnp, dtype), remat=remat)
    tlm = build_model(tcfg, compute_dtype=getattr(torch, dtype), remat=remat)
    rparams = rlm.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(rparams).items()}
    return rlm, rparams, tlm, params_from_reference(flat, tlm, "cpu")


def _tokens(vocab, b=4, s=17, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _source(cfg, b=4, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder.source_len, cfg.d_model)).astype(np.float32)


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
    fields = ("name", "kind", "window", "moe", "with_mlp", "with_cross", "causal")
    assert (ts.name, ts.count) == (rs.name, rs.count) == ("dec_layers", 2)
    assert [tuple(getattr(ld, f) for f in fields) for ld in ts.body] == \
        [tuple(getattr(ld, f) for f in fields) for ld in rs.body] == \
        [("blk", "attn", 0, False, True, True, True)]


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_param_defs_equal_reference(full):
    rcfg, tcfg = _cfgs(full=full)
    assert tcfg.fingerprint() == rcfg.fingerprint()
    rdefs = RL.build_param_defs(rcfg, tcfg.vocab_size)
    tdefs = TL.build_param_defs(tcfg, tcfg.vocab_size)
    assert [_fields(d) for d in tdefs] == [_fields(d) for d in rdefs]
    names = [d.path for d in tdefs]
    enc = [n for n in names if n.startswith("encoder.")]
    assert enc == ["encoder.blk.attn_norm", "encoder.blk.wqkv", "encoder.blk.wo",
                   "encoder.blk.mlp_norm", "encoder.blk.w1", "encoder.blk.w2", "encoder.norm"]
    assert {"dec_layers.blk.cross_wkv", "dec_layers.blk.w1"} <= set(names)
    assert not any(n.endswith(("cross_gate", "w_gate")) for n in names)  # ungated, GELU
    if full:
        assert tdefs.num_params() == rdefs.num_params() == FULL_PARAMS
        assert tdefs["encoder.blk.wqkv"].shape == (4, 384, 3 * 384)
        assert tdefs["dec_layers.blk.cross_wkv"].shape == (4, 384, 2 * 384)


def test_params_from_reference_round_trip():
    rlm, rp, tlm, tp = _pair("float32")
    want = {k: np.asarray(v) for k, v in flatten_with_paths(rp).items()}
    got = {k: v.numpy() for k, v in tflat(tp).items()}
    assert got.keys() == want.keys()
    assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    with pytest.raises(ValueError, match="encoder.norm"):
        params_from_reference({k: v for k, v in want.items() if k != "encoder.norm"}, tlm, "cpu")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_encode_matches_reference():
    rlm, rp, tlm, tp = _pair("float32")
    src = _source(tlm.cfg)
    want = np.asarray(rlm.encode(rp, jnp.asarray(src)))
    got = tlm.encode(tp, torch.from_numpy(src))
    assert got.shape == (4, 8, 64)
    np.testing.assert_allclose(_np(got), want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_reference(dtype):
    rlm, rp, tlm, tp = _pair(dtype)
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
    _, _, tlm, tp = _pair("float32")
    toks = torch.from_numpy(_tokens(tlm.cfg.vocab_size)).long()
    with torch.no_grad():
        la, lb = (tlm.forward(tp, toks, source_embeds=torch.from_numpy(_source(tlm.cfg, seed=s)))[0]
                  for s in (2, 3))
    assert (la - lb).abs().max() > 1e-2


def test_prefill_and_decode_match_reference():
    rlm, rp, tlm, tp = _pair("float32", remat="none")
    b, s, steps = 2, 16, 8
    toks = _tokens(tlm.cfg.vocab_size, b=b, s=s, seed=4)
    src = _source(tlm.cfg, b=b, seed=5)
    rc, tc = RD.init_cache(rlm, b, s + steps), D.init_cache(tlm, b, s + steps)
    entry = tc["dec_layers"]["blk"]
    assert set(entry) == {"k", "v", "slot_pos", "ck", "cv"}
    assert entry["ck"].shape == (2, b, 8, 2, 16) and entry["k"].shape == (2, b, s + steps, 2, 16)
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
    for k, t in tc["dec_layers"]["blk"].items():
        want = np.asarray(rc["dec_layers"]["blk"][k])
        if k == "slot_pos":
            np.testing.assert_array_equal(t.numpy(), want)
        else:
            np.testing.assert_allclose(_np(t), want.astype(np.float32), atol=1e-4, rtol=0,
                                       err_msg=k)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_reference_jit(dtype):
    """The gradient through the decoder's cross-attention into the encoder,
    three AdamW steps, each batch with its own source frames."""
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


# ---------------------------------------------------------------------------
# plans and checkpoints (whisper's vocabulary: padded under model=2)
# ---------------------------------------------------------------------------


def _plans(layout):
    mesh = LAYOUTS[layout]
    rcfg, tcfg = _cfgs(vocab=VOCAB)
    rmesh, tmesh = R.MeshSpec.from_dict(mesh), T.MeshSpec.from_dict(mesh)
    rpar, tpar = RC.ParallelismConfig(), TC.ParallelismConfig()
    rlm = ref_build(rcfg, vocab_multiple=RS.vocab_multiple(rpar, rmesh))
    tlm = build_model(tcfg, vocab_multiple=TS.vocab_multiple(tpar, tmesh))
    assert tlm.vocab_padded == rlm.vocab_padded == {"dp2mp2": VOCAB + 1, "single": VOCAB}[layout]
    return (RS.make_plan(rcfg, rlm.registry, rpar, rmesh),
            TS.make_plan(tcfg, tlm.registry, tpar, tmesh))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plan_equals_reference(layout):
    rplan, tplan = _plans(layout)
    assert {n: s.to_json() for n, s in tplan.param_specs.items()} == \
        {n: s.to_json() for n, s in rplan.param_specs.items()}
    assert tplan.param_specs["embed"].runtime_shape[0] == \
        {"dp2mp2": VOCAB + 1, "single": VOCAB}[layout]
    assert tplan.param_specs["embed"].logical_shape[0] == VOCAB


@pytest.mark.parametrize("src,tgt", [("dp2mp2", "single"), ("single", "dp2mp2")])
def test_stream_transforms_equal_reference(src, tgt):
    """The encoder's and the decoder's fused projections are consolidated
    where the model axis changes size; the embed and unembed re-pad."""
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
    assert {"encoder.blk.wqkv", "dec_layers.blk.wqkv", "dec_layers.blk.cross_wkv"} <= \
        set(rows[1][0])


def _snapshot(seed=0):
    rcfg, _ = _cfgs(vocab=VOCAB)
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
    assert ja == jb


def _padded(snap, vocab_padded):
    """The snapshot at the runtime shapes of a padded vocab (zero rows)."""
    out = {}
    for name, kinds in snap.items():
        axis = {"embed": 0, "unembed": 1}.get(name)
        if axis is None:
            out[name] = kinds
            continue
        pad = [(0, 0), (0, 0)]
        pad[axis] = (0, vocab_padded - VOCAB)
        out[name] = {k: np.pad(a, pad) for k, a in kinds.items()}
    return out


def test_port_checkpoint_is_the_reference_bytes_and_restores_in_reference(tmp_path):
    rplan, tplan = _plans("dp2mp2")
    snap = _padded(_snapshot(), VOCAB + 1)
    tsnap = {n: {T.StateKind(k.value): a for k, a in kinds.items()} for n, kinds in snap.items()}
    rcfg, tcfg = _cfgs(vocab=VOCAB)
    port_write(tsnap, tplan, 4, tmp_path / "port", config_fingerprint=tcfg.fingerprint())
    ref_write(snap, rplan, 4, tmp_path / "ref", workers=1, config_fingerprint=rcfg.fingerprint())
    _same_checkpoints(tmp_path / "port", tmp_path / "ref")
    ck = R.DistCheckpoint.open(tmp_path / "port")
    assert ck.validate() == []
    logical = _snapshot()
    for name, spec in ck.manifest.params.items():
        for kind in R.STATE_KINDS:  # the atom is the logical vocab: padding stripped
            assert R.assemble_atom(ck, spec, kind).tobytes() == logical[name][kind].tobytes(), \
                (name, kind)


def _trees(state):
    return [tflat(t) for t in (state.params, state.exp_avg, state.exp_avg_sq)]


def test_reference_checkpoint_restores_in_port(tmp_path):
    """Written by the reference under data=2,model=2 (vocab padded to
    51,866); the port restores it under data=1,model=1 (RESHARD_STREAM,
    the padding stripped) and data=2,model=2 (DIRECT, padded)."""
    logical = _snapshot(seed=2)
    snap = _padded(logical, VOCAB + 1)
    rplan, _ = _plans("dp2mp2")
    rcfg, _ = _cfgs(vocab=VOCAB)
    ref_write(snap, rplan, 3, tmp_path / "ck" / "step_00000003", workers=1,
              config_fingerprint=rcfg.fingerprint())
    kinds = (R.StateKind.FP32, R.StateKind.EXP_AVG, R.StateKind.EXP_AVG_SQ)
    for layout, mode, want_snap in (("single", ResumeMode.RESHARD_STREAM, logical),
                                    ("dp2mp2", ResumeMode.DIRECT, snap)):
        state, info = CheckpointManager(tmp_path / "ck", _plans(layout)[1]).restore("cpu")
        assert info.mode is mode, (layout, info.reason)
        for kind, tree in zip(kinds, _trees(state)):
            for name, t in tree.items():
                assert t.numpy().tobytes() == want_snap[name][kind].tobytes(), (layout, name, kind)


def test_stream_resume_equals_via_ucp_and_the_save(tmp_path):
    """Train 2 steps under data=2,model=2 with whisper's vocabulary (padded
    to 51,866) and save; restore under data=1,model=1 streamed and through
    UCP atoms: both equal to the saved state with the padding stripped."""
    tcfg = _cfgs(vocab=VOCAB)[1]
    tr = Trainer.create(
        tcfg, TC.ParallelismConfig(), TC.TrainConfig(), T.MeshSpec.from_dict(LAYOUTS["dp2mp2"]),
        batch_size=2, seq_len=16, ckpt_dir=str(tmp_path / "ck"),
        policy=CheckpointPolicy(save_interval=2, async_save=False), device="cpu",
    )
    saved, hist = tr.run(tr.init_state(), 0, 2)
    tr.manager.close()
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert saved.params["embed"].shape == (VOCAB + 1, 64)
    mgr = CheckpointManager(tmp_path / "ck", _plans("single")[1],
                            policy=CheckpointPolicy(async_save=False))
    stream, info = mgr.restore("cpu")
    assert info.mode is ResumeMode.RESHARD_STREAM, info.reason
    via, vinfo = mgr.restore("cpu", force_mode=ResumeMode.VIA_UCP)
    assert vinfo.mode is ResumeMode.VIA_UCP
    for a, b, c in zip(_trees(stream), _trees(via), _trees(saved)):
        assert a.keys() == b.keys() == c.keys()
        for name in a:
            assert torch.equal(a[name], b[name]), name
            region = tuple(slice(0, n) for n in a[name].shape)
            assert torch.equal(a[name], c[name][region]), name
    assert stream.params["embed"].shape == (VOCAB, 64)
    assert stream.step == via.step == saved.step == 2


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_train_cli_coded_resume_and_serve_cli(tmp_path, capsys):
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
