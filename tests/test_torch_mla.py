"""The MLA slice (deepseek-v2-236b: Multi-head Latent Attention with its
absorbed latent decode cache), held against the JAX package.

The reduced config keeps every structural feature: 2 layers (the dense
``head`` stage and one MoE layer), d 64, 2 heads, MLA q_lora 32, kv_lora 16,
nope 16, rope 8, v 16 (so attention runs with q and k of 24 and v of 16),
4 experts top-2 and one shared expert.  Both packages get the same inputs
(numpy, seeded) and the same weights (the reference's ``lm.init``, loaded
with ``params_from_reference``).

* The parameter tables equal the reference's, reduced and at full width
  (where 2 layers hold 5,358,679,040 params); serving casts every MLA
  weight to the compute dtype, as the reference reads them.
* The MLA block (``_self_attn`` of each stage) and what it keeps for the
  cache: float32 within 1e-5, bf16 within 2e-2.
* ``forward`` and ``loss_fn``: float32 logits, loss and aux within 1e-5.  In
  bf16 the two frameworks round the router's inputs at other places, so a
  token whose top-2 margin is below rounding picks another expert and its
  logits move by O(1): the bf16 loss and aux are held within 2e-2 at the
  config's top-2, the bf16 logits within 0.1 (the bf16 logit tolerance of
  the dense and MoE serving tests: XLA's and torch's bf16 GEMMs round apart
  by 0.04-0.07 here) with every expert chosen, where no routing can flip.
* Serving: prefill and 8 absorbed-latent decode steps, the logits within
  those tolerances, the greedy tokens equal (float32), the latent cache
  (``c_kv``, ``k_rope``, ``slot_pos``) equal to the reference's; the decode
  step ropes MLA at ``qk_rope_head_dim``, not at the head dim.
* Three ``make_train_step`` steps against the reference's jitted step:
  float32 losses within 1e-5, bf16 within 2e-2.
* Checkpoints under data=2,model=2 with expert parallelism: the port's
  save is the reference's bytes (manifest, shards, digests); a checkpoint
  the reference wrote restores in the port bit-equal, DIRECT and
  RESHARD_STREAM; the sharding plan puts the ``heads`` axis of ``wq_b``,
  ``wkv_b`` and ``wo`` and the expert dim on ``model``, never ``lora``.
* The serve CLI serves a checkpoint the port's trainer saved under EP,
  resharded (data=1,model=1) and direct, with the same tokens.
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

ARCH = "deepseek-v2-236b"
MESH = {"data": 2, "model": 2}  # 4 experts over model = 2: expert parallelism
MLA_NAMES = ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo")
# (atol) of logits, loss and aux by dtype; bf16 logits only where no routing flips
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BF16_LOGITS = 0.1


def _cfgs(*, full=False, all_experts=False):
    rcfg, tcfg = RC.get_config(ARCH), TC.get_config(ARCH)
    if not full:
        rcfg, tcfg = RC.reduced(rcfg), TC.reduced(tcfg)
    if all_experts:  # top-k = every expert: no routing can flip
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe, top_k=4))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, top_k=4))
    return rcfg, tcfg


def _pair(dtype, seed=0, remat="full", **kw):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rcfg, tcfg = _cfgs(**kw)
    rlm = ref_build(rcfg, compute_dtype=jdt, remat=remat)
    tlm = build_model(tcfg, compute_dtype=tdt, remat=remat)
    rparams = rlm.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(rparams).items()}
    return rlm, rparams, tlm, params_from_reference(flat, tlm, "cpu")


def _tokens(vocab, b=4, s=17, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _fields(d):
    return (d.path, tuple(d.shape), tuple(d.axes), d.init, d.fan_in_dim, d.parts, d.parts_dim,
            d.kind, d.stacked)


# ---------------------------------------------------------------------------
# parameter tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full-width"])
def test_param_defs_equal_reference(full):
    rcfg, tcfg = _cfgs(full=full)
    if full:  # depth cut to 2 layers: the dense head layer and one MoE layer
        rcfg = dataclasses.replace(rcfg, num_layers=2)
        tcfg = dataclasses.replace(tcfg, num_layers=2)
    assert tcfg.fingerprint() == rcfg.fingerprint()
    rdefs = RL.build_param_defs(rcfg, tcfg.vocab_size)
    tdefs = TL.build_param_defs(tcfg, tcfg.vocab_size)
    assert [_fields(d) for d in tdefs] == [_fields(d) for d in rdefs]
    names = {d.path for d in tdefs}
    for stage in ("head", "layers"):
        assert {f"{stage}.blk.{n}" for n in MLA_NAMES} <= names
        assert f"{stage}.blk.wqkv" not in names
    assert not any(d.keep_fp32 for d in tdefs)  # the reference casts every MLA leaf
    if full:
        assert tdefs.num_params() == rdefs.num_params() == 5_358_679_040
        m = tcfg.mla
        assert tdefs["head.blk.wq_b"].shape == (1, 1536, 128 * 192)
        assert tdefs["head.blk.wkv_b"].shape == (1, 512, 128 * 256)
        assert tdefs["layers.blk.wkv_a"].shape == (1, 5120, m.kv_lora_rank + m.qk_rope_head_dim)
        assert tdefs["layers.blk.we_gate"].shape == (1, 160, 5120, 1536)


def test_serving_cast_of_mla_weights_is_the_compute_dtype():
    """The reference reads every MLA weight through ``.astype(h.dtype)`` and
    the norms' scales through ``rms_norm``'s cast: the serving cast gives
    them all in bf16."""
    _, _, tlm, tp = _pair("float32")
    cast = tflat(tlm.registry.cast(tp, torch.bfloat16))
    for stage in ("head", "layers"):
        for n in MLA_NAMES:
            assert cast[f"{stage}.blk.{n}"].dtype == torch.bfloat16, n


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_block_matches_reference(dtype):
    """``_self_attn`` of each stage on the same input: the output and the
    (c_kv, k_rope) the cache keeps."""
    rlm, rp, tlm, tp = _pair(dtype, remat="none")
    x = np.random.default_rng(5).standard_normal((2, 20, tlm.cfg.d_model)).astype(np.float32)
    for stage in ("head", "layers"):
        p = {k: v[0] for k, v in tp[stage]["blk"].items()}
        rpl = {k: v[0] for k, v in rp[stage]["blk"].items()}
        rout, rkv = rlm._self_attn(rpl, jnp.asarray(x, getattr(jnp, dtype)), window=0,
                                   positions=jnp.arange(20))
        tout, tkv = tlm._self_attn(p, torch.from_numpy(x).to(getattr(torch, dtype)), window=0,
                                   positions=torch.arange(20))
        assert tkv[0].shape == (2, 20, 16) and tkv[1].shape == (2, 20, 8)
        for got, want in zip((tout, *tkv), (rout, *rkv)):
            np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_reference(dtype):
    rlm, rp, tlm, tp = _pair(dtype)
    toks = _tokens(tlm.cfg.vocab_size)
    rtotal, rmet = rlm.loss_fn(rp, {"tokens": jnp.asarray(toks)})
    ttotal, tmet = tlm.loss_fn(tp, {"tokens": torch.from_numpy(toks).long()})
    for a, b in ((ttotal, rtotal), (tmet["loss"], rmet["loss"]), (tmet["aux"], rmet["aux"])):
        np.testing.assert_allclose(float(a), float(b), atol=TOL[dtype])
    assert float(tmet["aux"]) > 0
    if dtype == "bfloat16":  # logits where no routing can flip
        rlm, rp, tlm, tp = _pair(dtype, all_experts=True)
    rlogits, raux = rlm.forward(rp, jnp.asarray(toks[:, :-1]))
    tlogits, taux = tlm.forward(tp, torch.from_numpy(toks[:, :-1]).long())
    atol = TOL[dtype] if dtype == "float32" else BF16_LOGITS
    np.testing.assert_allclose(_np(tlogits), _np(rlogits), atol=atol, rtol=0)
    np.testing.assert_allclose(float(taux), float(raux), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_latent_decode_match_reference(dtype):
    """Prefill 12 tokens, then 8 absorbed-latent decode steps fed the
    reference's greedy tokens; the cache the reference keeps, slot for slot."""
    rlm, rp, tlm, tp = _pair(dtype, remat="none", all_experts=dtype == "bfloat16")
    b, s, steps = 2, 12, 8
    toks = _tokens(tlm.cfg.vocab_size, b=b, s=s, seed=4)
    rc, tc = RD.init_cache(rlm, b, s + steps), D.init_cache(tlm, b, s + steps)
    assert set(tc["layers"]["blk"]) == {"c_kv", "k_rope", "slot_pos"}
    assert tc["head"]["blk"]["c_kv"].shape == (1, b, s + steps, 16)
    assert tc["head"]["blk"]["k_rope"].shape == (1, b, s + steps, 8)
    rl, rc = RD.prefill(rlm, rp, rc, jnp.asarray(toks))
    tl, tc = D.prefill(tlm, tp, tc, torch.from_numpy(toks).long())
    exact = dtype == "float32"
    atol = TOL[dtype] if exact else BF16_LOGITS
    np.testing.assert_allclose(_np(tl), _np(rl), atol=atol, rtol=0)
    cur = np.asarray(jnp.argmax(rl, -1))[:, None]
    assert not exact or np.array_equal(tl.argmax(-1)[:, None].numpy(), cur)
    for _ in range(steps):
        rl, rc = RD.decode_step(rlm, rp, rc, jnp.asarray(cur, jnp.int32))
        tl, tc = D.decode_step(tlm, tp, tc, torch.from_numpy(cur.copy()).long())
        np.testing.assert_allclose(_np(tl), _np(rl), atol=atol, rtol=0)
        nxt = np.asarray(jnp.argmax(rl[:, -1], -1))[:, None]
        top2 = np.sort(_np(rl[:, -1]), -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * atol  # no rounding within atol reorders these
        got = tl[:, -1].argmax(-1)[:, None].numpy()
        assert np.array_equal(got[sure], nxt[sure])
        cur = nxt
    for stage in ("head", "layers"):
        for name in ("c_kv", "k_rope"):
            np.testing.assert_allclose(_np(tc[stage]["blk"][name]), _np(rc[stage]["blk"][name]),
                                       atol=TOL[dtype] if exact else BF16_LOGITS, rtol=0)
        np.testing.assert_array_equal(tc[stage]["blk"]["slot_pos"].numpy(),
                                      np.asarray(rc[stage]["blk"]["slot_pos"]))


def test_decode_ropes_mla_at_its_rope_width(monkeypatch):
    """MLA ropes ``qk_rope_head_dim`` of each head: a decode step's rope
    tables must have that width, not the config's head dim (16 reduced,
    128 at full width, against 8 and 64)."""
    _, tcfg = _cfgs()
    assert tcfg.mla.qk_rope_head_dim != tcfg.resolved_head_dim
    lm = build_model(tcfg, compute_dtype=torch.float32)
    params = lm.init(torch.Generator().manual_seed(0))
    cache = D.init_cache(lm, 2, 8)
    widths = []
    rotary = D.rotary_embedding

    def recording(positions, width, theta):
        widths.append(width)
        return rotary(positions, width, theta)

    monkeypatch.setattr(D, "rotary_embedding", recording)
    D.decode_step(lm, params, cache, torch.zeros((2, 1), dtype=torch.long))
    assert widths and set(widths) == {tcfg.mla.qk_rope_head_dim}


# (loss and aux, grad norm relative): as tests/test_torch_moe.py (STEP_TOL):
# float32 the same arithmetic; bf16 within the 2e-2 of
# tests/test_reconfig_e2e.py, the gradient norm within 5%.
STEP_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 5e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_train_steps_match_reference_jit(dtype):
    """The gradient through ``_mla_attn`` (the plain attention, with q and k
    of 24 and v of 16) and the MoE, three AdamW steps."""
    tol, norm_rtol = STEP_TOL[dtype]
    rlm, rp, tlm, tp = _pair(dtype)
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
        tt = tflat(tstate.params)
        for name, a in flatten_with_paths(rstate.params).items():
            np.testing.assert_allclose(tt[name].numpy(), np.asarray(a), atol=3.6e-4,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _plans(mesh_d, **kw):
    rcfg, tcfg = _cfgs()
    rmesh, tmesh = R.MeshSpec.from_dict(mesh_d), T.MeshSpec.from_dict(mesh_d)
    rpar, tpar = RC.ParallelismConfig(**kw), TC.ParallelismConfig(**kw)
    rlm = ref_build(rcfg, vocab_multiple=RS.vocab_multiple(rpar, rmesh))
    tlm = build_model(tcfg, vocab_multiple=TS.vocab_multiple(tpar, tmesh))
    return (RS.make_plan(rcfg, rlm.registry, rpar, rmesh),
            TS.make_plan(tcfg, tlm.registry, tpar, tmesh))


def test_plan_splits_heads_and_experts_over_model():
    rplan, tplan = _plans(MESH)
    assert tplan.moe_mode == rplan.moe_mode == "ep"
    assert {n: s.to_json() for n, s in tplan.param_specs.items()} == \
        {n: s.to_json() for n, s in rplan.param_specs.items()}
    fp32 = T.StateKind.FP32
    for stage in ("head", "layers"):
        for name, axis in (("wq_b", 2), ("wkv_b", 2), ("wo", 1)):
            dims = tplan.param_specs[f"{stage}.blk.{name}"].states[fp32].dims
            assert dims[axis].axes == ("model",), (name, dims)
        for name in ("wq_a", "wkv_a", "q_norm", "kv_norm"):
            dims = tplan.param_specs[f"{stage}.blk.{name}"].states[fp32].dims
            assert all("model" not in d.axes for d in dims), name
    dims = tplan.param_specs["layers.blk.we_gate"].states[fp32].dims
    assert dims[1].axes == ("model",)  # the expert dim


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


def test_save_under_ep_is_the_reference_bytes(tmp_path):
    rplan, tplan = _plans(MESH)
    snap = _snapshot()
    tsnap = {n: {T.StateKind(k.value): a for k, a in kinds.items()} for n, kinds in snap.items()}
    rcfg, tcfg = _cfgs()
    port_write(tsnap, tplan, 4, tmp_path / "port", config_fingerprint=tcfg.fingerprint())
    ref_write(snap, rplan, 4, tmp_path / "ref", workers=1, config_fingerprint=rcfg.fingerprint())
    _same_checkpoints(tmp_path / "port", tmp_path / "ref")
    assert R.DistCheckpoint.open(tmp_path / "port").validate() == []


def test_reference_written_checkpoint_restores_in_port(tmp_path):
    """The reference writes under data=2,model=2 EP; the port restores it
    under data=1,model=1 (RESHARD_STREAM) and the same layout (DIRECT),
    every kind bit-equal."""
    snap = _snapshot(seed=2)
    rplan, tplan = _plans(MESH)
    rcfg, tcfg = _cfgs()
    ref_write(snap, rplan, 3, tmp_path / "ck" / "step_00000003", workers=1,
              config_fingerprint=rcfg.fingerprint())
    _, single = _plans({"data": 1, "model": 1})
    kinds = (R.StateKind.FP32, R.StateKind.EXP_AVG, R.StateKind.EXP_AVG_SQ)
    for plan, mode in ((single, ResumeMode.RESHARD_STREAM), (tplan, ResumeMode.DIRECT)):
        state, info = CheckpointManager(tmp_path / "ck", plan).restore("cpu")
        assert info.mode is mode, info.reason
        for kind, tree in zip(kinds, (state.params, state.exp_avg, state.exp_avg_sq)):
            for name, t in tflat(tree).items():
                want = snap[name][kind]
                got = t[tuple(slice(0, n) for n in want.shape)].numpy()
                assert got.tobytes() == want.tobytes(), (name, kind)


def test_serve_cli_serves_a_resharded_mla_checkpoint(tmp_path, capsys):
    """The port's trainer takes one step of reduced deepseek-v2 under
    data=2,model=2 EP and saves it; the serve CLI restores the weights
    under data=1,model=1 (RESHARD_STREAM) and data=2,model=2 (DIRECT) and
    serves the same tokens."""
    from repro_torch.launch import serve

    tr = Trainer.create(
        TC.reduced(TC.get_config(ARCH)), TC.ParallelismConfig(), TC.TrainConfig(),
        T.MeshSpec.from_dict(MESH), batch_size=2, seq_len=16, ckpt_dir=str(tmp_path / "ck"),
        policy=CheckpointPolicy(save_interval=1, async_save=False), device="cpu",
    )
    assert tr.plan.moe_mode == "ep"
    _, hist = tr.run(tr.init_state(), 0, 1)
    tr.manager.close()
    assert np.isfinite(hist[0]["loss"]) and hist[0]["aux"] > 0
    outs = {}
    for mesh in ("data=1,model=1", "data=2,model=2"):
        assert serve.main(["--arch", ARCH, "--reduced", "--ckpt-dir", str(tmp_path / "ck"),
                           "--mesh", mesh, "--device", "cpu", "--batch", "2",
                           "--prompt-len", "12", "--gen", "6"]) == 0
        outs[mesh] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert outs["data=1,model=1"]["mode"] == "reshard_stream"
    assert outs["data=2,model=2"]["mode"] == "direct"
    assert outs["data=1,model=1"]["tokens"] == outs["data=2,model=2"]["tokens"]
