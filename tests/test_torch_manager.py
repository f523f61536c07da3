"""The port's checkpoint manager and trainer, on their own (reduced smollm,
CPU):

* sync saves, keep-last GC and ``restore_latest``;
* the paper's loop with coded moments (async saves): train 3 steps under
  data=2,model=2, resume under data=2,model=2 (DIRECT) and data=1,model=1
  (RESHARD_STREAM) with params bit-equal to the save and moments equal to
  the codec's served view (every manifest digest validates), then
  continue: with ``int8ef`` and ``fp8:e4m3`` moments the losses stay within
  2e-2 of the uninterrupted run (the tolerance of
  ``tests/test_reconfig_e2e.py``); with ``int8:b256`` they leave it, and
  the restored state and each continued step are held in fp32 against the
  JAX package continuing from the same coded checkpoint (see that test);
* policy knobs and CLI flags whose machinery is not ported raise (the
  hot tier's and ``--trace`` now run); delta
  saves through a 4-wide engine (``save_mode="delta"``, ``io_workers=4``)
  work, from the policy and from the CLI;
* ``python -m repro_torch.launch.train --device cpu`` trains, then resumes
  under another mesh (with full and with delta saves).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as TC  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.ckpt.policy import CheckpointPolicy  # noqa: E402
from repro_torch.ckpt.saver import AsyncSaver  # noqa: E402
from repro_torch.core.dist_ckpt import DistCheckpoint  # noqa: E402
from repro_torch.core.layout import MeshSpec  # noqa: E402
from repro_torch.core.patterns import StateKind  # noqa: E402
from repro_torch.core.plan import ResumeMode  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = TC.reduced(TC.get_config("smollm-360m"))
TCFG = TC.TrainConfig(warmup_steps=2, total_steps=20)


def _trainer(mesh, ckpt_dir=None, policy=None, parallel=None):
    return Trainer.create(
        CFG, parallel or TC.ParallelismConfig(), TCFG, MeshSpec.from_dict(mesh),
        batch_size=4, seq_len=32, ckpt_dir=ckpt_dir, policy=policy, device="cpu",
    )


@pytest.fixture(scope="module")
def baseline():
    tr = _trainer({"data": 2, "model": 2})
    _, hist = tr.run(tr.init_state(), 0, 6)
    return [h["loss"] for h in hist]


def test_sync_save_gc_keep_last_and_restore_latest(tmp_path):
    policy = CheckpointPolicy(keep_last=2, save_interval=1, async_save=False)
    tr = _trainer({"data": 2, "model": 2}, tmp_path / "ck", policy)
    state, _ = tr.run(tr.init_state(), 0, 4)
    assert tr.manager.steps() == [3, 4]
    (tmp_path / "ck" / "step_00000001").mkdir()  # wreckage: no COMMIT
    tr.manager.gc()
    assert not (tmp_path / "ck" / "step_00000001").exists()
    restored, info = tr.manager.restore_latest("cpu")
    assert (info.step, info.mode, restored.step) == (4, ResumeMode.DIRECT, 4)
    for tree_a, tree_b in ((state.params, restored.params), (state.exp_avg, restored.exp_avg),
                           (state.exp_avg_sq, restored.exp_avg_sq)):
        b = flatten_with_paths(tree_b)
        for name, t in flatten_with_paths(tree_a).items():
            assert torch.equal(t, b[name]), name


def test_save_mode_all_writes_every_replica(tmp_path):
    dedup = _trainer({"data": 2, "model": 2}, tmp_path / "d",
                     CheckpointPolicy(save_interval=1, async_save=False))
    every = _trainer({"data": 2, "model": 2}, tmp_path / "a",
                     CheckpointPolicy(save_interval=1, async_save=False, save_mode="all"))
    state, _ = dedup.run(dedup.init_state(), 0, 1)
    every.run(every.init_state(), 0, 1)
    d = DistCheckpoint.open(tmp_path / "d" / "step_00000001").manifest
    a = DistCheckpoint.open(tmp_path / "a" / "step_00000001").manifest
    assert (d.save_mode, a.save_mode) == ("dedup", "all")
    assert len(a.shard_digests) > len(d.shard_digests)
    restored, info = every.manager.restore_latest("cpu")
    assert info.mode is ResumeMode.DIRECT
    for name, t in flatten_with_paths(state.params).items():
        assert torch.equal(flatten_with_paths(restored.params)[name], t), name


@pytest.mark.parametrize("codec", [None, "int8:b256"])
def test_bf16_moments_save_and_restore(tmp_path, codec):
    """``moment_dtype="bfloat16"``: raw moments come back bit-equal, coded
    ones as the served view (every digest validates)."""
    tr = Trainer.create(
        CFG, TC.ParallelismConfig(moment_dtype="bfloat16"), TCFG,
        MeshSpec.from_dict({"data": 2, "model": 2}), batch_size=4, seq_len=32,
        ckpt_dir=tmp_path / "ck", device="cpu",
        policy=CheckpointPolicy(save_interval=1, async_save=False, codec=codec),
    )
    state, _ = tr.run(tr.init_state(), 0, 1)
    ck = DistCheckpoint.open(tmp_path / "ck" / "step_00000001")
    assert ck.manifest.params["embed"].states[StateKind.EXP_AVG_SQ].dtype == "bfloat16"
    assert ck.validate() == []
    restored, _ = tr.manager.restore_latest("cpu")
    got = flatten_with_paths(restored.exp_avg_sq)
    assert got["embed"].dtype == torch.bfloat16
    if codec is None:
        for name, t in flatten_with_paths(state.exp_avg_sq).items():
            assert torch.equal(got[name], t), name


MODES = [({"data": 2, "model": 2}, "direct"), ({"data": 1, "model": 1}, "reshard_stream")]


def _coded_resume(tmp_path, codec, mesh, parallel=None):
    """Train 3 steps under data=2,model=2 saving with ``codec`` (async),
    resume under ``mesh``, check the restored state, train 3 more steps;
    returns (the resume mode, the restored state, the resumed losses)."""
    policy = CheckpointPolicy(codec=codec, save_interval=3, async_save=True)
    src = _trainer({"data": 2, "model": 2}, tmp_path / "ck", policy, parallel)
    saved, _ = src.run(src.init_state(), 0, 3)
    src.manager.close()
    ck = DistCheckpoint.open(tmp_path / "ck" / "step_00000003")
    assert ck.manifest.shard_codecs and ck.validate() == []

    tgt = _trainer(mesh, tmp_path / "ck", CheckpointPolicy(async_save=False, save_interval=100),
                   parallel)
    state, info = tgt.init_or_restore()
    sp = flatten_with_paths(saved.params)
    for name, t in flatten_with_paths(state.params).items():
        logical = t[tuple(slice(0, s) for s in sp[name].shape)]
        assert torch.equal(logical, sp[name]), name
    # the moments are the served view: re-cut under the source layout, every
    # shard hashes to the manifest's served digest
    check = CheckpointManager(tmp_path / "re", src.plan, policy=CheckpointPolicy(async_save=False))
    check.save(saved.__class__(saved.params, state.exp_avg, state.exp_avg_sq, 3), 3)
    resaved = DistCheckpoint.open(tmp_path / "re" / "step_00000003")
    assert resaved.manifest.shard_digests == ck.manifest.shard_digests
    _, hist = tgt.run(state, 3, 3)
    resumed = [h["loss"] for h in hist]
    assert (info.step, state.step) == (3, 3) and all(np.isfinite(resumed))
    return info.mode.value, state, resumed


@pytest.mark.parametrize("codec", ["int8ef:b256", "fp8:e4m3:b256"])
@pytest.mark.parametrize("mesh,mode", MODES)
def test_coded_resume_continues_the_loss_curve(tmp_path, baseline, codec, mesh, mode):
    got_mode, _, resumed = _coded_resume(tmp_path, codec, mesh)
    assert got_mode == mode
    np.testing.assert_allclose(resumed, baseline[3:], atol=2e-2)


@pytest.mark.parametrize("mesh,mode", MODES)
def test_int8_coded_resume_is_finite_and_mode_independent(tmp_path, mesh, mode):
    """The reference's default lossy policy, ``int8:b256`` on both moments,
    zeroes every second-moment entry below half its block's step (``v``
    spans the square of the gradient's range), so the continued curve
    leaves the uninterrupted one (fp8 keeps the small entries, above).
    Such an entry's next update is about ``m/(|g|/2 + eps)`` with ``|g|``
    near ``eps``: gradient rounding noise moves it, and the curve with it
    (the JAX package's own jitted and eager gradients already give two
    curves well beyond 1e-5 apart from this checkpoint).  So the port is
    held, in fp32, against the JAX package step by step from the same
    coded checkpoint:

    * the restored state, in both resume modes, equals the reference's own
      decode (its ``DistCheckpoint`` and ``assemble_atom``) bit for bit;
    * from the reference's state at each of steps 4-6, the port's train
      step gives the reference's loss within 1e-5 and grad norm within
      1e-5 relative, and the port's ``adamw_update`` on the reference's
      gradients gives its params, moments and step (atol 1e-6 on params:
      the entries the zeroed ``v`` sends flying move by up to ~5, where one
      fp32 ulp is 4.8e-7; 1e-9 on moments: XLA fuses ``b·m + (1-b)·g`` into
      one multiply-add);
    * the port's own resumed curve is finite and starts at the reference's
      loss (params are raw)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.configs as RC
    from repro.core.convert import assemble_atom
    from repro.core.dist_ckpt import DistCheckpoint as RefCheckpoint
    from repro.core.patterns import StateKind as RK
    from repro.core.pytree import flatten_with_paths as rflat
    from repro.core.pytree import unflatten_from_paths as runflat
    from repro.models import build_model as ref_build
    from repro.train import data as rdata
    from repro.train.optimizer import TrainState as RefState
    from repro.train.optimizer import adamw_update as ref_adamw

    from repro_torch.core.pytree import unflatten_from_paths
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import TrainState, adamw_update
    from repro_torch.train.steps import make_train_step

    fp32 = TC.ParallelismConfig(compute_dtype="float32")
    got_mode, state, resumed = _coded_resume(tmp_path, "int8:b256", mesh, fp32)
    assert got_mode == mode

    rck = RefCheckpoint.open(tmp_path / "ck" / "step_00000003")
    decoded = {
        kind: {n: assemble_atom(rck, spec, kind) for n, spec in rck.manifest.params.items()}
        for kind in (RK.FP32, RK.EXP_AVG, RK.EXP_AVG_SQ)
    }
    for kind, tree in ((RK.FP32, state.params), (RK.EXP_AVG, state.exp_avg),
                       (RK.EXP_AVG_SQ, state.exp_avg_sq)):
        for name, t in flatten_with_paths(tree).items():
            want = decoded[kind][name]
            logical = t[tuple(slice(0, s) for s in want.shape)]
            assert logical.numpy().tobytes() == want.tobytes(), (kind, name)
    v = flatten_with_paths(state.exp_avg_sq)["layers.blk.w_up"]
    m = flatten_with_paths(state.exp_avg)["layers.blk.w_up"]
    assert bool(((v == 0) & (m != 0)).any())

    rcfg = RC.reduced(RC.get_config("smollm-360m"))
    rlm = ref_build(rcfg, compute_dtype=jnp.float32)
    rtcfg = RC.TrainConfig(warmup_steps=TCFG.warmup_steps, total_steps=TCFG.total_steps)
    grad_fn = jax.jit(jax.value_and_grad(rlm.loss_fn, has_aux=True))
    ref_update = jax.jit(ref_adamw, static_argnums=2)
    tstep = make_train_step(build_model(CFG, compute_dtype=torch.float32), TCFG, fp32)
    rstate = RefState(*(runflat({n: jnp.asarray(a) for n, a in decoded[k].items()})
                        for k in (RK.FP32, RK.EXP_AVG, RK.EXP_AVG_SQ)),
                      jnp.asarray(3, jnp.int32))

    def to_port(tree):
        return unflatten_from_paths({n: torch.from_numpy(np.array(a)) for n, a in rflat(tree).items()})

    shape = RC.ShapeSpec("train", 32, 4, "train")
    ref_losses = []
    for step in range(3, 6):
        toks = rdata.batch_for_step(rcfg, shape, step, seed=TCFG.seed,
                                    batch_override=4, seq_override=32)["tokens"]
        (rloss, _), rgrads = grad_fn(rstate.params, {"tokens": jnp.asarray(toks)})
        rnew, rmet = ref_update(rstate, rgrads, rtcfg)
        tstate = TrainState(to_port(rstate.params), to_port(rstate.exp_avg),
                            to_port(rstate.exp_avg_sq), step)
        _, tmet = tstep(tstate, {"tokens": torch.from_numpy(toks).long()})
        assert abs(float(tmet["loss"]) - float(rloss)) <= 1e-5, step
        np.testing.assert_allclose(float(tmet["grad_norm"]), float(rmet["grad_norm"]), rtol=1e-5)
        tnew, _ = adamw_update(tstate, to_port(rgrads), TCFG)
        assert tnew.step == int(rnew.step) == step + 1
        for what, atol in (("params", 1e-6), ("exp_avg", 1e-9), ("exp_avg_sq", 1e-9)):
            tt = flatten_with_paths(getattr(tnew, what))
            for name, a in rflat(getattr(rnew, what)).items():
                np.testing.assert_allclose(tt[name].numpy(), np.asarray(a), rtol=1e-6, atol=atol,
                                           err_msg=f"step {step + 1} {what} {name}")
        ref_losses.append(float(rloss))
        rstate = rnew
    assert all(np.isfinite(resumed)) and abs(resumed[0] - ref_losses[0]) <= 1e-5


@pytest.mark.parametrize("kw", [
    {"hot_interval": 2}, {"registry": object()},
], ids=lambda kw: next(iter(kw)))
def test_unported_policy_knobs_raise(kw):
    """Both knobs are ported now: the hot tier (item 7) and the fan-out
    registry (item 8) build a policy, and a manager with a registry
    publishes its commits (``tests/test_torch_fanout.py`` checks what it
    publishes)."""
    policy = CheckpointPolicy(**kw)
    if "hot_interval" in kw:
        assert (policy.hot_interval, policy.effective_disk_interval) == (2, 50)
        return
    assert policy.registry is kw["registry"]


@pytest.mark.parametrize("kw,err", [
    ({"keep_last": 0}, ValueError), ({"save_mode": "x"}, ValueError),
    ({"codec": 3}, TypeError), ({"codec": "int8:b0"}, ValueError),
])
def test_policy_validation_matches_reference(kw, err):
    with pytest.raises(err):
        CheckpointPolicy(**kw)
    assert CheckpointPolicy(codec="raw").codec is None
    assert CheckpointPolicy(codec="int8:b256").codec.exp_avg == "int8:b256"


@pytest.mark.parametrize("flags", [
    ["--host-devices", "4"], ["--pipe-axis", "pipe"], ["--hot-interval", "2"],
    ["--trace", "t.json"],
], ids=lambda f: f[0])
def test_unported_cli_flags_raise(flags, tmp_path):
    """``--host-devices`` and ``--pipe-axis`` (item 11) still raise;
    ``--hot-interval`` (item 7) and ``--trace`` (item 9a) are ported and run
    (``tests/test_torch_elastic.py`` checks what they produce)."""
    argv = ["--arch", "smollm-360m", "--reduced", "--device", "cpu"]
    if flags[0] in ("--hot-interval", "--trace"):
        flags = [flags[0], str(tmp_path / flags[1]) if flags[0] == "--trace" else flags[1]]
        assert train_cli.main([*argv, "--steps", "1", "--batch", "2", "--seq", "16",
                               "--ckpt-dir", str(tmp_path / "ck"), *flags]) == 0
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_cli.main([*argv, *flags])


def test_force_direct_on_a_changed_layout_raises(tmp_path):
    src = _trainer({"data": 2, "model": 2}, tmp_path / "ck",
                   CheckpointPolicy(save_interval=1, async_save=False))
    src.run(src.init_state(), 0, 1)
    tgt = _trainer({"data": 1, "model": 1}, tmp_path / "ck")
    with pytest.raises(ValueError, match="cannot force DIRECT"):
        tgt.manager.restore("cpu", force_mode=ResumeMode.DIRECT)


def test_async_saver_surfaces_a_failed_save(tmp_path):
    saver = AsyncSaver()
    tr = _trainer({"data": 2, "model": 2})
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver.submit(tr.init_state(), tr.plan, 1, blocker / "step_00000001")
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        saver.wait()
    saver.close()
    with pytest.raises(RuntimeError, match="after close"):
        saver.submit(tr.init_state(), tr.plan, 2, tmp_path / "x")


def _cli(*args):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-360m",
         "--reduced", "--device", "cpu", "--batch", "4", "--seq", "32", "--log-json",
         "--codec", "int8:b256", *args],
        cwd=REPO, capture_output=True, text=True, timeout=600, check=False,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")),
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


def test_train_cli_runs_then_resumes_under_another_mesh(tmp_path):
    ck = str(tmp_path / "ck")
    first = _cli("--mesh", "data=2,model=2", "--steps", "4", "--ckpt-dir", ck,
                 "--save-interval", "2")
    assert [r["step"] for r in first] == [1, 2, 3, 4]
    second = _cli("--mesh", "data=1,model=1", "--steps", "6", "--ckpt-dir", ck,
                  "--save-interval", "100")
    assert second[0]["event"] == "restored"
    assert (second[0]["mode"], second[0]["step"]) == ("reshard_stream", 4)
    assert [r["step"] for r in second[1:]] == [5, 6]
    assert all(np.isfinite(r["loss"]) for r in second[1:])


def test_train_cli_requires_the_card_it_asks_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        train_cli.main(["--arch", "smollm-360m", "--reduced", "--steps", "1"])


def test_delta_policy_saves_deltas_through_a_wide_engine(tmp_path):
    """``CheckpointPolicy(save_mode="delta", io_workers=4)``: the manager
    writes through a private 4-wide engine; the first save is full, the
    next ones are deltas against the previous commit (AdamW changes every
    shard, so a re-save of the same state is what inherits), and the tip
    restores DIRECT and RESHARD_STREAM bit-equal to the state saved."""
    policy = CheckpointPolicy(save_mode="delta", io_workers=4, save_interval=1,
                              async_save=False, full_interval=100, keep_last=10,
                              codec="int8:b256")
    tr = _trainer({"data": 2, "model": 2}, tmp_path / "ck", policy)
    assert tr.manager.engine.workers == 4 and tr.manager.engine_for("cpu") is tr.manager.engine
    state, _ = tr.run(tr.init_state(), 0, 2)
    tr.manager.save(state, 3)
    m = [DistCheckpoint.open(tr.manager.step_dir(s)).manifest for s in (1, 2, 3)]
    assert [x.save_mode for x in m] == ["dedup", "delta", "delta"]
    assert (m[0].base_step, m[1].base_step, m[2].base_step) == (None, 1, 2)
    assert m[1].shard_sources == {}  # every shard changed in a train step
    assert set(m[2].shard_sources) == set(m[2].shard_digests)  # nothing changed
    assert set(m[2].shard_sources.values()) == {2}
    assert m[2].shard_codecs == m[1].shard_codecs != {}
    assert not list(tr.manager.step_dir(3).rglob("*.npy"))
    assert DistCheckpoint.open(tr.manager.step_dir(3)).validate() == []
    direct, info = tr.manager.restore("cpu")
    assert (info.step, info.mode) == (3, ResumeMode.DIRECT)
    tgt = _trainer({"data": 1, "model": 1}, tmp_path / "ck",
                   CheckpointPolicy(async_save=False, io_workers=4))
    stream, info2 = tgt.manager.restore("cpu")
    assert (info2.step, info2.mode) == (3, ResumeMode.RESHARD_STREAM)
    want = flatten_with_paths(state.params)
    for restored in (direct, stream):
        for name, t in flatten_with_paths(restored.params).items():
            logical = t[tuple(slice(0, s) for s in want[name].shape)]
            assert torch.equal(logical, want[name]), name
    for kind in ("exp_avg", "exp_avg_sq"):  # the served view, the same both ways
        a, b = flatten_with_paths(getattr(direct, kind)), flatten_with_paths(getattr(stream, kind))
        for name, t in a.items():
            assert torch.equal(b[name][tuple(slice(0, s) for s in t.shape)],
                               t[tuple(slice(0, s) for s in b[name].shape)]), (kind, name)
    tr.manager.close()
    tgt.manager.close()


def test_train_cli_delta_saves_then_resumes_under_another_mesh(tmp_path):
    ck = str(tmp_path / "ck")
    first = _cli("--mesh", "data=2,model=2", "--steps", "4", "--ckpt-dir", ck,
                 "--save-interval", "1", "--save-mode", "delta", "--full-interval", "2")
    assert [r["step"] for r in first] == [1, 2, 3, 4]
    modes = {s: DistCheckpoint.open(tmp_path / "ck" / f"step_{s:08d}").manifest
             for s in (1, 2, 3, 4)}
    # every 2nd save is a rebase: full, delta, full, delta
    assert [modes[s].save_mode for s in (1, 2, 3, 4)] == ["dedup", "delta", "dedup", "delta"]
    assert (modes[2].base_step, modes[4].base_step) == (1, 3)
    second = _cli("--mesh", "data=1,model=1", "--steps", "6", "--ckpt-dir", ck,
                  "--save-interval", "100")
    assert second[0]["event"] == "restored"
    assert (second[0]["mode"], second[0]["step"]) == ("reshard_stream", 4)
    assert [r["step"] for r in second[1:]] == [5, 6]
    assert all(np.isfinite(r["loss"]) for r in second[1:])
