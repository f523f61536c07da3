"""The multi-rank training runtime of the port, on the CPU, held against the
single-device port and the JAX package.

Ranks are processes of a gloo group (``run_world``: spawned, a ``file://``
store in ``tmp_path``, joined with a timeout and killed after it), on
reduced smollm-360m in fp32.  Two worlds run once per module:

* 4 ranks: data=2,model=2 (ZeRO-3/FSDP and TP storage) and pipe=2,data=2;
  the first also saves its step-3 state raw and ``int8:b256`` through the
  rank-aware manager, restores the raw one DIRECT with the shard files
  opened recorded, and trains 3 steps with an async save every step; then
  reduced mixtral-8x22b under data=2,model=2 with EP and with expert-TP
  (``--no-ep``, the reference's Fig. 10 target) storage;
* 2 ranks: data=2,model=1, ZeRO-1 (weights replicated over the data axis,
  moments sharded), the 4-rank checkpoints resumed under data=1,model=2
  (RESHARD_STREAM) and 2 more steps computed partitioned over the model
  axis (the int8 one also on the gathered path), and reduced mixtral-8x22b
  under data=2,model=1.

Each world's results are held here against:

* ``state_pspecs`` of the reference's plan, entry for entry, for reduced
  smollm, mixtral (EP and expert-TP), mamba2, ZeRO 1 and 3, FSDP off and a
  pipe axis;
* at init, each rank's shards bit-equal to ``slice_shard`` of the
  single-device state (the same seed);
* 3 steps from the reference's weights: losses and gradient norms within
  1e-5 relative of the single-device port and of the reference's jitted
  no-mesh step; every replica of every fragment bit-identical across ranks
  (ZeRO-1's weights included);
* the 4-rank raw and ``int8:b256`` saves byte for byte the reference's
  ``write_distributed`` of the gathered snapshot (files, digests, manifest
  but ``created_at``), validated by the reference;
* resumes: 4 ranks → 2 ranks under another layout, and 2 ranks → 1
  process, each rank's state bit-equal to ``slice_shard`` of a one-process
  restore; DIRECT opens only the files of the rank's own fragments (the
  primary rank's for a replica) and ``restore.bytes_read`` is the rank's
  shard bytes;
* a shard lost after planning: every rank falls back to VIA_UCP together
  and raises rank 0's conversion failure;
* MoE under a data size of 2: losses, aux and gradient norms over 3 fp32
  steps within 1e-5 relative of the single-device port and of the
  reference's jitted no-mesh step (a MoE layer routes one token group a
  sequence, so capacity and the aux loss split with the batch rows);
* refusals: a group of another size than the mesh, a ``moe_groups`` that
  does not split over the data size, and ``--host-devices`` other than the
  mesh size.  The hot tier, delta saves and fan-out under a group are
  ``tests/test_torch_multirank_hot.py``'s.

The reference is imported lazily, so the spawned ranks (which import this
module to find their entry point) load no JAX.
"""

import math
import shutil
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.ckpt.policy import CheckpointPolicy  # noqa: E402
from repro_torch.core.dist_ckpt import DistCheckpoint  # noqa: E402
from repro_torch.core.layout import MeshSpec, slice_shard  # noqa: E402
from repro_torch.core.patterns import StateKind  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths  # noqa: E402
from repro_torch.dist.sharding import make_plan, rank_rows  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train.optimizer import TrainState, init_state  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, gather_state, shard_state  # noqa: E402

ARCH = "smollm-360m"
MOE = "mixtral-8x22b"
B, S, STEPS = 4, 32, 3
JOIN_TIMEOUT_S = 240
REL = 1e-5
FIELDS = (("params", StateKind.FP32), ("exp_avg", StateKind.EXP_AVG),
          ("exp_avg_sq", StateKind.EXP_AVG_SQ))


def _ref():
    pytest.importorskip("jax")
    import repro
    import repro.configs
    import repro.core
    import repro.core.pytree
    import repro.dist.sharding

    return repro


def parallel_for(mesh: MeshSpec, **kw) -> TC.ParallelismConfig:
    """The launcher's parallelism for a mesh, in fp32."""
    names = mesh.axis_names
    kw.setdefault("pipe_axis", "pipe" if "pipe" in names else None)
    return TC.ParallelismConfig(
        data_axes=tuple(a for a in ("pod", "data") if a in names) or ("data",),
        model_axis="model", compute_dtype="float32", **kw)


def _trainer(mesh_d, group=None, *, arch=ARCH, ckpt_dir=None, policy=None,
             grad_transform=None, device="cpu", moe_groups=None, **par) -> Trainer:
    mesh = MeshSpec.from_dict(mesh_d)
    cfg = TC.reduced(TC.get_config(arch))
    return Trainer.create(cfg, parallel_for(mesh, **par), TC.TrainConfig(), mesh,
                          batch_size=B, seq_len=S, device=device, group=group,
                          ckpt_dir=ckpt_dir, policy=policy, grad_transform=grad_transform,
                          moe_groups=moe_groups)


def halve_port(grads: dict) -> dict:
    """The gradient transform of the hook's tests: every leaf times 0.5 but
    the norms' (a transform that changes the clip and the update)."""
    return {k: halve_port(v) if isinstance(v, dict) else (v if v.dim() == 1 else v * 0.5)
            for k, v in grads.items()}


def _flat_state(state: TrainState) -> dict:
    return {f: {n: t.clone() for n, t in flatten_with_paths(getattr(state, f)).items()}
            for f, _ in FIELDS}


# ---------------------------------------------------------------------------
# the ranks


def _train(rank, out, weights, mesh_d, **par):
    """Init, then 3 steps from the reference's weights."""
    t = _trainer(mesh_d, dist.group.WORLD, **par)
    return _steps(t, rank, weights)


def _steps(t, rank, weights):
    init = _flat_state(t.init_state())
    state = shard_state(init_state(params_from_reference(weights, t.lm, "cpu")), t.plan, rank)
    hist = []
    for step in range(STEPS):
        state, m = t.step_fn(state, t.batch(step))
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return t, state, {"init": init, "final": _flat_state(state), "hist": hist}


def _direct_restore(rank, root, plan):
    """A DIRECT restore of ``root`` by this rank, with the shard files it
    opened."""
    opened = []
    real = DistCheckpoint.read_shard

    def spy(self, r, name, kind, **kw):
        opened.append((r, name, kind.value))
        return real(self, r, name, kind, **kw)

    DistCheckpoint.read_shard = spy
    try:
        mgr = CheckpointManager(root, plan, group=dist.group.WORLD)
        state, info = mgr.restore("cpu")
    finally:
        DistCheckpoint.read_shard = real
    return {"mode": info.mode.value, "bytes_read": info.restore_stats.bytes_read,
            "opened": sorted(set(opened)), "state": _flat_state(state)}


def world4(rank, out, weights):
    res = {}
    t, state, res["dense22"] = _train(rank, out, weights, {"data": 2, "model": 2})
    for label, policy in (("raw", CheckpointPolicy()),
                          ("int8", CheckpointPolicy(codec="int8:b256"))):
        mgr = CheckpointManager(out / f"{label}22", t.plan, policy=policy,
                                group=dist.group.WORLD,
                                config_fingerprint={"model": t.cfg.fingerprint(),
                                                    "parallel": t.parallel.fingerprint()})
        mgr.save(state, STEPS)
        (r,) = mgr.wait()
        mgr.close()
        res[f"save_{label}"] = {"bytes": r.bytes_written, "shards": r.shards_written}
        res[f"direct_{label}"] = _direct_restore(rank, out / f"{label}22", t.plan)
    # an async save every step, drained at the end of the run
    t2 = _trainer({"data": 2, "model": 2}, dist.group.WORLD, ckpt_dir=out / "async22",
                  policy=CheckpointPolicy(save_interval=1, keep_last=2, async_save=True))
    t2.run(t2.init_state(), 0, STEPS)
    res["async"] = {"results": len(t2.save_results), "steps": t2.manager.steps()}
    t2.manager.close()
    _, _, res["pipe"] = _train(rank, out, weights, {"pipe": 2, "data": 2})
    res["moe22_ep"] = _moe_train(rank, out, {"data": 2, "model": 2})
    res["moe22_tp"] = _moe_train(rank, out, {"data": 2, "model": 2}, expert_parallel=False)
    return res


def _moe_train(rank, out, mesh_d, **par):
    """3 fp32 steps of reduced mixtral from the reference's weights: (loss,
    aux, grad norm) a step."""
    weights = dict(np.load(out / "weights_moe.npz"))
    t = _trainer(mesh_d, dist.group.WORLD, arch=MOE, remat="none", **par)
    state = shard_state(init_state(params_from_reference(weights, t.lm, "cpu")), t.plan, rank)
    hist = []
    for step in range(STEPS):
        state, m = t.step_fn(state, t.batch(step))
        hist.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
    return {"hist": hist, "moe_mode": t.plan.moe_mode}


def world2(rank, out, weights):
    res = {}
    t, state, res["dense21"] = _train(rank, out, weights, {"data": 2, "model": 1})
    mgr = CheckpointManager(out / "raw21", t.plan, policy=CheckpointPolicy(async_save=False),
                            group=dist.group.WORLD)
    mgr.save(state, STEPS, block=True)
    mgr.close()
    _, _, res["zero1"] = _train(rank, out, weights, {"data": 2, "model": 1}, zero=1, fsdp=False)
    _, _, res["transform"] = _steps(_trainer({"data": 2, "model": 1}, dist.group.WORLD,
                                             grad_transform=halve_port), rank, weights)
    # partitioned over the model axis (the dense family's tensor-parallel
    # compute), and the int8 one also on the gathered path (every rank the
    # whole model: tensor and sequence parallelism off)
    for key, label, tp in (("raw", "raw", True), ("int8", "int8", True),
                           ("int8_gathered", "int8", False)):
        t = _trainer({"data": 1, "model": 2}, dist.group.WORLD, ckpt_dir=out / f"{label}22",
                     policy=CheckpointPolicy(save_interval=100, async_save=False),
                     tensor_parallel=tp, sequence_parallel=tp)
        state, info = t.init_or_restore()
        restored = _flat_state(state)
        hist, states = [], []
        for _ in range(2):  # each step's gathered state kept for the step-by-step check
            states.append(_flat_state(gather_state(state, t.plan, dist.group.WORLD)))
            state, h = t.run(state, state.step, 1)
            hist += h
        states.append(_flat_state(gather_state(state, t.plan, dist.group.WORLD)))
        res[f"resume_{key}"] = {"mode": info.mode.value, "state": restored,
                                "partitioned": t.lm.tp is not None,
                                "hist": [(h["loss"], h["grad_norm"]) for h in hist],
                                "states": states if rank == 0 else None}
        t.manager.close()
    # a shard lost after planning: the stream fails, the ranks fall back to
    # VIA_UCP together, and rank 0's conversion fails on every rank
    lost = out / "lost22"
    if rank == 0:
        shutil.copytree(out / "raw22", lost)
        next((lost / f"step_{STEPS:08d}" / "ranks" / "rank_00001").glob("*@fp32.npy")).unlink()
    dist.barrier()
    t = _trainer({"data": 1, "model": 2}, dist.group.WORLD, ckpt_dir=lost,
                 policy=CheckpointPolicy(save_interval=100, async_save=False))
    try:
        t.init_or_restore()
        res["lost"] = "restored"
    except RuntimeError as e:
        res["lost"] = str(e)
    res["moe21"] = _moe_train(rank, out, {"data": 2, "model": 1})
    try:
        _trainer({"data": 2, "model": 1}, dist.group.WORLD, arch=MOE, moe_groups=3)
        res["moe_groups3"] = "created"
    except ValueError as e:
        res["moe_groups3"] = str(e)
    return res


def device_world(rank, out, weights, device):
    """3 steps of data=2,model=1 on ``device``, then a fixed seeded state
    saved ``int8:b256`` through the rank-aware manager: the card test holds
    the card's world against the CPU's (losses, digests, launches)."""
    from repro_torch.kernels.block_quant.ops import block_dequantize, block_quantize

    t = _trainer({"data": 2, "model": 1}, dist.group.WORLD, device=device)
    state = shard_state(init_state(params_from_reference(weights, t.lm, device)), t.plan, rank)
    hist = []
    for step in range(STEPS):
        state, m = t.step_fn(state, t.batch(step))
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    rng = np.random.default_rng(7)
    full = init_state(params_from_reference(
        {n: rng.standard_normal(w.shape).astype(np.float32) for n, w in weights.items()},
        t.lm, device))
    for tree in (full.exp_avg, full.exp_avg_sq):
        for leaf in flatten_with_paths(tree).values():
            leaf.copy_(torch.from_numpy(np.abs(rng.standard_normal(tuple(leaf.shape))).astype(
                np.float32)))
    mgr = CheckpointManager(out / "coded", t.plan, group=dist.group.WORLD,
                            policy=CheckpointPolicy(codec="int8:b256", async_save=False))
    q0, d0 = block_quantize.launches, block_dequantize.launches
    mgr.save(shard_state(full, t.plan, rank), 1, block=True)
    mgr.close()
    return {"hist": hist, "launches": (block_quantize.launches - q0,
                                       block_dequantize.launches - d0)}


def rank_main(rank: int, world: int, store: str, out_dir: str, body: str,
              device: str = "cpu", module: str | None = None) -> None:
    """One rank: ``body`` (a function of this module, or of ``module``)
    run in a gloo world, its result saved for the test."""
    torch.set_num_threads(1)
    import datetime
    import importlib

    if device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    try:
        out = Path(out_dir)
        weights = dict(np.load(out / "weights.npz"))
        kw = {} if body != "device_world" else {"device": device}
        fn = globals()[body] if module is None else getattr(importlib.import_module(module), body)
        res = fn(rank, out, weights, **kw)
        torch.save(res, out / f"{body}_rank{rank}.pt")
    finally:
        if dist.is_initialized():  # a body may have destroyed it (a rank's death)
            dist.destroy_process_group()


def run_world(out: Path, world: int, body: str, device: str = "cpu",
              module: str | None = None) -> list[dict]:
    ctx = torch.multiprocessing.get_context("spawn")
    store = out / f"store_{body}"
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, str(store), str(out), body, device, module))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert not hung, f"{body}: ranks {hung} still running after {JOIN_TIMEOUT_S} s: killed"
    assert [p.exitcode for p in procs] == [0] * world, body
    return [torch.load(out / f"{body}_rank{r}.pt") for r in range(world)]


# ---------------------------------------------------------------------------
# fixtures: the reference's weights and trajectory, the single-device port's,
# and the two worlds


def _reference_weights(arch: str) -> dict:
    import jax

    repro = _ref()
    from repro.models import build_model as ref_build

    rlm = ref_build(repro.configs.reduced(repro.configs.get_config(arch)),
                    compute_dtype=jax.numpy.float32)
    return {k: np.asarray(v) for k, v in
            repro.core.pytree.flatten_with_paths(rlm.init(jax.random.PRNGKey(0))).items()}


@pytest.fixture(scope="module")
def weights():
    return _reference_weights(ARCH)


@pytest.fixture(scope="module")
def weights_moe():
    return _reference_weights(MOE)


def _global_batch(step: int, arch: str = ARCH) -> np.ndarray:
    cfg = TC.reduced(TC.get_config(arch))
    return tdata.batch_for_step(cfg, TC.ShapeSpec("train", S, B, "train"), step, seed=0,
                                batch_override=B, seq_override=S)["tokens"]


@pytest.fixture(scope="module")
def reference_hist(weights):
    return _reference_steps(weights)


@pytest.fixture(scope="module")
def reference_hist_halved(weights):
    import jax

    return _reference_steps(weights, lambda g: jax.tree.map(
        lambda x: x if x.ndim == 1 else x * 0.5, g))


def _reference_steps(weights, grad_transform=None):
    """3 steps of the reference's step under plain ``jax.jit``, no mesh."""
    import jax
    import jax.numpy as jnp

    repro = _ref()
    from repro.models import build_model as ref_build
    from repro.train.optimizer import init_state as ref_init_state
    from repro.train.steps import make_train_step as ref_make_step

    rc = repro.configs
    rlm = ref_build(rc.reduced(rc.get_config(ARCH)), compute_dtype=jnp.float32)
    params = repro.core.pytree.unflatten_from_paths({k: jnp.asarray(v) for k, v in weights.items()})
    step = jax.jit(ref_make_step(rlm, rc.TrainConfig(), rc.ParallelismConfig(
        compute_dtype="float32"), grad_transform=grad_transform))
    state, hist = ref_init_state(params), []
    for i in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(_global_batch(i))})
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return hist


def _single_steps(weights, state=None, start=0, n=STEPS, grad_transform=None):
    lm = build_model(TC.reduced(TC.get_config(ARCH)), compute_dtype=torch.float32)
    step = make_train_step(lm, TC.TrainConfig(), TC.ParallelismConfig(compute_dtype="float32"),
                           grad_transform=grad_transform)
    state = state or init_state(params_from_reference(weights, lm, "cpu"))
    hist = []
    for i in range(start, start + n):
        state, m = step(state, {"tokens": torch.from_numpy(_global_batch(i)).long()})
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return state, hist


@pytest.fixture(scope="module")
def single(weights):
    return _single_steps(weights)


def _moe_reference_steps(weights):
    """3 steps of reduced mixtral under the reference's plain ``jax.jit``
    step, no mesh, fp32 and remat none: (loss, aux, grad norm) a step."""
    import jax
    import jax.numpy as jnp

    repro = _ref()
    from repro.models import build_model as ref_build
    from repro.train.optimizer import init_state as ref_init_state
    from repro.train.steps import make_train_step as ref_make_step

    rc = repro.configs
    rlm = ref_build(rc.reduced(rc.get_config(MOE)), compute_dtype=jnp.float32, remat="none")
    params = repro.core.pytree.unflatten_from_paths({k: jnp.asarray(v) for k, v in weights.items()})
    step = jax.jit(ref_make_step(rlm, rc.TrainConfig(), rc.ParallelismConfig(
        compute_dtype="float32", remat="none")))
    state, hist = ref_init_state(params), []
    for i in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(_global_batch(i, MOE))})
        hist.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
    return hist


def _moe_single_steps(weights):
    lm = build_model(TC.reduced(TC.get_config(MOE)), compute_dtype=torch.float32, remat="none")
    step = make_train_step(lm, TC.TrainConfig(), TC.ParallelismConfig(
        compute_dtype="float32", remat="none"))
    state, hist = init_state(params_from_reference(weights, lm, "cpu")), []
    for i in range(STEPS):
        state, m = step(state, {"tokens": torch.from_numpy(_global_batch(i, MOE)).long()})
        hist.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
    return hist


@pytest.fixture(scope="module")
def moe_hists(weights_moe):
    return _moe_single_steps(weights_moe), _moe_reference_steps(weights_moe)


@pytest.fixture(scope="module")
def worlds(weights, weights_moe, tmp_path_factory):
    out = tmp_path_factory.mktemp("worlds")
    np.savez(out / "weights.npz", **weights)
    np.savez(out / "weights_moe.npz", **weights_moe)
    w4 = run_world(out, 4, "world4")
    w2 = run_world(out, 2, "world2")  # resumes the 4-rank checkpoints
    return out, w4, w2


def _world(worlds, scenario):
    out, w4, w2 = worlds
    ranks = w4 if scenario in w4[0] else w2
    return out, [r[scenario] for r in ranks]


# ---------------------------------------------------------------------------
# the plan's PartitionSpecs


PSPEC_CASES = [
    ("smollm-360m", {"data": 2, "model": 2}, {}),
    ("smollm-360m", {"data": 2, "model": 2}, {"zero": 1, "fsdp": False}),
    ("smollm-360m", {"data": 4, "model": 1}, {"zero": 3, "fsdp": False}),
    ("smollm-360m", {"data": 2, "model": 1}, {"fsdp": False, "zero": 1}),
    ("smollm-360m", {"pipe": 2, "data": 2, "model": 2}, {"pipe_axis": "pipe"}),
    ("mixtral-8x22b", {"data": 1, "model": 4}, {}),
    ("mixtral-8x22b", {"data": 2, "model": 2}, {"expert_parallel": False}),
    ("mamba2-130m", {"data": 2, "model": 2}, {}),
]


@pytest.mark.parametrize("arch,mesh_d,kw", PSPEC_CASES,
                         ids=[f"{a}-{','.join(f'{k}={v}' for k, v in m.items())}-{k}"
                              for a, m, k in PSPEC_CASES])
def test_state_pspecs_equal_the_reference(arch, mesh_d, kw):
    repro = _ref()
    from repro.models import build_model as ref_build

    rc = repro.configs
    mesh = MeshSpec.from_dict(mesh_d)
    rmesh = repro.core.MeshSpec.from_dict(mesh_d)
    data_axes = ("data",)
    tpar = TC.ParallelismConfig(data_axes=data_axes, **kw)
    rpar = rc.ParallelismConfig(data_axes=data_axes, **kw)
    tcfg, rcfg = TC.reduced(TC.get_config(arch)), rc.reduced(rc.get_config(arch))
    from repro_torch.dist.sharding import vocab_multiple

    tplan = make_plan(tcfg, build_model(tcfg, vocab_multiple=vocab_multiple(tpar, mesh)).registry,
                      tpar, mesh)
    rplan = repro.dist.sharding.make_plan(
        rcfg, ref_build(rcfg, vocab_multiple=repro.dist.sharding.vocab_multiple(rpar, rmesh)
                        ).registry, rpar, rmesh)
    got, want = tplan.state_pspecs(), rplan.state_pspecs()
    assert set(got) == set(want) == {"params", "exp_avg", "exp_avg_sq"}
    sharded = 0
    for field in want:
        assert set(got[field]) == set(want[field])
        for name, ps in want[field].items():
            assert tuple(got[field][name]) == tuple(ps), (field, name)
            sharded += any(e is not None for e in ps)
    assert sharded  # the case shards something
    assert tplan.partition_specs == got["params"]
    assert tplan.moment_partition_specs == got["exp_avg"]


def test_rank_rows_follow_the_data_coordinate():
    mesh = MeshSpec.from_dict({"pipe": 2, "data": 2, "model": 2})
    par = parallel_for(mesh)
    rows = [rank_rows(8, par, mesh, r) for r in mesh.ranks()]
    for r in mesh.ranks():
        d = mesh.coords(r)["data"]
        assert rows[r] == slice(4 * d, 4 * d + 4)
    with pytest.raises(ValueError, match="does not split"):
        rank_rows(3, par, mesh, 0)


# ---------------------------------------------------------------------------
# the worlds


TRAIN_WORLDS = [("dense22", {"data": 2, "model": 2}, {}),
                ("pipe", {"pipe": 2, "data": 2}, {}),
                ("dense21", {"data": 2, "model": 1}, {}),
                ("zero1", {"data": 2, "model": 1}, {"zero": 1, "fsdp": False})]
WORLD_IDS = [w[0] for w in TRAIN_WORLDS]


def _plan(mesh_d, **par):
    return _trainer(mesh_d, **par).plan


def _gather(locals_, plan, field, kind):
    """The runtime-shaped tensors from every rank's local shards (numpy
    inversion of the layouts; primaries only)."""
    out = {}
    for name, spec in plan.param_specs.items():
        layout = spec.layout_for(kind, plan.mesh)
        full = torch.empty(spec.runtime_shape, dtype=locals_[0][field][name].dtype)
        for r in layout.primary_ranks():
            for e in layout.entries[r]:
                full[e.atom_index()] = locals_[r][field][name][e.shard_index()]
        out[name] = full
    return out


@pytest.mark.parametrize("scenario,mesh_d,par", TRAIN_WORLDS, ids=WORLD_IDS)
def test_init_shards_equal_the_single_device_state(worlds, scenario, mesh_d, par):
    _, ranks = _world(worlds, scenario)
    t = _trainer(mesh_d, **par)
    full = _flat_state(t.init_state())
    for r, res in enumerate(ranks):
        for field, kind in FIELDS:
            for name, got in res["init"][field].items():
                layout = t.plan.param_specs[name].layout_for(kind, t.plan.mesh)
                want = slice_shard(full[field][name], layout, r)
                assert got.shape == layout.local_shape
                assert torch.equal(got, want), (scenario, r, field, name)


@pytest.mark.parametrize("scenario,mesh_d,par", TRAIN_WORLDS, ids=WORLD_IDS)
def test_three_steps_track_single_device_and_reference(worlds, single, reference_hist,
                                                       scenario, mesh_d, par):
    _, ranks = _world(worlds, scenario)
    state1, hist1 = single
    for res in ranks:  # every rank logs the single-device value
        for (loss, gn), (l1, g1), (lr, gr) in zip(res["hist"], hist1, reference_hist):
            assert abs(loss - l1) <= REL * abs(l1) and abs(loss - lr) <= REL * abs(lr)
            assert abs(gn - g1) <= REL * abs(g1) and abs(gn - gr) <= REL * abs(gr)
    # the gathered weights: the single device's, but for AdamW's sign flips
    # of gradients within rounding of 0 (tests/test_torch_train.py)
    plan = _plan(mesh_d, **par)
    got = _gather([r["final"] for r in ranks], plan, "params", StateKind.FP32)
    for name, want in flatten_with_paths(state1.params).items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), atol=3.6e-4, err_msg=name)


def _close(hist, *wants):
    for want in wants:
        for (loss, gn), (lw, gw) in zip(hist, want, strict=True):
            assert abs(loss - lw) <= REL * abs(lw) and abs(gn - gw) <= REL * abs(gw)


def test_grad_transform_matches_the_reference_jit(weights, single, reference_hist,
                                                  reference_hist_halved):
    """The hook runs after the gradient and before the clip, as the
    reference's (``repro/train/steps.py:84-85``): on one device and under a
    2-rank group (on the reduced gradient)."""
    _, hist = _single_steps(weights, grad_transform=halve_port)
    _close(hist, reference_hist_halved)
    assert all(abs(a[1] - b[1]) > 1e-3 for a, b in zip(hist, reference_hist))  # it acted


def test_grad_transform_under_a_group(worlds, reference_hist_halved):
    _, ranks = _world(worlds, "transform")
    for res in ranks:
        _close(res["hist"], reference_hist_halved)


@pytest.mark.parametrize("scenario,mesh_d,par", TRAIN_WORLDS, ids=WORLD_IDS)
def test_replicas_are_bit_identical(worlds, scenario, mesh_d, par):
    """Every rank of a fragment holds the same bits after 3 steps, so a dedup
    save's lowest replica stands for all (ZeRO-1's replicated weights)."""
    _, ranks = _world(worlds, scenario)
    plan = _plan(mesh_d, **par)
    replicated = 0
    for field, kind in FIELDS:
        for name, spec in plan.param_specs.items():
            layout = spec.layout_for(kind, plan.mesh)
            for r in plan.mesh.ranks():
                p = layout.ranks_for_fragment(layout.fragment_id[r])[0]
                if p != r:
                    replicated += 1
                    a, b = ranks[r]["final"][field][name], ranks[p]["final"][field][name]
                    assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (field, name)
    # ZeRO-3 over data=2 alone shards every tensor: no replica to compare
    assert replicated or scenario == "dense21"
    if scenario == "zero1":  # weights replicated over data, moments sharded
        assert any(len(set(s.layout_for(StateKind.FP32, plan.mesh).fragment_id)) == 1
                   and len(set(s.layout_for(StateKind.EXP_AVG, plan.mesh).fragment_id)) == 2
                   for s in plan.param_specs.values())


@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_four_rank_save_is_the_reference_save_of_the_gathered_state(worlds, codec, tmp_path):
    repro = _ref()
    from repro.ckpt.saver import write_distributed as ref_write
    from repro.models import build_model as ref_build

    out, ranks = _world(worlds, "dense22")
    saves = _world(worlds, f"save_{codec}")[1]
    rc = repro.configs
    mesh_d = {"data": 2, "model": 2}
    t = _trainer(mesh_d)
    snap = {}
    for field, kind in FIELDS:
        for name, full in _gather([r["final"] for r in ranks], t.plan, field, kind).items():
            snap.setdefault(name, {})[repro.core.StateKind(kind.value)] = full.numpy()
    rmesh = repro.core.MeshSpec.from_dict(mesh_d)
    rpar = rc.ParallelismConfig(data_axes=("data",), compute_dtype="float32")
    rcfg = rc.reduced(rc.get_config(ARCH))
    rplan = repro.dist.sharding.make_plan(
        rcfg, ref_build(rcfg, vocab_multiple=repro.dist.sharding.vocab_multiple(rpar, rmesh)
                        ).registry, rpar, rmesh)
    kw = {}
    if codec == "int8":
        from repro.core.codec import CodecPolicy

        kw["codec"] = CodecPolicy.moments("int8:b256")
    ref_root = tmp_path / "ref"
    rres = ref_write(snap, rplan, STEPS, ref_root, workers=1,
                     config_fingerprint={"model": t.cfg.fingerprint(),
                                         "parallel": t.parallel.fingerprint()}, **kw)
    port_root = out / f"{codec}22" / f"step_{STEPS:08d}"
    port_ck, ref_ck = repro.core.DistCheckpoint.open(port_root), repro.core.DistCheckpoint.open(ref_root)
    assert port_ck.is_committed
    pj, rj = port_ck.manifest.to_json(), ref_ck.manifest.to_json()
    pj.pop("created_at"), rj.pop("created_at")
    assert pj == rj
    assert port_ck.validate() == []  # the reference recomputes every digest
    files = sorted(p.relative_to(port_root) for p in port_root.rglob("*.npy"))
    assert files == sorted(p.relative_to(ref_root) for p in ref_root.rglob("*.npy"))
    for f in files:
        assert (port_root / f).read_bytes() == (ref_root / f).read_bytes(), f
    # each rank wrote and counted only its own shards
    assert sum(s["shards"] for s in saves) == len(rj["shard_digests"])
    assert sum(s["bytes"] for s in saves) == rres.bytes_written
    if codec == "int8":
        assert set(rj["shard_codecs"].values()) == {"int8:b256"}


@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_direct_restore_reads_only_the_ranks_own_fragments(worlds, codec):
    out, ranks = _world(worlds, "dense22")
    _, direct = _world(worlds, f"direct_{codec}")
    plan = _plan({"data": 2, "model": 2})
    root = out / f"{codec}22" / f"step_{STEPS:08d}"
    ck = DistCheckpoint.open(root)
    for r, res in enumerate(ranks):
        got = direct[r]
        assert got["mode"] == "direct"
        want_files, shard_bytes = set(), 0
        for name, spec in plan.param_specs.items():
            for kind in (StateKind.FP32, StateKind.EXP_AVG, StateKind.EXP_AVG_SQ):
                layout = spec.layout_for(kind, plan.mesh)
                owner = layout.ranks_for_fragment(layout.fragment_id[r])[0]
                assert owner in ck.writing_ranks(name, kind)
                want_files.add((owner, name, kind.value))
                item = got["state"]["params"][name].element_size()
                shard_bytes += item * sum(math.prod(b - a for a, b in e.shard_slice)
                                          for e in layout.entries[r])
        assert set(got["opened"]) == want_files, r
        assert got["bytes_read"] == shard_bytes
        # the restored shards are the saved ones
        if codec == "raw":
            for field, _ in FIELDS:
                for name, t in got["state"][field].items():
                    assert torch.equal(t, res["final"][field][name]), (field, name)


def _one_process_restore(root, mesh_d, **par):
    t = _trainer(mesh_d, ckpt_dir=root, policy=CheckpointPolicy(save_interval=100), **par)
    state, info = t.manager.restore("cpu")
    return t, state, info


def _hold_step(got: dict, want: TrainState, before: dict, coded: bool) -> None:
    """A rank group's state after a step (flat, gathered) against the single
    device's step from the same state: every element within ``REL`` of its
    tensor's largest.  After an int8-coded resume a parameter may leave that
    only where the code zeroed the second moment: there Adam divides a
    gradient of rounding size by a root of the same size, so the
    partitioned sums' rounding moves the update; the moments themselves
    hold everywhere."""
    for field, _ in FIELDS:
        for name, w in flatten_with_paths(getattr(want, field)).items():
            off = (got[field][name] - w).abs() > REL * w.abs().max()
            if coded and field == "params":
                off &= before["exp_avg_sq"][name] != 0
            assert not off.any(), (field, name, int(off.sum()))


@pytest.mark.parametrize("codec", ["raw", "int8", "int8_gathered"])
def test_four_ranks_resume_as_two_under_another_layout(worlds, codec):
    """The 4-rank step-3 checkpoints (raw and ``int8:b256``) resumed by 2
    ranks under data=1,model=2: each rank's restored shards are the
    one-process restore's.  Computing partitioned over the model axis, each
    of the 2 steps after it is the single device's step from the ranks' own
    state (loss, gradient norm, the state it leaves), and the raw resume's 2
    steps follow the single device's trajectory; ``int8_gathered`` resumes
    the coded checkpoint on the gathered path (``tensor_parallel=False``
    and ``sequence_parallel=False``: with sequence parallelism on, tensor
    parallelism off computes by rows), whose 2 steps follow the single
    device's trajectory too."""
    label = codec.removesuffix("_gathered")
    par = ({"tensor_parallel": False, "sequence_parallel": False}
           if codec.endswith("_gathered") else {})
    out, ranks = _world(worlds, f"resume_{codec}")
    t, state, info = _one_process_restore(out / f"{label}22", {"data": 1, "model": 2}, **par)
    assert info.mode.value == "reshard_stream"
    full = _flat_state(state)
    for r, res in enumerate(ranks):
        assert res["mode"] == "reshard_stream"
        assert res["partitioned"] == (not par)
        for field, kind in FIELDS:
            for name, got in res["state"][field].items():
                layout = t.plan.param_specs[name].layout_for(kind, t.plan.mesh)
                assert torch.equal(got, slice_shard(full[field][name], layout, r)), (field, name)
        assert res["hist"] == ranks[0]["hist"]
    states = ranks[0]["states"]
    for i in range(2):
        before = TrainState(step=STEPS + i,
                            **{f: unflatten_from_paths(states[i][f]) for f, _ in FIELDS})
        after, ((l1, g1),) = _single_steps(None, state=before, start=STEPS + i, n=1)
        loss, gn = ranks[0]["hist"][i]
        assert abs(loss - l1) <= REL * abs(l1) and abs(gn - g1) <= REL * abs(g1)
        _hold_step(states[i + 1], after, states[i], coded=label == "int8")
    if codec != "int8":
        _, hist = _single_steps(None, state=state, start=STEPS, n=2)
        for (loss, gn), (l1, g1) in zip(ranks[0]["hist"], hist, strict=True):
            assert abs(loss - l1) <= REL * abs(l1) and abs(gn - g1) <= REL * abs(g1)


def test_two_ranks_resume_as_one_process(worlds):
    out, ranks = _world(worlds, "dense21")
    _, state, info = _one_process_restore(out / "raw21", {"data": 1, "model": 1})
    assert info.mode.value == "reshard_stream"
    plan = _plan({"data": 2, "model": 1})
    for field, kind in FIELDS:
        want = _gather([r["final"] for r in ranks], plan, field, kind)
        for name, got in flatten_with_paths(getattr(state, field)).items():
            assert torch.equal(got, want[name]), (field, name)


def test_async_save_every_step_finishes(worlds):
    _, ranks = _world(worlds, "async")
    for res in ranks:
        assert res["results"] == STEPS and res["steps"] == [2, 3]


def test_a_lost_shard_fails_every_rank_together(worlds):
    """No rank hangs in a collective and none goes on alone: the stream's
    failure on any rank sends all of them to VIA_UCP, and the conversion's
    failure on rank 0 is raised on every rank."""
    _, ranks = _world(worlds, "lost")
    assert all(msg.startswith("UCP conversion on rank 0 failed") for msg in ranks), ranks


MOE_WORLDS = [("moe21", "ep"), ("moe22_ep", "ep"), ("moe22_tp", "tp")]


@pytest.mark.parametrize("scenario,mode", MOE_WORLDS, ids=[w[0] for w in MOE_WORLDS])
def test_moe_under_a_data_size_of_two_tracks_single_device_and_reference(
        worlds, moe_hists, scenario, mode):
    """A MoE layer routes one token group a sequence in both packages, so the
    data axes split capacity and the aux loss with the rows: data=2,model=1,
    and data=2,model=2 under EP and expert-TP storage (Fig. 10's target)."""
    _, ranks = _world(worlds, scenario)
    single, ref = moe_hists
    for res in ranks:
        assert res["moe_mode"] == mode
        for got, one, want in zip(res["hist"], single, ref, strict=True):
            for g, o, w in zip(got, one, want):
                assert abs(g - o) <= REL * abs(o) and abs(g - w) <= REL * abs(w), (got, one, want)
    assert all(r["hist"] == ranks[0]["hist"] for r in ranks)


def test_moe_groups_that_do_not_split_over_the_data_size_are_refused(worlds):
    _, ranks = _world(worlds, "moe_groups3")
    assert all(msg == "moe_groups 3 does not split over the data size 2" for msg in ranks)


@pytest.fixture
def one_rank_group(tmp_path):
    assert not dist.is_initialized(), "a test left the default group initialized"
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_a_group_of_another_size_is_refused(one_rank_group):
    with pytest.raises(ValueError, match="the group has 1 ranks"):
        _trainer({"data": 2, "model": 1}, one_rank_group)


def test_one_rank_group_is_the_single_device_trainer(one_rank_group, tmp_path):
    """A group of 1 over a mesh of 1: the same losses as no group, and a
    checkpoint with the same digests."""
    a = _trainer({"data": 1, "model": 1}, one_rank_group, ckpt_dir=tmp_path / "a",
                 policy=CheckpointPolicy(save_interval=2, async_save=False))
    b = _trainer({"data": 1, "model": 1}, ckpt_dir=tmp_path / "b",
                 policy=CheckpointPolicy(save_interval=2, async_save=False))
    _, ha = a.run(a.init_state(), 0, 2)
    _, hb = b.run(b.init_state(), 0, 2)
    assert [h["loss"] for h in ha] == [h["loss"] for h in hb]
    da = DistCheckpoint.open(a.manager.step_dir(2)).manifest.shard_digests
    db = DistCheckpoint.open(b.manager.step_dir(2)).manifest.shard_digests
    assert da == db


def test_host_devices_must_be_the_mesh_size():
    with pytest.raises(SystemExit, match="one rank per mesh position"):
        train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--host-devices", "3",
                        "--mesh", "data=2,model=1"])
