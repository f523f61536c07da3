"""Compute by pipeline stages over a pipe axis, and sequence parallelism
with tensor parallelism off, on the CPU, held against the single-device port
and the JAX package.

Two gloo worlds spawned once per module (``tests/test_torch_multirank.py``'s
``run_world``), every model reduced and in fp32, 3 steps of 4 rows of 32
positions from the reference's weights (llama-vision's cross gates set
nonzero from a seed: the reference's 0 would hide a wrong cross path):

* 4 ranks: smollm cut to 6 layers under pipe=4 (chunks 2, 2, 2, 0: one
  stage empty), smollm and mixtral cut to 3 layers (EP; chunks 2, 1, so
  rank 1's shard holds a padded layer) under pipe=2,model=2, smollm under
  pipe=2,data=2;
* 2 ranks: pipe=2 for smollm, mamba2, jamba (2 periods), deepseek-v2 (its
  one-layer ``head`` leaves rank 1 an empty chunk), llama-vision and whisper
  (its encoder split too); data=1,model=2 with tensor parallelism off for
  smollm, mixtral under EP and whisper; smollm's pipe=2 step-3 checkpoint
  resumed under data=1,model=2 with tensor parallelism off; ``grad_accum=2``
  under pipe=2.

Each run's losses, aux and gradient norms are within 1e-5 relative of the
single-device port and of the reference's jitted no-mesh step (the
reference under a mesh fails in this container); a rank's compute tree
holds only its stage's layers of every stack (leading dims its chunk of the
checkpoint layout, by ceil division) and it computed exactly those; with
tensor parallelism off every layer saw only the rank's rows.  The reference
is imported lazily, so the spawned ranks load no JAX.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.ckpt.policy import CheckpointPolicy  # noqa: E402
from repro_torch.core.layout import MeshSpec, slice_shard  # noqa: E402
from repro_torch.core.patterns import StateKind  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths  # noqa: E402
from repro_torch.dist.pipeline import Pipeline, pipelines  # noqa: E402
from repro_torch.dist.sharding import make_plan  # noqa: E402
from repro_torch.dist.tensor_parallel import partitions  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train.optimizer import init_state  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, shard_state  # noqa: E402
from test_torch_multirank import run_world  # noqa: E402

MODULE = "test_torch_pipeline"
B, S, STEPS, REL = 4, 32, 3, 1e-5

# model variants: (arch, config changes)
MODELS = {
    "smollm": ("smollm-360m", {"num_layers": 6}),
    "mixtral": ("mixtral-8x22b", {"num_layers": 3}),
    "mamba2": ("mamba2-130m", {}),
    "jamba": ("jamba-1.5-large-398b", {}),
    "deepseek": ("deepseek-v2-236b", {}),
    "vlm": ("llama-3.2-vision-11b", {}),
    "whisper": ("whisper-tiny", {}),
}
P4 = {"pipe": 4, "data": 1, "model": 1}
P2 = {"pipe": 2, "data": 1, "model": 1}
P2M2 = {"pipe": 2, "data": 1, "model": 2}
P2D2 = {"pipe": 2, "data": 2, "model": 1}
M2 = {"data": 1, "model": 2}
NO_TP = {"tensor_parallel": False}
# train scenarios: (model, mesh, parallelism changes)
TRAIN = {
    "smollm_p4": ("smollm", P4, {}),
    "smollm_p2m2": ("smollm", P2M2, {}),
    "mixtral_p2m2": ("mixtral", P2M2, {}),
    "smollm_p2d2": ("smollm", P2D2, {}),
    "smollm_p2": ("smollm", P2, {}),
    "mamba2_p2": ("mamba2", P2, {}),
    "jamba_p2": ("jamba", P2, {}),
    "deepseek_p2": ("deepseek", P2, {}),
    "vlm_p2": ("vlm", P2, {}),
    "whisper_p2": ("whisper", P2, {}),
    "smollm_sp": ("smollm", M2, NO_TP),
    "mixtral_sp": ("mixtral", M2, NO_TP),
    "whisper_sp": ("whisper", M2, NO_TP),
}
ACCUM = ("smollm", P2, {"grad_accum": 2})
RESUME = "smollm_p2"  # saved at step 3, resumed under data=1,model=2 with TP off


def _size(mesh_d) -> int:
    return int(np.prod(list(mesh_d.values())))


def port_cfg(model: str) -> TC.ModelConfig:
    arch, changes = MODELS[model]
    return dataclasses.replace(TC.reduced(TC.get_config(arch)), **changes)


def parallel_for(mesh_d, **changes) -> TC.ParallelismConfig:
    return TC.ParallelismConfig(data_axes=("data",), model_axis="model", compute_dtype="float32",
                                remat="none", pipe_axis="pipe" if "pipe" in mesh_d else None,
                                **changes)


def _global_batch(cfg, step: int) -> dict:
    full = tdata.batch_for_step(cfg, TC.ShapeSpec("train", S, B, "train"), step, seed=0,
                                batch_override=B, seq_override=S)
    return {k: full[k] for k in ("tokens", "source_embeds") if k in full}


def _torch_batch(batch: dict) -> dict:
    out = {"tokens": torch.from_numpy(batch["tokens"]).long()}
    if "source_embeds" in batch:
        out["source_embeds"] = torch.from_numpy(batch["source_embeds"])
    return out


def _w(weights: dict, model: str) -> dict:
    pre = model + ":"
    return {k[len(pre):]: v for k, v in weights.items() if k.startswith(pre)}


def chunk(count: int, size: int, coord: int) -> tuple[int, int]:
    """A stage's layers of a stack of ``count`` by ceil division."""
    c = -(-count // size)
    lo = min(coord * c, count)
    return lo, min(lo + c, count)


# ---------------------------------------------------------------------------
# the ranks


class _Rows:
    """Records the rows of the stream every layer of ``lm`` is handed."""

    def __init__(self, lm):
        self.seen, real = set(), lm._layer

        def spy(ld, window, positions, keys, sp, x, source, *values):
            self.seen.add(x.shape[1])
            return real(ld, window, positions, keys, sp, x, source, *values)

        lm._layer = spy


def _trainer(model, mesh_d, changes, **kw):
    return Trainer.create(port_cfg(model), parallel_for(mesh_d, **changes), TC.TrainConfig(),
                          MeshSpec.from_dict(mesh_d), batch_size=B, seq_len=S, device="cpu",
                          group=dist.group.WORLD, **kw)


def _train(rank, out, weights, model, mesh_d, changes, **kw):
    t = _trainer(model, mesh_d, changes, **kw)
    rows = _Rows(t.lm)
    state = shard_state(init_state(params_from_reference(_w(weights, model), t.lm, "cpu")),
                        t.plan, rank)
    res = {"pipe": None, "tp": None}
    pipe, tp = t.lm.pipe, t.lm.tp
    if pipe is not None:
        _, comp = pipe.weights(flatten_with_paths(state.params))
        res["pipe"] = {"chunks": dict(pipe.chunks), "coord": pipe.coord,
                       "held": {n: tuple(x.shape) for n, x in comp.items() if pipe.stacked[n]},
                       "unstacked": sorted(n for n in comp if not pipe.stacked[n])}
    hist = []
    for step in range(STEPS):
        state, m = t.step_fn(state, t.batch(step))
        hist.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
    if pipe is not None:
        res["pipe"]["computed"] = list(pipe.computed)
    if tp is not None:
        res["tp"] = {"tensor": tp.tensor, "sp": tp.sp, "enc_sp": tp.enc_sp}
    res.update(hist=hist, rows=sorted(rows.seen), split=dict(t.step_fn.split))
    return t, state, res


def _resume_under_sp(rank, t, state, root: Path) -> dict:
    """The pipe=2 ranks save step 3; the same ranks resume it under
    data=1,model=2 with tensor parallelism off (RESHARD_STREAM), each
    rank's state against its shard of a one-process restore, and take
    step 4."""
    t.manager.save(state, STEPS, block=True)
    pol = CheckpointPolicy(save_interval=1000, async_save=False)
    tgt = _trainer("smollm", M2, NO_TP, ckpt_dir=str(root), policy=pol)
    restored, info = tgt.init_or_restore()
    whole, _ = CheckpointManager(str(root), tgt.plan, policy=pol).restore("cpu")
    diff = 0
    for kind, tree, want in ((StateKind.FP32, restored.params, whole.params),
                             (StateKind.EXP_AVG, restored.exp_avg, whole.exp_avg),
                             (StateKind.EXP_AVG_SQ, restored.exp_avg_sq, whole.exp_avg_sq)):
        want = flatten_with_paths(want)
        for n, got in flatten_with_paths(tree).items():
            cut = slice_shard(want[n], tgt.plan.param_specs[n].layout_for(kind, tgt.mesh), rank)
            diff += int((got.view(torch.int32) != cut.view(torch.int32)).sum())
    _, m = tgt.step_fn(restored, tgt.batch(STEPS))
    tgt.manager.close()
    return {"mode": info.mode.value, "step": info.step, "bits_differing": diff,
            "tensor": tgt.lm.tp.tensor, "sp": tgt.lm.tp.sp, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"])}


def pipe_world(rank, out, weights):
    world = dist.get_world_size()
    res = {}
    for name, (model, mesh_d, changes) in TRAIN.items():
        if _size(mesh_d) != world:
            continue
        kw = {}
        if name == RESUME:
            kw = dict(ckpt_dir=str(out / "ckpt_resume"),
                      policy=CheckpointPolicy(save_interval=1000, async_save=False))
        t, state, res[name] = _train(rank, out, weights, model, mesh_d, changes, **kw)
        if name == RESUME:
            res[name]["resume"] = _resume_under_sp(rank, t, state, out / "ckpt_resume")
            t.manager.close()
    if world == _size(ACCUM[1]):
        res["accum"] = _train(rank, out, weights, *ACCUM)[2]
    return res


# ---------------------------------------------------------------------------
# the reference and one device


def _ref():
    pytest.importorskip("jax")
    import repro
    import repro.configs
    import repro.core.pytree

    return repro


def _reference_weights(model: str) -> dict:
    """The reference's init, its cross gates then set nonzero from a seed."""
    import jax

    repro = _ref()
    from repro.models import build_model as ref_build

    arch, changes = MODELS[model]
    cfg = dataclasses.replace(repro.configs.reduced(repro.configs.get_config(arch)), **changes)
    rlm = ref_build(cfg, compute_dtype=jax.numpy.float32)
    flat = {k: np.asarray(v) for k, v in
            repro.core.pytree.flatten_with_paths(rlm.init(jax.random.PRNGKey(0))).items()}
    rng = np.random.default_rng(11)
    for k in sorted(flat):
        if k.endswith("cross_gate"):
            flat[k] = rng.uniform(0.3, 0.9, flat[k].shape).astype(np.float32)
    return flat


def _reference_steps(model: str, weights: dict) -> list:
    """3 steps of the reference's step under plain ``jax.jit``, no mesh."""
    import jax
    import jax.numpy as jnp

    repro = _ref()
    from repro.models import build_model as ref_build
    from repro.train.optimizer import init_state as ref_init_state
    from repro.train.steps import make_train_step as ref_make_step

    rc = repro.configs
    arch, changes = MODELS[model]
    rlm = ref_build(dataclasses.replace(rc.reduced(rc.get_config(arch)), **changes),
                    compute_dtype=jnp.float32, remat="none")
    params = repro.core.pytree.unflatten_from_paths({k: jnp.asarray(v) for k, v in weights.items()})
    step = jax.jit(ref_make_step(rlm, rc.TrainConfig(), rc.ParallelismConfig(
        compute_dtype="float32", remat="none")))
    state, hist = ref_init_state(params), []
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in _global_batch(port_cfg(model), i).items()}
        state, m = step(state, batch)
        hist.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
    return hist


def _single(model: str, weights: dict, steps: int = STEPS + 1, **changes) -> list:
    """The single-device port's steps."""
    cfg = port_cfg(model)
    lm = build_model(cfg, compute_dtype=torch.float32, remat="none")
    step = make_train_step(lm, TC.TrainConfig(), TC.ParallelismConfig(
        compute_dtype="float32", remat="none", **changes))
    state, hist = init_state(params_from_reference(weights, lm, "cpu")), []
    for i in range(steps):
        state, m = step(state, _torch_batch(_global_batch(cfg, i)))
        hist.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
    return hist


# ---------------------------------------------------------------------------
# fixtures


@pytest.fixture(scope="module")
def weights():
    return {m: _reference_weights(m) for m in MODELS}


@pytest.fixture(scope="module")
def trajectories(weights):
    """(single-device port, reference hist) by model."""
    return {m: (_single(m, weights[m]), _reference_steps(m, weights[m])) for m in MODELS}


@pytest.fixture(scope="module")
def worlds(weights, tmp_path_factory):
    out = tmp_path_factory.mktemp("pipe_worlds")
    np.savez(out / "weights.npz", **{f"{m}:{k}": v for m, w in weights.items()
                                     for k, v in w.items()})
    return {2: run_world(out, 2, "pipe_world", module=MODULE),
            4: run_world(out, 4, "pipe_world", module=MODULE)}


def _ranks(worlds, name):
    ranks = worlds[4] if name in worlds[4][0] else worlds[2]
    return [r[name] for r in ranks]


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= REL * max(abs(b), 1e-30)


# ---------------------------------------------------------------------------
# the decisions


def test_pipe_and_rows_decisions_of_the_full_configs():
    """A pipe axis over 1 computes by stages, and no longer keeps a model
    axis from computing partitioned; tensor parallelism off computes by
    rows where sequence parallelism is on, and gathers where both are off."""
    par = TC.ParallelismConfig(pipe_axis="pipe")
    for arch in ("smollm-360m", "mixtral-8x22b", "deepseek-v2-236b", "whisper-tiny"):
        cfg = TC.get_config(arch)
        assert pipelines(par, MeshSpec.from_dict(P2M2)) and partitions(cfg, par,
                                                                        MeshSpec.from_dict(P2M2))
        assert pipelines(par, MeshSpec.from_dict(P2D2))
        assert not partitions(cfg, par, MeshSpec.from_dict(P2D2)), arch
        assert partitions(cfg, TC.ParallelismConfig(tensor_parallel=False),
                          MeshSpec.from_dict(M2)), arch
        assert not partitions(cfg, TC.ParallelismConfig(tensor_parallel=False,
                                                        sequence_parallel=False),
                              MeshSpec.from_dict(M2)), arch
    assert not pipelines(par, MeshSpec.from_dict({"pipe": 1, "data": 2, "model": 1}))
    assert not pipelines(TC.ParallelismConfig(), MeshSpec.from_dict(M2))


def test_a_pipeline_needs_a_pipe_axis():
    class _Ranks:
        parallel = TC.ParallelismConfig(pipe_axis="pipe")
        mesh = MeshSpec.from_dict({"pipe": 1, "data": 2, "model": 1})

    with pytest.raises(ValueError, match="no pipe axis over 1"):
        Pipeline(_Ranks(), None)


@pytest.mark.parametrize("count,size,want", [
    (6, 4, [(0, 2), (2, 4), (4, 6), (6, 6)]),
    (3, 2, [(0, 2), (2, 3)]),
    (1, 2, [(0, 1), (1, 1)]),
    (2, 2, [(0, 1), (1, 2)]),
])
def test_chunks_are_the_ceil_division_of_the_layout(count, size, want):
    """The plan's layout of a stacked weight over a pipe axis gives each
    stage the ceil-division chunk of the layers (the last ones short or
    empty), which :func:`chunk` computes for the world tests."""
    cfg = dataclasses.replace(TC.reduced(TC.get_config("smollm-360m")), num_layers=count)
    mesh = MeshSpec.from_dict({"pipe": size, "data": 1, "model": 1})
    lm = build_model(cfg)
    layout = make_plan(cfg, lm.registry, parallel_for({"pipe": size}), mesh).param_specs[
        "layers.blk.wqkv"].layout_for(StateKind.FP32, mesh)
    got = [layout.entries[r][0].atom_slice[0] if layout.entries[r] else (count, count)
           for r in range(size)]
    assert got == want == [chunk(count, size, c) for c in range(size)]


# ---------------------------------------------------------------------------
# the worlds


@pytest.mark.parametrize("name", list(TRAIN))
def test_steps_track_single_device_and_reference(worlds, trajectories, name):
    """3 steps under the scenario's mesh: every rank reports the loss, aux
    and gradient norm of the single-device port and of the reference's
    jitted step, within 1e-5 relative (a padded MoE layer would add its
    uniform router's aux)."""
    model = TRAIN[name][0]
    single, ref = trajectories[model]
    for res in _ranks(worlds, name):
        for got, one, want in zip(res["hist"], single, ref, strict=False):
            for a, b, c in zip(got, one, want):
                assert _close(a, b) and _close(a, c), (name, got, one, want)


@pytest.mark.parametrize("name", [n for n, (_, mesh_d, _) in TRAIN.items() if "pipe" in mesh_d])
def test_a_rank_holds_and_computes_only_its_stage(worlds, weights, name):
    """Each rank's compute tree holds its chunk of every stack (leading dims
    the ceil-division chunk of its pipe coordinate, empty ones too), every
    unstacked weight whole, and it computed exactly its chunks in model
    order: the encoder's, then each stage's."""
    model, mesh_d, _ = TRAIN[name]
    lm = build_model(port_cfg(model), compute_dtype=torch.float32)
    counts = {d.path.split(".")[0]: d.shape[0] for d in lm.registry if d.stacked}
    order = (["encoder"] if "encoder" in counts else []) + [st.name for st in lm.stages]
    for res in _ranks(worlds, name):
        pp = res["pipe"]
        want = {s: chunk(n, mesh_d["pipe"], pp["coord"]) for s, n in counts.items()}
        assert pp["chunks"] == want
        for n, shape in pp["held"].items():
            lo, hi = want[n.split(".")[0]]
            assert shape[0] == hi - lo, (n, shape)
        assert set(pp["held"]) | set(pp["unstacked"]) == {d.path for d in lm.registry}
        assert pp["unstacked"] == sorted(d.path for d in lm.registry if not d.stacked)
        assert pp["computed"] == [(s, *want[s]) for s in order]
        assert "pipe_s" in res["split"] and res["split"]["pipe_bytes"] > 0
    if name == "smollm_p4":  # one stage holds no layer
        assert [r["pipe"]["chunks"]["layers"] for r in _ranks(worlds, name)] == [
            (0, 2), (2, 4), (4, 6), (6, 6)]
    if name == "mixtral_p2m2":  # pipe coordinate 1's shard: 1 layer and 1 padded
        assert {r["pipe"]["chunks"]["layers"] for r in _ranks(worlds, name)} == {(0, 2), (2, 3)}
    if name == "deepseek_p2":  # the one-layer head: rank 1's chunk is empty
        assert [r["pipe"]["chunks"]["head"] for r in _ranks(worlds, name)] == [(0, 1), (1, 1)]


@pytest.mark.parametrize("name", ["smollm_sp", "mixtral_sp", "whisper_sp"])
def test_tensor_parallelism_off_computes_the_rank_rows(worlds, name):
    """With tensor parallelism off and sequence parallelism on, each model
    rank's layers see only its rows of each stream the sharder splits (32
    decoder positions, whisper's 8 frames) and no model-axis weight split
    but EP experts."""
    ranks = _ranks(worlds, name)
    for res in ranks:
        assert res["tp"] == {"tensor": False, "sp": True, "enc_sp": name == "whisper_sp"}
        assert max(res["rows"]) <= S // 2, res["rows"]
        assert res["tp"] is not None and "tp_s" in res["split"]


def test_pipe_checkpoint_resumes_under_rows_without_tp(worlds, trajectories):
    """smollm's pipe=2 step-3 checkpoint resumed under data=1,model=2 with
    tensor parallelism off: RESHARD_STREAM, each rank bit-equal to its
    shard of a one-process restore, its step 4 the single device's."""
    single, _ = trajectories["smollm"]
    for res in _ranks(worlds, RESUME):
        r = res["resume"]
        assert (r["mode"], r["step"], r["bits_differing"]) == ("reshard_stream", STEPS, 0)
        assert (r["tensor"], r["sp"]) == (False, True)
        assert _close(r["loss"], single[STEPS][0]) and _close(r["grad_norm"], single[STEPS][2])


def test_accumulation_under_pipe_equals_one_device(worlds, weights):
    """``grad_accum=2`` under pipe=2: each microbatch through the stages in
    turn, the sum in the one-process order."""
    one = _single("smollm", weights["smollm"], steps=STEPS, grad_accum=2)
    for res in _ranks(worlds, "accum"):
        for got, want in zip(res["hist"], one, strict=True):
            assert all(_close(a, b) for a, b in zip(got, want)), (got, want)
