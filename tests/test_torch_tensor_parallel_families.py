"""Partitioned compute of the MoE (without MLA), SSM and hybrid families
over the model axis, on the CPU, held against the single-device port and
the JAX package.

* ``partitions`` and the decisions of ``TensorParallel`` (EP or expert-TP,
  Mamba-2 by SSM heads or gathered) for the full-size configs;
* two gloo worlds spawned once per module, as
  ``tests/test_torch_tensor_parallel.py`` spawns its own: 2 ranks at
  data=1,model=2 and 4 ranks at data=2,model=2 and data=1,model=4, reduced
  mixtral under EP and under expert-TP, reduced mamba2 (d_inner 128 and
  B|C 2·16: its conv channels split over 2 and 4 ranks out of line with
  the x/B/C sub-fragments), mamba2 at a head dim of 64 (2 heads: at model=4
  the Mamba block computes from its gathered weights), and reduced jamba
  cut to one period (8 layers), all fp32 over 3 steps of 4 rows of 32
  positions (33 tokens a row: the stream seq-sharded) or 33 (replicated):
  losses, aux and gradient norms within 1e-5 relative of the single-device
  port and of the reference's jitted step; the router's and the per-head
  scalars' gradients equal to one device's; the same routing on every model
  rank; a ``gather_full`` spy showing exactly the weights each design
  gathers (never an expert, ``in_proj`` or ``out_proj`` where the experts
  and the SSM heads split);
* mixtral's save under EP on 2 ranks equal to one process's save of the
  gathered state, resumed under expert-TP (RESHARD_STREAM, each rank's
  state bit-equal to its shard of a one-process restore) for a 4th step;
* serving in those worlds (fp32): prefill logits within 1e-4 of one
  process's, the same greedy tokens, each rank's ``h``/``conv``/KV cache
  its ``cache_pspecs`` shard (a gathered Mamba block's state whole);
* the serve CLI under ``--host-devices 2`` gives one process's tokens for
  reduced mixtral, mamba2 and jamba.

The reference is imported lazily, so the spawned ranks load no JAX.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.dist.tensor_parallel as tp_mod  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.ckpt.policy import CheckpointPolicy  # noqa: E402
from repro_torch.ckpt.saver import snapshot_state, write_distributed  # noqa: E402
from repro_torch.core.dist_ckpt import DistCheckpoint  # noqa: E402
from repro_torch.core.layout import MeshSpec, slice_shard  # noqa: E402
from repro_torch.core.patterns import StateKind  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths  # noqa: E402
from repro_torch.dist.sharding import (  # noqa: E402
    RankGroups, cache_pspecs, local_shape, make_plan, rank_rows, vocab_multiple,
)
from repro_torch.dist.tensor_parallel import TensorParallel, partitions  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model, moe, params_from_reference  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train.optimizer import init_state  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, gather_state, shard_state  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
B, STEPS, REL = 4, 3, 1e-5
PROMPT, GEN = 8, 4
M2, M4, D2M2 = {"data": 1, "model": 2}, {"data": 1, "model": 4}, {"data": 2, "model": 2}

# model variants: (arch, config changes)
MODELS = {
    "mixtral": ("mixtral-8x22b", {}),
    "mamba2": ("mamba2-130m", {}),
    "mamba2g": ("mamba2-130m", {"ssm_head_dim": 64}),  # 2 SSM heads
    "jamba": ("jamba-1.5-large-398b", {"num_layers": 8}),  # one period
}
# train scenarios: (model, mesh, positions a row, expert parallelism)
TRAIN = {
    "mixtral_ep_m2": ("mixtral", M2, 32, True),
    "mixtral_tp_m2": ("mixtral", M2, 32, False),
    "mixtral_ep_m2_nosp": ("mixtral", M2, 33, True),
    "mamba2_m2": ("mamba2", M2, 32, True),
    "mamba2_m2_nosp": ("mamba2", M2, 33, True),
    "jamba_m2": ("jamba", M2, 32, True),
    "mixtral_ep_d2m2": ("mixtral", D2M2, 32, True),
    "mixtral_tp_m4": ("mixtral", M4, 32, False),
    "mamba2_m4": ("mamba2", M4, 32, True),
    "mamba2_d2m2": ("mamba2", D2M2, 32, True),
    "mamba2g_m4": ("mamba2g", M4, 32, True),
    "jamba_m4": ("jamba", M4, 32, True),
}
# serve scenarios: (model, mesh, expert parallelism)
SERVE = {
    "serve_mixtral_m2": ("mixtral", M2, True),
    "serve_mixtral_tp_m2": ("mixtral", M2, False),
    "serve_mamba2_m2": ("mamba2", M2, True),
    "serve_jamba_m2": ("jamba", M2, True),
    "serve_mamba2_m4": ("mamba2", M4, True),
    "serve_mamba2g_m4": ("mamba2g", M4, True),
    "serve_jamba_d2m2": ("jamba", D2M2, True),
}
RESUME = "mixtral_ep_m2"  # saved at step 3, resumed under expert-TP in the same world
JOIN_TIMEOUT_S = 240


def _size(mesh_d) -> int:
    return int(np.prod(list(mesh_d.values())))


def _variant(cfg, model: str):
    _, changes = MODELS[model]
    changes = dict(changes)
    if "ssm_head_dim" in changes:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, head_dim=changes.pop("ssm_head_dim")))
    return dataclasses.replace(cfg, **changes)


def port_cfg(model: str) -> TC.ModelConfig:
    return _variant(TC.reduced(TC.get_config(MODELS[model][0])), model)


def parallel_for(ep: bool = True, remat: str = "none") -> TC.ParallelismConfig:
    return TC.ParallelismConfig(data_axes=("data",), model_axis="model", compute_dtype="float32",
                                remat=remat, expert_parallel=ep)


def _global_batch(cfg, step: int, seq: int) -> np.ndarray:
    return tdata.batch_for_step(cfg, TC.ShapeSpec("train", seq, B, "train"), step, seed=0,
                                batch_override=B, seq_override=seq)["tokens"]


def _prompts(cfg) -> np.ndarray:
    return np.random.default_rng(5).integers(0, cfg.vocab_size, (B, PROMPT))


# ---------------------------------------------------------------------------
# the ranks


class _Routes:
    """Records the experts every ``moe.route`` call chooses."""

    def __enter__(self):
        self.idx, self._route = [], moe.route

        def spy(xg, router_w, k):
            probs, gate_k, idx_k = self._route(xg, router_w, k)
            self.idx.append(idx_k.detach().cpu())
            return probs, gate_k, idx_k

        moe.route = spy
        return self

    def __exit__(self, *exc):
        moe.route = self._route


def _grads(t, local: dict, batch: dict) -> tuple[dict, dict]:
    """The rank's model-local gradients of one loss (the step's forward and
    backward, no update) and its metrics."""
    tp = t.lm.tp
    _, comp = tp.weights(local)
    leaves = {n: x.detach().requires_grad_(True) for n, x in comp.items()}
    loss, metrics = t.lm.loss_fn(unflatten_from_paths(leaves), batch)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return tp.reduce_grads(grads), {k: float(v) for k, v in metrics.items()}


def _train(rank, out, name):
    model, mesh_d, seq, ep = TRAIN[name]
    cfg = port_cfg(model)
    weights = dict(np.load(out / f"weights_{model}.npz"))
    mesh = MeshSpec.from_dict(mesh_d)
    root = out / f"ckpt_{name}"
    kw = dict(ckpt_dir=str(root), policy=CheckpointPolicy(save_interval=1000, async_save=False))
    t = Trainer.create(cfg, parallel_for(ep), TC.TrainConfig(), mesh, batch_size=B, seq_len=seq,
                       device="cpu", group=dist.group.WORLD, **(kw if name == RESUME else {}))
    tp = t.lm.tp
    gathered = []
    real = tp_mod.gather_full

    def spy(local, layout, group, members=None):
        gathered.append(next(n for n, lay in tp.layouts.items() if lay is layout))
        return real(local, layout, group, members)

    tp_mod.gather_full = spy
    try:
        state = shard_state(init_state(params_from_reference(weights, t.lm, "cpu")), t.plan, rank)
        grads, first = _grads(t, flatten_with_paths(state.params), t.batch(0))
        keep = {n: g for n, g in grads.items() if n.split(".")[-1] in (
            "router", "a_log", "d_skip", "dt_bias", "ssm_norm", "conv_b", "mlp_norm", "norm")}
        hist = []
        with _Routes() as routes:
            for step in range(STEPS):
                state, m = t.step_fn(state, t.batch(step))
                hist.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
    finally:
        tp_mod.gather_full = real
    res = {"hist": hist, "gathered": sorted(set(gathered)), "sp": tp.sp,
           "ssm_heads": tp.ssm_heads, "moe_mode": tp.moe_mode, "first": first,
           "grads": keep, "routes": routes.idx,
           "split": dict(t.step_fn.split)}
    if name == RESUME:
        res["resume"] = _save_and_resume(rank, t, state, root, cfg, seq)
        t.manager.close()
    return res


def _save_and_resume(rank, t, state, root: Path, cfg, seq: int) -> dict:
    """Each rank saves its shards of step 3 (EP); one process's save of the
    gathered state beside it; then the same ranks resume under expert-TP
    (RESHARD_STREAM) and take step 4."""
    t.manager.save(state, STEPS, block=True)
    full = gather_state(state, t.plan, dist.group.WORLD)
    one = root.parent / f"one_{root.name}"
    if rank == 0:
        write_distributed(snapshot_state(full, t.manager.codec), t.plan, STEPS, one,
                          codec=t.manager.codec, config_fingerprint=t.manager.config_fingerprint)
    dist.barrier()
    a, b = DistCheckpoint.open(t.manager.step_dir(STEPS)), DistCheckpoint.open(one)
    same = a.manifest.shard_digests == b.manifest.shard_digests and a.is_committed
    tgt = Trainer.create(cfg, parallel_for(False), TC.TrainConfig(), t.mesh, batch_size=B,
                         seq_len=seq, device="cpu", group=dist.group.WORLD, ckpt_dir=str(root),
                         policy=CheckpointPolicy(save_interval=1000, async_save=False))
    restored, info = tgt.init_or_restore()
    whole, _ = CheckpointManager(str(root), tgt.plan, policy=CheckpointPolicy(
        save_interval=1000, async_save=False)).restore("cpu")
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
    return {"same_as_one_process": same, "mode": info.mode.value, "step": info.step,
            "moe_mode": tgt.lm.tp.moe_mode, "bits_differing": diff,
            "loss": float(m["loss"]), "aux": float(m["aux"])}


def serving_lm(cfg, mesh, group=None, ep: bool = True):
    """The serve CLI's model and plan for a mesh (expert-TP with ``ep``
    off), in fp32, with its rank context under ``group``."""
    par = dataclasses.replace(serve.serving_parallelism(mesh), expert_parallel=ep)
    lm = build_model(cfg, vocab_multiple=vocab_multiple(par, mesh), compute_dtype=torch.float32,
                     remat="none")
    plan = make_plan(cfg, lm.registry, par, mesh)
    ranks = None
    if group is not None:
        ranks = RankGroups.create(group, plan, par)
        lm.tp = TensorParallel(ranks, cfg)
    return lm, plan, ranks


def _serve(rank, out, name):
    model, mesh_d, ep = SERVE[name]
    cfg = port_cfg(model)
    mesh = MeshSpec.from_dict(mesh_d)
    lm, plan, ranks = serving_lm(cfg, mesh, dist.group.WORLD, ep)
    full = flatten_with_paths(params_from_reference(dict(np.load(out / f"weights_{model}.npz")),
                                                    lm, "cpu"))
    local = {n: slice_shard(x, plan.param_specs[n].layout_for(StateKind.FP32, mesh), rank)
             for n, x in full.items()}
    gathered = []
    real = tp_mod.gather_full

    def spy(local, layout, group, members=None):
        gathered.append(next(n for n, lay in lm.tp.layouts.items() if lay is layout))
        return real(local, layout, group, members)

    tp_mod.gather_full = spy
    try:
        params = unflatten_from_paths(serve.rank_weights(lm, ranks, local))
    finally:
        tp_mod.gather_full = real
    rows = rank_rows(B, ranks.parallel, mesh, rank)
    prompts = torch.from_numpy(_prompts(cfg)[rows]).long()
    cache = D.init_cache(lm, B, PROMPT + GEN)
    with torch.inference_mode():  # the cache after the prefill and GEN - 1 decode steps
        logits, cache = D.prefill(lm, params, cache, prompts)
        cur = D.greedy(lm, logits)[:, None]
        for _ in range(GEN - 1):
            lg, cache = D.decode_step(lm, params, cache, cur)
            cur = D.greedy(lm, lg[:, -1])[:, None]
        logits = lm.tp.gather_vocab(logits, cfg.vocab_size)
    tokens, _, _ = serve.generate(lm, params, prompts, GEN)
    return {"rows": (rows.start, rows.stop), "logits": logits, "tokens": tokens,
            "cache": {n: x.clone() for n, x in flatten_with_paths(cache).items()},
            "gathered": sorted(set(gathered)), "ssm_heads": lm.tp.ssm_heads}


def family_world(rank, out):
    world = dist.get_world_size()
    res = {}
    for name, (_, mesh_d, *_rest) in TRAIN.items():
        if _size(mesh_d) == world:
            res[name] = _train(rank, out, name)
    for name, (_, mesh_d, _) in SERVE.items():
        if _size(mesh_d) == world:
            res[name] = _serve(rank, out, name)
    return res


def rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    import datetime

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    try:
        out = Path(out_dir)
        torch.save(family_world(rank, out), out / f"world{world}_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_world(out: Path, world: int) -> list[dict]:
    """Spawn ``world`` ranks of :func:`family_world`, join them with a
    timeout (killed after it) and load each rank's results."""
    import time

    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, str(out / f"store{world}"), str(out)))
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
    assert not hung, f"ranks {hung} of {world} still running after {JOIN_TIMEOUT_S} s: killed"
    assert [p.exitcode for p in procs] == [0] * world
    return [torch.load(out / f"world{world}_rank{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# the reference and one device


def _ref():
    pytest.importorskip("jax")
    import repro
    import repro.configs
    import repro.core.pytree

    return repro


def ref_cfg(model: str):
    repro = _ref()
    return _variant(repro.configs.reduced(repro.configs.get_config(MODELS[model][0])), model)


def _reference_weights(model: str) -> dict:
    import jax

    repro = _ref()
    from repro.models import build_model as ref_build

    rlm = ref_build(ref_cfg(model), compute_dtype=jax.numpy.float32)
    return {k: np.asarray(v) for k, v in
            repro.core.pytree.flatten_with_paths(rlm.init(jax.random.PRNGKey(0))).items()}


def _reference_steps(model: str, weights: dict, seq: int) -> list:
    """3 steps of the reference's step under plain ``jax.jit``, no mesh."""
    import jax
    import jax.numpy as jnp

    repro = _ref()
    from repro.models import build_model as ref_build
    from repro.train.optimizer import init_state as ref_init_state
    from repro.train.steps import make_train_step as ref_make_step

    rc = repro.configs
    rlm = ref_build(ref_cfg(model), compute_dtype=jnp.float32, remat="none")
    params = repro.core.pytree.unflatten_from_paths({k: jnp.asarray(v) for k, v in weights.items()})
    step = jax.jit(ref_make_step(rlm, rc.TrainConfig(), rc.ParallelismConfig(
        compute_dtype="float32", remat="none")))
    state, hist = ref_init_state(params), []
    for i in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(_global_batch(port_cfg(model), i, seq))})
        hist.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
    return hist


def _single(model: str, weights: dict, seq: int):
    """The single-device port: 4 steps, and the first loss's gradients."""
    cfg = port_cfg(model)
    lm = build_model(cfg, compute_dtype=torch.float32, remat="none")
    params = params_from_reference(weights, lm, "cpu")
    leaves = {n: x.detach().requires_grad_(True) for n, x in flatten_with_paths(params).items()}
    batch = {"tokens": torch.from_numpy(_global_batch(cfg, 0, seq)).long()}
    loss, _ = lm.loss_fn(unflatten_from_paths(leaves), batch)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    step = make_train_step(lm, TC.TrainConfig(), TC.ParallelismConfig(compute_dtype="float32",
                                                                     remat="none"))
    state, hist = init_state(params), []
    with _Routes() as routes:
        for i in range(STEPS + 1):
            state, m = step(state, {"tokens": torch.from_numpy(_global_batch(cfg, i, seq)).long()})
            hist.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
    return {"hist": hist, "grads": grads, "routes": routes.idx}


# ---------------------------------------------------------------------------
# fixtures


@pytest.fixture(scope="module")
def weights():
    return {m: _reference_weights(m) for m in MODELS}


@pytest.fixture(scope="module")
def trajectories(weights):
    """(single-device port, reference hist) by (model, positions a row)."""
    out = {}
    for model, _, seq, _ in TRAIN.values():
        if (model, seq) not in out:
            out[model, seq] = (_single(model, weights[model], seq),
                               _reference_steps(model, weights[model], seq))
    return out


@pytest.fixture(scope="module")
def worlds(weights, tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_family_worlds")
    for model, w in weights.items():
        np.savez(out / f"weights_{model}.npz", **w)
    return out, {2: run_world(out, 2), 4: run_world(out, 4)}


def _ranks(worlds, name):
    _, by_size = worlds
    ranks = by_size[4] if name in by_size[4][0] else by_size[2]
    return [r[name] for r in ranks]


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= REL * max(abs(b), 1e-30)


# ---------------------------------------------------------------------------
# the decisions


def test_tensor_parallel_decisions_of_the_full_configs():
    m2 = MeshSpec.from_dict(M2)
    par = TC.ParallelismConfig()
    for arch in ("mixtral-8x22b", "mamba2-130m", "jamba-1.5-large-398b"):
        assert partitions(TC.get_config(arch), par, m2), arch
        assert partitions(TC.get_config(arch), dataclasses.replace(par, expert_parallel=False),
                          m2), arch
    # mixtral under expert-TP at model=3: 16384 % 3, so the gathered path
    m3 = MeshSpec.from_dict({"data": 1, "model": 3})
    assert not partitions(TC.get_config("mixtral-8x22b"), par, m3)
    assert tp_mod._ssm_split(TC.get_config("mamba2-130m"), 2)      # 12 of 24 heads a rank
    assert not tp_mod._ssm_split(TC.get_config("mamba2-130m"), 16)  # 24 heads over 16
    assert tp_mod._ssm_split(port_cfg("mamba2"), 4)
    assert not tp_mod._ssm_split(port_cfg("mamba2g"), 4)  # 2 heads over 4: gathered


# ---------------------------------------------------------------------------
# the worlds: training


@pytest.mark.parametrize("name", list(TRAIN))
def test_partitioned_families_track_single_device_and_reference(worlds, trajectories, name):
    model, mesh_d, seq, ep = TRAIN[name]
    ranks = _ranks(worlds, name)
    single, ref = trajectories[model, seq]
    cfg = port_cfg(model)
    m = mesh_d["model"]
    for res in ranks:  # every rank logs the single-device value
        assert res["sp"] == (seq % m == 0)
        if cfg.moe is not None:
            assert res["moe_mode"] == ("ep" if ep else "tp")
        for (loss, aux, gn), (l1, a1, g1), (lr, ar, gr) in zip(res["hist"], single["hist"], ref):
            assert _close(loss, l1) and _close(loss, lr), (loss, l1, lr)
            assert _close(aux, a1) and _close(aux, ar), (aux, a1, ar)
            assert _close(gn, g1) and _close(gn, gr), (gn, g1, gr)
        assert res["split"]["tp_s"] > 0 and res["split"]["tp_bytes"] > 0


@pytest.mark.parametrize("name", [n for n, v in TRAIN.items() if v[1]["data"] == 1])
def test_router_and_per_head_scalar_gradients_equal_one_devices(worlds, trajectories, name):
    """The replicated weights each rank reads in part (the router; Mamba's
    a_log, d_skip, dt_bias, ssm_norm, conv_b) and the norms: after
    ``reduce_grads`` every rank's gradient is one device's (data=1)."""
    model, _, seq, _ = TRAIN[name]
    single, _ = trajectories[model, seq]
    for res in _ranks(worlds, name):
        assert res["grads"]
        for n, g in res["grads"].items():
            want = single["grads"][n]
            # fp32 sums in another order (jamba: 8 layers): within 2e-5 of the
            # tensor's largest element; the aux loss counted m times misses by
            # (m - 1) x its share of the router's gradient
            np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=0,
                                       atol=2e-5 * float(want.abs().max()), err_msg=n)


@pytest.mark.parametrize("name", [n for n, v in TRAIN.items() if port_cfg(v[0]).moe is not None])
def test_every_model_rank_routes_as_one_device(worlds, trajectories, name):
    model, mesh_d, seq, _ = TRAIN[name]
    ranks = _ranks(worlds, name)
    single, _ = trajectories[model, seq]
    m = mesh_d["model"]
    for r, res in enumerate(ranks):
        peer = ranks[r - r % m]  # the first rank of this model group
        assert len(res["routes"]) == len(peer["routes"]) > 0
        for a, b in zip(res["routes"], peer["routes"]):
            assert torch.equal(a, b)
    if mesh_d["data"] == 1:  # the whole batch on every rank: one device's experts
        for a, b in zip(ranks[0]["routes"], single["routes"]):
            assert torch.equal(a, b)


def _want_gathered(cfg, mesh_d, names) -> set:
    m = mesh_d["model"]
    leaves = set()
    if cfg.num_heads % m or cfg.num_kv_heads % m:
        if cfg.family != "ssm":
            leaves |= {"wqkv", "wo"}
    if cfg.ssm is not None:
        leaves |= {"conv_w"} if tp_mod._ssm_split(cfg, m) else {"in_proj", "conv_w", "out_proj"}
    return {n for n in names if n.split(".")[-1] in leaves}


@pytest.mark.parametrize("name", list(TRAIN))
def test_ranks_gather_only_what_the_design_gathers(worlds, weights, name):
    """Over the model axis a rank gathers the attention weights whose heads
    do not divide it, Mamba's ``conv_w`` (a few kB) where the SSM heads
    split and the whole block's weights where they do not: never an
    expert's, ``in_proj`` or ``out_proj`` where they split."""
    model, mesh_d, _, _ = TRAIN[name]
    cfg = port_cfg(model)
    want = _want_gathered(cfg, mesh_d, weights[model])
    for res in _ranks(worlds, name):
        assert set(res["gathered"]) == want
        if tp_mod._ssm_split(cfg, mesh_d["model"]) or cfg.ssm is None:
            assert not any(n.split(".")[-1] in ("we_gate", "we_up", "we_down", "in_proj",
                                                "out_proj") for n in res["gathered"])


def test_ep_save_equals_one_process_and_resumes_under_expert_tp(worlds, trajectories):
    single, _ = trajectories["mixtral", 32]
    for res in _ranks(worlds, RESUME):
        rs = res["resume"]
        assert rs["same_as_one_process"]
        assert rs["mode"] == "reshard_stream" and rs["step"] == STEPS
        assert rs["moe_mode"] == "tp"
        assert rs["bits_differing"] == 0
        loss, aux, _ = single["hist"][STEPS]
        assert _close(rs["loss"], loss) and _close(rs["aux"], aux)


# ---------------------------------------------------------------------------
# the worlds: serving


@pytest.mark.parametrize("name", list(SERVE))
def test_partitioned_family_serving_equals_one_process(worlds, weights, name):
    model, mesh_d, ep = SERVE[name]
    out, _ = worlds
    cfg = port_cfg(model)
    mesh = MeshSpec.from_dict(mesh_d)
    lm, _, _ = serving_lm(cfg, mesh, ep=ep)
    params = params_from_reference(weights[model], lm, "cpu")
    prompts = torch.from_numpy(_prompts(cfg)).long()
    with torch.inference_mode():
        logits, _ = D.prefill(lm, params, D.init_cache(lm, B, PROMPT + GEN), prompts)
    tokens, _, _ = serve.generate(lm, params, prompts, GEN)
    shapes = D.init_cache(lm, B, PROMPT + GEN, device="meta")
    specs = flatten_with_paths(cache_pspecs(shapes, serve.serving_parallelism(mesh), mesh))
    full = flatten_with_paths(shapes)
    gathered_ssm = cfg.ssm is not None and not tp_mod._ssm_split(cfg, mesh_d["model"])
    for res in _ranks(worlds, name):
        lo, hi = res["rows"]
        np.testing.assert_allclose(res["logits"].numpy(), logits[lo:hi].numpy(), atol=1e-4)
        assert torch.equal(res["tokens"], tokens[lo:hi])
        assert res["ssm_heads"] == (cfg.ssm is not None and not gathered_ssm)
        assert set(res["gathered"]) == _want_gathered(cfg, mesh_d, full_names(lm))
        for path, x in res["cache"].items():
            spec = specs[path]
            if gathered_ssm and path.split(".")[-1] in ("h", "conv"):
                spec = tuple(None if e == "model" else e for e in spec)
            assert tuple(x.shape) == local_shape(tuple(full[path].shape), spec, mesh), path
    for path in res["cache"]:  # the SSM state's model split, where the heads split
        if path.split(".")[-1] == "h" and not gathered_ssm:
            assert res["cache"][path].shape[2] * mesh_d["model"] == full[path].shape[2]


def full_names(lm) -> list[str]:
    return [d.path for d in lm.registry]


def test_mamba_rank_cache_holds_its_cache_pspecs_values(worlds, weights):
    """Beyond the shapes: after prefill and decode, each rank's ``h`` and
    ``conv`` entries are its ``cache_pspecs`` slices of one process's."""
    name = "serve_mamba2_m4"
    model, mesh_d, _ = SERVE[name]
    cfg = port_cfg(model)
    mesh = MeshSpec.from_dict(mesh_d)
    lm, _, _ = serving_lm(cfg, mesh)
    params = params_from_reference(weights[model], lm, "cpu")
    prompts = torch.from_numpy(_prompts(cfg)).long()
    cache = D.init_cache(lm, B, PROMPT + GEN)
    with torch.inference_mode():
        logits, cache = D.prefill(lm, params, cache, prompts)
        cur = logits.argmax(-1)[:, None]
        for _ in range(GEN - 1):
            lg, cache = D.decode_step(lm, params, cache, cur)
            cur = lg[:, -1].argmax(-1)[:, None]
    whole = flatten_with_paths(cache)
    for c, res in enumerate(_ranks(worlds, name)):
        for path in ("layers.blk.h", "layers.blk.conv"):
            dim = 2 if path.endswith("h") else 3
            n = whole[path].shape[dim] // mesh_d["model"]
            want = whole[path].narrow(dim, c * n, n)
            np.testing.assert_allclose(res["cache"][path].numpy(), want.numpy(), atol=1e-4,
                                       err_msg=path)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "mamba2-130m", "jamba-1.5-large-398b"])
def test_serve_cli_on_two_ranks_equals_one_process(tmp_path, arch):
    """``--host-devices 2 --mesh data=1,model=2`` on a checkpoint the train
    CLI wrote under data=1,model=2 (DIRECT on every rank), the CLI's bf16
    compute, against one process under the same mesh."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    ckpt = tmp_path / "ckpt"
    train = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--reduced",
             "--device", "cpu", "--mesh", "data=1,model=2", "--steps", "1", "--batch", "2",
             "--seq", "16", "--ckpt-dir", str(ckpt), "--save-interval", "1"]
    run = subprocess.run(train, capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--reduced",
            "--device", "cpu", "--ckpt-dir", str(ckpt), "--batch", "2", "--prompt-len", "16",
            "--gen", "4", "--mesh", "data=1,model=2"]
    recs = []
    for extra in ([], ["--host-devices", "2"]):
        run = subprocess.run(base + extra, capture_output=True, text=True, env=env, timeout=300)
        assert run.returncode == 0, run.stderr[-2000:]
        recs.append(json.loads(run.stdout.strip().splitlines()[-1]))
    one, two = recs
    assert one["mode"] == two["mode"] == "direct"
    assert (one["ranks"], two["ranks"]) == (1, 2)
    assert two["tokens"] == one["tokens"] and len(one["tokens"]) == 2
