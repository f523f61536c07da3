"""Tensor- and sequence-parallel compute and multi-rank serving of the port,
on the CPU, held against the JAX package and the single-device port.

* ``make_sharder``: the port's PartitionSpec for every activation the
  reference constrains (its ``LM.shard`` call sites in the forward and the
  decode step, traced once per arch with a recording hook) equals the one
  the reference's ``make_sharder`` builds on an ``AbstractMesh`` (captured
  by replacing ``jax.lax.with_sharding_constraint``), for reduced smollm,
  gpt3, gemma3, minitron, mixtral, mamba2 and jamba (the MoE, SSM and
  hybrid families compute partitioned too, ``tests/test_torch_tensor_
  parallel_families.py``) at data=1,model=2, data=2,model=2 and
  data=1,model=4 with tensor and sequence parallelism each on and off; and
  the port's ``LM.shard`` hook sees the reference's (shape, axes) set;
* ``cache_pspecs``: equal to the reference's on both packages' ``init_cache``
  trees (every family's cache leaves), ``shard_cache_seq`` on and off;
* two gloo worlds spawned once per module (:func:`run_world`, as
  ``tests/test_torch_multirank.py`` spawns its own): 2 ranks at data=1,model=2 and 4 ranks
  at data=2,model=2 and data=1,model=4, reduced smollm (6:2 heads), gpt3
  (2:2) and smollm at its own 15:5 heads with a narrow head dim (the card's
  smollm case: attention by query rows), fp32 over 3 steps of 4 rows of 32
  positions (33 tokens: 32 split over 2 and 4, so the stream is
  seq-sharded), remat ``none`` (and one ``full``; and two of 33 positions,
  which do not split: attention by heads, and replicated, with a
  replicated stream): losses and gradient norms within 1e-5 relative
  of the single-device port and of the reference's jitted step, the
  gathered weights within 3.6e-4 of the single device's; a spy on
  ``gather_full`` shows that a rank gathers over the model axis only the
  attention weights whose heads do not divide it;
* serving in those worlds (fp32): prefill logits within 1e-4 of one
  process's, the same greedy tokens, each rank's decode cache its
  ``cache_pspecs`` shard; the rank-aware weights-only restore reads only
  the rank's regions (RESHARD_STREAM and DIRECT);
* the serve CLI under ``--host-devices 2`` gives one process's tokens;
* ``q_offset``: the flash wrapper's plain version and ``full_attention``
  equal the reference's ``full_attention``.

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
from repro_torch import obs  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.ckpt.policy import CheckpointPolicy  # noqa: E402
from repro_torch.core.dist_ckpt import DistCheckpoint  # noqa: E402
from repro_torch.core.layout import MeshSpec, slice_shard  # noqa: E402
from repro_torch.core.patterns import StateKind  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths  # noqa: E402
from repro_torch.dist.sharding import (  # noqa: E402
    PartitionSpec, RankGroups, cache_pspecs, local_shape, make_plan, make_sharder, rank_rows,
    vocab_multiple,
)
from repro_torch.dist.tensor_parallel import TensorParallel, partitions  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models.attention import full_attention  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train.optimizer import init_state  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, gather_state, shard_state  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
B, STEPS, REL = 4, 3, 1e-5
PROMPT, GEN = 8, 4

# model variants: (arch, (hq, hkv, head_dim) or None for the reduced config's)
MODELS = {"smollm": ("smollm-360m", None), "gpt3": ("gpt3-350m", None),
          "smollm15": ("smollm-360m", (15, 5, 8))}
# train scenarios: (model, mesh, positions a row (seq_len; a row holds one
# more token), remat, the attention branch); 32 positions split over the
# model axis (sequence parallelism), 33 do not
TRAIN = {
    "smollm_m2": ("smollm", {"data": 1, "model": 2}, 32, "none", "heads"),
    "gpt3_m2": ("gpt3", {"data": 1, "model": 2}, 32, "none", "heads"),
    "gpt3_m2_nosp": ("gpt3", {"data": 1, "model": 2}, 33, "none", "heads"),
    "smollm15_m2": ("smollm15", {"data": 1, "model": 2}, 32, "none", "rows"),
    "smollm15_m2_full": ("smollm15", {"data": 1, "model": 2}, 32, "full", "rows"),
    "smollm15_m2_nosp": ("smollm15", {"data": 1, "model": 2}, 33, "none", "replicated"),
    "smollm_d2m2": ("smollm", {"data": 2, "model": 2}, 32, "none", "heads"),
    "gpt3_d2m2": ("gpt3", {"data": 2, "model": 2}, 32, "none", "heads"),
    "smollm_m4": ("smollm", {"data": 1, "model": 4}, 32, "none", "rows"),
    "gpt3_m4": ("gpt3", {"data": 1, "model": 4}, 32, "none", "rows"),
}
# serve scenarios: (model, mesh)
SERVE = {
    "serve_smollm15_m2": ("smollm15", {"data": 1, "model": 2}),
    "serve_gpt3_m2": ("gpt3", {"data": 1, "model": 2}),
    "serve_smollm_m4": ("smollm", {"data": 1, "model": 4}),
    "serve_gpt3_d2m2": ("gpt3", {"data": 2, "model": 2}),
}
# the module's checkpoint is smollm's weights saved under data=1,model=2
CKPT_MESH = {"data": 1, "model": 2}
RESTORE_MESHES = {"direct": CKPT_MESH, "reshard_stream": {"data": 2, "model": 1}}
JOIN_TIMEOUT_S = 240


def _size(mesh_d) -> int:
    return int(np.prod(list(mesh_d.values())))


def port_cfg(model: str) -> TC.ModelConfig:
    arch, heads = MODELS[model]
    cfg = TC.reduced(TC.get_config(arch))
    if heads:
        cfg = dataclasses.replace(cfg, num_heads=heads[0], num_kv_heads=heads[1],
                                  head_dim=heads[2])
    return cfg


def parallel_for(remat="none", **kw) -> TC.ParallelismConfig:
    return TC.ParallelismConfig(data_axes=("data",), model_axis="model",
                                compute_dtype="float32", remat=remat, **kw)


def _global_batch(cfg, step: int, seq: int) -> np.ndarray:
    return tdata.batch_for_step(cfg, TC.ShapeSpec("train", seq, B, "train"), step, seed=0,
                                batch_override=B, seq_override=seq)["tokens"]


def _prompts(cfg) -> np.ndarray:
    return np.random.default_rng(5).integers(0, cfg.vocab_size, (B, PROMPT))


# ---------------------------------------------------------------------------
# the ranks


def _train(rank, out, name, device="cpu"):
    model, mesh_d, seq, remat, _ = TRAIN[name]
    cfg = port_cfg(model)
    weights = dict(np.load(out / f"weights_{model}.npz"))
    mesh = MeshSpec.from_dict(mesh_d)
    t = Trainer.create(cfg, parallel_for(remat), TC.TrainConfig(), mesh, batch_size=B,
                       seq_len=seq, device=device, group=dist.group.WORLD)
    gathered, offsets = [], set()
    real = tp_mod.gather_full

    def spy(local, layout, group, members=None):
        gathered.append(next(n for n, lay in t.lm.tp.layouts.items() if lay is layout))
        return real(local, layout, group, members)

    attention = t.lm._attention

    def attention_spy(q, k, v, **kw):
        offsets.add((q.shape[1], k.shape[1], kw.get("q_offset", 0)))
        return attention(q, k, v, **kw)

    t.lm._attention = attention_spy
    tp_mod.gather_full = spy
    try:
        state = shard_state(init_state(params_from_reference(weights, t.lm, device)), t.plan,
                            rank)
        hist, splits = [], []
        for step in range(STEPS):
            state, m = t.step_fn(state, t.batch(step))
            hist.append((float(m["loss"]), float(m["grad_norm"])))
            splits.append(dict(t.step_fn.split))
    finally:
        tp_mod.gather_full = real
    final = gather_state(state, t.plan, dist.group.WORLD)
    return {"hist": hist, "gathered": sorted(set(gathered)), "splits": splits,
            "heads": t.lm.tp.heads, "sp": t.lm.tp.sp,
            "attention": sorted(offsets),
            "final": {n: x.cpu() for n, x in flatten_with_paths(final.params).items()}
            if rank == 0 else None}


def serving_lm(cfg, mesh, group=None):
    """The serve CLI's model and plan for a mesh, in fp32, with its rank
    context under ``group``."""
    par = serve.serving_parallelism(mesh)
    lm = build_model(cfg, vocab_multiple=vocab_multiple(par, mesh), compute_dtype=torch.float32,
                     remat="none")
    plan = make_plan(cfg, lm.registry, par, mesh)
    ranks = None
    if group is not None:
        ranks = RankGroups.create(group, plan, par)
        lm.tp = TensorParallel(ranks, cfg)
    return lm, plan, ranks


def _serve(rank, out, name, device="cpu"):
    model, mesh_d = SERVE[name]
    cfg = port_cfg(model)
    mesh = MeshSpec.from_dict(mesh_d)
    lm, plan, ranks = serving_lm(cfg, mesh, dist.group.WORLD)
    full = flatten_with_paths(params_from_reference(dict(np.load(out / f"weights_{model}.npz")),
                                                    lm, device))
    local = {n: slice_shard(x, plan.param_specs[n].layout_for(StateKind.FP32, mesh), rank)
             for n, x in full.items()}
    params = unflatten_from_paths(serve.rank_weights(lm, ranks, local))
    rows = rank_rows(B, ranks.parallel, mesh, rank)
    prompts = torch.from_numpy(_prompts(cfg)[rows]).long().to(device)
    cache = D.init_cache(lm, B, PROMPT + GEN, device=device)
    shapes = {n: tuple(x.shape) for n, x in flatten_with_paths(cache).items()}
    launches = flash_attention.launches
    with torch.inference_mode():
        logits, _ = D.prefill(lm, params, cache, prompts)
        logits = lm.tp.gather_vocab(logits, cfg.vocab_size)
    launches = flash_attention.launches - launches
    tokens, _, _ = serve.generate(lm, params, prompts, GEN)
    return {"rows": (rows.start, rows.stop), "logits": logits.cpu(), "tokens": tokens.cpu(),
            "cache": shapes, "flash_launches": launches}


def _restore(rank, out, mode):
    """The serve CLI's weights-only restore of the module's checkpoint by
    this rank: the regions it read (bytes, and under DIRECT the files)."""
    mesh = MeshSpec.from_dict(RESTORE_MESHES[mode])
    _, plan, _ = serving_lm(port_cfg("smollm"), mesh)
    ranks = RankGroups.create(dist.group.WORLD, plan, serve.serving_parallelism(mesh))
    opened = []
    real = DistCheckpoint.read_shard

    def spy(self, r, name, kind, **kw):
        opened.append((r, name, kind.value))
        return real(self, r, name, kind, **kw)

    DistCheckpoint.read_shard = spy
    try:
        with obs.enabled() as tracer:
            flat, rp = serve.restore_params(serve.latest_step_dir(out / "ckpt"), plan, "cpu",
                                            rank=ranks.rank, group=dist.group.WORLD)
    finally:
        DistCheckpoint.read_shard = real
    return {"mode": rp.mode.value, "bytes_read": tracer.counters()["restore.bytes_read"],
            "opened": sorted(set(opened)), "flat": flat}


def tp_world(rank, out, device="cpu", names=None):
    """The scenarios of this world's size (or ``names``) on ``device``."""
    world = dist.get_world_size()
    res = {}
    for name, (_, mesh_d, *_rest) in TRAIN.items():
        if _size(mesh_d) == world and (names is None or name in names):
            res[name] = _train(rank, out, name, device)
    for name, (_, mesh_d) in SERVE.items():
        if _size(mesh_d) == world and (names is None or name in names):
            res[name] = _serve(rank, out, name, device)
    if world == 2 and names is None:
        for mode in RESTORE_MESHES:
            res[f"restore_{mode}"] = _restore(rank, out, mode)
    return res


def rank_main(rank: int, world: int, store: str, out_dir: str, device: str = "cpu",
              names=None) -> None:
    import datetime

    torch.set_num_threads(1)
    if device != "cpu":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    try:
        out = Path(out_dir)
        torch.save(tp_world(rank, out, device, names), out / f"world{world}_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_world(out: Path, world: int, device: str = "cpu", names=None) -> list[dict]:
    """Spawn ``world`` ranks of :func:`tp_world`, join them with a timeout
    (killed after it) and load each rank's results."""
    import time

    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, str(out / f"store{world}"), str(out), device, names))
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
# the reference


def _ref():
    pytest.importorskip("jax")
    import repro
    import repro.configs
    import repro.core.pytree
    import repro.dist.sharding
    import repro.models.decode

    return repro


def ref_cfg(model: str):
    repro = _ref()
    arch, heads = MODELS[model]
    cfg = repro.configs.reduced(repro.configs.get_config(arch))
    if heads:
        cfg = dataclasses.replace(cfg, num_heads=heads[0], num_kv_heads=heads[1],
                                  head_dim=heads[2])
    return cfg


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
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return hist


def _single(model: str, weights: dict, seq: int):
    cfg = port_cfg(model)
    lm = build_model(cfg, compute_dtype=torch.float32, remat="none")
    step = make_train_step(lm, TC.TrainConfig(), TC.ParallelismConfig(compute_dtype="float32",
                                                                     remat="none"))
    state, hist = init_state(params_from_reference(weights, lm, "cpu")), []
    for i in range(STEPS):
        state, m = step(state, {"tokens": torch.from_numpy(_global_batch(cfg, i, seq)).long()})
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return state, hist


# ---------------------------------------------------------------------------
# fixtures


@pytest.fixture(scope="module")
def weights():
    return {m: _reference_weights(m) for m in MODELS}


@pytest.fixture(scope="module")
def trajectories(weights):
    """(single-device state and hist, reference hist) by (model, tokens a row)."""
    out = {}
    for model, _, seq, _, _ in TRAIN.values():
        if (model, seq) not in out:
            out[model, seq] = (_single(model, weights[model], seq),
                               _reference_steps(model, weights[model], seq))
    return out


@pytest.fixture(scope="module")
def worlds(weights, tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_worlds")
    for model, w in weights.items():
        np.savez(out / f"weights_{model}.npz", **w)
    # a checkpoint of smollm's weights for the restores
    lm, plan, _ = serving_lm(port_cfg("smollm"), MeshSpec.from_dict(CKPT_MESH))
    mgr = CheckpointManager(out / "ckpt", plan, policy=CheckpointPolicy(async_save=False))
    mgr.save(init_state(params_from_reference(weights["smollm"], lm, "cpu")), 1, block=True)
    mgr.close()
    return out, {2: run_world(out, 2), 4: run_world(out, 4)}


def _ranks(worlds, name):
    _, by_size = worlds
    ranks = by_size[4] if name in by_size[4][0] else by_size[2]
    return [r[name] for r in ranks]


# ---------------------------------------------------------------------------
# make_sharder and the hook's call sites


SHARDER_ARCHS = ["smollm-360m", "gpt3-350m", "gemma3-12b", "minitron-8b", "mixtral-8x22b",
                 "mamba2-130m", "jamba-1.5-large-398b"]
SHARDER_MESHES = [{"data": 1, "model": 2}, {"data": 2, "model": 2}, {"data": 1, "model": 4}]
FLAGS = [(True, True), (True, False), (False, True), (False, False)]
_CALLS: dict = {}


def reference_calls(arch: str) -> list:
    """The (shape, logical axes) of every ``LM.shard`` call of the
    reference's forward and decode step (B 4, S 32), traced once."""
    if arch not in _CALLS:
        import jax
        import jax.numpy as jnp

        repro = _ref()
        from repro.models import build_model as ref_build

        calls = []

        def rec(x, axes):
            calls.append((tuple(x.shape), tuple(axes)))
            return x

        rlm = ref_build(repro.configs.reduced(repro.configs.get_config(arch)), shard=rec,
                        remat="none")
        params = jax.eval_shape(rlm.init, jax.random.PRNGKey(0))
        tokens = jax.ShapeDtypeStruct((4, 32), jnp.int32)
        jax.eval_shape(lambda p, t: rlm.forward(p, t), params, tokens)
        cache = jax.eval_shape(lambda: repro.models.decode.init_cache(rlm, 4, 40))
        jax.eval_shape(lambda p, c, t: repro.models.decode.decode_step(rlm, p, c, t), params,
                       cache, jax.ShapeDtypeStruct((4, 1), jnp.int32))
        _CALLS[arch] = calls
    return _CALLS[arch]


@pytest.mark.parametrize("tp_on,sp_on", FLAGS, ids=[f"tp{int(a)}-sp{int(b)}" for a, b in FLAGS])
@pytest.mark.parametrize("mesh_d", SHARDER_MESHES,
                         ids=[",".join(f"{k}={v}" for k, v in m.items()) for m in SHARDER_MESHES])
@pytest.mark.parametrize("arch", SHARDER_ARCHS)
def test_make_sharder_equals_the_reference_at_every_call_site(monkeypatch, arch, mesh_d,
                                                              tp_on, sp_on):
    import jax
    from jax.sharding import AbstractMesh

    repro = _ref()
    kw = dict(data_axes=("data",), tensor_parallel=tp_on, sequence_parallel=sp_on)
    rshard = repro.dist.sharding.make_sharder(
        repro.configs.ParallelismConfig(**kw),
        AbstractMesh(tuple(mesh_d.values()), tuple(mesh_d)))
    pshard = make_sharder(TC.ParallelismConfig(**kw), MeshSpec.from_dict(mesh_d))
    got = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, sharding: got.append(tuple(sharding.spec)) or x)
    calls = reference_calls(arch)
    # q, the block outputs, the embedded input, logits, decode (mamba2 has no q)
    assert len(calls) >= (4 if arch == "mamba2-130m" else 6)
    claimed = 0
    for shape, axes in calls:
        got.clear()
        rshard(jax.ShapeDtypeStruct(shape, jax.numpy.float32), axes)
        want = tuple(got[0]) if got else (None,) * len(shape)
        want = want + (None,) * (len(shape) - len(want))
        spec = pshard(shape, axes)
        assert isinstance(spec, PartitionSpec)
        assert tuple(spec) == want, (shape, axes)
        claimed += any(e == "model" for e in want)
    assert claimed or not (tp_on or sp_on)


@pytest.mark.parametrize("arch", SHARDER_ARCHS)
def test_port_calls_the_hook_at_the_reference_call_sites(arch):
    calls = []

    def rec(x, axes):
        calls.append((tuple(x.shape), tuple(axes)))
        return x

    lm = build_model(TC.reduced(TC.get_config(arch)), compute_dtype=torch.float32, remat="none",
                     shard=rec)
    params = lm.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((4, 32), dtype=torch.long)
    with torch.no_grad():
        lm.forward(params, tokens)
        D.decode_step(lm, params, D.init_cache(lm, 4, 40), tokens[:, :1])
    assert set(calls) == set(reference_calls(arch))


def test_partitioned_compute_is_the_dense_family_under_tp():
    """Under tensor parallelism with a model axis every family partitions:
    the dense family, MoE (EP and expert-TP), the SSM and the hybrid
    families, and since the MLA, vlm and encdec slice those three too; a
    pipe axis beside the model axis partitions too (each stage's model
    ranks, ``dist.pipeline``), and with TP off every family computes by
    sequence rows while sequence parallelism is on; a run with no model
    axis, or with TP and SP both off, keeps the gathered path."""
    m22 = MeshSpec.from_dict({"data": 2, "model": 2})
    par = TC.ParallelismConfig()
    rows_only = TC.ParallelismConfig(tensor_parallel=False)
    neither = TC.ParallelismConfig(tensor_parallel=False, sequence_parallel=False)
    assert partitions(TC.get_config("smollm-360m"), par, m22)
    assert partitions(TC.get_config("smollm-360m"), rows_only, m22)
    assert not partitions(TC.get_config("smollm-360m"), neither, m22)
    assert not partitions(TC.get_config("smollm-360m"), par, MeshSpec.from_dict(
        {"data": 4, "model": 1}))
    assert partitions(TC.get_config("smollm-360m"), TC.ParallelismConfig(pipe_axis="pipe"),
                      MeshSpec.from_dict({"pipe": 2, "data": 1, "model": 2}))
    for arch in ("mixtral-8x22b", "mamba2-130m", "jamba-1.5-large-398b", "deepseek-v2-236b"):
        assert partitions(TC.get_config(arch), par, m22), arch
        assert partitions(TC.get_config(arch), TC.ParallelismConfig(expert_parallel=False),
                          m22), arch
        assert partitions(TC.get_config(arch), rows_only, m22), arch
        assert not partitions(TC.get_config(arch), neither, m22), arch
    for arch in ("llama-3.2-vision-11b", "whisper-tiny"):
        assert partitions(TC.get_config(arch), par, m22), arch
        assert partitions(TC.get_config(arch), rows_only, m22), arch
        assert not partitions(TC.get_config(arch), neither, m22), arch


# ---------------------------------------------------------------------------
# cache_pspecs


CACHE_ARCHS = ["smollm-360m", "gpt3-350m", "gemma3-12b", "minitron-8b", "mixtral-8x22b",
               "deepseek-v2-236b", "mamba2-130m", "jamba-1.5-large-398b",
               "llama-3.2-vision-11b", "whisper-tiny"]
_CACHES: dict = {}


def caches(arch: str):
    """Both packages' decode caches of reduced ``arch`` (B 4, 24 slots)."""
    if arch not in _CACHES:
        repro = _ref()
        from repro.models import build_model as ref_build

        rlm = ref_build(repro.configs.reduced(repro.configs.get_config(arch)))
        tlm = build_model(TC.reduced(TC.get_config(arch)))
        _CACHES[arch] = (repro.models.decode.init_cache(rlm, 4, 24),
                         D.init_cache(tlm, 4, 24, device="meta"))
    return _CACHES[arch]


@pytest.mark.parametrize("seq_cache", [False, True], ids=["replicate", "shard_cache_seq"])
@pytest.mark.parametrize("mesh_d", SHARDER_MESHES,
                         ids=[",".join(f"{k}={v}" for k, v in m.items()) for m in SHARDER_MESHES])
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_pspecs_equal_the_reference(arch, mesh_d, seq_cache):
    repro = _ref()
    rtree, ttree = caches(arch)
    kw = dict(data_axes=("data",), shard_cache_seq=seq_cache)
    want = repro.core.pytree.flatten_with_paths(repro.dist.sharding.cache_pspecs(
        rtree, repro.configs.ParallelismConfig(**kw), repro.core.MeshSpec.from_dict(mesh_d)))
    par, mesh = TC.ParallelismConfig(**kw), MeshSpec.from_dict(mesh_d)
    for tree in (ttree, rtree):  # the port's rule on both packages' trees
        got = flatten_with_paths(cache_pspecs(tree, par, mesh))
        assert set(got) == set(want)
        for path, spec in want.items():
            assert tuple(got[path]) == tuple(spec), path
    assert {tuple(x.shape) for x in flatten_with_paths(ttree).values()} == {
        tuple(x.shape) for x in repro.core.pytree.flatten_with_paths(rtree).values()}


# ---------------------------------------------------------------------------
# the worlds: training


@pytest.mark.parametrize("name", list(TRAIN))
def test_partitioned_steps_track_single_device_and_reference(worlds, trajectories, name):
    model, mesh_d, seq, _, branch = TRAIN[name]
    ranks = _ranks(worlds, name)
    (state1, hist1), ref = trajectories[model, seq]
    m = mesh_d["model"]
    for r, res in enumerate(ranks):  # every rank logs the single-device value
        assert res["heads"] == (branch == "heads")
        assert res["sp"] == (seq % m == 0)
        c, n = r % m, seq // m  # the rank's model coordinate and rows
        want = {"heads": {(seq, seq, 0)}, "replicated": {(seq, seq, 0)},
                "rows": {(n, (c + 1) * n, c * n)}}[branch]
        assert set(map(tuple, res["attention"])) == want, (r, res["attention"])
        for (loss, gn), (l1, g1), (lr, gr) in zip(res["hist"], hist1, ref, strict=True):
            assert abs(loss - l1) <= REL * abs(l1) and abs(loss - lr) <= REL * abs(lr)
            assert abs(gn - g1) <= REL * abs(g1) and abs(gn - gr) <= REL * abs(gr)
        for split in res["splits"]:
            assert split["tp_s"] > 0 and split["tp_bytes"] > 0
            assert {"gather_s", "grad_s", "all_reduce_s", "update_s"} <= set(split)
    # the gathered weights: the single device's, but for AdamW's sign flips
    # of gradients within rounding of 0 (tests/test_torch_train.py)
    for n, want in flatten_with_paths(state1.params).items():
        np.testing.assert_allclose(ranks[0]["final"][n].numpy(), want.numpy(), atol=3.6e-4,
                                   err_msg=n)


@pytest.mark.parametrize("name", list(TRAIN))
def test_ranks_gather_only_weights_they_do_not_compute(worlds, name):
    """Over the model axis a rank gathers nothing when the heads divide it
    (gpt3, smollm's reduced 6:2 at model=2) and only the attention weights
    when they do not (smollm at 15:5, and 6:2 or 2:2 at model=4): never the
    MLP's or the vocab's."""
    _, _, _, _, branch = TRAIN[name]
    want = [] if branch == "heads" else ["layers.blk.wo", "layers.blk.wqkv"]
    for res in _ranks(worlds, name):
        assert res["gathered"] == want


# ---------------------------------------------------------------------------
# the worlds: serving


@pytest.mark.parametrize("name", list(SERVE))
def test_partitioned_serving_equals_one_process(worlds, name):
    model, mesh_d = SERVE[name]
    out, _ = worlds
    cfg = port_cfg(model)
    mesh = MeshSpec.from_dict(mesh_d)
    lm, _, _ = serving_lm(cfg, mesh)
    params = params_from_reference(dict(np.load(out / f"weights_{model}.npz")), lm, "cpu")
    prompts = torch.from_numpy(_prompts(cfg)).long()
    with torch.inference_mode():
        logits, _ = D.prefill(lm, params, D.init_cache(lm, B, PROMPT + GEN), prompts)
    tokens, _, _ = serve.generate(lm, params, prompts, GEN)
    specs = flatten_with_paths(cache_pspecs(D.init_cache(lm, B, PROMPT + GEN, device="meta"),
                                            serve.serving_parallelism(mesh), mesh))
    full = flatten_with_paths(D.init_cache(lm, B, PROMPT + GEN, device="meta"))
    for res in _ranks(worlds, name):
        lo, hi = res["rows"]
        np.testing.assert_allclose(res["logits"].numpy(), logits[lo:hi].numpy(), atol=1e-4)
        assert torch.equal(res["tokens"], tokens[lo:hi])
        for path, shape in res["cache"].items():
            assert shape == local_shape(tuple(full[path].shape), specs[path], mesh), path
    k = res["cache"]["layers.blk.k"]
    heads_split = cfg.num_kv_heads % mesh_d["model"] == 0
    assert k[3] == cfg.num_kv_heads // (mesh_d["model"] if heads_split else 1)


@pytest.mark.parametrize("mode", list(RESTORE_MESHES))
def test_rank_restore_reads_only_its_own_regions(worlds, mode):
    out, _ = worlds
    ranks = _ranks(worlds, f"restore_{mode}")
    mesh = MeshSpec.from_dict(RESTORE_MESHES[mode])
    _, plan, _ = serving_lm(port_cfg("smollm"), mesh)
    flat, _ = serve.restore_params(serve.latest_step_dir(out / "ckpt"), plan, "cpu")
    for r, res in enumerate(ranks):
        assert res["mode"] == mode
        shard_bytes = 0
        for n, spec in plan.param_specs.items():
            layout = spec.layout_for(StateKind.FP32, mesh)
            assert torch.equal(res["flat"][n], slice_shard(flat[n], layout, r)), n
            shard_bytes += 4 * sum(int(np.prod([b - a for a, b in e.shard_slice]))
                                   for e in layout.entries[r])
        assert res["bytes_read"] == shard_bytes
        if mode == "direct":  # the files of the rank's own fragments (a replica's primary's)
            want = set()
            for n, spec in plan.param_specs.items():
                layout = spec.layout_for(StateKind.FP32, mesh)
                want.add((layout.ranks_for_fragment(layout.fragment_id[r])[0], n, "fp32"))
            assert set(res["opened"]) == want


def test_serve_cli_on_two_ranks_equals_one_process(worlds):
    """``--host-devices 2 --mesh data=1,model=2`` from the module's
    checkpoint (DIRECT on every rank, each reading its own shards), the
    CLI's bf16 compute, against one process under the same mesh."""
    out, _ = worlds
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "smollm-360m",
            "--reduced", "--device", "cpu", "--ckpt-dir", str(out / "ckpt"), "--batch", "4",
            "--prompt-len", "16", "--gen", "6", "--mesh", "data=1,model=2"]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    recs = []
    for extra in ([], ["--host-devices", "2"]):
        run = subprocess.run(base + extra, capture_output=True, text=True, env=env, timeout=300)
        assert run.returncode == 0, run.stderr[-2000:]
        recs.append(json.loads(run.stdout.strip().splitlines()[-1]))
    one, two = recs
    assert one["mode"] == two["mode"] == "direct"
    assert (one["ranks"], two["ranks"]) == (1, 2)
    assert two["tokens"] == one["tokens"] and len(one["tokens"]) == 4


def test_serve_cli_host_devices_must_be_the_mesh_size():
    with pytest.raises(SystemExit, match="one rank per mesh position"):
        serve.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                    "--host-devices", "3", "--mesh", "data=1,model=2"])


# ---------------------------------------------------------------------------
# q_offset


QOFF = [(8, 16, 8, True, 0), (8, 16, 8, True, 5), (4, 16, 12, True, 0), (6, 10, 3, False, 0),
        (8, 24, 16, True, 4)]


@pytest.mark.parametrize("sq,skv,off,causal,window", QOFF)
def test_q_offset_equals_the_reference_full_attention(sq, skv, off, causal, window):
    import jax.numpy as jnp

    _ref()
    from repro.models.attention import full_attention as ref_full

    rng = np.random.default_rng(sq + skv + off)
    q = rng.standard_normal((2, sq, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    want = np.asarray(ref_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               window=window, q_offset=off))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for got in (full_attention(tq, tk, tv, causal=causal, window=window, q_offset=off),
                flash_attention(tq, tk, tv, causal=causal, window=window, q_offset=off)):
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
