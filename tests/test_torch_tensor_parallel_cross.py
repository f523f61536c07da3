"""Partitioned compute of MLA (deepseek-v2), gated cross-attention
(llama-vision, ``vlm``) and the encoder-decoder (whisper, ``encdec``) over
the model axis, on the CPU, held against the single-device port and the JAX
package.

* ``partitions`` for the full-size configs (True at data=1,model=2; False
  with a pipe axis of 2 or with tensor parallelism off);
* two gloo worlds spawned once per module through
  ``tests/test_torch_multirank.py``'s ``run_world``: 2 ranks at
  data=1,model=2 (by heads: reduced deepseek-v2 has 2 heads, llama-vision
  8:2, whisper 2:2) and 4 ranks at data=1,model=4 (gathered: 2 heads, and
  llama-vision's 2 KV heads, do not divide 4), each fp32 over 3 steps of 4
  rows of 32 positions (the stream seq-sharded) or 33 (replicated);
  whisper's 8-frame encoder splits over 2 and 4 while a 33-position decoder
  does not (the mixed decision), and a 9-frame variant's encoder stays
  replicated while its decoder splits: losses, aux and gradient norms
  within 1e-5 relative of the single-device port and of the reference's
  jitted step; MLA's ``wq_a``/``q_norm``/``wkv_a``/``kv_norm`` and the
  cross gates' gradients equal to one device's; a ``gather_full`` spy
  showing exactly the weights each design gathers;
* whisper's save under data=1,model=2 resumed under data=2,model=1
  (RESHARD_STREAM) in the same world, each rank's state bit-equal to its
  shard of a one-process restore, and its 4th step one device's;
* serving in those worlds (fp32): prefill logits within 1e-4 of one
  process's, the same greedy tokens, each rank's cache its
  ``cache_pspecs`` shard (``c_kv``/``k_rope`` whole, ``ck``/``cv`` by KV
  heads);
* the serve CLI under ``--host-devices 2`` gives one process's tokens for
  the three reduced configs.

The cross gates are set nonzero from a seed first: the reference
initialises them to 0, and tanh(0) = 0 would hide a wrong cross path.  The
reference is imported lazily, so the spawned ranks load no JAX.
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
from repro_torch.core.layout import MeshSpec, slice_shard  # noqa: E402
from repro_torch.core.patterns import StateKind  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths  # noqa: E402
from repro_torch.dist.sharding import (  # noqa: E402
    RankGroups, cache_pspecs, local_shape, make_plan, rank_rows, vocab_multiple,
)
from repro_torch.dist.tensor_parallel import TensorParallel, partitions  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.train import data as tdata  # noqa: E402
from repro_torch.train.optimizer import init_state  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, shard_state  # noqa: E402
from test_torch_multirank import run_world  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MODULE = "test_torch_tensor_parallel_cross"
B, STEPS, REL = 4, 3, 1e-5
PROMPT, GEN = 8, 4
M2, M4, D2 = {"data": 1, "model": 2}, {"data": 1, "model": 4}, {"data": 2, "model": 1}

# model variants: (arch, encoder frames or None for the config's)
MODELS = {
    "deepseek": ("deepseek-v2-236b", None),
    "vlm": ("llama-3.2-vision-11b", None),
    "whisper": ("whisper-tiny", None),
    "whisper9": ("whisper-tiny", 9),  # 9 frames: the encoder's stream stays replicated
}
# train scenarios: (model, mesh, positions a row)
TRAIN = {
    "deepseek_m2": ("deepseek", M2, 32),
    "deepseek_m2_nosp": ("deepseek", M2, 33),
    "vlm_m2": ("vlm", M2, 32),
    "vlm_m2_nosp": ("vlm", M2, 33),
    "whisper_m2": ("whisper", M2, 32),
    "whisper_m2_nosp": ("whisper", M2, 33),  # encoder seq-sharded, decoder replicated
    "whisper9_m2": ("whisper9", M2, 32),     # encoder replicated, decoder seq-sharded
    "deepseek_m4": ("deepseek", M4, 32),
    "deepseek_m4_nosp": ("deepseek", M4, 33),
    "vlm_m4": ("vlm", M4, 32),
    "vlm_m4_nosp": ("vlm", M4, 33),
    "whisper_m4": ("whisper", M4, 32),
    "whisper_m4_nosp": ("whisper", M4, 33),
}
SERVE = {
    "serve_deepseek_m2": ("deepseek", M2),
    "serve_vlm_m2": ("vlm", M2),
    "serve_whisper_m2": ("whisper", M2),
    "serve_deepseek_m4": ("deepseek", M4),
    "serve_vlm_m4": ("vlm", M4),
    "serve_whisper_m4": ("whisper", M4),
}
RESUME = "whisper_m2"  # saved at step 3, resumed under data=2,model=1 in the same world
MLA_PARTIAL = ("wq_a", "q_norm", "wkv_a", "kv_norm")
KEEP = MLA_PARTIAL + ("cross_gate", "attn_norm", "cross_norm", "mlp_norm", "norm", "router")


def _size(mesh_d) -> int:
    return int(np.prod(list(mesh_d.values())))


def _variant(cfg, model: str):
    frames = MODELS[model][1]
    if frames is None:
        return cfg
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, source_len=frames))


def port_cfg(model: str) -> TC.ModelConfig:
    return _variant(TC.reduced(TC.get_config(MODELS[model][0])), model)


def parallel_for(remat: str = "none") -> TC.ParallelismConfig:
    return TC.ParallelismConfig(data_axes=("data",), model_axis="model", compute_dtype="float32",
                                remat=remat)


def _global_batch(cfg, step: int, seq: int) -> dict:
    full = tdata.batch_for_step(cfg, TC.ShapeSpec("train", seq, B, "train"), step, seed=0,
                                batch_override=B, seq_override=seq)
    return {k: full[k] for k in ("tokens", "source_embeds") if k in full}


def _torch_batch(batch: dict) -> dict:
    out = {"tokens": torch.from_numpy(batch["tokens"]).long()}
    if "source_embeds" in batch:
        out["source_embeds"] = torch.from_numpy(batch["source_embeds"])
    return out


def _prompts(cfg) -> tuple[np.ndarray, np.ndarray | None]:
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, PROMPT))
    if cfg.encoder is not None:
        return tokens, rng.standard_normal((B, cfg.encoder.source_len, cfg.d_model),
                                           dtype=np.float32)
    if cfg.cross_attn is not None:
        return tokens, rng.standard_normal(
            (B, cfg.cross_attn.source_len, cfg.cross_attn.source_dim), dtype=np.float32)
    return tokens, None


def _w(weights: dict, model: str) -> dict:
    pre = model + ":"
    return {k[len(pre):]: v for k, v in weights.items() if k.startswith(pre)}


def _spy_gathers(tp):
    """Record the names of the weights ``gather_full`` rebuilds over the
    model subgroup; returns (names, undo)."""
    names, real = [], tp_mod.gather_full

    def spy(local, layout, group, members=None):
        names.append(next(n for n, lay in tp.layouts.items() if lay is layout))
        return real(local, layout, group, members)

    tp_mod.gather_full = spy
    return names, lambda: setattr(tp_mod, "gather_full", real)


# ---------------------------------------------------------------------------
# the ranks


def _grads(t, local: dict, batch: dict) -> dict:
    """The rank's model-local gradients of one loss (the step's forward and
    backward, no update)."""
    tp = t.lm.tp
    _, comp = tp.weights(local)
    leaves = {n: x.detach().requires_grad_(True) for n, x in comp.items()}
    loss, _ = t.lm.loss_fn(unflatten_from_paths(leaves), batch)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    return tp.reduce_grads(grads)


def _train(rank, out, weights, name):
    model, mesh_d, seq = TRAIN[name]
    cfg = port_cfg(model)
    mesh = MeshSpec.from_dict(mesh_d)
    root = out / f"ckpt_{name}"
    kw = dict(ckpt_dir=str(root), policy=CheckpointPolicy(save_interval=1000, async_save=False))
    t = Trainer.create(cfg, parallel_for(), TC.TrainConfig(), mesh, batch_size=B, seq_len=seq,
                       device="cpu", group=dist.group.WORLD, **(kw if name == RESUME else {}))
    tp = t.lm.tp
    gathered, undo = _spy_gathers(tp)
    try:
        state = shard_state(init_state(params_from_reference(_w(weights, model), t.lm, "cpu")),
                            t.plan, rank)
        grads = _grads(t, flatten_with_paths(state.params), t.batch(0))
        keep = {n: g for n, g in grads.items() if n.split(".")[-1] in KEEP}
        hist = []
        for step in range(STEPS):
            state, m = t.step_fn(state, t.batch(step))
            hist.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
    finally:
        undo()
    res = {"hist": hist, "gathered": sorted(set(gathered)), "sp": tp.sp, "enc_sp": tp.enc_sp,
           "heads": tp.heads, "partial": sorted(tp.partial), "grads": keep,
           "split": dict(t.step_fn.split)}
    if name == RESUME:
        res["resume"] = _save_and_resume(rank, t, state, root, cfg, seq)
        t.manager.close()
    return res


def _save_and_resume(rank, t, state, root: Path, cfg, seq: int) -> dict:
    """Each rank saves its shards of step 3 under data=1,model=2; the same
    ranks resume under data=2,model=1 (RESHARD_STREAM) and take step 4."""
    t.manager.save(state, STEPS, block=True)
    pol = CheckpointPolicy(save_interval=1000, async_save=False)
    tgt = Trainer.create(cfg, parallel_for(), TC.TrainConfig(), MeshSpec.from_dict(D2),
                         batch_size=B, seq_len=seq, device="cpu", group=dist.group.WORLD,
                         ckpt_dir=str(root), policy=pol)
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
    return {"mode": info.mode.value, "step": info.step, "tp": tgt.lm.tp is not None,
            "bits_differing": diff, "loss": float(m["loss"])}


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


def _serve(rank, out, weights, name):
    model, mesh_d = SERVE[name]
    cfg = port_cfg(model)
    mesh = MeshSpec.from_dict(mesh_d)
    lm, plan, ranks = serving_lm(cfg, mesh, dist.group.WORLD)
    full = flatten_with_paths(params_from_reference(_w(weights, model), lm, "cpu"))
    local = {n: slice_shard(x, plan.param_specs[n].layout_for(StateKind.FP32, mesh), rank)
             for n, x in full.items()}
    gathered, undo = _spy_gathers(lm.tp)
    try:
        params = unflatten_from_paths(serve.rank_weights(lm, ranks, local))
    finally:
        undo()
    rows = rank_rows(B, ranks.parallel, mesh, rank)
    tokens, source = _prompts(cfg)
    prompts = torch.from_numpy(tokens[rows]).long()
    source = None if source is None else torch.from_numpy(source[rows])
    cache = D.init_cache(lm, B, PROMPT + GEN)
    with torch.inference_mode():  # the cache after the prefill and GEN - 1 decode steps
        logits, cache = D.prefill(lm, params, cache, prompts, source_embeds=source)
        cur = D.greedy(lm, logits)[:, None]
        for _ in range(GEN - 1):
            lg, cache = D.decode_step(lm, params, cache, cur)
            cur = D.greedy(lm, lg[:, -1])[:, None]
        logits = lm.tp.gather_vocab(logits, cfg.vocab_size)
    seq, _, _ = serve.generate(lm, params, prompts, GEN, source_embeds=source)
    return {"rows": (rows.start, rows.stop), "logits": logits, "tokens": seq,
            "cache": {n: x.clone() for n, x in flatten_with_paths(cache).items()},
            "gathered": sorted(set(gathered)), "heads": lm.tp.heads}


def cross_world(rank, out, weights):
    world = dist.get_world_size()
    res = {}
    for name, (_, mesh_d, _) in TRAIN.items():
        if _size(mesh_d) == world:
            res[name] = _train(rank, out, weights, name)
    for name, (_, mesh_d) in SERVE.items():
        if _size(mesh_d) == world:
            res[name] = _serve(rank, out, weights, name)
    return res


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
    """The reference's init, its cross gates then set nonzero from a seed."""
    import jax

    repro = _ref()
    from repro.models import build_model as ref_build

    rlm = ref_build(ref_cfg(model), compute_dtype=jax.numpy.float32)
    flat = {k: np.asarray(v) for k, v in
            repro.core.pytree.flatten_with_paths(rlm.init(jax.random.PRNGKey(0))).items()}
    rng = np.random.default_rng(11)
    for k in sorted(flat):
        if k.endswith("cross_gate"):
            flat[k] = rng.uniform(0.3, 0.9, flat[k].shape).astype(np.float32)
    return flat


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
        batch = {k: jnp.asarray(v) for k, v in _global_batch(port_cfg(model), i, seq).items()}
        state, m = step(state, batch)
        hist.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
    return hist


def _single(model: str, weights: dict, seq: int):
    """The single-device port: 4 steps, and the first loss's gradients."""
    cfg = port_cfg(model)
    lm = build_model(cfg, compute_dtype=torch.float32, remat="none")
    params = params_from_reference(weights, lm, "cpu")
    leaves = {n: x.detach().requires_grad_(True) for n, x in flatten_with_paths(params).items()}
    loss, _ = lm.loss_fn(unflatten_from_paths(leaves), _torch_batch(_global_batch(cfg, 0, seq)))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    step = make_train_step(lm, TC.TrainConfig(), TC.ParallelismConfig(compute_dtype="float32",
                                                                     remat="none"))
    state, hist = init_state(params), []
    for i in range(STEPS + 1):
        state, m = step(state, _torch_batch(_global_batch(cfg, i, seq)))
        hist.append((float(m["loss"]), float(m["aux"]), float(m["grad_norm"])))
    return {"hist": hist, "grads": grads}


# ---------------------------------------------------------------------------
# fixtures


@pytest.fixture(scope="module")
def weights():
    return {m: _reference_weights(m) for m in MODELS}


@pytest.fixture(scope="module")
def trajectories(weights):
    """(single-device port, reference hist) by (model, positions a row)."""
    out = {}
    for model, _, seq in TRAIN.values():
        if (model, seq) not in out:
            out[model, seq] = (_single(model, weights[model], seq),
                               _reference_steps(model, weights[model], seq))
    return out


@pytest.fixture(scope="module")
def worlds(weights, tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_cross_worlds")
    np.savez(out / "weights.npz", **{f"{m}:{k}": v for m, w in weights.items()
                                     for k, v in w.items()})
    return {2: run_world(out, 2, "cross_world", module=MODULE),
            4: run_world(out, 4, "cross_world", module=MODULE)}


def _ranks(worlds, name):
    ranks = worlds[4] if name in worlds[4][0] else worlds[2]
    return [r[name] for r in ranks]


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= REL * max(abs(b), 1e-30)


def full_names(lm) -> list[str]:
    return [d.path for d in lm.registry]


def _want_gathered(cfg, m: int, names) -> set:
    """What a rank gathers over the model axis: nothing of attention where
    the heads divide; else the heads-split attention weights."""
    heads = cfg.num_heads % m == 0 and (cfg.mla is not None or cfg.num_kv_heads % m == 0)
    if heads:
        return set()
    leaves = {"wqkv", "wo", "wq_b", "wkv_b", "cross_wq", "cross_wkv", "cross_wo"}
    return {n for n in names if n.split(".")[-1] in leaves}


# ---------------------------------------------------------------------------
# the decisions


def test_partitions_the_three_families_at_full_size():
    m2 = MeshSpec.from_dict(M2)
    par = TC.ParallelismConfig()
    pipe = MeshSpec.from_dict({"pipe": 2, "data": 1, "model": 2})
    for arch in ("deepseek-v2-236b", "llama-3.2-vision-11b", "whisper-tiny"):
        cfg = TC.get_config(arch)
        assert partitions(cfg, par, m2), arch
        # each pipe stage's model ranks partition (dist.pipeline); TP off, by rows
        assert partitions(cfg, dataclasses.replace(par, pipe_axis="pipe"), pipe), arch
        assert partitions(cfg, dataclasses.replace(par, tensor_parallel=False), m2), arch
        assert not partitions(cfg, dataclasses.replace(par, tensor_parallel=False,
                                                       sequence_parallel=False), m2), arch


@pytest.mark.parametrize("name", list(TRAIN))
def test_partitioned_cross_families_track_single_device_and_reference(worlds, trajectories,
                                                                      name):
    model, mesh_d, seq = TRAIN[name]
    single, ref = trajectories[model, seq]
    cfg = port_cfg(model)
    m = mesh_d["model"]
    for res in _ranks(worlds, name):  # every rank logs the single-device value
        assert res["sp"] == (seq % m == 0)
        if cfg.encoder is not None:
            assert res["enc_sp"] == (cfg.encoder.source_len % m == 0)
        assert res["heads"] == (m == 2)
        mla = {n for n in res["partial"] if n.split(".")[-1] in MLA_PARTIAL}
        assert bool(mla) == (cfg.mla is not None and m == 2)
        for (loss, aux, gn), (l1, a1, g1), (lr, ar, gr) in zip(res["hist"], single["hist"], ref):
            assert _close(loss, l1) and _close(loss, lr), (loss, l1, lr)
            assert _close(aux, a1) and _close(aux, ar), (aux, a1, ar)
            assert _close(gn, g1) and _close(gn, gr), (gn, g1, gr)
        assert res["split"]["tp_s"] > 0 and res["split"]["tp_bytes"] > 0


@pytest.mark.parametrize("name", list(TRAIN))
def test_replicated_and_gate_gradients_equal_one_devices(worlds, trajectories, name):
    """The replicated weights each rank reads in part (MLA's ``wq_a``,
    ``q_norm``, ``wkv_a``, ``kv_norm``; the router), the cross gates and the
    norms: after ``reduce_grads`` every rank's gradient is one device's."""
    model, _, seq = TRAIN[name]
    single, _ = trajectories[model, seq]
    for res in _ranks(worlds, name):
        leaves = {n.split(".")[-1] for n in res["grads"]}
        if port_cfg(model).mla is not None:
            assert set(MLA_PARTIAL) <= leaves
        if model == "vlm":
            assert "cross_gate" in leaves
        for n, g in res["grads"].items():
            want = single["grads"][n]
            np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=0,
                                       atol=2e-5 * float(want.abs().max()), err_msg=n)


@pytest.mark.parametrize("name", list(TRAIN))
def test_ranks_gather_only_what_the_design_gathers(worlds, weights, name):
    model, mesh_d, _ = TRAIN[name]
    want = _want_gathered(port_cfg(model), mesh_d["model"], weights[model])
    for res in _ranks(worlds, name):
        assert set(res["gathered"]) == want
        if mesh_d["model"] == 2:  # by heads: no attention weight, no expert gathered
            assert res["gathered"] == []


def test_whisper_save_resumes_under_data_parallelism(worlds, trajectories):
    single, _ = trajectories["whisper", 32]
    for res in _ranks(worlds, RESUME):
        rs = res["resume"]
        assert rs["mode"] == "reshard_stream" and rs["step"] == STEPS
        assert not rs["tp"]  # data=2,model=1: no model axis to partition over
        assert rs["bits_differing"] == 0
        assert _close(rs["loss"], single["hist"][STEPS][0])


# ---------------------------------------------------------------------------
# the worlds: serving


@pytest.mark.parametrize("name", list(SERVE))
def test_partitioned_cross_serving_equals_one_process(worlds, weights, name):
    model, mesh_d = SERVE[name]
    cfg = port_cfg(model)
    mesh = MeshSpec.from_dict(mesh_d)
    lm, _, _ = serving_lm(cfg, mesh)
    params = params_from_reference(weights[model], lm, "cpu")
    tokens, source = _prompts(cfg)
    prompts = torch.from_numpy(tokens).long()
    source = None if source is None else torch.from_numpy(source)
    with torch.inference_mode():
        logits, _ = D.prefill(lm, params, D.init_cache(lm, B, PROMPT + GEN), prompts,
                              source_embeds=source)
    seq, _, _ = serve.generate(lm, params, prompts, GEN, source_embeds=source)
    shapes = D.init_cache(lm, B, PROMPT + GEN, device="meta")
    specs = flatten_with_paths(cache_pspecs(shapes, serve.serving_parallelism(mesh), mesh))
    full = flatten_with_paths(shapes)
    m = mesh_d["model"]
    for res in _ranks(worlds, name):
        lo, hi = res["rows"]
        np.testing.assert_allclose(res["logits"].numpy(), logits[lo:hi].numpy(), atol=1e-4)
        assert torch.equal(res["tokens"], seq[lo:hi])
        assert set(res["gathered"]) == _want_gathered(cfg, m, full_names(lm))
        for path, x in res["cache"].items():
            assert tuple(x.shape) == local_shape(tuple(full[path].shape), specs[path], mesh), path
            leaf = path.split(".")[-1]
            if leaf in ("c_kv", "k_rope", "slot_pos"):  # the latent cache whole on every rank
                assert x.shape == full[path].shape, path
            if leaf in ("ck", "cv", "k", "v"):  # by KV heads where they divide
                split = cfg.num_kv_heads % m == 0
                assert x.shape[3] * (m if split else 1) == full[path].shape[3], path


def test_cross_rank_cache_holds_its_kv_heads(worlds, weights):
    """Beyond the shapes: after prefill and decode each rank's ``ck``/``cv``
    (vlm) and ``c_kv``/``k_rope`` (deepseek) hold one process's values, its
    KV heads and the whole latent."""
    for name, paths in (("serve_vlm_m2", ("periods.cross.ck", "periods.cross.cv")),
                        ("serve_deepseek_m2", ("layers.blk.c_kv", "layers.blk.k_rope"))):
        model, mesh_d = SERVE[name]
        cfg = port_cfg(model)
        lm, _, _ = serving_lm(cfg, MeshSpec.from_dict(mesh_d))
        params = params_from_reference(weights[model], lm, "cpu")
        tokens, source = _prompts(cfg)
        prompts = torch.from_numpy(tokens).long()
        source = None if source is None else torch.from_numpy(source)
        cache = D.init_cache(lm, B, PROMPT + GEN)
        with torch.inference_mode():
            logits, cache = D.prefill(lm, params, cache, prompts, source_embeds=source)
            cur = logits.argmax(-1)[:, None]
            for _ in range(GEN - 1):
                lg, cache = D.decode_step(lm, params, cache, cur)
                cur = lg[:, -1].argmax(-1)[:, None]
        whole = flatten_with_paths(cache)
        for c, res in enumerate(_ranks(worlds, name)):
            for path in paths:
                want = whole[path]
                if path.split(".")[-1] in ("ck", "cv"):
                    n = want.shape[3] // mesh_d["model"]
                    want = want.narrow(3, c * n, n)
                np.testing.assert_allclose(res["cache"][path].numpy(), want.numpy(), atol=1e-4,
                                           err_msg=f"{name} {path}")


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "llama-3.2-vision-11b", "whisper-tiny"])
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
