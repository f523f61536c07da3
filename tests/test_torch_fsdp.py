"""The partitioned train step's FSDP gather, layer by layer, on the CPU:
held against the single-device port, the JAX package and the dry run.

The reference's step gathers each layer's FSDP shard inside its layer scan
(XLA under ``jit``); the port's model reads every weight through
``LM.fsdp`` (:class:`~repro_torch.dist.sharding.WeightGather`), inside the
function that remat checkpoints.  Gloo worlds (``run_world`` of
``tests/test_torch_multirank.py``, spawned once per module) hold:

* (a) reduced smollm-360m under data=2 (remat ``full``, and ``dots`` for
  one step) and reduced mixtral-8x22b under data=2,model=2 with expert
  parallelism (remat ``full``): every data-axis gather is one layer's
  slice, never a stacked weight's whole model-local tensor, and each
  stacked weight is gathered once a layer in the forward and once more in
  each layer's recompute; three steps track one device and the reference
  within ``REL``;
* (c) the gradient norm under data=2 equals one device's within ``REL``,
  with the weights sharded over data (FSDP) and replicated (ZeRO-1);
* (d) a stacked weight whose layers dim carries the data axes (reduced
  mamba2 with 2 SSM heads: ``a_log``, ``d_skip``, ``dt_bias`` are
  [layers=2, heads=2]) is gathered whole once a forward, and three steps
  track one device.

And the dry run under a fake data=4,model=2 group (b): the temporaries grow
with depth by less than one layer's model-local fp32 weights a layer, as
they do when no layer's weights stay gathered.
"""

import argparse
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
from repro_torch.core.layout import MeshSpec  # noqa: E402
from repro_torch.core.patterns import StateKind  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.dist.sharding import make_plan, model_layout, vocab_multiple  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402
from repro_torch.train.optimizer import init_state  # noqa: E402
from repro_torch.train.trainer import Trainer, shard_state  # noqa: E402
from test_torch_multirank import (  # noqa: E402
    ARCH, MOE, REL, STEPS, _moe_reference_steps, _moe_single_steps, _reference_steps,
    _reference_weights, _single_steps, _trainer, run_world,
)

MODULE = "test_torch_fsdp"
B, S = 4, 32


class _Gathers:
    """Records every data-axis gather of a trainer's step: (weight, whether
    it took one layer, the shape it made)."""

    def __init__(self, fsdp):
        self.fsdp, self.seen = fsdp, []
        self.names = {id(lay): n for n, lay in fsdp.shard.items()}
        self.real = sharding.gather_shard

        def spy(local, layout, target, rank, group, members):
            out = self.real(local, layout, target, rank, group, members)
            if group is fsdp.ranks.data and self.names.get(id(layout)) is not None:
                self.seen.append((self.names[id(layout)], local.dim() < len(layout.local_shape),
                                  tuple(out.shape)))
            return out

        sharding.gather_shard = spy

    def take(self) -> list:
        seen, self.seen = self.seen, []
        return seen

    def close(self) -> None:
        sharding.gather_shard = self.real


def _record(t, steps, state, rank):
    """``steps`` steps of trainer ``t`` with the gathers of each recorded."""
    gathers = _Gathers(t.lm.fsdp)
    hist, per_step = [], []
    try:
        for step in range(steps):
            state, m = t.step_fn(state, t.batch(step))
            hist.append(tuple(float(m[k]) for k in ("loss", "aux", "grad_norm")))
            per_step.append(gathers.take())
    finally:
        gathers.close()
    fs = t.lm.fsdp
    return {"hist": hist, "gathers": per_step, "split": dict(t.step_fn.split),
            "local": {n: tuple(lay.local_shape) for n, lay in fs.local.items()},
            "split_by_data": sorted(n for n in fs.shard
                                    if fs.shard[n].local_shape != fs.local[n].local_shape),
            "whole": sorted(fs.whole),
            "stacked": {n: s.runtime_shape[0] for n, s in t.plan.param_specs.items()
                        if s.stacked_dim == 0}}


def _from(weights, t, rank):
    return shard_state(init_state(params_from_reference(weights, t.lm, "cpu")), t.plan, rank)


def _mamba2g() -> TC.ModelConfig:
    cfg = TC.reduced(TC.get_config("mamba2-130m"))
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, head_dim=64))


def world2(rank, out, weights):
    res = {}
    t = _trainer({"data": 2, "model": 1}, dist.group.WORLD)
    res["smollm_d2"] = _record(t, STEPS, _from(weights, t, rank), rank)
    t = _trainer({"data": 2, "model": 1}, dist.group.WORLD, remat="dots")
    res["smollm_d2_dots"] = _record(t, 1, _from(weights, t, rank), rank)
    t = _trainer({"data": 2, "model": 1}, dist.group.WORLD, zero=1, fsdp=False)
    res["smollm_zero1"] = _record(t, STEPS, _from(weights, t, rank), rank)
    # (d): one device's trajectory beside the ranks', from the same seed
    cfg, par = _mamba2g(), TC.ParallelismConfig(compute_dtype="float32")
    hists = []
    for mesh_d, group in (({"data": 2, "model": 1}, dist.group.WORLD),
                          ({"data": 1, "model": 1}, None)):
        t = Trainer.create(cfg, par, TC.TrainConfig(), MeshSpec.from_dict(mesh_d), batch_size=B,
                           seq_len=S, device="cpu", group=group)
        if group is None:
            hists.append([(h["loss"], h["grad_norm"]) for h in t.run(t.init_state(), 0, STEPS)[1]])
        else:
            rec = _record(t, STEPS, t.init_state(), rank)
            hists.append([(h[0], h[2]) for h in rec["hist"]])
            res["mamba2g_d2"] = rec
    res["mamba2g_d2"]["one_device"] = hists[1]
    return res


def world4(rank, out, weights):
    moe = dict(np.load(out / "weights_moe.npz"))
    t = _trainer({"data": 2, "model": 2}, dist.group.WORLD, arch=MOE)
    rec = _record(t, STEPS, _from(moe, t, rank), rank)
    rec["moe_mode"] = t.plan.moe_mode
    return {"mixtral_d2m2": rec}


@pytest.fixture(scope="module")
def weights():
    return _reference_weights(ARCH)


@pytest.fixture(scope="module")
def worlds(weights, tmp_path_factory):
    out = tmp_path_factory.mktemp("fsdp")
    np.savez(out / "weights.npz", **weights)
    np.savez(out / "weights_moe.npz", **_reference_weights(MOE))
    return {2: run_world(out, 2, "world2", module=MODULE),
            4: run_world(out, 4, "world4", module=MODULE)}


def _ranks(worlds, name):
    return [r[name] for r in worlds[4 if name == "mixtral_d2m2" else 2]]


# ---------------------------------------------------------------------------
# (a) one layer at a time, and again in each recompute


@pytest.mark.parametrize("name", ["smollm_d2", "smollm_d2_dots", "mixtral_d2m2"])
def test_data_axis_gathers_take_one_layer_at_a_time(worlds, name):
    """No data-axis gather makes a stacked weight's whole model-local
    tensor; each stacked weight the data axes split is gathered once a
    layer in the forward and once in that layer's recompute (remat ``full``
    and ``dots``: the selective policy recomputes the gather, it does not
    save it); the unstacked ones whole where the model reads them."""
    for res in _ranks(worlds, name):
        assert res["split_by_data"] and not res["whole"]
        stacked = {n: count for n, count in res["stacked"].items() if n in res["split_by_data"]}
        assert stacked
        for gathers in res["gathers"]:
            for n, layer, shape in gathers:
                if n in res["stacked"]:
                    assert layer and shape == res["local"][n][1:], (n, shape)
                    assert shape != res["local"][n]
                else:
                    assert not layer and shape == res["local"][n], (n, shape)
            counts = {}
            for n, layer, _ in gathers:
                counts[n] = counts.get(n, 0) + 1
            for n, layers in stacked.items():
                assert counts[n] == 2 * layers, (n, counts[n], layers)
        assert res["split"]["gather_bytes"] > 0 and res["split"]["all_reduce_bytes"] > 0


@pytest.fixture(scope="module")
def single(weights):
    return _single_steps(weights)[1]


@pytest.fixture(scope="module")
def reference_hist(weights):
    return _reference_steps(weights)


@pytest.fixture(scope="module")
def moe_hists():
    w = _reference_weights(MOE)
    return _moe_single_steps(w), _moe_reference_steps(w)


def test_three_steps_track_single_device_and_reference(worlds, single, reference_hist,
                                                       moe_hists):
    """Losses and gradient norms of smollm (data=2) and of mixtral's loss,
    aux and gradient norm (data=2,model=2, EP) within ``REL`` of one device
    and of the reference's jitted step, every rank the same."""
    for res in _ranks(worlds, "smollm_d2"):
        for (loss, _, gn), (l1, g1), (lr, gr) in zip(res["hist"], single, reference_hist,
                                                     strict=True):
            assert abs(loss - l1) <= REL * abs(l1) and abs(loss - lr) <= REL * abs(lr)
            assert abs(gn - g1) <= REL * abs(g1) and abs(gn - gr) <= REL * abs(gr)
    one, ref = moe_hists
    ranks = _ranks(worlds, "mixtral_d2m2")
    for res in ranks:
        assert res["moe_mode"] == "ep"
        for got, o, w in zip(res["hist"], one, ref, strict=True):
            for g, a, b in zip(got, o, w):
                assert abs(g - a) <= REL * abs(a) and abs(g - b) <= REL * abs(b), (got, o, w)
    assert all(r["hist"] == ranks[0]["hist"] for r in ranks)


# ---------------------------------------------------------------------------
# (c) the norm counts each element once


@pytest.mark.parametrize("name", ["smollm_d2", "smollm_zero1"])
def test_grad_norm_equals_one_devices(worlds, single, name):
    """FSDP shards the gradients over data, ZeRO-1 replicates them: either
    way every rank's clip norm is one device's."""
    ranks = _ranks(worlds, name)
    for res in ranks:
        for (_, _, gn), (_, g1) in zip(res["hist"], single, strict=True):
            assert abs(gn - g1) <= REL * abs(g1), (name, gn, g1)
    assert all(r["hist"] == ranks[0]["hist"] for r in ranks)
    assert bool(ranks[0]["split_by_data"]) == (name == "smollm_d2")


# ---------------------------------------------------------------------------
# (d) the data axes on a stack's layers dim


def test_a_stack_split_by_data_over_its_layers_is_gathered_whole(worlds):
    for res in _ranks(worlds, "mamba2g_d2"):
        whole = set(res["whole"])
        assert {n.split(".")[-1] for n in whole} == {"a_log", "d_skip", "dt_bias"}
        for gathers in res["gathers"]:
            for n in whole:
                got = [(layer, shape) for m, layer, shape in gathers if m == n]
                assert got == [(False, res["local"][n])], (n, got)
        for (loss, _, gn), (l1, g1) in zip(res["hist"], res["one_device"], strict=True):
            assert abs(loss - l1) <= REL * abs(l1) and abs(gn - g1) <= REL * abs(g1)


# ---------------------------------------------------------------------------
# (b) the dry run's temporaries over depth


def _layer_local_bytes(cfg, par, mesh) -> int:
    """One layer's model-local fp32 weights (the data axes dropped)."""
    lm = build_model(cfg, vocab_multiple=vocab_multiple(par, mesh))
    plan = make_plan(cfg, lm.registry, par, mesh)
    return sum(math.prod(model_layout(s, StateKind.FP32, mesh, par.model_axis).local_shape[1:])
               * 4 for s in plan.param_specs.values() if s.stacked_dim == 0)


def test_temporaries_grow_with_depth_by_less_than_a_gathered_layer():
    """Under a fake data=4,model=2 group, 4 more layers of reduced smollm add
    less than one layer's model-local fp32 weights a layer to the step's
    temporaries (their gradients, new state and kept inputs at the size of
    the rank's shards: a quarter of it each); a step that kept each layer's
    gathered weights and their gradients adds twice that."""
    mesh = MeshSpec.from_dict({"data": 4, "model": 2})
    args = argparse.Namespace(remat="full", grad_accum=1, moment_dtype=None, param_dtype=None,
                              no_fsdp=False, cast_params=False, shard_cache_seq=False)
    temps, per_layer = {}, set()
    for depth in (2, 6):
        cfg = dataclasses.replace(TC.reduced(TC.get_config(ARCH)), num_layers=depth)
        rec = dryrun.run_cell(ARCH, "train", False, args, mesh=mesh,
                              shape=TC.ShapeSpec("train", S, 8, "train"), cfg=cfg)
        assert rec["ok"]
        temps[depth] = rec["memory"]["temp_bytes_per_device"]
        per_layer.add(_layer_local_bytes(cfg, TC.ParallelismConfig(), mesh))
    (layer,) = per_layer
    growth = (temps[6] - temps[2]) / 4
    assert 0 < growth < layer, (temps, layer)
    assert not dist.is_initialized()
