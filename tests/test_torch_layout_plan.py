"""The port's sharding rule table and resume planner against the JAX package's.

* ``make_plan(...).param_specs`` equal, through ``to_json``, for reduced
  smollm and a narrow config with smollm's 15:5 head ratio, over every mesh
  of ``tests/test_reconfig_e2e.py::TARGETS`` (with that test's flags);
* ``plan_resume(...).mode`` equal on every pair of
  ``tests/test_reshard_stream.py::MATRIX``;
* the 15/5-head fused QKV under a model axis that splits heads (2, 4) or
  even its k/v sub-fragments (3) round-trips bit for bit in both packages.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import repro.configs as RC  # noqa: E402
import repro.core as R  # noqa: E402
import repro.dist.sharding as RS  # noqa: E402
from repro.ckpt.saver import write_distributed as ref_write  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.dist.sharding as TS  # noqa: E402
from repro_torch.ckpt.restore import params_from_source, target_regions  # noqa: E402
from repro_torch.ckpt.saver import write_distributed as port_write  # noqa: E402
from repro_torch.models import build_model as port_build  # noqa: E402

# tests/test_reconfig_e2e.py:78 TARGETS: (mesh, launcher flags as config fields)
TARGETS = [
    ({"data": 2, "model": 2}, {}),
    ({"data": 4, "model": 1}, {}),
    ({"data": 1, "model": 2}, {"zero": 1, "fsdp": False}),
    ({"data": 2, "model": 4}, {}),
    ({"pipe": 2, "data": 2, "model": 2}, {"pipe_axis": "pipe"}),
]

# tests/test_reshard_stream.py:302 MATRIX
MATRIX = [
    ({"data": 2, "model": 2}, {}, {"data": 2, "model": 2}, {}, "direct"),
    ({"data": 2, "model": 2}, {}, {"data": 4, "model": 1}, {}, "reshard_stream"),
    ({"data": 4, "model": 1}, {}, {"data": 2, "model": 2}, {}, "reshard_stream"),
    ({"data": 2, "model": 2}, {}, {"pipe": 2, "data": 1, "model": 2},
     {"pipe_axis": "pipe"}, "reshard_stream"),
    ({"data": 2, "model": 2}, {}, {"data": 2, "model": 2},
     {"zero": 1, "fsdp": False}, "reshard_stream"),
    ({"data": 1, "model": 4}, {}, {"data": 4, "model": 1}, {}, "reshard_stream"),
]

NARROW = dict(num_heads=15, num_kv_heads=5, head_dim=8, num_layers=2)


def _cfgs(name):
    r = RC.reduced(RC.get_config("smollm-360m"))
    t = TC.reduced(TC.get_config("smollm-360m"))
    if name == "narrow15x5":
        r, t = dataclasses.replace(r, **NARROW), dataclasses.replace(t, **NARROW)
    return r, t


def _ref_plan(cfg, mesh_d, kw):
    mesh = R.MeshSpec.from_dict(mesh_d)
    parallel = RC.ParallelismConfig(**kw)
    lm = ref_build(cfg, vocab_multiple=RS.vocab_multiple(parallel, mesh))
    return RS.make_plan(cfg, lm.registry, parallel, mesh), lm


def _port_plan(cfg, mesh_d, kw):
    mesh = T.MeshSpec.from_dict(mesh_d)
    parallel = TC.ParallelismConfig(**kw)
    lm = port_build(cfg, vocab_multiple=TS.vocab_multiple(parallel, mesh))
    return TS.make_plan(cfg, lm.registry, parallel, mesh), lm


def _json(plan):
    return {n: s.to_json() for n, s in plan.param_specs.items()}


@pytest.mark.parametrize("cfg_name", ["smollm-reduced", "narrow15x5"])
@pytest.mark.parametrize("mesh_d,kw", TARGETS)
def test_param_specs_equal_reference(cfg_name, mesh_d, kw):
    rcfg, tcfg = _cfgs(cfg_name)
    assert tcfg.fingerprint() == rcfg.fingerprint()
    rplan, rlm = _ref_plan(rcfg, mesh_d, kw)
    tplan, tlm = _port_plan(tcfg, mesh_d, kw)
    assert tlm.vocab_padded == rlm.vocab_padded
    assert [(d.path, d.shape, d.axes, d.parts, d.kind) for d in tlm.registry] == [
        (d.path, d.shape, d.axes, d.parts, d.kind) for d in rlm.registry
    ]
    assert _json(tplan) == _json(rplan)
    assert tplan.mesh.to_json() == rplan.mesh.to_json()


@pytest.mark.parametrize("src_mesh,src_kw,tgt_mesh,tgt_kw,expect", MATRIX)
def test_plan_resume_mode_equals_reference(src_mesh, src_kw, tgt_mesh, tgt_kw, expect):
    rcfg, tcfg = _cfgs("smollm-reduced")
    modes = []
    for plan_fn, pkg, cfg in ((_ref_plan, R, rcfg), (_port_plan, T, tcfg)):
        src, _ = plan_fn(cfg, src_mesh, src_kw)
        tgt, _ = plan_fn(cfg, tgt_mesh, tgt_kw)
        manifest = pkg.DistManifest(step=1, mesh=src.mesh, params=src.param_specs,
                                    scalars={}, config_fingerprint={})
        rp = pkg.plan_resume(manifest, pkg.TargetSpec(tgt.mesh, tgt.param_specs))
        modes.append((rp.mode.value, sorted(rp.consolidate_params)))
    assert modes[0] == modes[1]
    assert modes[1][0] == expect


@pytest.mark.parametrize("src_mesh", [
    {"data": 2, "model": 2},   # 7.5 q heads per rank
    {"data": 1, "model": 4},   # 3.75 q heads per rank
    {"data": 1, "model": 3},   # k/v parts of 40 split 14/14/12: padded sub-fragments
])
def test_fused_qkv_15x5_round_trips_both_packages(tmp_path, src_mesh):
    """Fused QKV whose head count the model axis does not divide: saved by
    each package under ``src_mesh``, restored under data=1,model=1 (and the
    same layout) by the port, and consolidated by the reference — every path
    gives back the saved bytes."""
    rcfg, tcfg = _cfgs("narrow15x5")
    rplan, _ = _ref_plan(rcfg, src_mesh, {})
    tplan, _ = _port_plan(tcfg, src_mesh, {})
    rng = np.random.default_rng(0)
    snap = {
        n: {k: rng.standard_normal(s.runtime_shape).astype(np.float32) for k in R.STATE_KINDS}
        for n, s in rplan.param_specs.items()
    }
    ref_write(snap, rplan, 1, tmp_path / "ref", workers=1)
    port_write({n: {T.StateKind(k.value): a for k, a in kinds.items()}
                for n, kinds in snap.items()}, tplan, 1, tmp_path / "port")
    name = "layers.blk.wqkv"
    want = snap[name][R.StateKind.FP32]
    for root in ("ref", "port"):
        rck = R.DistCheckpoint.open(tmp_path / root)
        atom = R.assemble_atom(rck, rck.manifest.params[name], R.StateKind.FP32)
        np.testing.assert_array_equal(atom, want)
        tck = T.DistCheckpoint.open(tmp_path / root)
        for tgt_mesh in ({"data": 1, "model": 1}, src_mesh):
            tgt, _ = _port_plan(tcfg, tgt_mesh, {})
            rp = T.plan_resume(tck.manifest, T.TargetSpec(tgt.mesh, tgt.param_specs))
            expect = "direct" if tgt_mesh == src_mesh else "reshard_stream"
            assert rp.mode.value == expect
            flat = params_from_source(tck, tgt, "cpu", transforms=rp.transforms)
            np.testing.assert_array_equal(flat[name].numpy(), want)
            if expect == "reshard_stream":
                assert name in rp.consolidate_params
                assert len(target_regions(tgt.param_specs[name], tgt.mesh)) == 1


# ---------------------------------------------------------------------------
# mamba2-130m: the five-part fused in_proj (z/x/B/C/dt) through the same
# fragment machinery as the fused QKV
# ---------------------------------------------------------------------------

SSM_MESHES = [{"data": 2, "model": 2}, {"data": 1, "model": 1}, {"data": 1, "model": 4}]


def _ssm_cfgs(size):
    r, t = RC.get_config("mamba2-130m"), TC.get_config("mamba2-130m")
    return (RC.reduced(r), TC.reduced(t)) if size == "reduced" else (r, t)


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("mesh_d", SSM_MESHES, ids=lambda m: ",".join(f"{k}={v}" for k, v in m.items()))
def test_mamba2_param_specs_equal_reference(size, mesh_d):
    rcfg, tcfg = _ssm_cfgs(size)
    assert tcfg.fingerprint() == rcfg.fingerprint()
    rplan, rlm = _ref_plan(rcfg, mesh_d, {})
    tplan, tlm = _port_plan(tcfg, mesh_d, {})
    assert tlm.vocab_padded == rlm.vocab_padded
    assert [(d.path, d.shape, d.axes, d.parts, d.parts_dim, d.kind, d.init, d.fan_in_dim)
            for d in tlm.registry] == [
        (d.path, d.shape, d.axes, d.parts, d.parts_dim, d.kind, d.init, d.fan_in_dim)
        for d in rlm.registry
    ]
    assert _json(tplan) == _json(rplan)
    assert tplan.mesh.to_json() == rplan.mesh.to_json()


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("src_mesh", SSM_MESHES, ids=lambda m: ",".join(f"{k}={v}" for k, v in m.items()))
def test_mamba2_checkpoint_round_trips_both_packages(tmp_path, writer, src_mesh):
    """A reduced mamba2 checkpoint written by either package under
    ``src_mesh``: the reference consolidates every atom bit for bit, and the
    port restores every weight bit for bit DIRECT (same layout) and
    RESHARD_STREAM (the two other layouts, ``in_proj`` consolidated)."""
    rcfg, tcfg = _ssm_cfgs("reduced")
    rplan, _ = _ref_plan(rcfg, src_mesh, {})
    tplan, _ = _port_plan(tcfg, src_mesh, {})
    rng = np.random.default_rng(1)
    snap = {
        n: {k: rng.standard_normal(s.runtime_shape).astype(np.float32) for k in R.STATE_KINDS}
        for n, s in rplan.param_specs.items()
    }
    if writer == "ref":
        ref_write(snap, rplan, 1, tmp_path, workers=1)
    else:
        port_write({n: {T.StateKind(k.value): a for k, a in kinds.items()}
                    for n, kinds in snap.items()}, tplan, 1, tmp_path)
    rck = R.DistCheckpoint.open(tmp_path)
    assert rck.validate() == []
    for name, spec in rck.manifest.params.items():
        for kind in R.STATE_KINDS:
            np.testing.assert_array_equal(R.assemble_atom(rck, spec, kind), snap[name][kind])
    tck = T.DistCheckpoint.open(tmp_path)
    for tgt_mesh in SSM_MESHES:
        tgt, _ = _port_plan(tcfg, tgt_mesh, {})
        rp = T.plan_resume(tck.manifest, T.TargetSpec(tgt.mesh, tgt.param_specs))
        expect = "direct" if tgt_mesh == src_mesh else "reshard_stream"
        assert rp.mode.value == expect, rp.reason
        flat = params_from_source(tck, tgt, "cpu", transforms=rp.transforms)
        assert set(flat) == set(snap)
        for name, t in flat.items():
            np.testing.assert_array_equal(t.numpy(), snap[name][R.StateKind.FP32])
        if expect == "reshard_stream" and (src_mesh["model"] > 1 or tgt_mesh["model"] > 1):
            assert "layers.blk.in_proj" in rp.consolidate_params
