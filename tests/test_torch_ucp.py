"""UCP atoms, their conversion and the VIA_UCP restore in the port, held
against the JAX package (CPU).

* The cases of ``tests/test_ucp_roundtrip.py`` on the port: any Source
  layout → atoms → any Target layout is lossless (a property over meshes,
  shardings and padding), replica averaging, ZeRO-1 moments, a fused QKV
  TP-width change, a PP stage regroup, a dtype-policy change on load, and
  the refusal of an uncommitted checkpoint; each atom directory also equals
  the reference's conversion of the same checkpoint.
* Stream == VIA_UCP, bit for bit, for every parameter class
  (``tests/test_reshard_stream.py``): plain, fused QKV, vocab padding kept
  and changed, MoE expert layouts, averaged replicas, random layouts; and
  on reduced smollm over the reference's reshard matrix, where the
  reference's ``state_from_ucp`` on the same atoms gives the same bytes.
* The manager (``tests/test_ckpt_manager.py``,
  ``tests/test_reshard_stream.py``): a forced VIA_UCP restore converts once
  and then reuses the cache; ``export_ucp`` is explicit and cached; a
  stream that loses a shard mid-way falls back to VIA_UCP, unless forced;
  a logical-shape change routes VIA_UCP and is refused loudly.
* Across packages: one distributed checkpoint (raw, and with ``int8:b256``
  moments; written by either package) converted by both packages gives
  equal manifest digests, and each package reads the other's atoms bit for
  bit.
* The serve launcher restores VIA_UCP when asked.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.core as R  # noqa: E402
import repro.dist.sharding as RS  # noqa: E402
from repro.ckpt.restore import state_from_ucp as ref_state_from_ucp  # noqa: E402
from repro.ckpt.saver import write_distributed as ref_write  # noqa: E402
from repro.core.codec import CodecPolicy as RCodecPolicy  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.ckpt.restore as TR  # noqa: E402
import repro_torch.dist.sharding as TS  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.ckpt.policy import CheckpointPolicy  # noqa: E402
from repro_torch.ckpt.saver import snapshot_state, snapshot_weights, write_distributed  # noqa: E402
from repro_torch.core.codec import CodecPolicy  # noqa: E402
from repro_torch.core.layout import slice_shard  # noqa: E402
from repro_torch.core.pytree import flatten_with_paths  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.optimizer import TrainState, init_state  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = (T.StateKind.FP32, T.StateKind.EXP_AVG, T.StateKind.EXP_AVG_SQ)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _save(tmp, mesh, specs, state, save_mode="dedup"):
    """Port writer of a hand-made state: every rank's shards, then COMMIT."""
    man = T.DistManifest(
        step=7, mesh=mesh, params=specs, scalars={"step": 7, "seed": 3},
        config_fingerprint={"model": "toy"}, save_mode=save_mode,
    )
    ck = T.DistCheckpoint.create(tmp, man)
    for n, spec in specs.items():
        for kind in T.STATE_KINDS:
            layout = spec.layout_for(kind, mesh)
            for r in ck.writing_ranks(n, kind):
                ck.write_shard(r, n, kind, slice_shard(state[n][kind], layout, r))
    ck.commit()
    return ck


def _reassemble_target(ucp, spec, kind, mesh):
    """Load every Target rank from atoms and re-union: the logical atom."""
    plan = T.gen_ucp_metadata({spec.name: spec}, mesh, ucp.manifest.atoms)
    pp = plan.params[spec.name][kind]
    glob = np.zeros(spec.runtime_shape, np.float32)
    for r in mesh.ranks():
        shard = T.load_param_shard(ucp, pp, r)
        for e in pp.layout.entries[r]:
            glob[e.atom_index()] = shard[e.shard_index()].astype(np.float32)
    body = glob[0] if spec.average else glob  # replica rows equal after Load
    return body[tuple(slice(0, s) for s in spec.logical_shape)]


def _bytes(atom) -> bytes:
    """An atom's element bytes (numpy, ml_dtypes or a torch tensor)."""
    if isinstance(atom, torch.Tensor):
        return atom.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(atom).tobytes()


def _ucp_dir(mgr, step):
    return mgr.step_dir(step).with_name(mgr.step_dir(step).name + ".ucp")


def _same_as_reference_conversion(ck, ucp, tmp):
    """The reference's convert of the same checkpoint: equal digests, and
    each package reads the other's atoms bit for bit."""
    ref, _ = R.convert_to_ucp(str(ck.root), str(tmp / "ref.ucp"), workers=1)
    port_m = json.loads((ucp.root / "MANIFEST.json").read_text())
    ref_m = json.loads((ref.root / "MANIFEST.json").read_text())
    assert port_m.keys() == ref_m.keys()
    assert port_m["atoms"] == ref_m["atoms"]  # digests, shapes, dtypes, kinds
    assert port_m["provenance"]["source_mesh"] == ref_m["provenance"]["source_mesh"]
    assert port_m["scalars"] == ref_m["scalars"] and port_m["step"] == ref_m["step"]
    cross_port = R.UcpCheckpoint.open(ucp.root)
    cross_ref = T.UcpCheckpoint.open(ref.root)
    for name, info in ucp.manifest.atoms.items():
        for kind in info.dtypes:
            rk = R.StateKind(kind.value)
            a = _bytes(cross_port.read_atom(name, rk))
            b = _bytes(cross_ref.read_atom(name, kind))
            assert a == _bytes(ucp.read_atom(name, kind))
            assert b == _bytes(ref.read_atom(name, rk))
            assert a == b
    assert cross_port.validate() == [] and cross_ref.validate() == []


# ---------------------------------------------------------------------------
# tests/test_ucp_roundtrip.py on the port
# ---------------------------------------------------------------------------


@st.composite
def _mesh(draw, axes=("data", "model")):
    return T.MeshSpec(tuple((a, draw(st.integers(1, 3))) for a in axes))


@st.composite
def _case(draw):
    src, tgt = draw(_mesh()), draw(_mesh())
    rows, cols = draw(st.integers(1, 10)), draw(st.integers(1, 10))
    pad_src, pad_tgt = draw(st.integers(0, 3)), draw(st.integers(0, 3))
    axis_choices = [(), ("data",), ("model",), ("data", "model")]

    def dims():
        d = (T.DimSpec(axes=draw(st.sampled_from(axis_choices))),
             T.DimSpec(axes=draw(st.sampled_from([(), ("model",)]))))
        return (d[0], T.DimSpec()) if set(d[0].axes) & set(d[1].axes) else d

    return src, tgt, (rows, cols), pad_src, pad_tgt, dims(), dims()


@settings(max_examples=40, deadline=None)
@given(_case())
def test_property_any_source_to_any_target(tmp_path_factory, case):
    src_mesh, tgt_mesh, (rows, cols), pad_s, pad_t, sdims, tdims = case
    tmp = tmp_path_factory.mktemp("ucp")
    mk = lambda pad, dims: T.ParamSpec(
        name="w", logical_shape=(rows, cols), runtime_shape=(rows + pad, cols),
        states={k: T.StateLayoutSpec(dims) for k in T.STATE_KINDS},
    )
    full = np.zeros((rows + pad_s, cols), np.float32)
    full[:rows] = np.random.default_rng(5).normal(size=(rows, cols)).astype(np.float32)
    ck = _save(tmp / "d", src_mesh, {"w": mk(pad_s, sdims)}, {"w": {k: full for k in T.STATE_KINDS}})
    ucp, _ = T.convert_to_ucp(ck, str(tmp / "u"), workers=1)
    got = _reassemble_target(ucp, mk(pad_t, tdims), T.StateKind.FP32, tgt_mesh)
    np.testing.assert_array_equal(got, full[:rows])


def test_params_to_average_consolidation(tmp_path):
    """Divergent replicas: the atom is their mean (computed in float64, as
    the reference) and every Target replica receives it."""
    mk = lambda n: T.ParamSpec(
        name="w", logical_shape=(6,), runtime_shape=(n, 6),
        states={k: T.StateLayoutSpec((T.DimSpec(("data",)), T.DimSpec())) for k in T.STATE_KINDS},
        average=True,
    )
    runtime = np.random.default_rng(0).normal(size=(4, 6)).astype(np.float32)
    mesh = T.MeshSpec.from_dict({"data": 4, "model": 1})
    ck = _save(tmp_path / "d", mesh, {"w": mk(4)}, {"w": {k: runtime for k in T.STATE_KINDS}})
    assert mk(4).pattern_for(T.StateKind.FP32, mesh) == T.Pattern.AVERAGE
    ucp, _ = T.convert_to_ucp(ck, str(tmp_path / "u"))
    atom = ucp.read_atom("w", T.StateKind.FP32)
    np.testing.assert_allclose(atom, runtime.mean(0), rtol=1e-6)
    got = _reassemble_target(ucp, mk(2), T.StateKind.FP32, T.MeshSpec.from_dict({"data": 2, "model": 1}))
    np.testing.assert_array_equal(got, atom)
    _same_as_reference_conversion(ck, ucp, tmp_path)


def test_zero1_moments_shard_differently_than_weights(tmp_path):
    """ZeRO-1: replicated weights + data-sharded moments round-trip; a
    parallel conversion (workers=2) writes the serial one's atoms byte for
    byte."""
    mesh = T.MeshSpec.from_dict({"data": 2, "model": 2})
    spec = T.ParamSpec(
        name="w", logical_shape=(8, 4),
        states={
            T.StateKind.FP32: T.StateLayoutSpec((T.DimSpec(("model",)), T.DimSpec())),
            T.StateKind.EXP_AVG: T.StateLayoutSpec((T.DimSpec(("model",)), T.DimSpec(("data",)))),
            T.StateKind.EXP_AVG_SQ: T.StateLayoutSpec((T.DimSpec(("model",)), T.DimSpec(("data",)))),
        },
    )
    assert spec.pattern_for(T.StateKind.FP32, mesh) == T.Pattern.FRAGMENT
    rng = np.random.default_rng(1)
    state = {"w": {k: rng.normal(size=(8, 4)).astype(np.float32) for k in T.STATE_KINDS}}
    ck = _save(tmp_path / "d", mesh, {"w": spec}, state)
    assert len(ck.writing_ranks("w", T.StateKind.FP32)) == 2
    assert len(ck.writing_ranks("w", T.StateKind.EXP_AVG)) == 4
    par, _ = T.convert_to_ucp(ck, str(tmp_path / "u2"), workers=2)
    ucp, stats = T.convert_to_ucp(ck, str(tmp_path / "u"), workers=1)
    assert par.manifest.atoms == ucp.manifest.atoms
    for k in T.STATE_KINDS:
        assert par.atom_path("w", k).read_bytes() == ucp.atom_path("w", k).read_bytes()
    assert (stats.params, stats.atoms_written, stats.bytes_written) == (1, 3, 3 * 8 * 4 * 4)
    for k in T.STATE_KINDS:
        np.testing.assert_array_equal(ucp.read_atom("w", k), state["w"][k])
    frags = list(T.extract(ck))
    assert len(frags) == 2 + 4 + 4 and {f.kind for f in frags} == set(T.STATE_KINDS)
    np.testing.assert_array_equal(T.union(ck, spec, T.StateKind.EXP_AVG), state["w"][T.StateKind.EXP_AVG])
    _same_as_reference_conversion(ck, ucp, tmp_path)


def test_fused_qkv_tp_width_change(tmp_path):
    """Fused QKV saved under TP=4, loaded under TP=2, with kv parts smaller
    than the TP degree (per-part ceil padding)."""
    qkv = (T.SubFragment("q", 12), T.SubFragment("k", 3), T.SubFragment("v", 3))
    mk = lambda: T.uniform_param_spec(
        "wqkv", (18, 5), [T.DimSpec(("model",), qkv), T.DimSpec()], kind="fused_qkv")
    rng = np.random.default_rng(2)
    state = {"wqkv": {k: rng.normal(size=(18, 5)).astype(np.float32) for k in T.STATE_KINDS}}
    ck = _save(tmp_path / "d", T.MeshSpec.from_dict({"data": 1, "model": 4}), {"wqkv": mk()}, state)
    ucp, _ = T.convert_to_ucp(ck, str(tmp_path / "u"))
    np.testing.assert_array_equal(ucp.read_atom("wqkv", T.StateKind.FP32),
                                  state["wqkv"][T.StateKind.FP32])
    got = _reassemble_target(ucp, mk(), T.StateKind.FP32, T.MeshSpec.from_dict({"data": 1, "model": 2}))
    np.testing.assert_array_equal(got, state["wqkv"][T.StateKind.FP32])
    _same_as_reference_conversion(ck, ucp, tmp_path)


def test_pp_stage_reconfiguration(tmp_path):
    """Layer-stacked params saved under pipe=4 resume under pipe=2."""
    mk = lambda model: T.uniform_param_spec(
        "blk.w", (8, 6, 4),
        [T.DimSpec(("pipe",)), T.DimSpec(), T.DimSpec(("model",) if model else ())],
        stacked_dim=0,
    )
    tgt_mesh = T.MeshSpec.from_dict({"pipe": 2, "data": 2, "model": 1})
    rng = np.random.default_rng(3)
    state = {"blk.w": {k: rng.normal(size=(8, 6, 4)).astype(np.float32) for k in T.STATE_KINDS}}
    ck = _save(tmp_path / "d", T.MeshSpec.from_dict({"pipe": 4, "data": 1, "model": 2}),
               {"blk.w": mk(True)}, state)
    target = T.TargetSpec(tgt_mesh, {"blk.w": mk(False)})
    assert T.plan_resume(ck.manifest, target).mode == T.ResumeMode.RESHARD_STREAM
    assert T.plan_resume(ck.manifest, target, allow_stream=False).mode == T.ResumeMode.VIA_UCP
    ucp, _ = T.convert_to_ucp(ck, str(tmp_path / "u"))
    got = _reassemble_target(ucp, mk(False), T.StateKind.EXP_AVG, tgt_mesh)
    np.testing.assert_array_equal(got, state["blk.w"][T.StateKind.EXP_AVG])
    assert ucp.manifest.atoms["blk.w"].stacked_dim == 0
    _same_as_reference_conversion(ck, ucp, tmp_path)


def test_dtype_policy_change_on_load(tmp_path):
    """fp32 atoms served to a bf16-moments Target: a bf16 tensor whose bytes
    are the reference's ml_dtypes cast of the same atom region."""
    mesh = T.MeshSpec.from_dict({"data": 2, "model": 1})
    spec32 = T.uniform_param_spec("w", (4, 4), [T.DimSpec(("data",)), T.DimSpec()])
    rng = np.random.default_rng(4)
    state = {"w": {k: rng.normal(size=(4, 4)).astype(np.float32) for k in T.STATE_KINDS}}
    ck = _save(tmp_path / "d", mesh, {"w": spec32}, state)
    ucp, _ = T.convert_to_ucp(ck, str(tmp_path / "u"))
    spec_bf = T.uniform_param_spec("w", (4, 4), [T.DimSpec(("data",)), T.DimSpec()],
                                   moment_dtype="bfloat16")
    plan = T.gen_ucp_metadata({"w": spec_bf}, mesh, ucp.manifest.atoms)
    shard = T.load_param_shard(ucp, plan.params["w"][T.StateKind.EXP_AVG], 0)
    assert isinstance(shard, torch.Tensor) and shard.dtype == torch.bfloat16
    want = state["w"][T.StateKind.EXP_AVG][:2].astype(ml_dtypes.bfloat16)
    assert shard.view(torch.uint16).numpy().tobytes() == want.tobytes()
    assert plan.params["w"][T.StateKind.EXP_AVG].read_bytes(0) == 2 * 4 * 2


def test_gen_ucp_metadata_checks_the_atom_index(tmp_path):
    mesh = T.MeshSpec.from_dict({"data": 1, "model": 1})
    spec = T.uniform_param_spec("w", (4, 4), [T.DimSpec(), T.DimSpec()])
    state = {"w": {k: np.ones((4, 4), np.float32) for k in T.STATE_KINDS}}
    ucp, _ = T.convert_to_ucp(_save(tmp_path / "d", mesh, {"w": spec}, state), str(tmp_path / "u"))
    with pytest.raises(KeyError, match="no atom"):
        T.gen_ucp_metadata({"v": spec}, mesh, ucp.manifest.atoms)
    other = T.uniform_param_spec("w", (4, 5), [T.DimSpec(), T.DimSpec()])
    with pytest.raises(ValueError, match="logical shape"):
        T.gen_ucp_metadata({"w": other}, mesh, ucp.manifest.atoms)


def test_convert_refuses_uncommitted(tmp_path):
    mesh = T.MeshSpec.from_dict({"data": 1, "model": 1})
    spec = T.uniform_param_spec("w", (2,), [T.DimSpec()])
    man = T.DistManifest(step=1, mesh=mesh, params={"w": spec}, scalars={}, config_fingerprint={})
    ck = T.DistCheckpoint.create(tmp_path / "d", man)
    ck.write_shard(0, "w", T.StateKind.FP32, np.zeros((2,), np.float32))
    with pytest.raises(ValueError, match="uncommitted"):
        T.convert_to_ucp(ck, str(tmp_path / "u"))


def test_validate_finds_a_corrupt_atom(tmp_path):
    mesh = T.MeshSpec.from_dict({"data": 2, "model": 1})
    spec = T.uniform_param_spec("w", (4, 4), [T.DimSpec(("data",)), T.DimSpec()])
    state = {"w": {k: np.full((4, 4), 2.0, np.float32) for k in T.STATE_KINDS}}
    ucp, _ = T.convert_to_ucp(_save(tmp_path / "d", mesh, {"w": spec}, state), str(tmp_path / "u"))
    assert ucp.validate() == [] and ucp.is_committed
    arr = np.load(ucp.atom_path("w", T.StateKind.EXP_AVG))
    arr[1, 1] = 3.0
    np.save(ucp.atom_path("w", T.StateKind.EXP_AVG), arr)
    (problem,) = T.UcpCheckpoint.open(ucp.root).validate()
    assert "w@exp_avg: content digest mismatch" in problem


# ---------------------------------------------------------------------------
# Stream == VIA_UCP, bit for bit, per parameter class
# ---------------------------------------------------------------------------


def _random_state(specs, seed=0):
    rng = np.random.default_rng(seed)
    return {n: {k: rng.normal(size=s.runtime_shape).astype(np.float32) for k in T.STATE_KINDS}
            for n, s in specs.items()}


def _states_equal(a: TrainState, b: TrainState):
    for tree_a, tree_b in ((a.params, b.params), (a.exp_avg, b.exp_avg),
                           (a.exp_avg_sq, b.exp_avg_sq)):
        fa, fb = flatten_with_paths(tree_a), flatten_with_paths(tree_b)
        assert fa.keys() == fb.keys() and fa
        for n in fa:
            assert fa[n].dtype == fb[n].dtype and torch.equal(fa[n], fb[n]), n
    assert a.step == b.step


def _stream_vs_ucp(tmp, src_mesh, tgt_mesh, src_specs, tgt_specs, seed=0):
    """Save under the Source layout, restore by stream and by atoms: both
    bit-identical.  Returns the plan table."""
    plan_src = TS.ShardingPlan(mesh=src_mesh, param_specs=dict(src_specs))
    plan_tgt = TS.ShardingPlan(mesh=tgt_mesh, param_specs=dict(tgt_specs))
    write_distributed(_random_state(src_specs, seed), plan_src, 1, tmp / "ck")
    ck = T.DistCheckpoint.open(tmp / "ck")
    transforms = T.stream_transforms(ck.manifest, T.TargetSpec(tgt_mesh, dict(tgt_specs)))
    s_stream = TR.state_from_stream(ck, plan_tgt, "cpu", transforms)
    ucp, _ = T.convert_to_ucp(ck, str(tmp / "ucp"), workers=1)
    _states_equal(s_stream, TR.state_from_ucp(ucp, plan_tgt, "cpu"))
    return transforms


def test_stream_plain_param_matches_ucp(tmp_path):
    src = {"w": T.uniform_param_spec("w", (8, 6), [T.DimSpec(("data",)), T.DimSpec(("model",))])}
    tgt = {"w": T.uniform_param_spec("w", (8, 6), [T.DimSpec(("data",)), T.DimSpec()])}
    tr = _stream_vs_ucp(tmp_path, T.MeshSpec.from_dict({"data": 2, "model": 2}),
                        T.MeshSpec.from_dict({"data": 4, "model": 1}), src, tgt)
    assert tr["w"].cls is T.TransformClass.RESLICE


def test_stream_fused_qkv_matches_ucp(tmp_path):
    qkv = (T.SubFragment("q", 12), T.SubFragment("k", 3), T.SubFragment("v", 3))
    mk = lambda: T.uniform_param_spec(
        "wqkv", (18, 5), [T.DimSpec(("model",), qkv), T.DimSpec()], kind="fused_qkv")
    tr = _stream_vs_ucp(tmp_path, T.MeshSpec.from_dict({"data": 1, "model": 4}),
                        T.MeshSpec.from_dict({"data": 1, "model": 2}), {"wqkv": mk()}, {"wqkv": mk()})
    assert tr["wqkv"].cls is T.TransformClass.CONSOLIDATE


@pytest.mark.parametrize("tgt_rows,tgt_dims,cls", [
    (12, (("model",), ("data",)), "RESLICE"),   # same padding multiple, resharded
    (16, (("data", "model"), ()), "CONSOLIDATE"),  # padding multiple changed
])
def test_stream_vocab_padded_matches_ucp(tmp_path, tgt_rows, tgt_dims, cls):
    """Padded runtime rows carry garbage at save time; both paths serve them
    as zeros."""
    mk = lambda rt, dims: T.ParamSpec(
        name="emb", logical_shape=(10, 4), runtime_shape=(rt, 4),
        states={k: T.StateLayoutSpec(tuple(T.DimSpec(d) for d in dims)) for k in T.STATE_KINDS},
    )
    tr = _stream_vs_ucp(tmp_path, T.MeshSpec.from_dict({"data": 4, "model": 1}),
                        T.MeshSpec.from_dict({"data": 2, "model": 2}),
                        {"emb": mk(12, (("data",), ()))}, {"emb": mk(tgt_rows, tgt_dims)})
    assert tr["emb"].cls is getattr(T.TransformClass, cls)


def test_stream_moe_expert_matches_ucp(tmp_path):
    ep = T.uniform_param_spec("moe.w", (4, 6, 8), [T.DimSpec(("model",)), T.DimSpec(), T.DimSpec()],
                              kind="moe_expert")
    tp = T.uniform_param_spec("moe.w", (4, 6, 8), [T.DimSpec(), T.DimSpec(("model",)), T.DimSpec()],
                              kind="moe_expert")
    mesh = T.MeshSpec.from_dict({"data": 2, "model": 2})
    tr = _stream_vs_ucp(tmp_path, mesh, mesh, {"moe.w": ep}, {"moe.w": tp})
    assert tr["moe.w"].cls is T.TransformClass.CONSOLIDATE


def test_stream_average_param_matches_ucp(tmp_path):
    mk = lambda dims: T.ParamSpec(
        name="a", logical_shape=(6, 4), runtime_shape=(2, 6, 4),
        states={k: T.StateLayoutSpec(tuple(dims)) for k in T.STATE_KINDS}, average=True,
    )
    tr = _stream_vs_ucp(tmp_path, T.MeshSpec.from_dict({"data": 2, "model": 1}),
                        T.MeshSpec.from_dict({"data": 2, "model": 2}),
                        {"a": mk([T.DimSpec(("data",)), T.DimSpec(), T.DimSpec()])},
                        {"a": mk([T.DimSpec(("data",)), T.DimSpec(("model",)), T.DimSpec()])})
    assert tr["a"].cls is T.TransformClass.CONSOLIDATE


@st.composite
def _random_reshard_case(draw):
    axis_choices = [(), ("data",), ("model",), ("data", "model")]
    meshes = [T.MeshSpec.from_dict({"data": draw(st.integers(1, 3)), "model": draw(st.integers(1, 3))})
              for _ in range(2)]
    rows, pad = draw(st.integers(4, 12)), draw(st.integers(0, 3))

    def dims():
        d = [T.DimSpec(draw(st.sampled_from(axis_choices))),
             T.DimSpec(draw(st.sampled_from([(), ("model",)])))]
        return (d[0], T.DimSpec()) if set(d[0].axes) & set(d[1].axes) else tuple(d)

    return meshes[0], meshes[1], rows, pad, dims(), dims()


@settings(max_examples=15, deadline=None)
@given(_random_reshard_case())
def test_property_stream_equals_ucp_random_layouts(tmp_path_factory, case):
    src_mesh, tgt_mesh, rows, pad, sd, td = case
    mk = lambda d: T.ParamSpec(
        name="w", logical_shape=(rows, 5), runtime_shape=(rows + pad, 5),
        states={k: T.StateLayoutSpec(tuple(d)) for k in T.STATE_KINDS},
    )
    _stream_vs_ucp(tmp_path_factory.mktemp("prop"), src_mesh, tgt_mesh,
                   {"w": mk(sd)}, {"w": mk(td)}, seed=rows * 7 + pad)


# ---------------------------------------------------------------------------
# reduced smollm: the reshard matrix, the manager and the reference's Load
# ---------------------------------------------------------------------------

CFG = TC.reduced(TC.get_config("smollm-360m"))
# (source mesh, source parallel kw, target mesh, target parallel kw, mode)
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


def _plan(mesh_d, kw=None):
    mesh = T.MeshSpec.from_dict(mesh_d)
    parallel = TC.ParallelismConfig(**(kw or {}))
    lm = build_model(CFG, vocab_multiple=TS.vocab_multiple(parallel, mesh))
    return TS.make_plan(CFG, lm.registry, parallel, mesh), lm


def _ref_plan(mesh_d, kw=None):
    cfg = RC.reduced(RC.get_config("smollm-360m"))
    mesh = R.MeshSpec.from_dict(mesh_d)
    parallel = RC.ParallelismConfig(**(kw or {}))
    from repro.models import build_model as ref_build

    lm = ref_build(cfg, vocab_multiple=RS.vocab_multiple(parallel, mesh))
    return RS.make_plan(cfg, lm.registry, parallel, mesh)


def _seeded_state(lm, seed=0):
    """Weights from ``lm.init`` and seeded random moments (numpy)."""
    state = init_state(lm.init(torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed)
    for tree in (state.exp_avg, state.exp_avg_sq):
        for t in flatten_with_paths(tree).values():
            t.copy_(torch.from_numpy(rng.random(tuple(t.shape), dtype=np.float32)))
    return state


@pytest.fixture(scope="module")
def matrix_sources(tmp_path_factory):
    cache = {}

    def get(src_mesh_d, src_kw):
        key = (tuple(sorted(src_mesh_d.items())), tuple(sorted(src_kw.items())))
        if key not in cache:
            plan, lm = _plan(src_mesh_d, src_kw)
            state = _seeded_state(lm)
            root = tmp_path_factory.mktemp("src") / "ck"
            CheckpointManager(root, plan, policy=CheckpointPolicy(async_save=False)).save(state, 10)
            cache[key] = (root, plan, state)
        return cache[key]

    return get


@pytest.mark.parametrize("src_mesh,src_kw,tgt_mesh,tgt_kw,expect", MATRIX)
def test_reshard_matrix_via_ucp_equals_stream_and_reference(
        matrix_sources, src_mesh, src_kw, tgt_mesh, tgt_kw, expect):
    """The planned restore and a forced VIA_UCP restore give the same bytes;
    the reference's ``state_from_ucp`` on the port's atoms gives them too;
    a stream leaves the checkpoint directory untouched."""
    root, _, _ = matrix_sources(src_mesh, src_kw)
    tgt_plan, _ = _plan(tgt_mesh, tgt_kw)
    mgr = CheckpointManager(root, tgt_plan, policy=CheckpointPolicy(async_save=False))
    before = sorted(p for p in root.rglob("*") if p.is_file())
    restored, info = mgr.restore("cpu")
    assert info.mode.value == expect, info.reason
    assert before == sorted(p for p in root.rglob("*") if p.is_file())
    via, info2 = mgr.restore("cpu", force_mode=T.ResumeMode.VIA_UCP)
    assert info2.mode is T.ResumeMode.VIA_UCP
    _states_equal(restored, via)

    ucp = R.UcpCheckpoint.open(_ucp_dir(mgr, 10))
    axes = tuple(tgt_mesh)
    ref = ref_state_from_ucp(ucp, _ref_plan(tgt_mesh, tgt_kw), jax.make_mesh((1,) * len(axes), axes))
    for tree, port_tree in ((ref.params, via.params), (ref.exp_avg, via.exp_avg),
                            (ref.exp_avg_sq, via.exp_avg_sq)):
        ref_flat = R.flatten_with_paths(tree)
        for name, t in flatten_with_paths(port_tree).items():
            assert np.asarray(ref_flat[name]).tobytes() == t.numpy().tobytes(), name


@pytest.fixture
def saved(tmp_path):
    plan, lm = _plan({"data": 2, "model": 2})
    state = _seeded_state(lm, seed=3)
    mgr = CheckpointManager(tmp_path / "ck", plan, policy=CheckpointPolicy(async_save=False))
    mgr.save(state, 10)
    target, _ = _plan({"data": 1, "model": 1}, {"zero": 1, "fsdp": False})
    return mgr, CheckpointManager(tmp_path / "ck", target, policy=CheckpointPolicy(async_save=False)), state


def _logical_equal(restored: TrainState, state: TrainState):
    for a, b in ((restored.params, state.params), (restored.exp_avg, state.exp_avg),
                 (restored.exp_avg_sq, state.exp_avg_sq)):
        fb = flatten_with_paths(b)
        for name, t in flatten_with_paths(a).items():
            assert torch.equal(t[tuple(slice(0, s) for s in fb[name].shape)], fb[name]), name


def test_via_ucp_restore_and_conversion_cache(saved):
    _, tgt, state = saved
    restored, info = tgt.restore("cpu", force_mode=T.ResumeMode.VIA_UCP)
    assert info.mode is T.ResumeMode.VIA_UCP and info.convert_stats is not None
    assert info.convert_stats.params == len(tgt.plan.param_specs)
    _logical_equal(restored, state)
    restored2, info2 = tgt.restore("cpu", force_mode=T.ResumeMode.VIA_UCP)
    assert info2.convert_stats is None  # the committed cache is reused
    _states_equal(restored, restored2)
    assert tgt.steps() == [10]  # the .ucp directory is not a step


def test_export_ucp_is_explicit_and_cached(saved):
    mgr, tgt, _ = saved
    ucp, cstats = mgr.export_ucp(device="cpu")
    assert cstats is not None and cstats.params > 0 and cstats.bytes_written > 0
    assert (_ucp_dir(mgr, 10) / "COMMIT").exists() and ucp.validate() == []
    _, cstats2 = mgr.export_ucp(10, device="cpu")
    assert cstats2 is None
    # a partial conversion (no COMMIT) is removed and redone
    (_ucp_dir(mgr, 10) / "COMMIT").unlink()
    _, cstats3 = mgr.export_ucp(device="cpu")
    assert cstats3 is not None and T.UcpCheckpoint.open(_ucp_dir(mgr, 10)).validate() == []
    with pytest.raises(ValueError, match="cannot force DIRECT"):
        tgt.restore("cpu", force_mode=T.ResumeMode.DIRECT)
    with pytest.raises(ValueError, match="no committed checkpoint"):
        CheckpointManager(mgr.root / "empty", mgr.plan).export_ucp(device="cpu")


def test_crash_mid_stream_falls_back_to_via_ucp(tmp_path, monkeypatch):
    mesh = T.MeshSpec.from_dict({"data": 2, "model": 1})
    specs = {
        "w": T.uniform_param_spec("w", (8, 6), [T.DimSpec(("data",)), T.DimSpec()]),
        "u": T.uniform_param_spec("u", (6, 4), [T.DimSpec(), T.DimSpec(("data",))]),
    }
    src = CheckpointManager(tmp_path / "ck", TS.ShardingPlan(mesh, dict(specs)))
    write_distributed(_random_state(specs, seed=11), src.plan, 10, src.step_dir(10))
    tgt_specs = {
        "w": T.uniform_param_spec("w", (8, 6), [T.DimSpec(), T.DimSpec(("data",))]),
        "u": T.uniform_param_spec("u", (6, 4), [T.DimSpec(("data",)), T.DimSpec()]),
    }
    mgr = CheckpointManager(tmp_path / "ck", TS.ShardingPlan(mesh, dict(tgt_specs)))
    real = TR.read_region_from_source
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise OSError("simulated I/O loss mid-stream")
        return real(*a, **kw)

    monkeypatch.setattr(TR, "read_region_from_source", flaky)
    restored, info = mgr.restore("cpu")
    assert calls["n"] >= 3, "stream path was never exercised"
    assert info.mode is T.ResumeMode.VIA_UCP and info.convert_stats is not None
    assert "stream failed" in info.reason and "via_ucp" in info.reason
    monkeypatch.setattr(TR, "read_region_from_source", real)
    _states_equal(restored, mgr.restore("cpu", force_mode=T.ResumeMode.VIA_UCP)[0])
    # a forced stream does not fall back: the error surfaces
    monkeypatch.setattr(TR, "read_region_from_source", flaky)
    calls["n"] = 0
    with pytest.raises(OSError, match="mid-stream"):
        mgr.restore("cpu", force_mode=T.ResumeMode.RESHARD_STREAM)
    # and an error that is not a lost shard propagates unforced too
    monkeypatch.setattr(TR, "read_region_from_source",
                        lambda *a, **kw: (_ for _ in ()).throw(TypeError("a bug")))
    with pytest.raises(TypeError, match="a bug"):
        mgr.restore("cpu")


def test_logical_shape_change_routes_via_ucp_and_is_refused(tmp_path):
    """A logical-shape change hiding inside unchanged runtime padding plans
    VIA_UCP, whose Load refuses it loudly (never serves padding as data)."""
    mesh = T.MeshSpec.from_dict({"data": 2, "model": 1})
    mk = lambda logical: T.ParamSpec(
        name="emb", logical_shape=logical, runtime_shape=(12, 4),
        states={k: T.StateLayoutSpec((T.DimSpec(("data",)), T.DimSpec())) for k in T.STATE_KINDS},
    )
    write_distributed(_random_state({"emb": mk((10, 4))}), TS.ShardingPlan(mesh, {"emb": mk((10, 4))}),
                      1, tmp_path / "ck" / "step_00000001")
    mgr = CheckpointManager(tmp_path / "ck", TS.ShardingPlan(mesh, {"emb": mk((12, 4))}))
    rp = T.plan_resume(T.DistCheckpoint.open(mgr.step_dir(1)).manifest,
                       T.TargetSpec(mesh, {"emb": mk((12, 4))}))
    assert rp.mode is T.ResumeMode.VIA_UCP and "logical shape" in rp.reason
    with pytest.raises(ValueError, match="logical shape"):
        mgr.restore("cpu")


def test_bf16_moments_via_ucp(tmp_path):
    """bf16 moments (numpy cannot hold them) convert to bf16 atoms and
    restore VIA_UCP equal to the stream."""
    plan, lm = _plan({"data": 2, "model": 2}, {"moment_dtype": "bfloat16"})
    state = _seeded_state(lm)
    state = TrainState(state.params, _cast_tree(state.exp_avg), _cast_tree(state.exp_avg_sq),
                       state.step)
    CheckpointManager(tmp_path / "ck", plan, policy=CheckpointPolicy(async_save=False)).save(state, 4)
    target, _ = _plan({"data": 1, "model": 1}, {"moment_dtype": "bfloat16"})
    mgr = CheckpointManager(tmp_path / "ck", target)
    stream, info = mgr.restore("cpu")
    via, info2 = mgr.restore("cpu", force_mode=T.ResumeMode.VIA_UCP)
    assert info.mode is T.ResumeMode.RESHARD_STREAM and info2.mode is T.ResumeMode.VIA_UCP
    _states_equal(stream, via)
    ucp = T.UcpCheckpoint.open(_ucp_dir(mgr, 4))
    name = next(iter(ucp.manifest.atoms))
    assert ucp.manifest.atoms[name].dtypes[T.StateKind.EXP_AVG] == "bfloat16"
    assert ucp.validate() == []
    _same_as_reference_conversion(T.DistCheckpoint.open(mgr.step_dir(4)), ucp, tmp_path)


def _cast_tree(tree):
    from repro_torch.core.pytree import unflatten_from_paths

    return unflatten_from_paths({k: v.to(torch.bfloat16) for k, v in flatten_with_paths(tree).items()})


# ---------------------------------------------------------------------------
# across packages: one distributed checkpoint, two conversions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", [None, "int8:b256"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_conversions_agree_across_packages(tmp_path, writer, codec):
    """The same checkpoint (written by either package, raw or with coded
    moments) converted by both packages: equal manifests and digests, and
    each package reads the other's atoms bit for bit.  Coded moments are
    decoded by each package's codec before the union."""
    plan, lm = _plan({"data": 2, "model": 2})
    state = _seeded_state(lm, seed=5)
    root = tmp_path / "step_00000006"
    if writer == "port":
        policy = CodecPolicy.moments(codec) if codec else None
        write_distributed(snapshot_state(state, policy), plan, 6, root, codec=policy)
    else:
        snap = {n: {R.StateKind(k.value): (a.numpy() if isinstance(a, torch.Tensor) else a)
                    for k, a in kinds.items()} for n, kinds in snapshot_state(state).items()}
        ref_write(snap, _ref_plan({"data": 2, "model": 2}), 6, root, workers=1,
                  codec=RCodecPolicy.moments(codec) if codec else None)
    ck = T.DistCheckpoint.open(root)
    assert bool(ck.manifest.shard_codecs) == bool(codec)
    ucp, stats = T.convert_to_ucp(ck, str(tmp_path / "port.ucp"))
    assert ucp.validate() == [] and stats.atoms_written == 3 * len(plan.param_specs)
    _same_as_reference_conversion(ck, ucp, tmp_path)
    if codec is None:  # raw: the atoms are the saved state, logically
        for kind, tree in zip(KINDS, (state.params, state.exp_avg, state.exp_avg_sq)):
            for name, t in flatten_with_paths(tree).items():
                want = t[tuple(slice(0, s) for s in plan.param_specs[name].logical_shape)]
                assert ucp.read_atom(name, kind).tobytes() == want.numpy().tobytes()


# ---------------------------------------------------------------------------
# the serve launcher
# ---------------------------------------------------------------------------


def _serve(ckpt_dir, mesh, *extra):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "smollm-360m", "--reduced", "--ckpt-dir", str(ckpt_dir),
         "--mesh", mesh, "--batch", "2", "--prompt-len", "8", "--gen", "6", *extra],
        capture_output=True, text=True, timeout=300, check=False,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_serve_cli_via_ucp_equals_stream(tmp_path):
    plan, lm = _plan({"data": 2, "model": 2})
    write_distributed(snapshot_weights(lm.init(torch.Generator().manual_seed(3))), plan, 5,
                      tmp_path / "ck" / "step_00000005")
    via = _serve(tmp_path / "ck", "data=1,model=1", "--force-mode", "via_ucp")
    assert (via["mode"], via["step"]) == ("via_ucp", 5)
    assert (tmp_path / "ck" / "step_00000005.ucp" / "COMMIT").exists()
    stream = _serve(tmp_path / "ck", "data=1,model=1")
    assert stream["mode"] == "reshard_stream" and stream["tokens"] == via["tokens"]
