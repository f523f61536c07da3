"""The port's shard codec, held against the JAX package.

* ``encode_shard``: the RQS1 payload bytes equal the reference's for the
  same shard and tag (int8, fp8 e4m3/e5m2, int8ef, and int8ef's raw
  fall-back on bf16 values it cannot prove exact), and each package decodes
  the other's payload bit for bit;
* ``parse_codec`` and ``CodecPolicy`` reject what the reference rejects;
* checkpoints: a coded ``write_distributed`` of the port writes the same
  files, bytes and manifest as the reference's serial writer, and the
  reference validates and decodes it; a coded save of the reference
  restores in the port DIRECT and RESHARD_STREAM (plans from ``make_plan``
  over a ``MeshSpec``: no devices), with every coded shard's decoded view
  equal to the reference's ``read_shard`` and the served digests valid.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.core as R  # noqa: E402
import repro.core.codec as RCO  # noqa: E402
import repro.dist.sharding as RS  # noqa: E402
from repro.ckpt.saver import write_distributed as ref_write  # noqa: E402
from repro.core.pytree import flatten_with_paths  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.codec as TCO  # noqa: E402
import repro_torch.dist.sharding as TS  # noqa: E402
from repro_torch.ckpt.restore import state_from_source, state_from_stream  # noqa: E402
from repro_torch.ckpt.saver import write_distributed as port_write  # noqa: E402
from repro_torch.core.layout import slice_shard  # noqa: E402
from repro_torch.models import build_model as port_build  # noqa: E402

TAGS = ["int8:b256", "int8:b64", "fp8:e4m3:b128", "fp8:e5m2:b32", "int8ef:b64", "int8:b100"]
SHAPES = [(5,), (33, 7), (4, 3, 5), (1000,)]
SOURCE = {"data": 2, "model": 2}


def _rand(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 3.0).astype(np.float32)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_payload_bytes_equal_reference(tag, shape):
    x = _rand(shape, seed=len(shape))
    mine = TCO.encode_shard(x, tag)
    theirs = RCO.encode_shard(x, tag)
    assert mine.tag == theirs.tag == tag
    assert mine.payload.tobytes() == theirs.payload.tobytes()
    assert mine.decoded.tobytes() == theirs.decoded.tobytes()
    # a CPU tensor encodes to the same bytes, its decoded view a tensor
    as_tensor = TCO.encode_shard(torch.from_numpy(x), tag)
    assert as_tensor.payload.tobytes() == theirs.payload.tobytes()
    assert as_tensor.decoded.numpy().tobytes() == theirs.decoded.tobytes()


@pytest.mark.parametrize("tag", TAGS)
def test_each_package_decodes_the_others_payload(tag):
    x = _rand((777,), seed=3)
    mine, theirs = TCO.encode_shard(x, tag), RCO.encode_shard(x, tag)
    by_ref = RCO.decode_payload(mine.payload, expect_tag=tag, expect_dtype="float32")
    by_port = TCO.decode_payload(theirs.payload, expect_tag=tag, expect_dtype="float32")
    assert by_ref.tobytes() == theirs.decoded.tobytes()
    assert isinstance(by_port, np.ndarray) and by_port.tobytes() == mine.decoded.tobytes()


@pytest.mark.parametrize("tag", ["int8:b256", "fp8:e4m3:b256", "fp8:e5m2:b256"])
def test_payload_bytes_equal_reference_on_nonfinite(tag):
    """±NaN, ±inf and an all-NaN block: the same payload bytes (e5m2's NaN
    code included); the decoded views NaN at the same places (a NaN's
    payload differs between the reference's own paths), all else equal."""
    x = _rand((1000,), seed=5)
    x[3], x[50], x[300], x[420] = np.nan, -np.nan, np.inf, -np.inf
    x[512:768] = np.nan
    mine, theirs = TCO.encode_shard(x, tag), RCO.encode_shard(x, tag)
    assert mine.payload.tobytes() == theirs.payload.tobytes()
    nan = np.isnan(theirs.decoded)
    assert np.array_equal(np.isnan(mine.decoded), nan) and nan[:768].all()
    assert mine.decoded[~nan].tobytes() == theirs.decoded[~nan].tobytes()


def test_int8ef_bf16_falls_back_or_is_exact_as_in_the_reference():
    x = _rand((300,), seed=8)
    theirs = RCO.encode_shard(x.astype(ml_dtypes.bfloat16), "int8ef:b64")
    mine = TCO.encode_shard(torch.from_numpy(x).to(torch.bfloat16), "int8ef:b64")
    assert mine.tag == theirs.tag
    if theirs.tag == TCO.CODEC_RAW:
        assert mine.payload is None
    else:
        assert mine.payload.tobytes() == theirs.payload.tobytes()


def test_decode_crosschecks_raise():
    es = TCO.encode_shard(_rand((128,)), "int8:b64")
    with pytest.raises(T.tensor_io.IntegrityError, match="manifest recorded"):
        TCO.decode_payload(es.payload, expect_tag="int8:b32")
    with pytest.raises(T.tensor_io.IntegrityError, match="dtype"):
        TCO.decode_payload(es.payload, expect_dtype="float16")
    with pytest.raises(T.tensor_io.IntegrityError, match="magic"):
        TCO.decode_payload(np.zeros(64, np.uint8), expect_tag="int8:b64")


@pytest.mark.parametrize("junk", ["int8", "int8:b0", "int8:bx", "fp8:b64", "zstd", "int8:b-4"])
def test_parse_codec_rejects_what_the_reference_rejects(junk):
    with pytest.raises(ValueError):
        RCO.parse_codec(junk)
    with pytest.raises(ValueError):
        TCO.parse_codec(junk)


def test_parse_and_policy_agree_with_reference():
    for tag in ["raw", "int8:b256", "int8ef:b64", "fp8:e4m3:b128", "fp8:e5m2:b32"]:
        a, b = TCO.parse_codec(tag), RCO.parse_codec(tag)
        assert (a.tag, a.lossless, a.block) == (b.tag, b.lossless, b.block)
        if tag != "raw":
            assert a.qdtype == np.dtype(b.qdtype).name
    for cls in (TCO.CodecPolicy, RCO.CodecPolicy):
        with pytest.raises(ValueError, match="lossy"):
            cls(params="int8:b256")
        with pytest.raises(ValueError):
            cls(exp_avg="int8:b0")
    p = TCO.CodecPolicy.moments("fp8:e4m3:b128")
    assert p.tag_for(T.StateKind.FP32) == "raw"
    assert p.tag_for(T.StateKind.EXP_AVG_SQ) == "fp8:e4m3:b128"
    assert TCO.CodecPolicy().is_raw and not p.is_raw
    assert TCO.CodecPolicy(params="int8ef:b256", allow_lossy_params=False).params == "int8ef:b256"


# ---------------------------------------------------------------------------
# Coded checkpoints across the two packages
# ---------------------------------------------------------------------------


def _plans(mesh_d):
    mesh_r, mesh_t = R.MeshSpec.from_dict(mesh_d), T.MeshSpec.from_dict(mesh_d)
    rcfg, tcfg = RC.reduced(RC.get_config("smollm-360m")), TC.reduced(TC.get_config("smollm-360m"))
    rpar, tpar = RC.ParallelismConfig(), TC.ParallelismConfig()
    rlm = ref_build(rcfg, vocab_multiple=RS.vocab_multiple(rpar, mesh_r))
    tlm = port_build(tcfg, vocab_multiple=TS.vocab_multiple(tpar, mesh_t))
    return (RS.make_plan(rcfg, rlm.registry, rpar, mesh_r), rlm,
            TS.make_plan(tcfg, tlm.registry, tpar, mesh_t))


@pytest.fixture(scope="module")
def snapshot():
    """Reference params with seeded moments (numpy); the moments span the
    magnitudes of a real second moment."""
    _, rlm, _ = _plans(SOURCE)
    params = flatten_with_paths(rlm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    return {
        n: {
            R.StateKind.FP32: np.asarray(p),
            R.StateKind.EXP_AVG: (rng.standard_normal(p.shape) * 1e-3).astype(np.float32),
            R.StateKind.EXP_AVG_SQ: (rng.random(p.shape) * 1e-6).astype(np.float32),
        }
        for n, p in params.items()
    }


@pytest.fixture(scope="module", params=["int8:b256", "fp8:e4m3:b128"])
def ref_coded(request, snapshot, tmp_path_factory):
    rplan, _, _ = _plans(SOURCE)
    root = tmp_path_factory.mktemp("refcoded") / "step_00000003"
    ref_write(snapshot, rplan, 3, root, workers=1, codec=RCO.CodecPolicy.moments(request.param))
    return root


def _port_snap(snapshot):
    return {n: {T.StateKind(k.value): a for k, a in kinds.items()} for n, kinds in snapshot.items()}


@pytest.mark.parametrize("tag", ["int8:b256", "fp8:e5m2:b256", "int8ef:b256"])
def test_port_coded_save_is_the_reference_save(snapshot, tmp_path, tag):
    rplan, _, tplan = _plans(SOURCE)
    res = port_write(_port_snap(snapshot), tplan, 3, tmp_path / "port",
                     codec=TCO.CodecPolicy.moments(tag))
    rres = ref_write(snapshot, rplan, 3, tmp_path / "ref", workers=1,
                     codec=RCO.CodecPolicy.moments(tag))
    port_ck = R.DistCheckpoint.open(tmp_path / "port")
    ref_ck = R.DistCheckpoint.open(tmp_path / "ref")
    pj, rj = port_ck.manifest.to_json(), ref_ck.manifest.to_json()
    pj.pop("created_at"), rj.pop("created_at")
    assert pj == rj
    assert pj.get("shard_codecs") and (tag.startswith("int8ef") or pj["shard_pre_digests"])
    assert res.bytes_written == rres.bytes_written
    assert res.coded_raw_bytes > 3 * res.coded_bytes or tag.startswith("int8ef")
    assert port_ck.validate() == []  # the reference decodes and re-hashes every shard
    for key in rj["shard_digests"]:
        rel = f"ranks/{key}.npy"
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "ref" / rel).read_bytes()


@pytest.mark.parametrize("tgt_mesh,mode", [(SOURCE, "direct"), ({"data": 1, "model": 1},
                                                                 "reshard_stream")])
def test_reference_coded_save_restores_in_port(snapshot, ref_coded, tgt_mesh, mode):
    _, _, src_plan = _plans(SOURCE)
    _, _, tplan = _plans(tgt_mesh)
    ck = T.DistCheckpoint.open(ref_coded)
    assert ck.manifest.shard_codecs
    assert ck.validate() == []  # the port decodes and re-hashes every shard
    rp = T.plan_resume(ck.manifest, T.TargetSpec(tplan.mesh, tplan.param_specs))
    assert rp.mode.value == mode, rp.reason
    if mode == "direct":
        state = state_from_source(ck, tplan, "cpu")
    else:
        state = state_from_stream(ck, tplan, "cpu", rp.transforms)
    assert state.step == 3
    rck = R.DistCheckpoint.open(ref_coded)
    trees = {T.StateKind.FP32: state.params, T.StateKind.EXP_AVG: state.exp_avg,
             T.StateKind.EXP_AVG_SQ: state.exp_avg_sq}
    for kind, tree in trees.items():
        flat = T.flatten_with_paths(tree)
        for name, spec in src_plan.param_specs.items():
            got = flat[name]
            assert got.device.type == "cpu" and tuple(got.shape) == tuple(
                tplan.param_specs[name].runtime_shape)
            logical = got[tuple(slice(0, s) for s in spec.logical_shape)]
            if kind is T.StateKind.FP32:
                np.testing.assert_array_equal(logical.numpy(), snapshot[name][R.StateKind.FP32])
            # every source shard, re-cut from the restored state, is the
            # reference's served (decoded) view of it
            padded = torch.zeros(spec.runtime_shape, dtype=got.dtype)
            padded[tuple(slice(0, s) for s in spec.logical_shape)] = logical
            layout = spec.layout_for(kind, src_plan.mesh)
            for rank in rck.writing_ranks(name, R.StateKind(kind.value)):
                mine = slice_shard(padded, layout, rank).numpy()
                theirs = rck.read_shard(rank, name, R.StateKind(kind.value))
                assert mine.tobytes() == np.ascontiguousarray(theirs).tobytes(), (name, kind)
