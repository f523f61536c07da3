"""The checkpoint format, both ways between the JAX package and the port.

* Reference → port: the reference ``write_distributed`` (a numpy snapshot
  of reference params, under data=2,model=2) restored by the port's
  ``params_from_source`` — DIRECT under the same layout, RESHARD_STREAM
  under data=1,model=1 and data=4,model=1 — is bit-identical to the saved
  weights and to the reference ``read_region_from_source`` of the same
  regions.
* Port → reference: the port's ``write_distributed`` opens in the reference;
  the manifests are equal apart from ``created_at``, every shard digest
  matches, the reference validates it and reads back the same bytes.
* ``tensor_io``: bf16/fp8 cross the two packages through raw-byte views.
* The numpy path takes bf16 state: a numpy snapshot whose plan says
  bfloat16 moments is cast through torch (round to nearest even) and
  written byte for byte as the reference writes it; the reference reads it
  back.  An extended dtype resolves to the void of its width there, never
  to an integer type.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.core as R  # noqa: E402
import repro.core.tensor_io as RIO  # noqa: E402
import repro.dist.sharding as RS  # noqa: E402
from repro.ckpt.restore import read_region_from_source as ref_read_region  # noqa: E402
from repro.ckpt.saver import write_distributed as ref_write  # noqa: E402
from repro.core.pytree import flatten_with_paths  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.tensor_io as TIO  # noqa: E402
import repro_torch.dist.sharding as TS  # noqa: E402
from repro_torch.ckpt.restore import params_from_source, target_regions  # noqa: E402
from repro_torch.ckpt.saver import snapshot_weights, write_distributed as port_write  # noqa: E402
from repro_torch.models import build_model as port_build  # noqa: E402

SOURCE = {"data": 2, "model": 2}
TARGETS = [
    ({"data": 2, "model": 2}, "direct"),
    ({"data": 1, "model": 1}, "reshard_stream"),
    ({"data": 4, "model": 1}, "reshard_stream"),
]


def _ref_plan(mesh_d):
    cfg = RC.reduced(RC.get_config("smollm-360m"))
    mesh = R.MeshSpec.from_dict(mesh_d)
    parallel = RC.ParallelismConfig()
    lm = ref_build(cfg, vocab_multiple=RS.vocab_multiple(parallel, mesh))
    return RS.make_plan(cfg, lm.registry, parallel, mesh), lm, cfg


def _port_plan(mesh_d):
    cfg = TC.reduced(TC.get_config("smollm-360m"))
    mesh = T.MeshSpec.from_dict(mesh_d)
    parallel = TC.ParallelismConfig()
    lm = port_build(cfg, vocab_multiple=TS.vocab_multiple(parallel, mesh))
    return TS.make_plan(cfg, lm.registry, parallel, mesh), lm, cfg


@pytest.fixture(scope="module")
def ref_snapshot():
    """Reference params (``lm.init``) with seeded random moments, as numpy."""
    _, lm, _ = _ref_plan(SOURCE)
    params = flatten_with_paths(lm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    return {
        n: {
            R.StateKind.FP32: np.asarray(p),
            R.StateKind.EXP_AVG: rng.standard_normal(p.shape).astype(np.float32),
            R.StateKind.EXP_AVG_SQ: rng.random(p.shape).astype(np.float32),
        }
        for n, p in params.items()
    }


@pytest.fixture(scope="module")
def ref_ckpt(ref_snapshot, tmp_path_factory):
    plan, lm, cfg = _ref_plan(SOURCE)
    root = tmp_path_factory.mktemp("ref") / "step_00000005"
    ref_write(ref_snapshot, plan, 5, root, workers=1,
              config_fingerprint=cfg.fingerprint())
    return root


@pytest.mark.parametrize("tgt_mesh,mode", TARGETS)
def test_reference_checkpoint_restores_in_port(ref_snapshot, ref_ckpt, tgt_mesh, mode):
    tplan, _, _ = _port_plan(tgt_mesh)
    ck = T.DistCheckpoint.open(ref_ckpt)
    rp = T.plan_resume(ck.manifest, T.TargetSpec(tplan.mesh, tplan.param_specs))
    assert rp.mode.value == mode, rp.reason
    flat = params_from_source(ck, tplan, "cpu", transforms=rp.transforms)
    assert set(flat) == set(ref_snapshot)
    rck = R.DistCheckpoint.open(ref_ckpt)
    for name, t in flat.items():
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        got = t.numpy()
        np.testing.assert_array_equal(got, ref_snapshot[name][R.StateKind.FP32])
        for region in target_regions(tplan.param_specs[name], tplan.mesh):
            want = ref_read_region(rck, name, R.StateKind.FP32, region, "float32")
            assert got[region].tobytes() == np.ascontiguousarray(want).tobytes()


def test_port_checkpoint_opens_in_reference(ref_snapshot, tmp_path):
    rplan, _, rcfg = _ref_plan(SOURCE)
    tplan, _, tcfg = _port_plan(SOURCE)
    snap = {n: {T.StateKind(k.value): a for k, a in kinds.items()}
            for n, kinds in ref_snapshot.items()}
    res = port_write(snap, tplan, 5, tmp_path / "port",
                     scalars={"data_cursor": 7}, config_fingerprint=tcfg.fingerprint())
    rres = ref_write(ref_snapshot, rplan, 5, tmp_path / "ref", workers=1,
                     scalars={"data_cursor": 7}, config_fingerprint=rcfg.fingerprint())
    port_ck = R.DistCheckpoint.open(tmp_path / "port")
    ref_ck = R.DistCheckpoint.open(tmp_path / "ref")
    assert port_ck.is_committed
    pj, rj = port_ck.manifest.to_json(), ref_ck.manifest.to_json()
    pj.pop("created_at"), rj.pop("created_at")
    assert pj == rj
    assert res.shards_written == len(rj["shard_digests"])
    assert res.bytes_written == rres.bytes_written
    assert port_ck.validate() == []  # the reference recomputes every digest
    for name, spec in port_ck.manifest.params.items():
        for kind in spec.states:
            for rank in port_ck.writing_ranks(name, kind):
                a = port_ck.read_shard(rank, name, kind)
                b = ref_ck.read_shard(rank, name, kind)
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()


def test_snapshot_writes_zero_moments(tmp_path):
    """``snapshot_weights`` lists all three kinds, with the moments at
    AdamW's initial zeros, so the manifest matches a reference checkpoint's."""
    tplan, lm, _ = _port_plan(SOURCE)
    params = lm.init(torch.Generator().manual_seed(0))
    snap = snapshot_weights(params)
    port_write(snap, tplan, 1, tmp_path / "ck")
    ck = R.DistCheckpoint.open(tmp_path / "ck")
    assert ck.validate() == []
    for name, spec in ck.manifest.params.items():
        atoms = {k: R.assemble_atom(ck, spec, k) for k in R.STATE_KINDS}
        assert not atoms[R.StateKind.EXP_AVG].any() and not atoms[R.StateKind.EXP_AVG_SQ].any()
        want = T.flatten_with_paths(params)[name].numpy()
        np.testing.assert_array_equal(atoms[R.StateKind.FP32], want)


EXTENDED = {
    "bfloat16": ml_dtypes.bfloat16,
    "float8_e4m3fn": ml_dtypes.float8_e4m3fn,
    "float8_e5m2": ml_dtypes.float8_e5m2,
}


def _extended(name):
    rng = np.random.default_rng(1)
    return rng.standard_normal((6, 5)).astype(np.float32).astype(EXTENDED[name])


# float8_e5m2 is left out of this direction: the reference's own save_tensor
# writes it with descr '<f1', which np.load (and so the reference's
# load_tensor) refuses — see ROADMAP queue 3.
@pytest.mark.parametrize("name", ["bfloat16", "float8_e4m3fn"])
def test_reference_extended_dtype_loads_in_port(tmp_path, name):
    ref_arr = _extended(name)
    RIO.save_tensor(tmp_path / "r.npy", ref_arr)
    got = TIO.load_tensor(tmp_path / "r.npy", dtype=name)
    assert isinstance(got, torch.Tensor) and got.dtype == TIO.torch_dtype(name)
    np.testing.assert_array_equal(got.float().numpy(), ref_arr.astype(np.float32))
    assert TIO.content_digest(got) == RIO.content_digest(ref_arr)


@pytest.mark.parametrize("name", sorted(EXTENDED))
def test_port_extended_dtype_loads_in_reference(tmp_path, name):
    ref_arr = _extended(name)
    t = torch.from_numpy(ref_arr.astype(np.float32)).to(TIO.torch_dtype(name))
    TIO.save_tensor(tmp_path / "p.npy", t)
    back = RIO.load_tensor(tmp_path / "p.npy", dtype=name)
    assert back.dtype == np.dtype(EXTENDED[name])
    assert back.tobytes() == ref_arr.tobytes()  # torch and ml_dtypes round alike
    assert TIO.content_digest(t) == RIO.content_digest(back)
    again = TIO.load_tensor(tmp_path / "p.npy", dtype=name)
    assert torch.equal(again, t)
    # never an integer type on the numpy path: the void of the width (bytes)
    resolved = TIO.resolve_dtype(name)
    assert resolved.kind == "V" and resolved.itemsize == ref_arr.itemsize


def test_content_digest_matches_reference():
    rng = np.random.default_rng(2)
    arr = rng.standard_normal((3, 7)).astype(np.float32)[:, ::2]  # non-contiguous
    assert TIO.content_digest(arr) == RIO.content_digest(arr)
    as_tensor = torch.from_numpy(np.ascontiguousarray(arr))
    assert TIO.content_digest(as_tensor) == RIO.content_digest(arr)
    assert TIO.content_digest(arr, "crc32") == RIO.content_digest(arr, "crc32")


def test_bf16_moments_on_the_numpy_path_are_the_reference_bytes(ref_snapshot, tmp_path):
    """``moment_dtype="bfloat16"`` with a numpy (float32) snapshot: the port
    casts the moments through torch, the reference through ``ml_dtypes``;
    every file, header included, and the manifest are equal, the reference
    validates the port's checkpoint and reads the same bf16 values, and
    the port restores the reference's bit-equal."""
    mesh = R.MeshSpec.from_dict(SOURCE)
    rcfg, tcfg = RC.reduced(RC.get_config("smollm-360m")), TC.reduced(TC.get_config("smollm-360m"))
    rpar = RC.ParallelismConfig(moment_dtype="bfloat16")
    tpar = TC.ParallelismConfig(moment_dtype="bfloat16")
    rlm = ref_build(rcfg, vocab_multiple=RS.vocab_multiple(rpar, mesh))
    tlm = port_build(tcfg, vocab_multiple=TS.vocab_multiple(tpar, T.MeshSpec.from_dict(SOURCE)))
    rplan = RS.make_plan(rcfg, rlm.registry, rpar, mesh)
    tplan = TS.make_plan(tcfg, tlm.registry, tpar, T.MeshSpec.from_dict(SOURCE))
    snap = {n: {T.StateKind(k.value): a for k, a in kinds.items()}
            for n, kinds in ref_snapshot.items()}
    port_write(snap, tplan, 5, tmp_path / "port", config_fingerprint=tcfg.fingerprint())
    ref_write(ref_snapshot, rplan, 5, tmp_path / "ref", workers=1,
              config_fingerprint=rcfg.fingerprint())
    files = sorted(p.relative_to(tmp_path / "ref") for p in (tmp_path / "ref").glob("ranks/**/*.npy"))
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").glob("ranks/**/*.npy"))
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "ref" / rel).read_bytes(), rel
    pj, rj = (R.DistCheckpoint.open(tmp_path / d).manifest.to_json() for d in ("port", "ref"))
    pj.pop("created_at"), rj.pop("created_at")
    assert pj == rj
    ck = R.DistCheckpoint.open(tmp_path / "port")
    assert ck.validate() == []
    spec = ck.manifest.params["layers.blk.w_up"]
    for kind in (R.StateKind.EXP_AVG, R.StateKind.EXP_AVG_SQ):
        atom = R.assemble_atom(ck, spec, kind)
        want = ref_snapshot["layers.blk.w_up"][kind].astype(ml_dtypes.bfloat16)
        assert atom.dtype == np.dtype(ml_dtypes.bfloat16) and atom.tobytes() == want.tobytes()
    # and back: the reference's bf16 checkpoint restores in the port bit-equal
    from repro_torch.ckpt.manager import CheckpointManager

    (tmp_path / "mgr").mkdir()
    (tmp_path / "ref").rename(tmp_path / "mgr" / "step_00000005")
    state, info = CheckpointManager(tmp_path / "mgr", tplan).restore("cpu")
    assert info.mode.value == "direct"
    got = T.flatten_with_paths(state.exp_avg_sq)["layers.blk.w_up"]
    want = ref_snapshot["layers.blk.w_up"][R.StateKind.EXP_AVG_SQ].astype(ml_dtypes.bfloat16)
    assert got.dtype == torch.bfloat16
    assert got.contiguous().view(torch.uint16).numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("name", sorted(EXTENDED))
def test_numpy_path_buffers_of_extended_dtypes(tmp_path, name):
    """The arena and ``open_memmap`` take bf16/fp8: void buffers of the
    width (bytes, not numbers).  A memmap filled from a tensor is the file
    the reference's ``np.save`` of the same ``ml_dtypes`` array writes —
    except float8_e5m2, whose '<f1' header the reference's own ``np.load``
    refuses, so the port writes it as a '|V1' void the reference loads."""
    from repro_torch.core.engine import BufferArena

    buf = BufferArena().alloc((3, 4), name)
    assert buf.dtype.kind == "V" and buf.dtype.itemsize == np.dtype(EXTENDED[name]).itemsize
    ref_arr = _extended(name)
    t = torch.from_numpy(ref_arr.astype(np.float32)).to(TIO.torch_dtype(name))
    mm = TIO.open_memmap(tmp_path / "m.npy", ref_arr.shape, name)
    mm[...] = TIO.to_staging(mm, t)
    mm.flush()
    del mm
    TIO.save_tensor(tmp_path / "s.npy", t)
    assert (tmp_path / "m.npy").read_bytes() == (tmp_path / "s.npy").read_bytes()
    if name != "float8_e5m2":
        RIO.save_tensor(tmp_path / "r.npy", ref_arr)
        assert (tmp_path / "m.npy").read_bytes() == (tmp_path / "r.npy").read_bytes()
    else:
        RIO.save_tensor(tmp_path / "r.npy", ref_arr)
        with pytest.raises(ValueError):
            RIO.load_tensor(tmp_path / "r.npy", dtype=name)  # the reference cannot load its own
    back = RIO.load_tensor(tmp_path / "m.npy", dtype=name)
    assert back.tobytes() == ref_arr.tobytes()
    assert torch.equal(TIO.to_extended(ref_arr.astype(np.float32), name), t)
    assert torch.equal(TIO.to_extended(np.load(tmp_path / "m.npy"), name), t)
