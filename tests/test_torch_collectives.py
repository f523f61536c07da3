"""The port's compressed gradient collectives (``repro_torch.dist``) against
the reference's (``repro.dist.collectives``), on the CPU.

* The reference's four cases (``tests/test_collectives.py``), each also
  holding the port against the reference on the same numpy inputs: codes
  and scales bit-equal, the dequantized values bit-equal.
* ``compressed_psum`` over a one-rank gloo group against the reference's
  jitted ``compressed_psum`` under ``shard_map`` on a mesh of 1, for 30
  error-feedback steps: ``synced`` bit-equal; the residual bit-equal to
  the reference's ``acc - sent`` and within half an ulp of ``sent`` of the
  jitted one (XLA contracts ``acc - q * scale`` into an FMA on the CPU).
* Two- and four-rank gloo worlds in spawned processes: each rank's
  ``synced`` equals the numpy sum over the ranks of the reference's
  ``dequantize(quantize(acc_r))`` (within 1e-6 relative: the ring's order
  of summation is its own), every rank's residual is the reference's bit
  for bit, the telescoping identity holds, and every rank gets the same
  result.
* Without an initialized group it raises.

The reference is imported lazily, so the spawned ranks (which import this
module to find their entry point) and the card tests that reuse it load no
JAX.
"""

import math
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.dist import compressed_psum, dequantize_int8, quantize_int8  # noqa: E402
from repro_torch.kernels.block_quant.ops import block_dequantize, block_quantize  # noqa: E402

JOIN_TIMEOUT_S = 240


def _ref():
    pytest.importorskip("jax")
    from repro.dist import collectives

    return collectives


def _np(x):
    return np.asarray(x)


def _assert_bits_equal(got: torch.Tensor, want) -> None:
    want = _np(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


# ---------------------------------------------------------------------------
# the reference's cases, held against the reference


def test_quantize_roundtrip_error_bound():
    import jax

    ref = _ref()
    x = _np(jax.random.normal(jax.random.PRNGKey(0), (1000,)) * 3.0).copy()
    q, s = quantize_int8(torch.from_numpy(x), block=128)
    y = dequantize_int8(q, s, x.shape)
    rq, rs = ref.quantize_int8(x, block=128)
    _assert_bits_equal(q, rq)
    _assert_bits_equal(s, rs)
    _assert_bits_equal(y, ref.dequantize_int8(rq, rs, x.shape))
    # per-block max-scaled int8: error ≤ scale/2 = max|block|/254
    err = np.abs(x - y.numpy())
    assert err.max() <= float(np.abs(x).max()) / 254 + 1e-6


def test_quantize_handles_zeros_and_padding():
    ref = _ref()
    x = np.zeros((130,), np.float32)
    q, s = quantize_int8(torch.from_numpy(x), block=64)
    y = dequantize_int8(q, s, x.shape)
    np.testing.assert_array_equal(y.numpy(), 0.0)
    rq, rs = ref.quantize_int8(x, block=64)
    _assert_bits_equal(q, rq)
    _assert_bits_equal(s, rs)
    _assert_bits_equal(y, ref.dequantize_int8(rq, rs, x.shape))


def test_wire_bytes_are_4x_smaller():
    ref = _ref()
    x = torch.zeros((1024,), dtype=torch.float32)
    q, s = quantize_int8(x, block=256)
    wire = q.numel() * q.element_size() + s.numel() * s.element_size()
    assert wire * 3.5 < x.numel() * x.element_size() * 1.01
    rq, rs = ref.quantize_int8(x.numpy(), block=256)
    assert wire == rq.nbytes + rs.nbytes


@pytest.fixture
def one_rank_group(tmp_path):
    assert not dist.is_initialized(), "a test left the default group initialized"
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_error_feedback_unbiased_over_steps(one_rank_group):
    """With error feedback, the *accumulated* synced gradient converges to
    the accumulated true gradient; and step by step, given the same residual,
    ``synced`` is the jitted reference's bit for bit.

    The residual is ``acc - sent`` as the reference writes it, bit for bit;
    the *jitted* reference differs there: XLA's CPU backend contracts
    ``acc - q * scale`` into one FMA, skipping the rounding of ``q * scale``
    that ``sent`` carries, so its residual may differ from the port's by up
    to half an ulp of ``sent`` (and by nothing else)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    ref = _ref()
    mesh = jax.make_mesh((1,), ("pod",))

    @jax.jit
    def step(g, err):
        f = shard_map(
            lambda gg, ee: ref.compressed_psum(gg, ee, axis_name="pod"),
            mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()),
        )
        return f(g, err)

    true_total = torch.zeros(64)
    sync_total = torch.zeros(64)
    err = torch.zeros(64)
    rerr = jnp.zeros((64,))
    key = jax.random.PRNGKey(1)
    q0, d0 = block_quantize.launches, block_dequantize.launches
    for _ in range(30):
        key, k = jax.random.split(key)
        g = jax.random.normal(k, (64,))
        gt = torch.from_numpy(_np(g).copy())
        # the port from the reference's residual: the same step, compared
        rsynced, rerr_next = step(g, rerr)
        synced_r, err_r = compressed_psum(gt, torch.from_numpy(_np(rerr).copy()))
        _assert_bits_equal(synced_r, rsynced)
        _assert_bits_equal(err_r, (_np(g) + _np(rerr)) - _np(rsynced))
        half_ulp = np.spacing(np.abs(_np(rsynced))) / 2
        assert np.all(np.abs(err_r.numpy().astype(np.float64) - _np(rerr_next)) <= half_ulp)
        rerr = rerr_next
        # the port from its own residual: the reference's accounting
        synced, err = compressed_psum(gt, err)
        true_total = true_total + gt
        sync_total = sync_total + synced
    # the plain version on CPU tensors: no kernel launch is counted
    assert (block_quantize.launches, block_dequantize.launches) == (q0, d0)

    # residual is bounded by one step's quantization error, so the
    # accumulated difference stays small relative to the accumulated norm
    diff = float(torch.linalg.norm(sync_total - true_total))
    assert diff <= float(err.abs().sum()) + 1e-3
    rel = diff / float(torch.linalg.norm(true_total))
    assert rel < 0.05


def test_dtypes_follow_grad_and_err(one_rank_group):
    g = torch.randn(300, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    synced, err = compressed_psum(g, torch.zeros(300, dtype=torch.float32), block=64)
    assert synced.dtype == torch.bfloat16 and err.dtype == torch.float32
    acc = g.float()
    q, s = quantize_int8(acc, block=64)
    sent = dequantize_int8(q, s, acc.shape)
    assert torch.equal(synced.view(torch.int16), sent.to(torch.bfloat16).view(torch.int16))
    _assert_bits_equal(err, acc - sent)


def test_refuses_without_an_initialized_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="not initialized"):
        compressed_psum(torch.zeros(8), torch.zeros(8))


# ---------------------------------------------------------------------------
# spawned gloo worlds


SHAPE = (3, 300)  # 900 elements: blocks of 256 with a padded tail
STEPS = 6


def rank_grad(rank: int, step: int, shape=SHAPE) -> np.ndarray:
    """Rank ``rank``'s gradient at ``step``: seeded normals with a scale that
    differs by rank and row, so blocks and ranks have their own absmax."""
    rng = np.random.default_rng([rank, step])
    scale = (1.0 + rank) * np.logspace(-2, 1, shape[0], dtype=np.float32)[:, None]
    return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(np.float32)


def rank_main(rank: int, world: int, init_file: str, out_dir: str, device: str = "cpu",
              steps: int = STEPS, shape=SHAPE) -> None:
    """One rank: ``steps`` error-feedback syncs of ``rank_grad`` on
    ``device``; writes its synced tensors, residuals and the kernel launches
    each step made to ``rank<r>.npz``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        err = torch.zeros(shape, device=device)
        synced_all, err_all, launches = [], [], []
        for t in range(steps):
            q0, d0 = block_quantize.launches, block_dequantize.launches
            g = torch.from_numpy(rank_grad(rank, t, shape)).to(device)
            synced, err = compressed_psum(g, err)
            launches.append((block_quantize.launches - q0, block_dequantize.launches - d0))
            synced_all.append(synced.cpu().numpy())
            err_all.append(err.cpu().numpy())
        np.savez(Path(out_dir) / f"rank{rank}.npz", synced=np.stack(synced_all),
                 err=np.stack(err_all), launches=np.array(launches))
    finally:
        dist.destroy_process_group()


def run_ranks(tmp_path: Path, world: int, **kw) -> list[dict]:
    """Spawn ``world`` ranks of :func:`rank_main`, join them with a timeout
    (killing any that outlive it) and return each rank's arrays."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, str(tmp_path / "store"),
                                                 str(tmp_path)), kwargs=kw)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert not hung, f"ranks {hung} still running after {JOIN_TIMEOUT_S} s: killed"
    assert [p.exitcode for p in procs] == [0] * world
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def reference_world(world: int, steps: int = STEPS, shape=SHAPE):
    """Per step: the numpy sum over ranks of the reference's
    ``dequantize(quantize(acc_r))``, and every rank's residual."""
    ref = _ref()
    errs = [np.zeros(shape, np.float32) for _ in range(world)]
    sums, residuals = [], []
    for t in range(steps):
        sent = []
        for r in range(world):
            acc = rank_grad(r, t, shape) + errs[r]
            q, s = ref.quantize_int8(acc, block=256)
            sent.append(_np(ref.dequantize_int8(q, s, shape)))
            errs[r] = acc - sent[-1]
        sums.append(np.sum(np.stack(sent), axis=0, dtype=np.float32))
        residuals.append([e.copy() for e in errs])
    return sums, residuals


@pytest.mark.parametrize("world", [2, 4])
def test_spawned_world_equals_the_reference_summed(tmp_path, world):
    ranks = run_ranks(tmp_path, world)
    sums, residuals = reference_world(world)
    for r, out in enumerate(ranks):
        # every rank gets the same sum, bit for bit
        np.testing.assert_array_equal(out["synced"].view(np.uint32),
                                      ranks[0]["synced"].view(np.uint32))
        for t in range(STEPS):
            np.testing.assert_allclose(out["synced"][t], sums[t], rtol=1e-6,
                                       atol=1e-6 * float(np.abs(sums[t]).max()))
            np.testing.assert_array_equal(out["err"][t].view(np.uint32),
                                          residuals[t][r].view(np.uint32))
        # the CPU path is the plain version: no kernel launch counted
        assert out["launches"].tolist() == [[0, 0]] * STEPS
    # telescoping: the synced total is the true total less the final residuals
    true_total = sum(rank_grad(r, t) for r in range(world) for t in range(STEPS))
    final = sum(out["err"][-1] for out in ranks)
    synced_total = ranks[0]["synced"].sum(axis=0)
    scale = sum(np.abs(rank_grad(r, t)) for r in range(world) for t in range(STEPS))
    assert np.all(np.abs(synced_total - (true_total - final)) <= 1e-5 * scale.max())
    rel = np.linalg.norm(synced_total - true_total) / np.linalg.norm(true_total)
    assert rel < 0.05


def test_shape_and_block_follow_the_caller(one_rank_group):
    for shape, block in (((5,), 4), ((2, 3, 7), 16), ((1, 1024), 1024)):
        n = math.prod(shape)
        g = torch.arange(n, dtype=torch.float32).reshape(shape) - n / 3
        synced, err = compressed_psum(g, torch.zeros(shape), block=block)
        assert synced.shape == shape and err.shape == shape
        q, s = quantize_int8(g, block=block)
        assert q.shape == (-(-n // block), block) and s.shape == (q.shape[0],)
        _assert_bits_equal(synced, dequantize_int8(q, s, shape))
