"""The dry run (``repro_torch.launch.dryrun``), on the CPU, held against the
JAX package's and against a real multi-rank step.

* ``ARCH_OVERRIDES`` and ``active_params`` equal the reference's for every
  arch (read from ``src/repro/launch/dryrun.py`` by its syntax tree: importing
  it would set the 512-device ``XLA_FLAGS`` of the reference's dry run);
* ``input_specs`` and ``cache_specs`` equal the reference's for every arch
  and shape (the caches at decode_32k, and long_500k where it is supported);
* for every arch at the production 16×16 mesh, a train cell's argument
  bytes a device equal the sum of the local shapes' bytes under the
  reference's ``make_plan(...).state_pspecs()`` (a dim that does not
  divide padded, as XLA pads it: mamba2's ``in_proj``), plus the rank's
  batch rows (no trace: the cell is built, not run);
* the analyzer counts 2·2·N·N·L for L chained matmuls (the reference's
  ``test_hlo_analyzer_counts_scan_trips``);
* on reduced smollm-360m with no mesh (``grad_accum=2``, remat ``none`` and
  ``full``) the traced ``dot_flops`` equal ``FlopCounterMode``'s exactly and
  are within 1% of the reference's ``analyze_hlo`` of its jitted step;
* rank 0 of a 4-rank gloo world under data=2,model=2 runs one real train
  step under the analyzer: its ``dot_flops``, ``op_bytes`` and collective
  bytes by opcode equal the meta trace's under the fake group;
* prefill cells on meta go through the flash and SSD shape functions (the
  ``.launches`` counters stay put), a head dim the kernel lacks fails the
  cell with the kernel's message, and training takes the plain path;
* a cell past ``HBM_BYTES`` fails, ``main`` exits 1 and writes the error row;
  every cell ends its fake group, and one started inside a live group is
  refused.

The reference is imported lazily, so the spawned ranks load no JAX.
"""

import argparse
import ast
import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import repro_torch.configs as TC  # noqa: E402
from repro_torch.core.layout import MeshSpec  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.hlo_analysis import TraceAnalyzer  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import build_model, cache_specs, input_specs  # noqa: E402
from repro_torch.models.lm import plan_stages  # noqa: E402
from test_torch_multirank import _ref, run_world  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = TC.list_configs()
MODULE = "test_torch_dryrun"
B, S = 4, 32  # the reduced train cells: 4 rows of 32 positions (33 tokens)


def _args(**kw) -> argparse.Namespace:
    """The dry run's command-line defaults."""
    base = dict(remat="full", grad_accum=0, moment_dtype=None, param_dtype=None, no_fsdp=False,
                cast_params=False, shard_cache_seq=False)
    return argparse.Namespace(**{**base, **kw})


def _reference_dryrun() -> dict:
    """``ARCH_OVERRIDES`` and ``active_params`` of the reference's dry run,
    executed from its source without the module's import-time flags."""
    tree = ast.parse((REPO / "src/repro/launch/dryrun.py").read_text())
    keep = [n for n in tree.body
            if (isinstance(n, ast.Assign) and any(getattr(t, "id", "") == "ARCH_OVERRIDES"
                                                  for t in n.targets))
            or (isinstance(n, ast.FunctionDef) and n.name == "active_params")]
    assert len(keep) == 2
    ns: dict = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "reference dryrun", "exec"), ns)
    return ns


def _shape(kind: str, seq: int = S, batch: int = B) -> TC.ShapeSpec:
    return TC.ShapeSpec(kind, seq, batch, kind)


def _cell(arch: str, kind: str, *, mesh=None, cfg=None, args=None, shape=None) -> dict:
    cfg = cfg if cfg is not None else TC.reduced(TC.get_config(arch))
    return dryrun.run_cell(arch, kind, False, args or _args(grad_accum=1),
                           mesh=mesh or MeshSpec((("data", 1), ("model", 1))),
                           shape=shape or _shape(kind), cfg=cfg)


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the tables and the specs, against the reference


def test_overrides_and_active_params_equal_the_reference():
    ref = _ref()
    from repro.models import build_model as ref_build

    ns = _reference_dryrun()
    assert dryrun.ARCH_OVERRIDES == ns["ARCH_OVERRIDES"]
    for arch in ARCHS:
        got = dryrun.active_params(build_model(TC.get_config(arch)))
        want = ns["active_params"](ref_build(ref.configs.get_config(arch)))
        assert got == want, arch


def test_production_mesh():
    assert make_production_mesh() == MeshSpec((("data", 16), ("model", 16)))
    assert make_production_mesh(multi_pod=True) == MeshSpec(
        (("pod", 2), ("data", 16), ("model", 16)))


@pytest.mark.parametrize("shape_name", list(TC.SHAPES))
def test_input_specs_equal_the_reference(shape_name):
    ref = _ref()
    from repro.models import input_specs as ref_specs

    for arch in ARCHS:
        got = input_specs(TC.get_config(arch), TC.SHAPES[shape_name])
        want = ref_specs(ref.configs.get_config(arch), ref.configs.SHAPES[shape_name])
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in got.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}, arch
        assert all(v.device.type == "meta" for v in got.values())


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_cache_specs_equal_the_reference(shape_name):
    import jax

    ref = _ref()
    from repro.models import build_model as ref_build
    from repro.models import decode as ref_decode

    shape = TC.SHAPES[shape_name]
    for arch in ARCHS:
        cfg = TC.get_config(arch)
        if shape_name == "long_500k" and not cfg.supports_long_decode:
            continue
        got = cache_specs(build_model(cfg), shape.global_batch, shape.seq_len)
        rlm = ref_build(ref.configs.get_config(arch))
        want = jax.eval_shape(lambda: ref_decode.init_cache(rlm, shape.global_batch,  # noqa: B023
                                                             shape.seq_len))
        flat = ref.core.pytree.flatten_with_paths(want)
        from repro_torch.core.pytree import flatten_with_paths

        got = flatten_with_paths(got)
        assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()
                } == {k: (tuple(v.shape), str(v.dtype)) for k, v in flat.items()}, arch
        assert all(v.device.type == "meta" for v in got.values())


def test_train_argument_bytes_equal_the_reference_plan():
    """Every arch at full width on the 16×16 mesh: the rank's state and
    batch bytes, built and not traced, against the reference's plan."""
    ref = _ref()
    import jax.numpy as jnp
    from repro.core.layout import MeshSpec as RefMesh
    from repro.dist.sharding import make_plan as ref_plan
    from repro.dist.sharding import vocab_multiple as ref_vocab
    from repro.models import build_model as ref_build

    mesh = RefMesh((("data", 16), ("model", 16)))
    for arch in ARCHS:
        try:
            built = dryrun.build_cell(arch, "train_4k", False, _args())
            got = TraceAnalyzer().hold(built["step_args"])
        finally:
            dist.destroy_process_group()
        over = dryrun.ARCH_OVERRIDES[arch]
        par = ref.configs.ParallelismConfig(data_axes=("data",), remat="full", **over)
        cfg = ref.configs.get_config(arch)
        rlm = ref_build(cfg, vocab_multiple=ref_vocab(par, mesh))
        pspecs = ref_plan(cfg, rlm.registry, par, mesh).state_pspecs()
        want = 0
        for kind, dt in (("params", par.param_dtype), ("exp_avg", par.moment_dtype),
                         ("exp_avg_sq", par.moment_dtype)):
            for d in rlm.registry:
                spec = tuple(pspecs[kind][d.path]) + (None,) * len(d.shape)
                n = 1
                for size, e in zip(d.shape, spec):  # an uneven split padded, as XLA pads
                    axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
                    n *= -(-size // math.prod(mesh.axis_size(a) for a in axes))
                want += n * jnp.dtype(dt).itemsize
        shape = TC.SHAPES["train_4k"]
        rows = shape.global_batch // 16
        want += rows * (shape.seq_len + 1) * 4  # int32 tokens
        if cfg.cross_attn is not None:
            want += rows * cfg.cross_attn.source_len * cfg.cross_attn.source_dim * 2
        if cfg.encoder is not None:
            want += rows * cfg.encoder.source_len * cfg.d_model * 2
        assert got == want, arch


# ---------------------------------------------------------------------------
# the analyzer


def test_analyzer_counts_chained_matmul_trips():
    L, N = 8, 64
    w = torch.zeros(N, N, device="meta")
    x = torch.zeros(2, N, device="meta")
    an = TraceAnalyzer()
    with an:
        h = x
        for _ in range(L):
            h = torch.tanh(h @ w)
    assert an.costs.dot_flops == 2.0 * 2 * N * N * L  # 2·M·N·K per matmul × L trips
    assert an.op_count == 2 * L


def test_analyzer_refuses_an_unmapped_collective(monkeypatch):
    from repro_torch.launch import hlo_analysis

    monkeypatch.delitem(hlo_analysis.C10D_OPS, "allreduce_")
    with pytest.raises(NotImplementedError, match="allreduce_"):
        _cell("smollm-360m", "train", mesh=MeshSpec((("data", 2), ("model", 1))))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_dot_flops_equal_flop_counter_and_the_reference(remat):
    """Reduced smollm, one device, two microbatches: the traced dot FLOPs are
    ``FlopCounterMode``'s and within 1% of the reference's compiled step."""
    from torch.utils.flop_counter import FlopCounterMode

    args = _args(remat=remat, grad_accum=2)
    rec = _cell("smollm-360m", "train", args=args)
    assert rec["ok"] and rec["kernels"] == {}  # training takes the plain attention
    try:
        built = dryrun.build_cell("smollm-360m", "train", False, args,
                                  mesh=MeshSpec((("data", 1), ("model", 1))), shape=_shape("train"),
                                  cfg=TC.reduced(TC.get_config("smollm-360m")))
        with FlopCounterMode(display=False) as fc:
            built["fn"](*built["step_args"])
    finally:
        dist.destroy_process_group()
    assert rec["per_device"]["dot_flops"] == fc.get_total_flops()

    import jax
    import jax.numpy as jnp

    ref = _ref()
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.models import build_model as ref_build
    from repro.train.optimizer import TrainState
    from repro.train.steps import make_train_step

    par = ref.configs.ParallelismConfig(remat=remat, grad_accum=2)
    rlm = ref_build(ref.configs.reduced(ref.configs.get_config("smollm-360m")), remat=remat)
    params = ref.core.pytree.unflatten_from_paths(
        {d.path: jax.ShapeDtypeStruct(d.shape, jnp.float32) for d in rlm.registry})
    state = TrainState(params=params, exp_avg=params, exp_avg_sq=params,
                       step=jax.ShapeDtypeStruct((), jnp.int32))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S + 1), jnp.int32)}
    fn = make_train_step(rlm, ref.configs.TrainConfig(), par)
    costs = analyze_hlo(jax.jit(fn).lower(state, batch).compile().as_text())
    assert rec["per_device"]["dot_flops"] == pytest.approx(costs.dot_flops, rel=0.01)


# ---------------------------------------------------------------------------
# the meta trace against a real 4-rank step


MESH4 = MeshSpec((("data", 2), ("model", 2)))


def real_step_world(rank: int, out: Path, weights: dict) -> dict:
    """One rank of a gloo world: the trainer's real partitioned step on the
    CPU under the analyzer, from the dry run's inputs (int32 tokens, the
    host int32 step counter)."""
    from repro_torch.dist.sharding import rank_rows
    from repro_torch.train.trainer import Trainer

    cfg = TC.reduced(TC.get_config("smollm-360m"))
    parallel = TC.ParallelismConfig(remat="full")
    t = Trainer.create(cfg, parallel, TC.TrainConfig(), MESH4, batch_size=B, seq_len=S,
                       device="cpu", group=dist.group.WORLD)
    state = dataclasses.replace(t.init_state(), step=torch.zeros((), dtype=torch.int32))
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=torch.Generator()
                           .manual_seed(0), dtype=torch.int32)
    batch = {"tokens": tokens[rank_rows(B, parallel, MESH4, rank)].clone()}
    an = TraceAnalyzer("cpu")
    with an:
        t.step_fn(state, batch)
    return {"per_device": an.costs.to_json(), "by_opcode": an.costs.by_opcode,
            "op_count": an.op_count}


def test_meta_trace_equals_a_real_four_rank_step(tmp_path, monkeypatch):
    from repro_torch.launch import hlo_analysis

    np.savez(tmp_path / "weights.npz", unused=np.zeros(1))
    real = run_world(tmp_path, 4, "real_step_world", module=MODULE)[0]
    seen = []

    class Spy(TraceAnalyzer):
        def __init__(self, *a):
            super().__init__(*a)
            seen.append(self)

    monkeypatch.setattr(hlo_analysis, "TraceAnalyzer", Spy)
    rec = _cell("smollm-360m", "train", mesh=MESH4)
    assert rec["ok"]
    got, want = rec["per_device"], real["per_device"]
    assert got["dot_flops"] == want["dot_flops"]
    assert got["collective_bytes"] == want["collective_bytes"]
    assert set(got["collective_bytes"]) == {"all-gather", "all-reduce"}
    # AdamW moves three 0-d fp32 scalars (lr and the two bias corrections)
    # from the host to the parameters' device: a copy on meta (and on the
    # card), none where that device is the CPU.  Every other byte is equal.
    host_copies = 3 * (4 + 4)
    assert got["op_bytes"] == want["op_bytes"] + host_copies
    assert rec["op_count"] == real["op_count"] + 3
    by = dict(real["by_opcode"])
    by["aten._to_copy"] += host_copies
    assert by == seen[0].costs.by_opcode


# ---------------------------------------------------------------------------
# the kernels' shape functions


def test_prefill_cells_take_the_kernel_shape_functions():
    before = (flash_attention.launches, ssd_scan.launches)
    cfg = TC.reduced(TC.get_config("jamba-1.5-large-398b"))
    rec = _cell("jamba-1.5-large-398b", "prefill", cfg=cfg)
    assert rec["ok"]
    layers = [(ld.kind, st.count) for st in plan_stages(cfg) for ld in st.body]
    kernels = rec["kernels"]
    assert {k: v["launches"] for k, v in kernels.items()} == {  # 2 periods of 1 attn, 7 mamba
        "flash_attention_fwd": sum(n for kind, n in layers if kind == "attn"),
        "ssd_scan_fwd": sum(n for kind, n in layers if kind == "mamba")} == {
        "flash_attention_fwd": 2, "ssd_scan_fwd": 14}
    assert rec["per_device"]["kernel_flops"] == sum(k["flops"] for k in kernels.values()) > 0
    rec = _cell("smollm-360m", "prefill")
    assert rec["kernels"]["flash_attention_fwd"]["launches"] == 2
    assert (flash_attention.launches, ssd_scan.launches) == before


def test_flash_shape_function_checks_and_counts():
    from repro_torch.kernels.flash_attention.ops import attention_pairs, launch_cost

    q = torch.empty(2, 8, 4, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 8, 2, 64, dtype=torch.bfloat16, device="meta")
    before = flash_attention.launches
    an = TraceAnalyzer()
    with an:
        o = flash_attention(q, k, k)
    assert o.shape == q.shape and o.dtype == q.dtype and o.device.type == "meta"
    flops, nbytes = launch_cost(q, k, k, causal=True, window=0)
    assert an.kernels == {"flash_attention_fwd": {
        "launches": 1, "flops": flops, "bytes": nbytes,
        "shapes": {"4:2 heads of (64, 64), 8 x 8, causal": 1}}}
    assert flops == 2.0 * 128 * (8 * 9 // 2) * 2 * 4
    with pytest.raises(ValueError, match="over 3 kv heads"):
        flash_attention(q, torch.empty(2, 8, 3, 64, dtype=torch.bfloat16, device="meta"),
                        torch.empty(2, 8, 3, 64, dtype=torch.bfloat16, device="meta"))
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):  # mixed devices
        flash_attention(q, torch.zeros(k.shape, dtype=k.dtype), k)
    assert flash_attention.launches == before
    # the pairs a mask allows, in closed form, against the row-by-row count
    for sq, skv, causal, window, off in [(33, 40, True, 0, 0), (16, 40, True, 8, 24),
                                         (40, 16, False, 5, 3), (7, 7, False, 0, 0)]:
        rows = sum(max(0, (min(i + 1, skv) if causal else skv)
                       - (max(0, i - window + 1) if window else 0))
                   for i in range(off, off + sq))
        assert attention_pairs(sq, skv, causal=causal, window=window, q_offset=off) == rows


def test_a_head_dim_the_kernel_lacks_fails_the_cell():
    before = flash_attention.launches
    cfg = TC.reduced(TC.get_config("smollm-360m"))
    cfg = dataclasses.replace(cfg, head_dim=24)
    with pytest.raises(ValueError, match=r"head dims \(D, Dv\) = \(24, 24\)"):
        _cell("smollm-360m", "prefill", cfg=cfg)
    assert flash_attention.launches == before


# ---------------------------------------------------------------------------
# the records, the memory gate, the group


def test_record_keys_and_memory():
    rec = _cell("smollm-360m", "train", mesh=MESH4)
    for key in ("arch", "shape", "mesh", "ok", "lower_s", "compile_s", "analyze_s", "memory",
                "per_device", "roofline", "dominant", "params_total", "params_active",
                "model_flops", "useful_flops_ratio", "roofline_fraction", "wall_s", "op_count",
                "kernels"):
        assert key in rec, key
    assert rec["mesh"] == "2x2"
    mem = rec["memory"]
    assert mem["temp_bytes_per_device"] > 0 and mem["output_bytes_per_device"] > 0
    assert mem["alias_bytes_per_device"] == 0  # the step returns a new state
    rec = _cell("smollm-360m", "decode", mesh=MESH4, shape=_shape("decode"))
    assert rec["ok"] and rec["memory"]["alias_bytes_per_device"] > 0  # the cache, in place


def test_decode_cache_sharded_over_its_length():
    """Reduced smollm at 3:1 heads (its 1 KV head does not divide model=2):
    with ``--shard-cache-seq`` a rank's cache is its ``cache_pspecs`` shard,
    the rings over their length, half a whole cache's rings."""
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.dist.sharding import cache_pspecs, local_shape, vocab_multiple
    from repro_torch.models.decode import init_cache

    cfg = dataclasses.replace(TC.reduced(TC.get_config("smollm-360m")), num_heads=3,
                              num_kv_heads=1)
    mesh = MeshSpec((("data", 1), ("model", 2)))
    got = {}
    for seq in (True, False):
        rec = _cell("smollm-360m", "decode", mesh=mesh, cfg=cfg, shape=_shape("decode", 16),
                    args=_args(grad_accum=1, shard_cache_seq=seq))
        assert rec["ok"]
        par = TC.ParallelismConfig(shard_cache_seq=seq)
        cache = init_cache(build_model(cfg, vocab_multiple=vocab_multiple(par, mesh)), B, 16,
                           device="meta")
        specs = flatten_with_paths(cache_pspecs(cache, par, mesh))
        want = sum(math.prod(local_shape(tuple(t.shape), specs[n], mesh)) * t.element_size()
                   for n, t in flatten_with_paths(cache).items())
        assert rec["memory"]["cache_bytes_per_device"] == want
        got[seq] = want
    pos = B * 4  # the int32 positions, whole on every rank
    assert got[True] - pos == (got[False] - pos) // 2


def test_a_cell_past_the_card_fails(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(dryrun, "HBM_BYTES", 1 << 20)
    with pytest.raises(MemoryError, match="pass the card's 1048576"):
        _cell("smollm-360m", "train")
    out = tmp_path / "rows.jsonl"
    assert dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--out",
                        str(out)]) == 1
    row = json.loads(out.read_text().splitlines()[-1])
    assert row["ok"] is False and row["error"].startswith("MemoryError: ")
    assert row["mesh"] == "16x16" and row["tag"] == "baseline"
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == row


def test_a_cell_inside_a_live_group_is_refused():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        with pytest.raises(RuntimeError, match="group is live already"):
            _cell("smollm-360m", "train")
        assert dist.is_initialized()  # the caller's group stays
    finally:
        dist.destroy_process_group()


def test_skips_and_the_production_cells():
    rec = dryrun.run_cell("smollm-360m", "long_500k", True, _args())
    assert rec == {"arch": "smollm-360m", "shape": "long_500k", "mesh": "2x16x16", "ok": True,
                   "skipped": True, "skip_reason": "full-attention arch: long_500k requires "
                   "sub-quadratic"}
    rec = dryrun.run_cell("whisper-tiny", "prefill_32k", True, _args())
    assert rec["ok"] and rec["mesh"] == "2x16x16"
    assert rec["kernels"]["flash_attention_fwd"]["launches"] > 0
