"""Multi-pod dry run: trace one rank's program of an (arch × shape × mesh)
cell (port of ``repro.launch.dryrun``).

For each cell this driver:

1. builds the production mesh's description (16×16 single-pod, or 2×16×16
   multi-pod; :func:`~repro_torch.launch.mesh.make_production_mesh`) and a
   fake ``torch.distributed`` group of its size (the ``fake`` backend: no
   device, no peer; this process is rank 0),
2. constructs the model, the sharding plan, the rank's groups and its
   partitioned step (train step, prefill or serve step per the shape's
   kind) as the trainer and the serve CLI do, and the rank's inputs on the
   meta device at its shard shapes,
3. runs that step on the meta tensors under a
   :class:`~repro_torch.launch.hlo_analysis.TraceAnalyzer`.  The meta device
   stands in for the card: the model takes the hand-written kernels where
   it would there (their wrappers' shape functions check each launch's
   contract), the collectives go through the fake group.  A step that runs
   to its end proves the partitioned program coherent: its shapes, its
   collectives and the kernels' shape contracts,
4. records the executed per-device FLOPs and bytes, the collective bytes
   by opcode and the peak of live bytes, and the roofline terms against the
   H100's constants,
5. appends a JSON record to ``--out``.

Nothing touches a device: the trace runs on meta tensors and CUDA is never
initialized, as the reference's touches no TPU.

Usage::

    python -m repro_torch.launch.dryrun --arch gemma3-27b --shape train_4k \\
        --out results/dryrun.jsonl
    python -m repro_torch.launch.dryrun --arch gemma3-27b --shape train_4k \\
        --multi-pod --out results/dryrun.jsonl

The record keeps the reference's keys where the port has a counterpart.
``memory`` is per device: the arguments (the rank's state, or its weights
and cache, and its batch), the outputs, the temporaries (the traced peak
less the arguments) and the outputs that share an argument's storage; a
prefill or decode cell adds the cache's share of the arguments
(``cache_bytes_per_device``).  A
cell whose arguments and temporaries pass :data:`HBM_BYTES` fails, as an
XLA compile that runs out of memory does.  ``op_count`` (the ops
dispatched) takes the place of ``hlo_chars``, ``kernels`` holds the kernel
stand-ins' launches, operations and bytes.  There is no
``xla_cost_analysis``: XLA's static count, which visits a loop body once,
has no counterpart in an eager trace.  The compute term reads
``dot_flops`` and the kernels' operations together (the reference's
Pallas kernels are custom calls whose dots its analyzer does not see).

The constants are the H100 SXM 80GB's datasheet figures (the smoke's card:
NVIDIA H100 80GB HBM3 at a 700 W power limit).  The collective term keeps
the reference's formula, every collective byte over one link's rate; a
model axis of 16 spans two 8-GPU NVLink domains, whose link between them
is far slower, so the term is optimistic there.  The times and bytes of a
record are estimates from these constants, not measurements.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys

import torch
import torch.distributed as dist

import repro_torch.obs as obs

# NVIDIA H100 SXM 80GB (datasheet; the smoke's card at 700 W)
PEAK_FLOPS = 989e12      # dense bf16 tensor cores / card
HBM_BW = 3.35e12         # B/s / card (HBM3)
LINK_BW = 450e9          # B/s / card, NVLink 4, one direction
# ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
# 80GB HBM3, as chip_smoke.py reads and prints it
HBM_BYTES = 85_017_493_504

# Per-arch parallelism overrides for the production mesh.
ARCH_OVERRIDES = {
    "deepseek-v2-236b": dict(moment_dtype="bfloat16", grad_accum=16),
    "jamba-1.5-large-398b": dict(moment_dtype="bfloat16", grad_accum=16),
    "mixtral-8x22b": dict(grad_accum=16),
    "gemma3-27b": dict(grad_accum=16),
    "gemma3-12b": dict(grad_accum=16),
    "llama-3.2-vision-11b": dict(grad_accum=16),
    "minitron-8b": dict(grad_accum=16),
    "smollm-360m": dict(grad_accum=16),
    "mamba2-130m": dict(grad_accum=8),
    "whisper-tiny": dict(grad_accum=4),
    "gpt3-350m": dict(grad_accum=8),
}

def active_params(lm) -> tuple[int, int]:
    """(total, active) parameter counts; active discounts non-routed experts."""
    cfg = lm.cfg
    total = active = 0
    for d in lm.registry:
        n = math.prod(d.shape)
        total += n
        if d.kind == "moe_expert" and cfg.moe is not None:
            active += n * cfg.moe.top_k / cfg.moe.num_experts
        else:
            active += n
    return total, int(active)


def mesh_name(mesh) -> str:
    return "x".join(str(n) for _, n in mesh.axes)


def build_cell(arch: str, shape_name: str, multi_pod: bool, args, *, mesh=None, shape=None,
               cfg=None):
    """The rank's program of one cell: its step and its meta inputs, under a
    fake group this call starts (:func:`run_cell` ends it).

    ``mesh`` (a :class:`~repro_torch.core.layout.MeshSpec`), ``shape`` (a
    :class:`~repro_torch.configs.base.ShapeSpec`) and ``cfg`` (a
    :class:`~repro_torch.configs.base.ModelConfig`) replace the production
    mesh, ``SHAPES[shape_name]`` and ``get_config(arch)``: the card's check
    of the prediction and the tests set them; the command line does not.
    On a mesh of one rank the step is the one-device step."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import SHAPES, ParallelismConfig, TrainConfig, get_config
    from repro_torch.core.patterns import StateKind
    from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths
    from repro_torch.dist.pipeline import Pipeline, pipelines
    from repro_torch.dist.sharding import (
        RankGroups, batch_axes, make_plan, rank_rows, vocab_multiple,
    )
    from repro_torch.dist.tensor_parallel import TensorParallel, partitions
    from repro_torch.launch.hlo_analysis import tensors_of
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.serve import rank_weights
    from repro_torch.models import build_model
    from repro_torch.models.api import cache_specs, input_specs
    from repro_torch.train.optimizer import TrainState
    from repro_torch.train.steps import make_prefill_step, make_serve_step, make_train_step
    from repro_torch.train.trainer import _DTYPES

    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]

    # applicability gates (DESIGN.md §4)
    if shape_name == "long_500k" and not cfg.supports_long_decode:
        return {"skip": "full-attention arch: long_500k requires sub-quadratic"}
    if arch == "whisper-tiny" and shape_name == "long_500k":
        return {"skip": "enc-dec 448-token decoder: 500k decode not meaningful"}
    if dist.is_initialized():
        raise RuntimeError("the dry run starts a fake group of its own; a torch.distributed "
                           "group is live already")

    mspec = mesh if mesh is not None else make_production_mesh(multi_pod=multi_pod)
    over = dict(ARCH_OVERRIDES.get(arch, {}))
    if args.grad_accum:
        over["grad_accum"] = args.grad_accum
    if args.moment_dtype:
        over["moment_dtype"] = args.moment_dtype
    parallel = ParallelismConfig(
        data_axes=("pod", "data") if multi_pod else ("data",),
        remat=args.remat,
        **over,
    )
    if shape.kind != "train":
        parallel = dataclasses.replace(parallel, grad_accum=1)
    if args.param_dtype:
        parallel = dataclasses.replace(parallel, param_dtype=args.param_dtype)
    if args.no_fsdp:
        parallel = dataclasses.replace(parallel, fsdp=False)
    if args.cast_params:
        parallel = dataclasses.replace(parallel, cast_params_once=True)
    if args.shard_cache_seq:
        parallel = dataclasses.replace(parallel, shard_cache_seq=True)

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mspec.size)
    train = shape.kind == "train"
    lm = build_model(
        cfg,
        vocab_multiple=vocab_multiple(parallel, mspec),
        compute_dtype=_DTYPES[parallel.compute_dtype],
        remat=parallel.remat if train else "none",
    )
    plan = make_plan(cfg, lm.registry, parallel, mspec)
    ranks = None
    if mspec.size > 1:
        ranks = RankGroups.create(dist.group.WORLD, plan, parallel)
        if partitions(cfg, parallel, mspec):
            lm.tp = TensorParallel(ranks, cfg)
        if train and pipelines(parallel, mspec):
            lm.pipe = Pipeline(ranks, lm)

    # ---- the rank's inputs, on meta ------------------------------------------
    dsize = math.prod(mspec.axis_size(a) for a in batch_axes(parallel, mspec))

    def rows(t: torch.Tensor) -> torch.Tensor:
        """The rank's rows of a batch input (all of them where the batch does
        not split over the data axes: the reference replicates it)."""
        if ranks is None or t.shape[0] % dsize:
            return t
        return t[rank_rows(t.shape[0], parallel, mspec, ranks.rank)].clone()  # its own storage

    batch = {k: rows(v) for k, v in input_specs(cfg, shape).items()}
    pdt = _DTYPES[parallel.param_dtype]

    def tree(kind: StateKind, dt: torch.dtype) -> dict:
        """The rank's tensors of a state kind: its shard of each parameter
        under the plan, a dim that does not divide padded as on the card
        (and as XLA pads a shard)."""
        return unflatten_from_paths({
            d.path: torch.empty(plan.param_specs[d.path].layout_for(kind, mspec).local_shape,
                                dtype=dt, device="meta")
            for d in lm.registry
        })

    if train:
        mdt = _DTYPES[parallel.moment_dtype]
        # the step counter on the host, as the trainer's (a meta one has no value)
        state = TrainState(tree(StateKind.FP32, pdt), tree(StateKind.EXP_AVG, mdt),
                           tree(StateKind.EXP_AVG_SQ, mdt), torch.zeros((), dtype=torch.int32))
        fn = make_train_step(lm, TrainConfig(), parallel, group=ranks)
        step_args = (state, batch)
    else:
        flat = flatten_with_paths(tree(StateKind.FP32, pdt))
        if ranks is not None:
            flat = rank_weights(lm, ranks, flat)
        params = lm.registry.cast(unflatten_from_paths(flat), lm.compute_dtype)
        # the cache's global batch under a rank context, else the rank's rows
        cache_batch = shape.global_batch if lm.tp is not None else batch["tokens"].shape[0]
        cache = cache_specs(lm, cache_batch, shape.seq_len)
        cache_bytes = sum(t.numel() * t.element_size() for t in tensors_of(cache)
                          if t.device.type == "meta")
        if shape.kind == "prefill":
            fn = make_prefill_step(lm)
            step_args = (params, cache, batch["tokens"]) + (
                (batch["source_embeds"],) if "source_embeds" in batch else ())
        else:
            fn = make_serve_step(lm)
            step_args = (params, cache, batch["tokens"])

    return {
        "fn": fn,
        "step_args": step_args,
        "cache_bytes": None if train else cache_bytes,
        "lm": lm,
        "shape": shape,
        "mesh_axes": dict(mspec.axes),
        "chips": mspec.size,
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, args, *, mesh=None, shape=None,
             cfg=None) -> dict:
    """One cell's record (:func:`build_cell`'s keywords).  The fake group it
    starts is ended before it returns or raises."""
    from repro_torch.launch.hlo_analysis import TraceAnalyzer, tensors_of

    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "ok": False,
    }
    if mesh is not None:
        rec["mesh"] = mesh_name(mesh)
    owned = not dist.is_initialized()
    try:
        # Durations go through obs.timed (perf_counter_ns), never time.time():
        # the chaos harness may skew the wall clock, and these numbers feed
        # regression comparisons (clock-injection policy, core/clock.py).
        with obs.timed("dryrun.cell") as sw_cell:
            with obs.timed("dryrun.lower") as sw:
                built = build_cell(arch, shape_name, multi_pod, args, mesh=mesh, shape=shape,
                                   cfg=cfg)
            if "skip" in built:
                rec.update(skipped=True, skip_reason=built["skip"], ok=True)
                return rec
            rec["lower_s"] = round(sw.elapsed_s, 1)
            fn, step_args = built.pop("fn"), built.pop("step_args")
            lm, shape, chips = built["lm"], built["shape"], built["chips"]

            analyzer = TraceAnalyzer("meta")
            arg_bytes = analyzer.hold(step_args)
            arg_keys = analyzer.storage_keys(step_args)
            with obs.timed("dryrun.compile") as sw:
                with analyzer:
                    if shape.kind == "train":
                        out = fn(*step_args)
                    else:
                        with torch.inference_mode():
                            out = fn(*step_args)
            rec["compile_s"] = round(sw.elapsed_s, 1)
            del fn, step_args

            with obs.timed("dryrun.analyze") as sw:
                out_tensors = [t for t in tensors_of(out) if t.device.type == "meta"]
                out_bytes = sum(t.numel() * t.element_size() for t in out_tensors)
                alias = sum(t.numel() * t.element_size() for t in out_tensors
                            if t.untyped_storage()._cdata in arg_keys)
                temp = analyzer.peak_bytes - arg_bytes
                rec["memory"] = {
                    "argument_bytes_per_device": arg_bytes,
                    "output_bytes_per_device": out_bytes,
                    "temp_bytes_per_device": temp,
                    "alias_bytes_per_device": alias,
                }
                if built["cache_bytes"] is not None:  # of the arguments: the decode cache
                    rec["memory"]["cache_bytes_per_device"] = built["cache_bytes"]
                print(f"[{arch} × {shape_name} × {rec['mesh']}] memory:", rec["memory"])
                costs = analyzer.costs
                rec["per_device"] = costs.to_json()
                rec["per_device"]["kernel_flops"] = analyzer.kernel_flops
                rec["op_count"] = analyzer.op_count
                rec["kernels"] = analyzer.kernels

                # ---- roofline terms (seconds; the reference's formulas) -------
                executed = costs.dot_flops + analyzer.kernel_flops
                terms = {
                    "compute_s": executed / PEAK_FLOPS,
                    "memory_s": costs.op_bytes / HBM_BW,
                    "collective_s": costs.total_collective_bytes / LINK_BW,
                }
                rec["roofline"] = terms
                rec["dominant"] = max(terms, key=terms.get)

                total, active = active_params(lm)
                if shape.kind == "train":
                    model_flops = 6.0 * active * shape.global_batch * shape.seq_len
                elif shape.kind == "prefill":
                    model_flops = 2.0 * active * shape.global_batch * shape.seq_len
                else:
                    model_flops = 2.0 * active * shape.global_batch
                rec["params_total"] = total
                rec["params_active"] = active
                rec["model_flops"] = model_flops
                hlo_global = executed * chips
                rec["useful_flops_ratio"] = model_flops / hlo_global if hlo_global else 0.0
                ideal = model_flops / (chips * PEAK_FLOPS)
                bound = max(terms.values())
                rec["roofline_fraction"] = ideal / bound if bound else 0.0
            rec["analyze_s"] = round(sw.elapsed_s, 1)
        rec["wall_s"] = round(sw_cell.elapsed_s, 1)
        if arg_bytes + temp > HBM_BYTES:  # XLA's compile-time out-of-memory
            raise MemoryError(
                f"{arg_bytes + temp} bytes a device ({arg_bytes} of arguments, {temp} "
                f"temporary) pass the card's {HBM_BYTES}")
        rec["ok"] = True
        return rec
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", required=True)
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--remat", default="full")
    p.add_argument("--grad-accum", type=int, default=0)
    p.add_argument("--moment-dtype", default=None)
    p.add_argument("--param-dtype", default=None,
                   help="serving override: lower with bf16 weights")
    p.add_argument("--no-fsdp", action="store_true",
                   help="serving override: replicate weights over data axes")
    p.add_argument("--serve-period-cache", action="store_true",
                   help="decode: period-scan with per-kind cache lengths")
    p.add_argument("--cast-params", action="store_true",
                   help="L1: bf16 working copy before layer use")
    p.add_argument("--shard-cache-seq", action="store_true",
                   help="L4: shard decode cache length over the model axis")
    p.add_argument("--tag", default="baseline")
    args = p.parse_args(argv)

    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod, args)
    except Exception as e:  # repro: allow[except-discipline] -- a failed cell is a finding: record it as a JSONL row, don't crash the sweep
        rec = {
            "arch": args.arch,
            "shape": args.shape,
            "mesh": "2x16x16" if args.multi_pod else "16x16",
            "ok": False,
            "error": f"{type(e).__name__}: {e}",
        }
        print(json.dumps(rec), file=sys.stderr)
    rec["tag"] = args.tag
    line = json.dumps(rec)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if rec.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
