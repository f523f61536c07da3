"""Serving launcher: restore weights from a checkpoint of any Source layout
and decode greedily (port of ``repro.launch.serve``).

::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --ckpt-dir /path/to/run --mesh data=1,model=1 --batch 4 \\
        --prompt-len 512 --gen 16

Every config serves, from a checkpoint of any layout: dense, Mamba-2,
mixtral, deepseek-v2 (``--arch deepseek-v2-236b``: MLA, whose decode
attends through the absorbed latent cache), jamba, llama-vision and
whisper.  The two cross-attention families read stubbed frontend
embeddings drawn from ``--seed`` on the device in bfloat16:
``[batch, cross_attn.source_len, source_dim]`` (llama-vision's patches) or
``[batch, encoder.source_len, d_model]`` (whisper's frames).

The restore is weights-only, as the reference's docstring says (the
reference restores a full ``TrainState``): open the newest committed
``step_XXXXXXXX``, plan the resume against this run's layout, and read the
fp32 weights only — DIRECT when the layouts are equal, RESHARD_STREAM with
the per-param plan table when they differ, VIA_UCP when the planner says so
(the step is converted once into ``<step dir>.ucp``, or that committed
cache is reused, and the weights are read from its ``fp32`` atoms).  The
bytes are the ``.params`` of a full restore.

``--device`` defaults to ``cuda``; asking for CUDA where there is none
raises.  The last line of output is a JSON record of the run.

``--host-devices N`` serves from N ranks, N processes of this host in a
gloo group started and supervised as the train launcher's (rank r on
``cuda:(r % device_count)``, or the CPU with ``--device cpu``); N must be
the mesh's size.  Each rank restores only its own shards of the weights
(the restore's ``rank=`` path, DIRECT or RESHARD_STREAM), gathers them over
the data axes once, and serves its rows of the batch: under tensor
parallelism every family computes partitioned over the model axis
(:class:`~repro_torch.dist.tensor_parallel.TensorParallel`, its decode cache
laid out by ``cache_pspecs``; vlm and encdec ranks draw the same source
embeds from ``--seed``), else from the whole weights.
Rank 0 prints, every row's tokens::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --reduced \\
        --device cpu --host-devices 2 --mesh data=1,model=2 --ckpt-dir /path/to/run \\
        --batch 4 --prompt-len 16 --gen 8

Under a tracer (:mod:`repro_torch.obs`) the restore's plan is the
``restore.plan`` span (beside ``restore.prefetch`` and
``restore.materialize`` of the region reads), and the prefill and the
decode steps are the reference's ``serve.prefill`` and ``serve.decode``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

import repro_torch.obs as obs
from repro_torch.ckpt.manager import cached_ucp
from repro_torch.ckpt.restore import params_from_source, params_from_ucp
from repro_torch.configs import ParallelismConfig, get_config, reduced
from repro_torch.core.dist_ckpt import DistCheckpoint
from repro_torch.core.engine import default_engine
from repro_torch.core.layout import MeshSpec
from repro_torch.core.plan import (
    ResumeMode, ResumePlan, TargetSpec, plan_resume, stream_transforms,
)
from repro_torch.core.layout import slice_shard
from repro_torch.core.patterns import StateKind
from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths
from repro_torch.dist.sharding import (
    RankGroups, ShardingPlan, gather_full, make_plan, rank_rows, vocab_multiple,
)
from repro_torch.dist.tensor_parallel import TensorParallel, partitions
from repro_torch.launch.mesh import mesh_spec_from_string
from repro_torch.models import build_model
from repro_torch.models import decode as D
from repro_torch.models.lm import LM

__all__ = [
    "latest_step_dir",
    "restore_params",
    "generate",
    "draw_source_embeds",
    "serving_parallelism",
    "rank_weights",
    "resolve_device",
    "main",
]


def resolve_device(name: str) -> torch.device:
    """The requested device; CUDA that is not there raises, never falls back."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but is not available (pass --device cpu)")
    return device


def serving_parallelism(mesh: MeshSpec) -> ParallelismConfig:
    """The reference serve launcher's parallelism for a mesh."""
    return ParallelismConfig(
        data_axes=tuple(a for a in ("pod", "data") if mesh.has_axis(a)) or ("data",),
    )


def latest_step_dir(root: str | Path) -> Path | None:
    """Newest committed ``step_XXXXXXXX`` directory under ``root`` (by step
    number, as the reference's ``CheckpointManager.steps``), or None."""
    steps = []
    for p in Path(root).glob("step_*"):
        if p.is_dir() and not p.name.endswith(".ucp") and (p / "COMMIT").exists():
            try:
                steps.append((int(p.name.split("_")[1]), p))
            except (IndexError, ValueError):
                continue
    return max(steps)[1] if steps else None


DISK_MODES = (ResumeMode.DIRECT, ResumeMode.RESHARD_STREAM, ResumeMode.VIA_UCP)


def restore_params(
    step_dir: str | Path, plan: ShardingPlan, device, *, force_mode: ResumeMode | None = None,
    rank: int | None = None, group=None,
) -> tuple[dict[str, torch.Tensor], ResumePlan]:
    """Weights-only restore of one committed step onto ``device`` under the
    Target ``plan``: flat fp32 params and the resume plan that served them.
    ``force_mode`` pins VIA_UCP (or RESHARD_STREAM, or DIRECT when the
    layouts are equal); the returned plan then carries that mode.  With
    ``rank`` (of ``group``, every rank calling): that rank's checkpoint
    shards, read from its own regions; a VIA_UCP conversion is rank 0's."""
    ckpt = DistCheckpoint.open(step_dir)
    with obs.span("restore.plan"):
        rp = plan_resume(ckpt.manifest, TargetSpec(plan.mesh, plan.param_specs))
    if force_mode is not None:
        force = ResumeMode(force_mode)
        if force not in DISK_MODES:
            raise ValueError(f"cannot force disk restore mode {force}")
        if force is ResumeMode.DIRECT and rp.mode is not ResumeMode.DIRECT:
            raise ValueError(f"cannot force DIRECT restore: layouts differ ({rp.reason})")
        transforms = rp.transforms
        if force is ResumeMode.RESHARD_STREAM and transforms is None:
            transforms = stream_transforms(ckpt.manifest, TargetSpec(plan.mesh, plan.param_specs))
        rp = dataclasses.replace(rp, mode=force, transforms=transforms,
                                 reason=f"forced {force.value}; planner said {rp.mode.value}")
    device = torch.device(device)
    engine = default_engine(device)
    try:
        if rp.mode is ResumeMode.VIA_UCP:
            if group is not None:  # one conversion; the others reuse its commit
                if rank == 0:
                    cached_ucp(ckpt, engine)
                torch.distributed.barrier(group=group)
            ucp, _ = cached_ucp(ckpt, engine)
            return params_from_ucp(ucp, plan, device, engine=engine, rank=rank), rp
        transforms = rp.transforms if rp.mode is ResumeMode.RESHARD_STREAM else None
        return params_from_source(ckpt, plan, device, transforms=transforms, engine=engine,
                                  rank=rank), rp
    finally:
        engine.release(ckpt)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def draw_source_embeds(cfg, batch: int, seed: int, device) -> torch.Tensor | None:
    """The stubbed frontend's embeddings of a vlm or encdec config (None for
    the others): standard normal in bfloat16 on ``device``, from ``seed``."""
    if cfg.encoder is not None:
        shape = (batch, cfg.encoder.source_len, cfg.d_model)
    elif cfg.cross_attn is not None:
        shape = (batch, cfg.cross_attn.source_len, cfg.cross_attn.source_dim)
    else:
        return None
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)


@torch.inference_mode()
def generate(lm: LM, params: dict, prompts: torch.Tensor, gen: int, *, cache_len: int = 0,
             source_embeds: torch.Tensor | None = None):
    """Greedy decoding: prefill the prompts (and the source, for vlm and
    encdec), then ``gen - 1`` decode steps.

    ``params`` are nested, in the compute dtype (``ParamRegistry.cast``:
    the leaves the reference reads in float32 stay float32).  Returns the generated
    tokens ``[B, gen]``, the prefill seconds and the decode seconds (each
    ended by a device synchronise).  Under a rank context (``lm.tp``) the
    prompts are the rank's rows and ``params`` its compute weights
    (:func:`rank_weights`); the greedy pick spans the vocab shards.
    """
    device = prompts.device
    b, s = prompts.shape
    rows = b * (lm.tp.ranks.data_size if lm.tp is not None else 1)  # the cache's global batch
    cache = D.init_cache(lm, rows, cache_len or (s + gen), device=device)
    _sync(device)
    with obs.timed("serve.prefill", batch=b, prompt_len=s) as sw:
        logits, cache = D.prefill(lm, params, cache, prompts, source_embeds=source_embeds)
        cur = D.greedy(lm, logits)[:, None]
        _sync(device)
    prefill_s = sw.elapsed_s
    outs = [cur]
    with obs.timed("serve.decode", batch=b, steps=gen - 1) as sw:
        for _ in range(gen - 1):
            lg, cache = D.decode_step(lm, params, cache, cur)
            cur = D.greedy(lm, lg[:, -1])[:, None]
            outs.append(cur)
        _sync(device)
    return torch.cat(outs, 1), prefill_s, sw.elapsed_s


def rank_weights(lm: LM, ranks: RankGroups, local: dict) -> dict:
    """A serving rank's flat compute weights from its checkpoint shards:
    gathered over the data axes (and the weights no rank computes from its
    shard, over the model axis) under partitioned compute, else the whole
    weights (every rank of a family that does not partition computes them
    all)."""
    if lm.tp is not None:
        return lm.tp.gathered_weights(local)
    plan = ranks.plan
    return {n: gather_full(t, plan.param_specs[n].layout_for(StateKind.FP32, plan.mesh),
                           ranks.group) for n, t in local.items()}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--host-devices", type=int, default=0,
                   help="serve from N ranks, N processes of this host (N = the mesh's size)")
    p.add_argument("--mesh", default="data=1,model=1",
                   help="the layout this run plans its restore under")
    p.add_argument("--ckpt-dir", default=None, help="resume weights from here")
    p.add_argument("--force-mode", default=None, choices=[m.value for m in DISK_MODES],
                   help="pin the restore mode (via_ucp: convert the step into "
                   "<step dir>.ucp once and read its atoms)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--cache-len", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    # a spawned rank's place in a --host-devices world (set by the launcher)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if not args.host_devices:
        return _serve(args, device, None)
    size = mesh_spec_from_string(args.mesh).size
    if args.host_devices != size:
        raise SystemExit(f"--host-devices {args.host_devices} is not the size of the mesh "
                         f"{args.mesh} ({size}): one rank per mesh position")
    if args.store is None:
        from repro_torch.launch.train import _spawn_world

        return _spawn_world(argv, args, module="repro_torch.launch.serve")
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(args.store, args.host_devices),
                            rank=args.rank, world_size=args.host_devices,
                            timeout=datetime.timedelta(minutes=30))
    try:
        if device.type == "cuda" and device.index is None:
            device = torch.device(f"cuda:{args.rank % torch.cuda.device_count()}")
        return _serve(args, device, dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def _serve(args, device: torch.device, group) -> int:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mesh = mesh_spec_from_string(args.mesh)
    parallel = serving_parallelism(mesh)
    lm = build_model(cfg, vocab_multiple=vocab_multiple(parallel, mesh))
    plan = make_plan(cfg, lm.registry, parallel, mesh)
    ranks = None
    if group is not None:
        ranks = RankGroups.create(group, plan, parallel)
        if partitions(cfg, parallel, mesh):
            lm.tp = TensorParallel(ranks, cfg)
    rank = None if ranks is None else ranks.rank
    lead = not rank  # only rank 0 prints

    step_dir = latest_step_dir(args.ckpt_dir) if args.ckpt_dir else None
    mode, step = "random_init", None
    if step_dir is not None:
        t0 = time.perf_counter()
        flat, rp = restore_params(step_dir, plan, device, force_mode=args.force_mode, rank=rank,
                                  group=group)
        _sync(device)
        mode, step = rp.mode.value, rp.source_step
        if lead:
            print(f"restored step {step} via {mode} in {time.perf_counter() - t0:.2f}s")
    else:
        if args.ckpt_dir and lead:
            print("no checkpoint found; serving from random init")
        flat = flatten_with_paths(lm.init(torch.Generator(device=device).manual_seed(args.seed)))
        if ranks is not None:
            flat = {n: slice_shard(t, plan.param_specs[n].layout_for(StateKind.FP32, mesh), rank)
                    for n, t in flat.items()}
    if ranks is not None:
        flat = rank_weights(lm, ranks, flat)
    params = unflatten_from_paths(flat)

    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator().manual_seed(args.seed),
    ).to(device)
    source = draw_source_embeds(cfg, args.batch, args.seed, device)
    if ranks is not None:  # the rank's rows of the batch
        rows = rank_rows(args.batch, parallel, mesh, rank)
        prompts = prompts[rows]
        source = None if source is None else source[rows]
    seq, prefill_s, decode_s = generate(
        lm, lm.registry.cast(params, lm.compute_dtype), prompts, args.gen,
        cache_len=args.cache_len, source_embeds=source,
    )
    if ranks is not None and ranks.data is not None:  # every row's tokens, in batch order
        parts = [torch.empty_like(seq) for _ in ranks.members["data"]]
        torch.distributed.all_gather(parts, seq.contiguous(), group=ranks.data)
        seq = torch.cat(parts, 0)
    if not lead:
        return 0
    steps = max(args.gen - 1, 1)
    print(f"prefill {args.prompt_len} toks × {args.batch} reqs: {prefill_s * 1e3:.1f} ms")
    print(f"decode  {args.gen - 1} steps × {args.batch} reqs: {decode_s * 1e3:.1f} ms "
          f"({decode_s * 1e3 / steps:.2f} ms/step)")
    print("sample:", seq[0, :16].tolist())
    print(json.dumps({
        "event": "serve", "device": str(device), "mode": mode, "step": step,
        "ranks": 1 if ranks is None else ranks.mesh.size,
        "prefill_ms": prefill_s * 1e3, "decode_ms_per_step": decode_s * 1e3 / steps,
        "tokens": seq.tolist(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
