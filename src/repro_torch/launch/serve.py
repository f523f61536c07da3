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
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

from repro_torch.ckpt.manager import cached_ucp
from repro_torch.ckpt.restore import params_from_source, params_from_ucp
from repro_torch.configs import ParallelismConfig, get_config, reduced
from repro_torch.core.dist_ckpt import DistCheckpoint
from repro_torch.core.engine import default_engine
from repro_torch.core.layout import MeshSpec
from repro_torch.core.plan import (
    ResumeMode, ResumePlan, TargetSpec, plan_resume, stream_transforms,
)
from repro_torch.core.pytree import unflatten_from_paths
from repro_torch.dist.sharding import ShardingPlan, make_plan, vocab_multiple
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


def restore_params(
    step_dir: str | Path, plan: ShardingPlan, device, *, force_mode: ResumeMode | None = None
) -> tuple[dict[str, torch.Tensor], ResumePlan]:
    """Weights-only restore of one committed step onto ``device`` under the
    Target ``plan``: flat fp32 params and the resume plan that served them.
    ``force_mode`` pins VIA_UCP (or RESHARD_STREAM, or DIRECT when the
    layouts are equal); the returned plan then carries that mode."""
    ckpt = DistCheckpoint.open(step_dir)
    rp = plan_resume(ckpt.manifest, TargetSpec(plan.mesh, plan.param_specs))
    if force_mode is not None:
        force = ResumeMode(force_mode)
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
            ucp, _ = cached_ucp(ckpt, engine)
            return params_from_ucp(ucp, plan, device, engine=engine), rp
        transforms = rp.transforms if rp.mode is ResumeMode.RESHARD_STREAM else None
        return params_from_source(ckpt, plan, device, transforms=transforms, engine=engine), rp
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
    ended by a device synchronise).
    """
    device = prompts.device
    b, s = prompts.shape
    cache = D.init_cache(lm, b, cache_len or (s + gen), device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = D.prefill(lm, params, cache, prompts, source_embeds=source_embeds)
    cur = logits.argmax(-1)[:, None]
    _sync(device)
    prefill_s = time.perf_counter() - t0
    outs = [cur]
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        lg, cache = D.decode_step(lm, params, cache, cur)
        cur = lg[:, -1].argmax(-1)[:, None]
        outs.append(cur)
    _sync(device)
    return torch.cat(outs, 1), prefill_s, time.perf_counter() - t0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--host-devices", type=int, default=0,
                   help="accepted for the reference's command line; one device serves here")
    p.add_argument("--mesh", default="data=1,model=1",
                   help="the layout this run plans its restore under")
    p.add_argument("--ckpt-dir", default=None, help="resume weights from here")
    p.add_argument("--force-mode", default=None, choices=[m.value for m in ResumeMode],
                   help="pin the restore mode (via_ucp: convert the step into "
                   "<step dir>.ucp once and read its atoms)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--cache-len", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mesh = mesh_spec_from_string(args.mesh)
    parallel = serving_parallelism(mesh)
    lm = build_model(cfg, vocab_multiple=vocab_multiple(parallel, mesh))

    step_dir = latest_step_dir(args.ckpt_dir) if args.ckpt_dir else None
    mode, step = "random_init", None
    if step_dir is not None:
        plan = make_plan(cfg, lm.registry, parallel, mesh)
        t0 = time.perf_counter()
        flat, rp = restore_params(step_dir, plan, device, force_mode=args.force_mode)
        _sync(device)
        params = unflatten_from_paths(flat)
        mode, step = rp.mode.value, rp.source_step
        print(f"restored step {step} via {mode} in {time.perf_counter() - t0:.2f}s")
    else:
        if args.ckpt_dir:
            print("no checkpoint found; serving from random init")
        params = lm.init(torch.Generator(device=device).manual_seed(args.seed))

    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator().manual_seed(args.seed),
    ).to(device)
    seq, prefill_s, decode_s = generate(
        lm, lm.registry.cast(params, lm.compute_dtype), prompts, args.gen,
        cache_len=args.cache_len,
        source_embeds=draw_source_embeds(cfg, args.batch, args.seed, device),
    )
    steps = max(args.gen - 1, 1)
    print(f"prefill {args.prompt_len} toks × {args.batch} reqs: {prefill_s * 1e3:.1f} ms")
    print(f"decode  {args.gen - 1} steps × {args.batch} reqs: {decode_s * 1e3:.1f} ms "
          f"({decode_s * 1e3 / steps:.2f} ms/step)")
    print("sample:", seq[0, :16].tolist())
    print(json.dumps({
        "event": "serve", "device": str(device), "mode": mode, "step": step,
        "prefill_ms": prefill_s * 1e3, "decode_ms_per_step": decode_s * 1e3 / steps,
        "tokens": seq.tolist(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
