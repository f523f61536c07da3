"""Training launcher CLI (port of ``repro.launch.train``).

Examples::

    # fresh run, checkpoint geometry of a 2x2 mesh, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --reduced \\
        --mesh data=2,model=2 --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/run1

    # resume the same run under a DIFFERENT mesh: the trainer detects the
    # layout change and reshards the checkpoint as it streams it in
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --reduced \\
        --mesh data=1,model=1 --steps 30 --batch 8 --seq 64 --ckpt-dir /tmp/run1

    # incremental saves: each save writes only the shards that changed since
    # the previous commit, every 4th save a full rebase
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --reduced \
        --mesh data=2,model=2 --steps 20 --ckpt-dir /tmp/run2 --save-mode delta \
        --full-interval 4

    # the hot tier: an in-memory snapshot every 2 steps, every 5th promoted
    # to disk (--save-interval 10), and an obs trace of the run
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --reduced \
        --mesh data=2,model=2 --steps 20 --ckpt-dir /tmp/run3 --hot-interval 2 \
        --trace /tmp/run3.trace.json

    # 4 ranks (4 processes on this host, a gloo group), each holding and
    # saving only its shards of a data=2,model=2 layout; then 2 ranks resume
    # the run under another layout and world size
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --reduced \
        --device cpu --host-devices 4 --mesh data=2,model=2 --steps 10 --ckpt-dir /tmp/run4
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --reduced \
        --device cpu --host-devices 2 --mesh data=2,model=1 --steps 20 --ckpt-dir /tmp/run4

    # 2 ranks with the hot tier (each rank's ring holds its own fragments and
    # its buddy's mirrors) and delta drains, every 2nd one a full rebase
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --reduced \
        --device cpu --host-devices 2 --mesh data=2,model=1 --steps 8 --ckpt-dir /tmp/run5 \
        --save-interval 2 --hot-interval 1 --save-mode delta --full-interval 2

The flags are the reference's, and ``--compute-dtype`` (default
``bfloat16``, the reference's only dtype; ``float32`` makes runs under two
layouts agree to rounding).  Without ``--host-devices`` the model
trains on one device (``--device``, default ``cuda``; CUDA that is not
there raises), and ``--mesh`` sets the checkpoint geometry.
``--host-devices N`` runs N ranks as N processes of this host in a gloo
group (a ``FileStore`` in a temporary directory), which this process
starts and supervises; on the CPU with ``--device cpu``, else on the
cards (rank r on ``cuda:(r % device_count)``).  N must equal the mesh's
size.  Only rank 0 prints.  ``--pipe-axis`` names the stage axis, by the
reference's rule (a named axis of the mesh, else ``pipe`` when the mesh
has one).  ``--trace PATH`` records the run's spans and counters and
writes them as a Chrome trace-event JSON at PATH (rank 0's).
``--log-json`` prints one JSON object per step (and one ``restored`` event).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="repro_torch trainer")
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true", help="tiny same-family config")
    p.add_argument("--host-devices", type=int, default=0,
                   help="run N ranks as N processes of this host (N = the mesh's size)")
    p.add_argument("--mesh", default="data=1,model=1")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--save-interval", type=int, default=10)
    p.add_argument("--hot-interval", type=int, default=None,
                   help="steps between in-memory hot snapshots (None = off); every "
                   "(save-interval // hot-interval)-th snapshot is drained to disk")
    p.add_argument("--hot-replication", type=int, default=1)
    p.add_argument("--save-mode", default="dedup", choices=("dedup", "all", "delta"))
    p.add_argument("--full-interval", type=int, default=8,
                   help="with --save-mode delta: every Nth save is a full rebase")
    p.add_argument("--keep-last", type=int, default=10)
    p.add_argument("--codec", default=None, metavar="TAG",
                   help="code optimizer-moment shards with this block-quant tag "
                   "(e.g. int8:b256, fp8:e4m3:b256); params stay raw")
    p.add_argument("--codec-params", default=None, metavar="TAG",
                   help="code parameter shards too; lossless tags only "
                   "(raw, int8ef:bN) unless you know what you are doing")
    p.add_argument("--sync-save", action="store_true")
    p.add_argument("--zero", type=int, default=3, choices=(1, 2, 3))
    p.add_argument("--no-fsdp", action="store_true")
    p.add_argument("--no-tp", action="store_true")
    p.add_argument("--no-sp", action="store_true")
    p.add_argument("--no-ep", action="store_true")
    p.add_argument("--pipe-axis", default=None)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--remat", default="full", choices=("none", "full", "dots"))
    p.add_argument("--moment-dtype", default="float32")
    p.add_argument("--compute-dtype", default="bfloat16", choices=("bfloat16", "float32"),
                   help="the forward and backward's dtype (float32: runs that must agree "
                   "with another layout to rounding)")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--total-steps", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-json", action="store_true")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="record an obs trace of the run and export it as a "
                   "Chrome trace-event JSON (Perfetto-loadable) at PATH")
    p.add_argument("--device", default="cuda")
    # a spawned rank's place in a --host-devices world (set by rank 0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--store", default=None, help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.host_devices:
        from repro_torch.launch.mesh import mesh_spec_from_string

        size = mesh_spec_from_string(args.mesh).size
        if args.host_devices != size:
            raise SystemExit(f"--host-devices {args.host_devices} is not the size of the "
                             f"mesh {args.mesh} ({size}): one rank per mesh position")
        if args.store is None:
            return _spawn_world(argv, args)

    import repro_torch.obs as obs

    tracer = obs.enable() if args.trace and args.rank == 0 else None
    try:
        return _run(args)
    finally:
        if tracer is not None:
            obs.write_chrome_trace(args.trace, tracer)
            obs.disable(tracer)


def _spawn_world(argv: list[str], args, module: str = "repro_torch.launch.train") -> int:
    """Start the N ranks of a ``--host-devices`` world as processes of this
    host (``python -m module``) and supervise them: rank 0 prints to this
    process's stdout; a rank that fails stops the others at once (rather
    than leave them waiting in a collective) and fails the run."""
    src = str(Path(__file__).resolve().parents[2])  # the directory holding repro_torch
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        cmd = [sys.executable, "-m", module, *argv,
               "--store", os.path.join(tmp, "store")]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env,
                                  stdout=None if r == 0 else subprocess.DEVNULL)
                 for r in range(args.host_devices)]
        try:
            while True:
                codes = [p.poll() for p in procs]
                failed = {r: c for r, c in enumerate(codes) if c not in (None, 0)}
                if failed:
                    print(f"ranks exited non-zero: {failed}; stopping the world",
                          file=sys.stderr, flush=True)
                    return 1
                if all(c == 0 for c in codes):
                    return 0
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def _run(args) -> int:
    from repro_torch.launch.serve import resolve_device

    device = resolve_device(args.device)
    if not args.host_devices:
        return _train(args, device, None)
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(args.store, args.host_devices),
                            rank=args.rank, world_size=args.host_devices,
                            timeout=datetime.timedelta(minutes=30))
    try:
        # a bare "cuda": the trainer places rank r on cuda:(r % device_count)
        return _train(args, None if str(device) == "cuda" else device, dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def _train(args, device, group) -> int:
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config, reduced
    from repro_torch.core.codec import CodecPolicy
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.train.trainer import Trainer

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mesh = mesh_spec_from_string(args.mesh)
    names = mesh.axis_names
    lead = args.rank == 0  # only rank 0 prints
    parallel = ParallelismConfig(
        data_axes=tuple(a for a in ("pod", "data") if a in names) or ("data",),
        model_axis="model",
        # the reference's rule: a named pipe axis of the mesh, else "pipe"
        pipe_axis=(args.pipe_axis if args.pipe_axis in names
                   else ("pipe" if "pipe" in names else None)),
        fsdp=not args.no_fsdp,
        zero=args.zero,
        tensor_parallel=not args.no_tp,
        expert_parallel=not args.no_ep,
        sequence_parallel=not args.no_sp,
        moment_dtype=args.moment_dtype,
        compute_dtype=args.compute_dtype,
        remat=args.remat,
        grad_accum=args.grad_accum,
    )
    tcfg = TrainConfig(
        learning_rate=args.lr, warmup_steps=args.warmup,
        total_steps=args.total_steps, seed=args.seed,
    )
    codec = None
    if args.codec is not None or args.codec_params is not None:
        moments = args.codec or "raw"
        codec = CodecPolicy(
            params=args.codec_params or "raw",
            exp_avg=moments,
            exp_avg_sq=moments,
            allow_lossy_params=args.codec_params is not None,
        )
    policy = CheckpointPolicy(
        keep_last=args.keep_last,
        save_interval=args.save_interval,
        hot_interval=args.hot_interval,
        hot_replication=args.hot_replication,
        async_save=not args.sync_save,
        save_mode=args.save_mode,
        full_interval=args.full_interval,
        codec=codec,
    )
    trainer = Trainer.create(
        cfg, parallel, tcfg, mesh,
        batch_size=args.batch, seq_len=args.seq,
        ckpt_dir=args.ckpt_dir, policy=policy, device=device, group=group,
    )
    state, info = trainer.init_or_restore()
    start = state.step
    if info is not None and lead:
        print(json.dumps({
            "event": "restored",
            "step": info.step,
            "mode": info.mode.value,
            "reason": info.reason,
            "load_s": round(info.wall_time_s, 3),
        }), flush=True)

    def log(rec):
        if not lead:
            return
        if args.log_json:
            print(json.dumps({"event": "step", **rec}), flush=True)
        else:
            print(
                f"step {rec['step']:5d} loss {rec['loss']:.4f} "
                f"gnorm {rec['grad_norm']:.3f} ({rec['dt'] * 1e3:.0f} ms)",
                flush=True,
            )

    remaining = args.steps - start
    if remaining > 0:
        state, _ = trainer.run(state, start, remaining, log=log)
    if trainer.manager is not None:
        trainer.manager.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
