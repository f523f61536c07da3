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

The flags are the reference's.  The model trains on one device
(``--device``, default ``cuda``; CUDA that is not there raises), and
``--mesh`` sets the checkpoint geometry.  Flags whose machinery is not
ported raise: ``--host-devices`` above 0 (one device trains here) and
``--pipe-axis``.  ``--trace PATH`` records the run's spans and counters and
writes them as a Chrome trace-event JSON at PATH.
``--log-json`` prints one JSON object per step (and one ``restored`` event).
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="repro_torch trainer")
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true", help="tiny same-family config")
    p.add_argument("--host-devices", type=int, default=0,
                   help="the reference's simulated CPU devices; must be 0 here")
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
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--total-steps", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-json", action="store_true")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="record an obs trace of the run and export it as a "
                   "Chrome trace-event JSON (Perfetto-loadable) at PATH")
    p.add_argument("--device", default="cuda")
    return p


def _refuse_unported(args) -> None:
    refused = [
        (args.host_devices > 0, "--host-devices", "one device trains here (item 11: multi-rank)"),
        (args.pipe_axis is not None, "--pipe-axis", "item 11: multi-rank runtime"),
    ]
    for hit, flag, item in refused:
        if hit:
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP queue 1, {item})")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)

    import repro_torch.obs as obs

    tracer = obs.enable() if args.trace else None
    try:
        return _run(args)
    finally:
        if tracer is not None:
            obs.write_chrome_trace(args.trace, tracer)
            obs.disable(tracer)


def _run(args) -> int:
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config, reduced
    from repro_torch.core.codec import CodecPolicy
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.launch.serve import resolve_device
    from repro_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mesh = mesh_spec_from_string(args.mesh)
    names = mesh.axis_names
    parallel = ParallelismConfig(
        data_axes=tuple(a for a in ("pod", "data") if a in names) or ("data",),
        model_axis="model",
        pipe_axis="pipe" if "pipe" in names else None,
        fsdp=not args.no_fsdp,
        zero=args.zero,
        tensor_parallel=not args.no_tp,
        expert_parallel=not args.no_ep,
        sequence_parallel=not args.no_sp,
        moment_dtype=args.moment_dtype,
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
        ckpt_dir=args.ckpt_dir, policy=policy, device=device,
    )
    state, info = trainer.init_or_restore()
    start = state.step
    if info is not None:
        print(json.dumps({
            "event": "restored",
            "step": info.step,
            "mode": info.mode.value,
            "reason": info.reason,
            "load_s": round(info.wall_time_s, 3),
        }), flush=True)

    def log(rec):
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
