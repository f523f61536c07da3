#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, any failure exits non-zero:

1. device  — require CUDA (no CPU fallback); print the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build   — compile the flash-attention kernel from this checkout's CUDA
   source with nvcc (sm_90a); print the build seconds and ptxas' report;
3. kernel  — the kernel against its plain PyTorch version on the card at the
   serving slice's shapes (B=4, S=512 and a ragged 500, 15:5 heads, D=64,
   bf16, causal; a window=128 case; an fp32 case), max abs error beside the
   tolerance; then kernel, plain and library
   (``scaled_dot_product_attention``, timed as a yardstick only) times;
4. main path, full smollm-360m at all 32 layers: init on the card from a
   seeded generator; ``write_distributed`` under data=2,model=2 (fp32
   weights and both Adam moments); weights-only restore under
   data=1,model=1 (RESHARD_STREAM) and data=2,model=2 (DIRECT), each
   bit-equal to the saved weights; prefill 4 × 512 tokens and 16 greedy
   decode steps from each restore, the kernel's launch count read around
   each run; both restores give the same tokens; the card's fp32 logits
   agree with the port's CPU path (plain attention) on a short prompt;
5. the kernels line (JSON), then the result line (JSON, last).
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
KERNEL_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention/kernel.py:96"
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 1e-5)}  # (atol, rtol), tests/test_kernels.py


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False,
    )
    check(res.returncode == 0 and res.stdout.strip(), f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 50) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` launches (CUDA events,
    after a warm-up)."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(q, k, v, o, *, causal: bool, window: int, flops_peak: float):
    """Least time for the work: each input read once and the output written
    once at the memory rate, against the score and P·V products this run's
    mask allows at the peak rate of the inputs' type."""
    b, s, hq, d = q.shape
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, o))
    pairs = 0
    for i in range(s):
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = i + 1 if causal else k.shape[1]
        pairs += hi - lo
    flops = 4.0 * d * pairs * b * hq
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / flops_peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def device_profile(torch, fn, top: int = 6):
    """Run ``fn`` once under the profiler: (wall ms with the profiler on,
    device busy ms = the sum of kernel and copy times, top rows by device
    time as (name, ms, count)).  Only device-side events are summed: the
    host ops that launched them carry the same time as their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.key, e.self_device_time_total / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return wall_ms, sum(r[1] for r in rows), rows[:top]


def profile_serving(torch, D, lm, params, prompts):
    """Where the serving time goes on the device: one prefill and 16 decode
    steps, each under the profiler (which slows the host, so the idle
    shares are upper bounds)."""
    b, s = prompts.shape
    with torch.inference_mode():
        cache = D.init_cache(lm, b, s + 17, device=prompts.device)
        cur = prompts[:, -1:].clone()
        phases = {
            "prefill": lambda: D.prefill(lm, params, cache, prompts),
            "decode x16": lambda: [D.decode_step(lm, params, cache, cur) for _ in range(16)],
        }
        for name, fn in phases.items():
            wall, busy, top = device_profile(torch, fn)
            print(f"profile {name}: wall {wall:.2f} ms (profiler on), device busy {busy:.2f} ms, "
                  f"idle share {max(0.0, 1 - busy / wall):.3f}")
            for key, ms, count in top:
                print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")


def kernel_phase(torch, F, kernel, ref):
    """Kernel vs plain on the card; returns the main-shape measurements."""
    dev = torch.device("cuda")
    cases = [
        ("bf16 causal S=512", torch.bfloat16, 512, 0, True),
        ("bf16 causal S=500", torch.bfloat16, 500, 0, True),
        ("bf16 causal window=128 S=500", torch.bfloat16, 500, 128, True),
        ("fp32 causal S=500", torch.float32, 500, 0, True),
    ]
    g = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    main = None
    for label, dtype, s, window, causal in cases:
        q, k, v = (torch.randn(4, s, h, 64, generator=g, device=dev).to(dtype) for h in (15, 5, 5))
        out = kernel.flash_attention_fwd(q, k, v, causal=causal, window=window, scale=0.125)
        plain = ref.attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, scale=0.125,
        ).transpose(1, 2)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out.float()).all()), f"{label}: non-finite output")
        atol, rtol = TOL[str(dtype).split(".")[1]]
        diff = (out.float() - plain.float()).abs()
        err = diff.max().item()
        ok = bool((diff <= atol + rtol * plain.float().abs()).all())
        print(f"kernel {label}: max_abs_err {err:.3e} (tolerance atol {atol} rtol {rtol}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{label}: kernel disagrees with its plain version")
        if dtype == torch.bfloat16:
            worst = max(worst, err)
        if main is None:
            main = (q, k, v, out)
    q, k, v, out = main
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    runs = {
        "kernel": lambda: kernel.flash_attention_fwd(q, k, v, causal=True, window=0, scale=0.125),
        "plain": lambda: ref.attention_ref(qt, kt, vt, causal=True, scale=0.125),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=0.125, enable_gqa=True),
    }
    try:
        lib_err = (runs["library"]().transpose(1, 2).float() - out.float()).abs().max().item()
        print(f"library yardstick agrees with the kernel to {lib_err:.3e}")
    except TypeError as e:  # a torch without enable_gqa: no library time
        print(f"library yardstick unavailable: {e}")
        del runs["library"]
    times: dict[str, list[float]] = {n: [] for n in runs}
    for name in ("plain", "kernel", "library", "library", "kernel", "plain"):
        if name in runs:
            times[name].append(cuda_ms(torch, runs[name]))
    ms = {n: sum(t) / len(t) for n, t in times.items()}
    ms.setdefault("library", None)
    _, busy, top = device_profile(torch, lambda: [runs["kernel"]() for _ in range(20)], top=1)
    print(f"kernel device time (profiler): {top[0][1] / top[0][2]:.4f} ms per launch "
          f"over {top[0][2]} launches ({top[0][0][:60]})")
    bound_ms, bound_by, nbytes, flops = attention_bound(
        q, k, v, out, causal=True, window=0, flops_peak=PEAK_BF16_FLOPS)
    fp32_floor_ms = flops / PEAK_FP32_FLOPS * 1e3
    print(f"kernel bf16 B=4 S=512 Hq=15 Hkv=5 D=64 causal: kernel_ms {ms['kernel']:.4f} "
          f"plain_ms {ms['plain']:.4f} library_ms {ms['library']} "
          f"bound_ms {bound_ms:.5f} ({bound_by}; {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP) "
          f"fp32-core floor {fp32_floor_ms:.4f} ms")
    return dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=worst)


def main_path(torch, ops):
    """Save, restore two ways, and serve full smollm-360m on the card."""
    from repro_torch.ckpt.saver import snapshot, write_distributed
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths
    from repro_torch.dist.sharding import make_plan, vocab_multiple
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.launch.serve import (
        generate, latest_step_dir, restore_params, serving_parallelism,
    )
    from repro_torch.models import build_model
    from repro_torch.models import decode as D
    from repro_torch.models.common import cast_tree

    dev = torch.device("cuda")
    cfg = get_config("smollm-360m")

    def plan_for(mesh_str, dtype=torch.bfloat16):
        mesh = mesh_spec_from_string(mesh_str)
        parallel = serving_parallelism(mesh)
        lm = build_model(cfg, vocab_multiple=vocab_multiple(parallel, mesh), compute_dtype=dtype)
        return lm, make_plan(cfg, lm.registry, parallel, mesh)

    lm, src_plan = plan_for("data=2,model=2")
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = lm.registry.num_params()
    print(f"main init: smollm-360m {cfg.num_layers} layers, {n_params} params on the card "
          f"in {time.perf_counter() - t0:.2f} s")

    ckpt_root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        snap = snapshot(params)
        snap_s = time.perf_counter() - t0
        res = write_distributed(snap, src_plan, 1, ckpt_root / "step_00000001",
                                config_fingerprint=cfg.fingerprint())
        del snap
        print(f"main save: data=2,model=2 {res.bytes_written / 1e9:.3f} GB in "
              f"{res.shards_written} shards, {res.wall_time_s:.2f} s "
              f"({res.bytes_written / 1e9 / res.wall_time_s:.3f} GB/s; "
              f"device→host snapshot {snap_s:.2f} s)")
        check(res.bytes_written >= 3 * 4 * n_params, "checkpoint smaller than 3 fp32 kinds")

        saved = flatten_with_paths(params)
        prompts = torch.randint(0, cfg.vocab_size, (4, 512),
                                generator=torch.Generator().manual_seed(1)).to(dev)
        step_dir = latest_step_dir(ckpt_root)
        check(step_dir is not None and step_dir.name == "step_00000001", "no committed step")
        runs = {}
        for mesh_str, expect in (("data=1,model=1", "reshard_stream"),
                                 ("data=2,model=2", "direct")):
            tlm, tplan = plan_for(mesh_str)
            t0 = time.perf_counter()
            flat, rp = restore_params(step_dir, tplan, dev)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            check(rp.mode.value == expect, f"{mesh_str}: planned {rp.mode.value}, want {expect}")
            check(set(flat) == set(saved), f"{mesh_str}: restored parameter set differs")
            for name, t in flat.items():
                check(torch.equal(t, saved[name]), f"{mesh_str}: {name} differs from the save")
            print(f"main restore {mesh_str}: {rp.mode.value} in {restore_s:.2f} s "
                  f"(consolidated in memory: {rp.consolidate_params}); bit-equal to the save")
            params_c = cast_tree(unflatten_from_paths(flat), torch.bfloat16)
            del flat
            # Warm-up at the timed shapes: lazily loaded CUDA modules, cuBLAS
            # handles and heuristics would otherwise land in the timed run.
            generate(tlm, params_c, prompts, 17)
            ops.flash_attention.launches = 0
            seq, prefill_s, decode_s = generate(tlm, params_c, prompts, 17)
            launches = ops.flash_attention.launches
            check(launches == cfg.num_layers,
                  f"{mesh_str}: {launches} kernel launches in one prefill, want {cfg.num_layers}")
            check(tuple(seq.shape) == (4, 17), f"{mesh_str}: tokens {tuple(seq.shape)}")
            check(bool(((seq >= 0) & (seq < cfg.vocab_size)).all()), "token out of vocab")
            print(f"main serve {mesh_str}: prefill 4x512 {prefill_s * 1e3:.2f} ms, "
                  f"decode {decode_s * 1e3 / 16:.3f} ms/token (batch 4, 16 steps), "
                  f"flash_attention launches {launches}")
            runs[mesh_str] = dict(seq=seq.cpu(), prefill_ms=prefill_s * 1e3,
                                  decode_ms=decode_s * 1e3 / 16, restore_s=restore_s,
                                  launches=launches)
            if expect == "direct":
                profile_serving(torch, D, tlm, params_c, prompts)
            del params_c
        a, b = runs["data=1,model=1"]["seq"], runs["data=2,model=2"]["seq"]
        check(torch.equal(a, b), "RESHARD_STREAM and DIRECT restores serve different tokens")
        print(f"main tokens identical across restores; sample {a[0, :8].tolist()}")

        # Right by the repo's own means: the card's fp32 path (kernel) against
        # the port's CPU path (plain attention) on the same weights, short prompt.
        flm, _ = plan_for("data=2,model=2", torch.float32)
        toks = prompts[:1, :48]
        with torch.inference_mode():
            lg_gpu, _ = D.prefill(flm, params, D.init_cache(flm, 1, 48, device=dev), toks)
            cpu_params = {n: t.cpu() for n, t in saved.items()}
            lg_cpu, _ = D.prefill(flm, unflatten_from_paths(cpu_params),
                                  D.init_cache(flm, 1, 48), toks.cpu())
        check(tuple(lg_gpu.shape) == (1, cfg.vocab_size), f"logits {tuple(lg_gpu.shape)}")
        check(bool(torch.isfinite(lg_gpu).all()), "non-finite logits")
        err = (lg_gpu.cpu() - lg_cpu).abs().max().item()
        print(f"main check fp32 logits card vs CPU (48 tokens): max_abs_err {err:.3e} "
              f"(tolerance 1e-3)")
        check(err <= 1e-3, "card and CPU logits disagree")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    return runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("CUDA is not available: this smoke runs on a card, never the CPU")
    if not (SRC / "repro_torch").is_dir():
        raise SmokeError(f"{SRC / 'repro_torch'} is missing: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    _, report = kernel.build()
    usage = [ln.strip() for ln in report["ptxas"].splitlines() if "Used" in ln or "spill" in ln]
    print(f"build: {'compiled' if report['compiled'] else 'cached'} in "
          f"{report['seconds']:.2f} s -> {Path(report['library']).relative_to(ROOT)}")
    for ln in usage:
        print(f"  ptxas: {ln}")

    k = kernel_phase(torch, F, kernel, ref)
    runs = main_path(torch, ops)
    launches = runs["data=1,model=1"]["launches"]

    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"]["kernel"],
        "plain_ms": k["ms"]["plain"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": k["ms"]["library"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeError, ImportError) as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
