#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, any failure exits non-zero (no phase catches its own failure, and
nothing falls back to the CPU or to a plain version):

1. device  — require CUDA; print the card's name and power limit as
   ``nvidia-smi`` reports them;
2. build   — compile the three kernel sources of this checkout with nvcc
   (sm_90a), one process each, started together; print the build seconds
   and ptxas' report;
3. kernel flash_attention — against its plain PyTorch version at the
   serving slice's shapes (B=4, S=512 and a ragged 500, 15:5 heads, D=64,
   bf16, causal; a window=128 case; an fp32 case), max abs error beside the
   tolerance; the library (``scaled_dot_product_attention``, a yardstick
   only) against the kernel; then the bf16 (tensor-core) kernel's and the
   library's device time per call (the profiler, over 20 warm calls, in
   turns), their CUDA-event times, the fp32 (CUDA-core) kernel's device
   time at the same shapes, and the plain version's event time;
4. kernel block_quant — quantize and dequantize against their plain version
   for int8, e4m3 and e5m2 on a ragged count, an all-zero block, values up
   to 1e30, a non-finite case (±NaN, ±inf and an all-NaN block) and one
   moment shard of ``layers.blk.w_up`` under data=2,model=2, the last also
   as a view one element off (the general kernels); checked byte for byte
   (q, scales and the decoded fp32), the non-finite case by NaN class (NaN
   at the same places, every other byte equal), and each launch's variant;
   then at the shard's shape the vector kernel's and the general kernel's
   device time per call (the profiler, 20 warm calls, in turns; the 98.6 MB
   shard exceeds the 50 MB L2), the vector kernel's and the plain version's
   event times, and the bound (bytes over 3.35 TB/s; no single PyTorch
   call computes this function, so no library time);
5. kernel ssd_scan — against its plain versions (``ssd_chunked``, the
   chunked form it computes, and the O(S) ``ssd_ref``) at the SSM serving
   slice's shapes (B=4, S=512, H=24, P=64, G=1, N=128, chunk 256, bf16 x/B/C;
   dt = softplus(N(0,1) + dt_bias) with dt_bias from the ``ssm_dt`` init,
   A = -(1..24)), a G=2 case with 4 heads and chunk 64, an fp32 case and a
   case reading strided views as the model hands them, max abs error beside
   the tolerances of ``tests/test_kernels.py``; then the bf16
   (tensor-core) kernel's device time per call (the profiler, over 20 warm
   calls) and event time, the fp32 (CUDA-core) kernel's device time and
   the plain version's event time, and the bound (no single PyTorch call
   computes this function, so no library time);
6. serve, full smollm-360m (32 layers) and then full mamba2-130m (24
   layers), each: init on the card from a seeded generator;
   ``write_distributed`` of the weights under data=2,model=2; weights-only
   restore under data=1,model=1 (RESHARD_STREAM, fused QKV or the five-part
   ``in_proj`` consolidated) and data=2,model=2 (DIRECT), each bit-equal to
   the save; prefill 4 × 512 tokens and 16 greedy decode steps from each
   restore, every kernel's launches counted around each run (smollm: 32
   flash-attention and 0 SSD-scan launches per prefill; mamba2: 24 and 0
   the other way), all of them bf16 (the tensor-core kernels); both give
   the same tokens; the card's fp32 logits agree with the port's CPU path
   (mamba2 over 512 tokens: two chunks, so the carried state is compared),
   every launch there fp32 (the CUDA-core kernels); the profiled prefill's
   device time and the kernel's share of it;
7. train, full smollm-360m at all 32 layers, seed 0, batch 8 × seq 512
   from ``train/data.py``, bf16 compute, fp32 master and moments, TF32 off:
   6 uninterrupted steps (the baseline); separately 3 steps under a
   ``CheckpointManager`` with ``CheckpointPolicy(codec="int8:b256",
   save_interval=3, async_save=True)`` and plan data=2,model=2; resume
   under data=1,model=1 (RESHARD_STREAM) and data=2,model=2 (DIRECT), each
   with params bit-equal to the save, both moments equal to the codec's
   served view (every coded shard re-cut from the restored state hashes to
   the manifest's served digest) and step 3; steps 4-6 from each resume
   (finite losses, printed beside the baseline's); the launch counts
   (quantize == coded shards written, dequantize >= that plus the coded
   shards read per resume, every block-quant launch the vector variant,
   flash-attention 0); step time, tokens/s, save
   GB/s, coded/raw bytes, restore seconds and one profiled step's device
   busy share;
8. the kernels line (JSON: each row names its variants; ``ms`` is the
   profiler's device time per launch, with ``event_ms`` beside it; rows 2-3
   add the general kernel's device time ``general_ms`` and the train
   phase's ``launches_by_variant``), the card line, then the result line
   (JSON, last).
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
KERNEL_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention/kernel.py:96"
BQ_SOURCE = "src/repro_torch/kernels/block_quant/csrc/block_quant.cu"
BQ_REPLACES = {
    "quantize_blocks": "src/repro/kernels/block_quant/kernel.py:56",
    "dequantize_blocks": "src/repro/kernels/block_quant/kernel.py:86",
}
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan/kernel.py:78"
# (atol, rtol) of y by dtype, and of h_final: tests/test_kernels.py:107-112
SSD_TOL = {"bfloat16": (5e-2, 5e-2), "float32": (5e-4, 1e-4)}
SSD_H_TOL = (5e-3, 5e-3)
QDTYPES = ("int8", "float8_e4m3fn", "float8_e5m2")
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 1e-5)}  # (atol, rtol), tests/test_kernels.py
# The tensor-core (bf16) kernel of each source, as the profiler names it.
TC_SYMBOL = {"flash_attention": "fwd_kernel_tc", "ssd_scan": "ssd_kernel_tc"}
VARIANT = {
    "flash_attention_fwd": "bf16: fwd_kernel_tc, mma.sync m16n8k16 tensor cores, cp.async "
                           "double-buffered K/V; fp32: fwd_kernel, CUDA cores",
    "ssd_scan_fwd": "bf16: ssd_kernel_tc, mma.sync m16n8k16 tensor cores, bf16 hi+lo splits "
                    "of the fp32 operands; fp32: ssd_kernel, CUDA cores",
    "quantize_blocks": "n % 8 == 0 <= 1024, 16-byte aligned: quantize_vec_kernel, a row in "
                       "registers, float4 loads, 4-byte code stores, grid-stride with the next "
                       "row prefetched; otherwise: quantize_kernel, one block a row",
    "dequantize_blocks": "n % 8 == 0 <= 1024, 16-byte aligned: dequantize_vec_kernel, 4-byte "
                         "code loads, paired fp8 conversion, float4 streaming stores, "
                         "grid-stride; otherwise: dequantize_kernel, one block a row",
}


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


def device_ms(torch, fn, calls: int = 20):
    """Device milliseconds per call of ``fn``: the profiler's device time of
    every kernel and copy that ``calls`` warm calls launched, over
    ``calls`` (so the host's enqueue time is not in it); with the top rows
    as (name, ms, count)."""
    for _ in range(3):
        fn()
    _, busy, top = device_profile(torch, lambda: [fn() for _ in range(calls)], top=4)
    return busy / calls, top


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
    device busy ms = the sum of kernel and copy times, the ``top`` rows by
    device time as (name, ms, count); all of them for ``top=None``).  Only device-side events are summed: the
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
    return wall_ms, sum(r[1] for r in rows), rows[:top] if top is not None else rows


def profile_serving(torch, D, lm, params, prompts):
    """Where the serving time goes on the device: one prefill and 16 decode
    steps, each under the profiler (which slows the host, so the idle
    shares are upper bounds).  Returns {phase: (wall ms, busy ms, top rows)}."""
    b, s = prompts.shape
    with torch.inference_mode():
        cache = D.init_cache(lm, b, s + 17, device=prompts.device)
        cur = prompts[:, -1:].clone()
        phases = {
            "prefill": lambda: D.prefill(lm, params, cache, prompts),
            "decode x16": lambda: [D.decode_step(lm, params, cache, cur) for _ in range(16)],
        }
        out = {}
        for name, fn in phases.items():
            wall, busy, rows = device_profile(torch, fn, top=None)
            print(f"profile {name}: wall {wall:.2f} ms (profiler on), device busy {busy:.2f} ms, "
                  f"idle share {max(0.0, 1 - busy / wall):.3f}")
            for key, ms, count in rows[:6]:
                print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")
            out[name] = (wall, busy, rows)
    return out


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
    q32, k32, v32 = (t.float() for t in (q, k, v))
    runs = {
        "kernel": lambda: kernel.flash_attention_fwd(q, k, v, causal=True, window=0, scale=0.125),
        "fp32": lambda: kernel.flash_attention_fwd(q32, k32, v32, causal=True, window=0, scale=0.125),
        "plain": lambda: ref.attention_ref(qt, kt, vt, causal=True, scale=0.125),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=0.125, enable_gqa=True),
    }
    lib = runs["library"]().transpose(1, 2).float()
    diff = (lib - out.float()).abs()
    lib_err = diff.max().item()
    atol, rtol = TOL["bfloat16"]
    lib_ok = bool((diff <= atol + rtol * lib.abs()).all())
    print(f"library yardstick agrees with the kernel to {lib_err:.3e} (tolerance atol {atol} "
          f"rtol {rtol}) {'ok' if lib_ok else 'FAIL'}")
    check(lib_ok, "the kernel and scaled_dot_product_attention disagree")
    events: dict[str, list[float]] = {"plain": [], "kernel": [], "library": []}
    for name in ("plain", "kernel", "library", "library", "kernel", "plain"):
        events[name].append(cuda_ms(torch, runs[name]))
    event_ms = {n: sum(t) / len(t) for n, t in events.items()}
    device: dict[str, list[float]] = {"kernel": [], "library": [], "fp32": []}
    for name in ("kernel", "library", "fp32", "fp32", "library", "kernel"):
        per_call, top = device_ms(torch, runs[name])
        device[name].append(per_call)
        if name != "library":
            check(top[0][2] == 20, f"flash {name}: {top[0][2]} launches of {top[0][0]} in 20 calls")
        print(f"kernel flash_attention {name} device time (profiler): {per_call:.5f} ms per call; "
              + "; ".join(f"{key[:48]} x{count} {t:.3f} ms" for key, t, count in top))
    ms = {n: sum(t) / len(t) for n, t in device.items()}
    bound_ms, bound_by, nbytes, flops = attention_bound(
        q, k, v, out, causal=True, window=0, flops_peak=PEAK_BF16_FLOPS)
    fp32_floor_ms = flops / PEAK_FP32_FLOPS * 1e3
    print(f"kernel bf16 B=4 S=512 Hq=15 Hkv=5 D=64 causal: device ms {ms['kernel']:.5f} "
          f"(event {event_ms['kernel']:.5f}) library device ms {ms['library']:.5f} "
          f"(event {event_ms['library']:.5f}) fp32 kernel device ms {ms['fp32']:.5f} plain_ms "
          f"{event_ms['plain']:.4f} bound_ms {bound_ms:.5f} ({bound_by}; {nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.3f} GFLOP) fp32-core floor {fp32_floor_ms:.4f} ms; "
          f"{bound_ms / ms['kernel']:.3f} of the bound")
    return dict(ms=ms, event_ms=event_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=worst)


def ssd_bound(x, bm, cm, y, h_final, dt, a, chunk: int, *, flops_peak: float):
    """Least time for the work: x, dt, a, B and C read once, y and h_final
    written once, at the memory rate; against the products of each chunk at
    the peak rate of the inputs' type — C·Bᵀ and its product with dt·x over
    the causal triangle (j <= i) only, the inter-chunk term and the state
    update in full."""
    bsz, s, h, p = x.shape
    n = bm.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (x, dt, a, bm, cm, y, h_final))
    tri = chunk * (chunk + 1) // 2
    flops = (2 * tri * n + 2 * tri * p + 4 * chunk * n * p) * bsz * h * (s // chunk)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / flops_peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def ssd_phase(torch, F, ssd_ops, ssd_ref):
    """The SSD kernel against its plain versions on the card, then its time
    at the SSM serving slice's shapes."""
    from repro_torch.models.common import ParamDef, ParamRegistry
    from repro_torch.models.ssm import ssd_chunked

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def inputs(b, s, h, p, groups, n, dtype):
        dt_bias = ParamRegistry([ParamDef("dt_bias", (h,), ("ssm_heads",), init="ssm_dt")]
                                ).init(g)["dt_bias"]
        x = torch.randn(b, s, h, p, generator=g, device=dev).to(dtype)
        dt = F.softplus(torch.randn(b, s, h, generator=g, device=dev) + dt_bias)
        a = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)
        bm, cm = (torch.randn(b, s, groups, n, generator=g, device=dev).to(dtype) for _ in "bc")
        return x, dt, a, bm, cm

    def within(got, want, atol, rtol):
        diff = (got.float() - want.float()).abs()
        return diff.max().item(), bool((diff <= atol + rtol * want.float().abs()).all())

    cases = [
        ("bf16 B=4 S=512 H=24 P=64 G=1 N=128 chunk 256", (4, 512, 24, 64, 1, 128), torch.bfloat16, 256),
        ("bf16 B=2 S=256 H=4 P=64 G=2 N=128 chunk 64", (2, 256, 4, 64, 2, 128), torch.bfloat16, 64),
        ("fp32 B=1 S=512 H=24 P=64 G=1 N=128 chunk 256", (1, 512, 24, 64, 1, 128), torch.float32, 256),
    ]
    worst, main = 0.0, None
    for label, shape, dtype, chunk in cases:
        x, dt, a, bm, cm = inputs(*shape, dtype)
        y, hT = ssd_ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk)
        rep = shape[2] // shape[4]
        plains = {
            "ssd_chunked": ssd_chunked(x, dt, a, bm, cm, chunk=chunk),
            "ssd_ref": tuple(
                t.transpose(1, 2) if i == 0 else t for i, t in enumerate(ssd_ref.ssd_ref(
                    x.transpose(1, 2), dt.transpose(1, 2), a,
                    bm.repeat_interleave(rep, 2).transpose(1, 2),
                    cm.repeat_interleave(rep, 2).transpose(1, 2)))),
        }
        torch.cuda.synchronize()
        check(y.dtype == dtype and hT.dtype == torch.float32, f"{label}: output dtypes")
        check(bool(torch.isfinite(y.float()).all() and torch.isfinite(hT).all()),
              f"{label}: non-finite output")
        atol, rtol = SSD_TOL[str(dtype).split(".")[1]]
        for name, (py, ph) in plains.items():
            ey, oky = within(y, py, atol, rtol)
            eh, okh = within(hT, ph, *SSD_H_TOL)
            print(f"kernel ssd_scan {label} vs {name}: y max_abs_err {ey:.3e} (atol {atol} "
                  f"rtol {rtol}), h_final max_abs_err {eh:.3e} (atol/rtol {SSD_H_TOL[0]}) "
                  f"{'ok' if oky and okh else 'FAIL'}")
            check(oky and okh, f"{label}: kernel disagrees with {name}")
            if dtype == torch.bfloat16 and name == "ssd_chunked":
                worst = max(worst, ey)
        if main is None:
            main = (x, dt, a, bm, cm, y, hT, chunk)

    # the model's views: x, B and C split from one conv output, dt a column slice
    b, s, h, p, groups, n = 4, 512, 24, 64, 1, 128
    xbc = torch.randn(b, s, h * p + 2 * groups * n, generator=g, device=dev).to(torch.bfloat16)
    xv, bv, cv = torch.split(xbc, [h * p, groups * n, groups * n], dim=-1)
    xv, bv, cv = xv.reshape(b, s, h, p), bv.reshape(b, s, groups, n), cv.reshape(b, s, groups, n)
    dtv = F.softplus(torch.randn(b, s, 2 * h, generator=g, device=dev))[..., :h]
    a = main[2]
    check(not (xv.is_contiguous() or bv.is_contiguous() or dtv.is_contiguous()), "views are contiguous")
    yv, hv = ssd_ops.ssd_scan(xv, dtv, a, bv, cv, chunk=256)
    yc, hc = ssd_ops.ssd_scan(*(t.contiguous() for t in (xv, dtv, a, bv, cv)), chunk=256)
    torch.cuda.synchronize()
    same = torch.equal(yv, yc) and torch.equal(hv, hc)
    print(f"kernel ssd_scan strided views (split xbc, sliced dt): equal to contiguous copies: {same}")
    check(same, "ssd_scan: strided views give another result")

    x, dt, a, bm, cm, y, hT, chunk = main
    x32, b32, c32 = (t.float() for t in (x, bm, cm))
    runs = {
        "kernel": lambda: ssd_ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk),
        "fp32": lambda: ssd_ops.ssd_scan(x32, dt, a, b32, c32, chunk=chunk),
        "plain": lambda: ssd_chunked(x, dt, a, bm, cm, chunk=chunk),
    }
    events: dict[str, list[float]] = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        events[name].append(cuda_ms(torch, runs[name], iters=20))
    event_ms = {n: sum(t) / len(t) for n, t in events.items()}
    device: dict[str, list[float]] = {"kernel": [], "fp32": []}
    for name in ("kernel", "fp32", "fp32", "kernel"):
        per_call, top = device_ms(torch, runs[name])
        device[name].append(per_call)
        check(top[0][2] == 20, f"ssd {name}: {top[0][2]} launches of {top[0][0]} in 20 calls")
        print(f"kernel ssd_scan {name} device time (profiler): {per_call:.5f} ms per call; "
              + "; ".join(f"{key[:48]} x{count} {t:.3f} ms" for key, t, count in top))
    ms = {n: sum(t) / len(t) for n, t in device.items()}
    bound_ms, bound_by, nbytes, flops = ssd_bound(x, bm, cm, y, hT, dt, a, chunk,
                                                  flops_peak=PEAK_BF16_FLOPS)
    print(f"kernel ssd_scan bf16 B=4 S=512 H=24 P=64 G=1 N=128 chunk 256: device ms "
          f"{ms['kernel']:.5f} (event {event_ms['kernel']:.5f}) fp32 kernel device ms "
          f"{ms['fp32']:.5f} plain_ms {event_ms['plain']:.4f} (ssd_chunked) bound_ms "
          f"{bound_ms:.5f} ({bound_by}; {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP in the "
          f"causal triangle) fp32-core floor {flops / PEAK_FP32_FLOPS * 1e3:.4f} ms; "
          f"{bound_ms / ms['kernel']:.3f} of the bound; library_ms None (no single PyTorch call)")
    return dict(ms=ms, event_ms=event_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=worst)


def serve_phase(torch, arch: str, counters: dict, per_prefill: dict, cpu_len: int):
    """Save, restore two ways, and serve one full-size config on the card.
    ``counters`` maps each kernel to its wrapper (whose ``launches`` count);
    ``per_prefill`` gives the launches one prefill of this config must make;
    ``cpu_len`` is the prompt of the card-vs-CPU fp32 logits check."""
    from repro_torch.ckpt.saver import snapshot_weights, write_distributed
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths
    from repro_torch.dist.sharding import make_plan, vocab_multiple
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.launch.serve import (
        generate, latest_step_dir, restore_params, serving_parallelism,
    )
    from repro_torch.models import build_model
    from repro_torch.models import decode as D

    dev = torch.device("cuda")
    cfg = get_config(arch)

    def plan_for(mesh_str, dtype=torch.bfloat16):
        mesh = mesh_spec_from_string(mesh_str)
        parallel = serving_parallelism(mesh)
        lm = build_model(cfg, vocab_multiple=vocab_multiple(parallel, mesh), compute_dtype=dtype)
        return lm, make_plan(cfg, lm.registry, parallel, mesh)

    def reset():
        for fn in counters.values():
            fn.launches = 0
            fn.launches_by_dtype = dict.fromkeys(fn.launches_by_dtype, 0)

    def counts():
        return {name: fn.launches for name, fn in counters.items()}

    def by_dtype(dtype):
        """Each kernel's launches must all be of ``dtype``: the variant it picks."""
        got = {name: dict(fn.launches_by_dtype) for name, fn in counters.items()}
        want = {name: {"bfloat16": 0, "float32": 0} | {dtype: n} for name, n in per_prefill.items()}
        check(got == want, f"launches by dtype {got}, want {want}")
        return got

    lm, src_plan = plan_for("data=2,model=2")
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = lm.registry.num_params()
    print(f"serve {arch} init: {cfg.num_layers} layers, {n_params} params on the card "
          f"in {time.perf_counter() - t0:.2f} s")

    ckpt_root = ROOT / "build" / f"chip_smoke_ckpt_{arch}"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        snap = snapshot_weights(params)
        snap_s = time.perf_counter() - t0
        res = write_distributed(snap, src_plan, 1, ckpt_root / "step_00000001",
                                config_fingerprint=cfg.fingerprint())
        del snap
        print(f"serve {arch} save: data=2,model=2 {res.bytes_written / 1e9:.3f} GB in "
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
            print(f"serve {arch} restore {mesh_str}: {rp.mode.value} in {restore_s:.2f} s "
                  f"(consolidated in memory: {rp.consolidate_params}); bit-equal to the save")
            params_c = tlm.registry.cast(unflatten_from_paths(flat), torch.bfloat16)
            del flat
            kept = {n for n, t in flatten_with_paths(params_c).items() if t.dtype == torch.float32}
            check(kept == {d.path for d in tlm.registry if d.keep_fp32},
                  f"{mesh_str}: {sorted(kept)} left in float32")
            # Warm-up at the timed shapes: lazily loaded CUDA modules, cuBLAS
            # handles and heuristics would otherwise land in the timed run.
            generate(tlm, params_c, prompts, 17)
            reset()
            seq, prefill_s, decode_s = generate(tlm, params_c, prompts, 17)
            launches = counts()
            check(launches == per_prefill,
                  f"{mesh_str}: kernel launches {launches} in one prefill, want {per_prefill}")
            dtypes = by_dtype("bfloat16")
            check(tuple(seq.shape) == (4, 17), f"{mesh_str}: tokens {tuple(seq.shape)}")
            check(bool(((seq >= 0) & (seq < cfg.vocab_size)).all()), "token out of vocab")
            print(f"serve {arch} {mesh_str}: prefill 4x512 {prefill_s * 1e3:.2f} ms, "
                  f"decode {decode_s * 1e3 / 16:.3f} ms/token (batch 4, 16 steps), "
                  f"kernel launches {launches}, by dtype {dtypes} (float32 leaves: {len(kept)})")
            runs[mesh_str] = dict(seq=seq.cpu(), prefill_ms=prefill_s * 1e3,
                                  decode_ms=decode_s * 1e3 / 16, restore_s=restore_s,
                                  launches=launches)
            if expect == "direct":
                _, busy, rows = profile_serving(torch, D, tlm, params_c, prompts)["prefill"]
                ((name, want),) = ((n, w) for n, w in per_prefill.items() if w)
                mine = [(key, ms, n) for key, ms, n in rows if TC_SYMBOL[name] in key]
                check(len(mine) == 1 and mine[0][2] == want,
                      f"profiled prefill: {mine} for {TC_SYMBOL[name]}, want {want} launches")
                ((key, ms, n),) = mine
                print(f"serve {arch} prefill device time {busy:.3f} ms; {key[:48]} {ms:.3f} ms "
                      f"over {n} launches ({ms / busy:.3f} of it)")
                runs[mesh_str].update(prefill_device_ms=busy, prefill_kernel_ms=ms)
            del params_c
        a, b = runs["data=1,model=1"]["seq"], runs["data=2,model=2"]["seq"]
        check(torch.equal(a, b), "RESHARD_STREAM and DIRECT restores serve different tokens")
        print(f"serve {arch} tokens identical across restores; sample {a[0, :8].tolist()}")

        # Right by the repo's own means: the card's fp32 path (kernels) against
        # the port's CPU path (plain versions) on the same weights.
        flm, _ = plan_for("data=2,model=2", torch.float32)
        toks = prompts[:1, :cpu_len]
        with torch.inference_mode():
            reset()
            lg_gpu, _ = D.prefill(flm, params, D.init_cache(flm, 1, cpu_len, device=dev), toks)
            launches = counts()
            cpu_params = {n: t.cpu() for n, t in saved.items()}
            lg_cpu, _ = D.prefill(flm, unflatten_from_paths(cpu_params),
                                  D.init_cache(flm, 1, cpu_len), toks.cpu())
        check(launches == per_prefill, f"fp32 card prefill launches {launches}, want {per_prefill}")
        dtypes = by_dtype("float32")
        check(tuple(lg_gpu.shape) == (1, cfg.vocab_size), f"logits {tuple(lg_gpu.shape)}")
        check(bool(torch.isfinite(lg_gpu).all()), "non-finite logits")
        err = (lg_gpu.cpu() - lg_cpu).abs().max().item()
        print(f"serve {arch} check fp32 logits card vs CPU ({cpu_len} tokens): max_abs_err "
              f"{err:.3e} (tolerance 1e-3); launches by dtype {dtypes}")
        check(err <= 1e-3, "card and CPU logits disagree")
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    return runs


def ptxas_usage(text: str) -> list[str]:
    """One line per kernel from ``ptxas -v``: its name (demangled where
    ``c++filt`` exists), registers and spills."""
    names, rows, spill = [], {}, {}
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            names.append(ln.split("'")[1])
        elif "spill" in ln and names:
            spill[names[-1]] = ln.strip()
        elif "Used" in ln and names:
            rows[names[-1]] = ln.split(":", 1)[1].strip()
    shown = names
    if names and shutil.which("c++filt"):
        res = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                             timeout=60, check=False)
        if res.returncode == 0 and len(res.stdout.splitlines()) == len(names):
            shown = [n.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
                     for n in res.stdout.splitlines()]
    return [f"{s}: {rows.get(n, '?')}; {spill.get(n, '?')}" for n, s in zip(names, shown)]


def build_all(kernels):
    """Build every kernel source at once (one nvcc each, in parallel)."""
    with ThreadPoolExecutor(len(kernels)) as pool:
        reports = dict(zip(kernels, pool.map(lambda k: k.build()[1], kernels.values())))
    for name, report in reports.items():
        print(f"build {name}: {'compiled' if report['compiled'] else 'cached'} in "
              f"{report['seconds']:.2f} s -> {Path(report['library']).relative_to(ROOT)}")
        for ln in ptxas_usage(report["ptxas"]):
            print(f"  ptxas: {ln}")


def w_up_moment_shard_numel() -> int:
    """Elements of one moment shard of layers.blk.w_up under data=2,model=2."""
    from repro_torch.configs import ParallelismConfig, get_config
    from repro_torch.core.layout import MeshSpec
    from repro_torch.core.patterns import StateKind
    from repro_torch.dist.sharding import make_plan, vocab_multiple
    from repro_torch.models import build_model

    cfg, mesh, par = get_config("smollm-360m"), MeshSpec.from_dict({"data": 2, "model": 2}), \
        ParallelismConfig()
    lm = build_model(cfg, vocab_multiple=vocab_multiple(par, mesh))
    spec = make_plan(cfg, lm.registry, par, mesh).param_specs["layers.blk.w_up"]
    shape = spec.layout_for(StateKind.EXP_AVG, mesh).local_shape
    print(f"kernel block_quant: a w_up moment shard under data=2,model=2 is {tuple(shape)}")
    n = 1
    for d in shape:
        n *= d
    return n


def same_by_nan_class(torch, got, want) -> bool:
    """NaN (an fp8 NaN code) at the same places as ``want``, and every other
    byte equal: byte for byte where ``want`` holds no NaN."""
    nan = torch.isnan(want.float())
    if not torch.equal(torch.isnan(got.float()), nan):
        return False
    ints = {1: torch.uint8, 4: torch.int32}[want.element_size()]
    return torch.equal(got.view(ints)[~nan], want.view(ints)[~nan])


def off_by_one(torch, t):
    """An equal tensor whose storage starts one element past a 16-byte
    boundary: the general kernels' input at the same shape."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def block_quant_phase(torch, bq_ops, bq_ref):
    """The block-quant kernels against their plain version, byte for byte
    (by NaN class on the non-finite case), then their times at the w_up
    moment shard's shape (int8:b256): the vector kernels, the general ones
    on a view one element off, the plain version."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    shard_n = w_up_moment_shard_numel()
    spread = torch.exp(torch.empty(shard_n // 256, 1, device=dev).uniform_(-20, 5, generator=g))
    nonfinite = torch.randn(2000, generator=g, device=dev)
    nonfinite[[3, 50, 300, 420]] = torch.tensor([math.nan, -math.nan, math.inf, -math.inf],
                                                device=dev)
    nonfinite[1024:1280] = math.nan
    shard = (torch.randn(shard_n // 256, 256, generator=g, device=dev) * spread).reshape(-1)
    cases = {  # label: (input, the variant its launches take)
        "ragged count 1000": (torch.randn(1000, generator=g, device=dev) * 3, "vector"),
        "all-zero block": (torch.cat([torch.randn(256, generator=g, device=dev),
                                      torch.zeros(256, device=dev),
                                      torch.randn(77, generator=g, device=dev)]), "vector"),
        "values up to 1e30": (torch.tensor([1e30, -1e30, 0.5, 0.0, 3e29, -7.0] * 100,
                                           device=dev), "vector"),
        "non-finite (NaN, ±inf)": (nonfinite, "vector"),
        f"w_up moment shard ({shard_n})": (shard, "vector"),
        f"w_up moment shard ({shard_n}), one element off": (off_by_one(torch, shard), "general"),
    }
    counters = (bq_ops.block_quantize, bq_ops.block_dequantize)
    worst = 0.0
    for label, (x, want) in cases.items():
        for qd in QDTYPES:
            for fn in counters:
                fn.launches_by_variant = dict.fromkeys(fn.launches_by_variant, 0)
            q, s = bq_ops.block_quantize(x, block=256, dtype=qd)
            d = bq_ops.block_dequantize(off_by_one(torch, q) if want == "general" else q, s,
                                        count=x.numel())
            pq, ps = bq_ref.quantize_blocks(bq_ref.blocked(x, block=256), dtype=qd)
            pd = bq_ref.dequantize_blocks(pq, ps, count=x.numel())
            torch.cuda.synchronize()
            took = [fn.launches_by_variant for fn in counters]
            check(took == [{"vector": int(want == "vector"), "general": int(want == "general")}] * 2,
                  f"block_quant {label} {qd}: launches by variant {took}, want {want}")
            nan = bool(torch.isnan(pd).any())
            check(nan == label.startswith("non-finite"), f"block_quant {label}: NaN in the plain decode")
            same = (same_by_nan_class(torch, q, pq) and same_by_nan_class(torch, s, ps)
                    and same_by_nan_class(torch, d, pd))
            finite = ~torch.isnan(pd)
            err = (d[finite] - pd[finite]).abs().max().item()
            if not nan:
                worst = max(worst, err)
            how = "by NaN class" if nan else "byte for byte"
            print(f"kernel block_quant {label} {qd} ({want}): q, scales and decoded equal to the "
                  f"plain version {how}: {same} (max_abs_err {err:.1e} off NaN)")
            check(same and (nan or bool(torch.isfinite(d).all())),
                  f"block_quant {label} {qd}: kernel disagrees with its plain version")
    x = shard
    blocks = bq_ref.blocked(x, block=256)
    q, s = bq_ops.block_quantize(x, block=256, dtype="int8")
    x_off, q_off = off_by_one(torch, x), off_by_one(torch, q)
    runs = {
        "quantize_blocks": {
            "kernel": lambda: bq_ops.block_quantize(x, block=256, dtype="int8"),
            "general": lambda: bq_ops.block_quantize(x_off, block=256, dtype="int8"),
            "plain": lambda: bq_ref.quantize_blocks(blocks, dtype="int8"),
        },
        "dequantize_blocks": {
            "kernel": lambda: bq_ops.block_dequantize(q, s, count=shard_n),
            "general": lambda: bq_ops.block_dequantize(q_off, s, count=shard_n),
            "plain": lambda: bq_ref.dequantize_blocks(q, s, count=shard_n),
        },
    }
    nblocks = blocks.shape[0]
    moved = {  # each input read once, each output written once
        "quantize_blocks": 4 * shard_n + shard_n + 4 * nblocks,
        "dequantize_blocks": shard_n + 4 * nblocks + 4 * shard_n,
    }
    out = {}
    for name, fns in runs.items():
        events: dict[str, list[float]] = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            events[which].append(cuda_ms(torch, fns[which]))
        device: dict[str, list[float]] = {"kernel": [], "general": []}
        for which in ("kernel", "general", "general", "kernel"):
            per_call, top = device_ms(torch, fns[which])
            device[which].append(per_call)
            check(top[0][2] == 20, f"{name} {which}: {top[0][2]} launches of {top[0][0]} in 20 calls")
            print(f"kernel {name} {which} device time (profiler): {per_call:.5f} ms per call; "
                  + "; ".join(f"{key[:60]} x{count} {t:.3f} ms" for key, t, count in top))
        ms = {k: sum(v) / len(v) for k, v in device.items()}
        event_ms = {k: sum(v) / len(v) for k, v in events.items()}
        bound_ms = moved[name] / PEAK_BYTES_PER_S * 1e3
        print(f"kernel {name} int8:b256 on {shard_n} elements: device ms {ms['kernel']:.5f} "
              f"(event {event_ms['kernel']:.5f}) general kernel device ms {ms['general']:.5f} "
              f"plain_ms {event_ms['plain']:.4f} bound_ms {bound_ms:.5f} (bytes: "
              f"{moved[name] / 1e6:.2f} MB, beyond the 50 MB L2) {bound_ms / ms['kernel']:.3f} of "
              f"the bound; library_ms None (no single PyTorch call)")
        out[name] = dict(ms=ms, event_ms=event_ms, bound_ms=bound_ms, max_abs_err=worst)
    return out


def served_view_matches(torch, state, src_plan, manifest) -> int:
    """Re-cut every coded shard from the restored moments under the Source
    plan and hash it: each must equal the manifest's served digest.
    Returns the number of shards checked."""
    from repro_torch.core.dist_ckpt import shard_digest_key
    from repro_torch.core.layout import slice_shard
    from repro_torch.core.patterns import StateKind
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.core.tensor_io import content_digest

    checked = 0
    for kind, tree in ((StateKind.EXP_AVG, state.exp_avg), (StateKind.EXP_AVG_SQ, state.exp_avg_sq)):
        for name, t in flatten_with_paths(tree).items():
            spec = src_plan.param_specs[name]
            logical = tuple(slice(0, n) for n in spec.logical_shape)
            full = torch.zeros(spec.runtime_shape, dtype=t.dtype, device=t.device)
            full[logical] = t[logical]
            layout = spec.layout_for(kind, src_plan.mesh)
            for rank in range(len(layout.entries)):
                key = shard_digest_key(rank, name, kind)
                if key not in manifest.shard_digests:
                    continue
                got = content_digest(slice_shard(full, layout, rank))
                check(got == manifest.shard_digests[key], f"{key}: not the served view")
                checked += 1
    return checked


def train_phase(torch, ops, bq_ops):
    """Train full smollm-360m; save coded under data=2,model=2; resume under
    two layouts; continue.  Returns the launch counts and measurements."""
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config
    from repro_torch.core.dist_ckpt import DistCheckpoint
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    cfg, tcfg, parallel = get_config("smollm-360m"), TrainConfig(seed=0), ParallelismConfig()
    check(parallel.compute_dtype == "bfloat16" and parallel.moment_dtype == "float32",
          "train: not bf16 compute with fp32 moments")
    root = ROOT / "build" / "chip_smoke_train_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def trainer(mesh, **kw):
        return Trainer.create(cfg, parallel, tcfg, mesh_spec_from_string(mesh),
                              batch_size=8, seq_len=512, device=dev, **kw)

    out = {}
    try:
        ops.flash_attention.launches = 0
        for fn in (bq_ops.block_quantize, bq_ops.block_dequantize):
            fn.launches = 0
            fn.launches_by_variant = dict.fromkeys(fn.launches_by_variant, 0)
        base = trainer("data=2,model=2")
        state, hist = base.run(base.init_state(), 0, 6)
        baseline = [h["loss"] for h in hist]
        step_s = sorted(h["dt"] for h in hist[1:])[len(hist[1:]) // 2]
        print(f"train baseline smollm-360m 32 layers, 8x512 tokens, 6 steps: losses "
              f"{[round(v, 4) for v in baseline]}; median step {step_s * 1e3:.1f} ms "
              f"({8 * 512 / step_s:.0f} tokens/s)")
        check(all(map(math.isfinite, baseline)), "baseline loss not finite")
        batch = base.batch(6)
        wall, busy, top = device_profile(torch, lambda: base.step_fn(state, batch))
        print(f"profile train step: wall {wall:.2f} ms (profiler on), device busy {busy:.2f} ms, "
              f"idle share {max(0.0, 1 - busy / wall):.3f}")
        for key, ms, count in top:
            print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")
        del state, base
        torch.cuda.empty_cache()

        policy = CheckpointPolicy(codec="int8:b256", save_interval=3, async_save=True)
        src = trainer("data=2,model=2", ckpt_dir=str(root), policy=policy)
        saved, hist = src.run(src.init_state(), 0, 3)
        src.manager.close()
        drift = max(abs(h["loss"] - b) for h, b in zip(hist, baseline))
        print(f"train coded run steps 1-3: max |loss - baseline| {drift:.2e}")
        check(drift <= 2e-2, "the coded run left the baseline before saving")
        (res,) = src.save_results
        src_plan = src.plan
        manifest = DistCheckpoint.open(src.manager.step_dir(3)).manifest
        n_coded = len(manifest.shard_codecs)
        quant = bq_ops.block_quantize.launches
        dequant_save = bq_ops.block_dequantize.launches
        print(f"train save step 3 (data=2,model=2, int8:b256 moments, async): "
              f"{res.bytes_written / 1e9:.3f} GB in {res.shards_written} shards, "
              f"{res.wall_time_s:.2f} s ({res.bytes_written / 1e9 / res.wall_time_s:.3f} GB/s); "
              f"coded {res.coded_bytes / 1e9:.3f} of raw {res.coded_raw_bytes / 1e9:.3f} GB "
              f"(ratio {res.coded_bytes / res.coded_raw_bytes:.4f}); device->host "
              f"{res.device_to_host_bytes / 1e9:.3f} GB for the coded shards; "
              f"{n_coded} coded shards, quantize launches {quant}, dequantize launches "
              f"{dequant_save}")
        check(n_coded > 0 and quant == n_coded, f"quantize launches {quant} != {n_coded} coded shards")
        check(dequant_save >= n_coded, f"dequantize launches {dequant_save} < {n_coded}")
        saved_params = flatten_with_paths(saved.params)
        del src

        restore_s = {}
        for mesh, expect in (("data=1,model=1", "reshard_stream"), ("data=2,model=2", "direct")):
            before = bq_ops.block_dequantize.launches
            tgt = trainer(mesh, ckpt_dir=str(root), policy=CheckpointPolicy(async_save=False,
                                                                            save_interval=1000))
            state, info = tgt.init_or_restore()
            read = bq_ops.block_dequantize.launches - before
            check(info is not None and info.mode.value == expect,
                  f"{mesh}: planned {info and info.mode.value}, want {expect}")
            check(state.step == 3, f"{mesh}: restored step {state.step}")
            for name, t in flatten_with_paths(state.params).items():
                logical = tuple(slice(0, n) for n in saved_params[name].shape)
                check(torch.equal(t[logical], saved_params[name]), f"{mesh}: {name} differs")
            n_checked = served_view_matches(torch, state, src_plan, manifest)
            check(n_checked == n_coded, f"{mesh}: {n_checked} served digests checked")
            check(read >= n_coded, f"{mesh}: {read} dequantize launches < {n_coded} coded shards")
            restore_s[expect] = info.wall_time_s
            _, hist = tgt.run(state, 3, 3)
            resumed = [h["loss"] for h in hist]
            check(all(map(math.isfinite, resumed)), f"{mesh}: resumed loss not finite")
            print(f"train resume {mesh}: {info.mode.value} in {info.wall_time_s:.2f} s, params "
                  f"bit-equal, {n_checked} moment shards equal to the served view, step 3, "
                  f"{read} dequantize launches; steps 4-6 losses "
                  + ", ".join(f"{a:.4f} (baseline {b:.4f})" for a, b in zip(resumed, baseline[3:])))
            del state, tgt
            torch.cuda.empty_cache()
        flash = ops.flash_attention.launches
        check(flash == 0, f"{flash} flash-attention launches during training")
        dequant = bq_ops.block_dequantize.launches
        by_variant = {"quantize": dict(bq_ops.block_quantize.launches_by_variant),
                      "dequantize": dict(bq_ops.block_dequantize.launches_by_variant)}
        check(by_variant == {"quantize": {"vector": quant, "general": 0},
                             "dequantize": {"vector": dequant, "general": 0}},
              f"train: block-quant launches by variant {by_variant}, want all vector")
        out = dict(quantize=quant, dequantize=dequant, by_variant=by_variant, step_s=step_s,
                   restore_s=restore_s)
        print(f"train launches: quantize {quant}, dequantize {dequant}, "
              f"flash_attention {flash}; block quant by variant {by_variant}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("CUDA is not available: this smoke runs on a card, never the CPU")
    if not (SRC / "repro_torch").is_dir():
        raise SmokeError(f"{SRC / 'repro_torch'} is missing: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F

    from repro_torch.kernels.block_quant import kernel as bq_kernel
    from repro_torch.kernels.block_quant import ops as bq_ops
    from repro_torch.kernels.block_quant import ref as bq_ref
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan import ref as ssd_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")

    build_all({"flash_attention": kernel, "block_quant": bq_kernel, "ssd_scan": ssd_kernel})
    k = kernel_phase(torch, F, kernel, ref)
    bq = block_quant_phase(torch, bq_ops, bq_ref)
    ssd = ssd_phase(torch, F, ssd_ops, ssd_ref)
    counters = {"flash_attention": ops.flash_attention, "ssd_scan": ssd_ops.ssd_scan}
    runs = serve_phase(torch, "smollm-360m", counters,
                       {"flash_attention": 32, "ssd_scan": 0}, cpu_len=48)
    ssm_runs = serve_phase(torch, "mamba2-130m", counters,
                           {"flash_attention": 0, "ssd_scan": 24}, cpu_len=512)
    train = train_phase(torch, ops, bq_ops)

    rows = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "variant": VARIANT["flash_attention_fwd"],
        "launches": runs["data=1,model=1"]["launches"]["flash_attention"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"]["kernel"],
        "ms_by": "profiler device time per launch",
        "event_ms": k["event_ms"]["kernel"],
        "fp32_ms": k["ms"]["fp32"],
        "plain_ms": k["event_ms"]["plain"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": k["ms"]["library"],
        "library_event_ms": k["event_ms"]["library"],
        "prefill_device_ms": runs["data=2,model=2"]["prefill_device_ms"],
        "prefill_kernel_ms": runs["data=2,model=2"]["prefill_kernel_ms"],
    }]
    for name, which in (("quantize_blocks", "quantize"), ("dequantize_blocks", "dequantize")):
        rows.append({
            "name": name,
            "route": "cuda",
            "source": BQ_SOURCE,
            "replaces": BQ_REPLACES[name],
            "variant": VARIANT[name],
            "launches": train[which],
            "launches_by_variant": train["by_variant"][which],
            "max_abs_err": bq[name]["max_abs_err"],
            "ms": bq[name]["ms"]["kernel"],
            "ms_by": "profiler device time per launch",
            "event_ms": bq[name]["event_ms"]["kernel"],
            "general_ms": bq[name]["ms"]["general"],
            "plain_ms": bq[name]["event_ms"]["plain"],
            "bound_ms": bq[name]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        })
    rows.append({
        "name": "ssd_scan_fwd",
        "route": "cuda",
        "source": SSD_SOURCE,
        "replaces": SSD_REPLACES,
        "variant": VARIANT["ssd_scan_fwd"],
        "launches": ssm_runs["data=1,model=1"]["launches"]["ssd_scan"],
        "max_abs_err": ssd["max_abs_err"],
        "ms": ssd["ms"]["kernel"],
        "ms_by": "profiler device time per launch",
        "event_ms": ssd["event_ms"]["kernel"],
        "fp32_ms": ssd["ms"]["fp32"],
        "plain_ms": ssd["event_ms"]["plain"],
        "bound_ms": ssd["bound_ms"],
        "bound_by": ssd["bound_by"],
        "library_ms": None,
        "prefill_device_ms": ssm_runs["data=2,model=2"]["prefill_device_ms"],
        "prefill_kernel_ms": ssm_runs["data=2,model=2"]["prefill_kernel_ms"],
    })
    print(json.dumps({"kernels": rows}))
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
