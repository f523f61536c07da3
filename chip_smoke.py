#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, any failure exits non-zero (no phase catches its own failure, and
nothing falls back to the CPU or to a plain version):

1. device  — require CUDA; print the card's name and power limit as
   ``nvidia-smi`` reports them;
2. build   — compile the three kernel sources of this checkout with nvcc
   (sm_90a), one process each, started together; print the build seconds
   and ptxas' report, and fail if the head-dim-256 flash instances
   (``fwd_kernel_tc<256>``, ``fwd_kernel<float, 256>``) spill;
3. kernel flash_attention — against its plain PyTorch version at the
   serving slice's shapes (B=4, S=512 and a ragged 500, 15:5 heads, D=64,
   bf16, causal; a window=128 case; an fp32 case), max abs error beside the
   tolerance; the library (``scaled_dot_product_attention``, a yardstick
   only) against the kernel; then the bf16 (tensor-core) kernel's and the
   library's device time per call (the profiler, over 20 warm calls, in
   turns), their CUDA-event times, the fp32 (CUDA-core) kernel's device
   time at the same shapes, and the plain version's event time; then
   gemma3-12b's head layout (16:8 heads of 256) in bf16 and fp32, causal at
   B=4, S=512 and with the local layers' window 1024 at S=2048, and there
   the bf16 kernel's device time beside the library's, the fp32 kernel's
   device time, the plain version's event time and the bound;
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
   A = -(1..24)), a G=2 case with 4 heads and chunk 64, an fp32 case at
   B=1 and a case reading strided views as the model hands them, max abs
   error beside the tolerances of ``tests/test_kernels.py``; the fp32
   kernel's and ``ssd_chunked``'s errors against ``ssd_ref`` in float64 at
   B=1 (the kernel's must be no larger); then the bf16
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
   the same tokens; smollm then exports the step as UCP atoms
   (``export_ucp``: atoms, GB, seconds, ``validate() == []``) and restores
   weights-only from them (VIA_UCP, forced) under data=1,model=1,
   bit-equal to the save and serving the same tokens.  smollm also holds
   the I/O engine's two profiles against each other: the snapshot saved
   with ``workers=1`` and with the default width (every shard file
   byte-equal, manifests equal but ``created_at``; both walls beside the
   disk floor: the same files' bytes written and fsync'd from 1 and from
   that many threads, and one core's sha256 rate), each restore repeated
   through a serial engine (bit-equal, both walls), the export repeated
   serially (the same atoms, files and digests, ``validate() == []``); then
   a delta save at step 2 with ``final_norm`` changed (shards written and
   inherited, bytes, wall), whose tip restores DIRECT, RESHARD_STREAM and
   VIA_UCP (forced) bit-equal to a full save of the same weights; the card's fp32
   logits agree with the port's CPU path (mamba2 over 512 tokens: two
   chunks, so the carried state is compared), every launch there fp32 (the
   CUDA-core kernels); the profiled prefill's device time and the kernel's
   share of it;
7. gemma3-12b at full width (d 3840, 16:8 heads of 256, d_ff 15360, vocab
   262144, tied embeddings, window 1024), its depth cut from 48 to 6
   layers (one local:global period): init on the card from a seeded
   generator; a bf16 prefill of 4 × 512 tokens with 6 flash launches, all
   bf16 (head dim 256), its wall and profiled device time; the card's fp32
   logits against the port's CPU path within 1e-3 over 32 tokens, every
   launch there fp32;
8. train, full smollm-360m at all 32 layers, seed 0, batch 8 × seq 512
   from ``train/data.py``, bf16 compute, fp32 master and moments, TF32 off:
   6 uninterrupted steps (the baseline); separately 3 steps under a
   ``CheckpointManager`` with ``CheckpointPolicy(codec="int8:b256",
   save_interval=3, async_save=True)`` and plan data=2,model=2; then
   ``export_ucp`` of step 3 on the card (every coded moment shard decoded
   once by the vector dequantize kernel: 60 launches; atoms, GB written,
   seconds, GB/s; ``validate() == []``); resume under data=1,model=1
   (RESHARD_STREAM) and data=2,model=2 (DIRECT), and forced VIA_UCP under
   both from the exported atoms, each with params bit-equal to the save,
   both moments equal to the codec's served view (every coded shard re-cut
   from the restored state hashes to the manifest's served digest) and step
   3, the VIA_UCP states bit-equal to the RESHARD_STREAM resume; steps 4-6
   from each resume (finite losses, printed beside the baseline's, or the
   RESHARD_STREAM resume's); a second export reuses the committed atoms
   (``ConvertStats`` None); the launch counts (quantize == coded shards
   written, dequantize >= that plus the coded shards read per resume,
   every block-quant launch the vector variant, flash-attention 0); step
   time, tokens/s, save GB/s, coded/raw bytes, restore seconds and one
   profiled step's device busy share.  The I/O engine's checks: the step-3
   snapshot saved again serially (byte-equal files and manifests, both
   walls, the disk floor), the export repeated serially (the same atoms),
   the RESHARD_STREAM and DIRECT resumes repeated through a serial engine
   (all three kinds bit-equal; every resume decodes each coded file once:
   60 dequantize launches); a coded resume under data=4,model=1, where
   every coded file feeds two regions, through a parallel and a serial
   engine (60 dequantize launches each, the two states bit-equal, the
   engines' caches empty after it, card memory retained beyond the state at
   most 64 MiB, its peak printed); then the coded policy with
   ``save_mode="delta"`` through saves at steps 2 and 3 (AdamW changes
   every shard: the delta inherits nothing), its tip resumed under
   data=1,model=1 with steps 4-6 within 2e-2 of the full-save resume's; and
   GC under a pin: an async ``keep_last=1`` delta manager whose delta at 30
   stalls after resolving base 10 while a rebase at 40 commits — base 10
   survives that GC, 30 commits and restores, the next GC leaves [40];
9. the I/O line (JSON: the walls above), the kernels line (JSON: each row
   names its variants; ``ms`` is the profiler's device time per launch,
   with ``event_ms`` beside it; rows 2-3 add the general kernel's device
   time ``general_ms`` and the train phase's ``launches_by_variant`` and
   ``launches_by_phase``; the flash row adds the head-dim-256 times, bound
   and gemma3 launches (``d256_*``), the dequantize row the export's
   launches ``convert_launches``), the card line, then the result line
   (JSON, last).
"""

from __future__ import annotations

import filecmp
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import threading
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


def device_ms(torch, fn, calls: int = 20, launches=None):
    """Device milliseconds per call of ``fn``: the profiler's device time of
    every kernel and copy that ``calls`` warm calls launched, over
    ``calls`` (so the host's enqueue time is not in it); with the top rows
    as (name, ms, count).

    A trace that recorded no device work at all was lost (every ``fn`` here
    launches work) and is taken once more; two empty traces fail.
    ``launches``, where given, reads the launch counter of the wrapper that
    ``fn`` calls.  When the trace shows fewer than ``calls`` launches of its
    top kernel, the counter tells a lost profiler record from a skipped
    launch: a counter short of ``calls`` fails here, and a full one takes
    the trace once more (the callers fail on a second short trace)."""
    for _ in range(3):
        fn()
    for attempt in range(2):
        before = launches() if launches is not None else 0
        _, busy, top = device_profile(torch, lambda: [fn() for _ in range(calls)], top=4)
        if (top and (launches is None or top[0][2] == calls)) or attempt == 1:
            break
        if launches is not None:
            counted = launches() - before
            check(counted == calls, f"the wrapper launched {counted} times in {calls} calls")
        print(f"profiler recorded {top[0][2] if top else 0} launches of "
              f"{top[0][0][:48] if top else 'nothing'} in {calls} calls; profiling again")
    check(bool(top), f"the profiler recorded no device work in two traces of {calls} calls")
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


def same_files(a_root: Path, b_root: Path, pattern: str) -> int:
    """Every file matching ``pattern`` under two roots exists in both and is
    byte-equal; returns how many there are."""
    a = sorted(str(p.relative_to(a_root)) for p in a_root.glob(pattern))
    b = sorted(str(p.relative_to(b_root)) for p in b_root.glob(pattern))
    check(a == b and bool(a), f"{a_root} and {b_root} hold different {pattern} files")
    with ThreadPoolExecutor(8) as pool:
        same = list(pool.map(lambda rel: filecmp.cmp(a_root / rel, b_root / rel, shallow=False), a))
    bad = [rel for rel, ok in zip(a, same) if not ok]
    check(not bad, f"{len(bad)} files differ between {a_root} and {b_root}: {bad[:3]}")
    return len(a)


def same_manifests(a_root: Path, b_root: Path) -> None:
    """MANIFEST.json of two checkpoints equal apart from ``created_at``."""
    ja, jb = (json.loads((r / "MANIFEST.json").read_text()) for r in (a_root, b_root))
    ja.pop("created_at"), jb.pop("created_at")
    check(ja == jb, f"manifests of {a_root} and {b_root} differ beyond created_at")


def disk_floor(sizes: list[int], threads: int, where: Path) -> float:
    """Seconds to write and fsync files of ``sizes`` bytes from ``threads``
    threads, with no slicing and no hashing: the floor a save of those files
    stands on (one buffer of random bytes, written through the page cache as
    the saver's are)."""
    buf = memoryview(os.urandom(max(sizes)))
    where.mkdir(parents=True, exist_ok=True)

    def write(i: int) -> None:
        with open(where / f"f{i:05d}", "wb") as f:
            f.write(buf[: sizes[i]])
            f.flush()
            os.fsync(f.fileno())

    t0 = time.perf_counter()
    if threads == 1:
        for i in range(len(sizes)):
            write(i)
    else:
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(write, range(len(sizes))))
    wall = time.perf_counter() - t0
    shutil.rmtree(where, ignore_errors=True)
    return wall


def sha256_gb_s(nbytes: int = 1 << 28) -> float:
    """One core's sha256 rate (GB/s) over ``nbytes`` of random bytes."""
    buf = os.urandom(nbytes)
    t0 = time.perf_counter()
    hashlib.sha256(buf).hexdigest()
    return nbytes / 1e9 / (time.perf_counter() - t0)


def io_floor(label: str, step_dir: Path, workers: int, scratch: Path) -> dict:
    """The disk floor of a save that wrote ``step_dir``: the same files'
    bytes written and fsync'd from 1 and from ``workers`` threads, and one
    core's sha256 rate."""
    sizes = [p.stat().st_size for p in sorted(step_dir.glob("ranks/**/*.npy"))]
    total = sum(sizes)
    one = disk_floor(sizes, 1, scratch)
    wide = disk_floor(sizes, workers, scratch)
    sha = sha256_gb_s()
    print(f"{label} disk floor: {total / 1e9:.3f} GB in {len(sizes)} files written and fsync'd "
          f"in {one:.2f} s from 1 thread ({total / 1e9 / one:.3f} GB/s), {wide:.2f} s from "
          f"{workers} threads ({total / 1e9 / wide:.3f} GB/s); sha256 on one core {sha:.3f} GB/s")
    return dict(gb=total / 1e9, files=len(sizes), floor_1_s=one, floor_w_s=wide, sha256_gb_s=sha)


def kernel_phase(torch, F, kernel, ops, ref):
    """Kernel vs plain on the card; returns the main-shape measurements
    (timed through the ``ops`` wrapper, whose launch counter ``device_ms``
    reads)."""
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
        "kernel": lambda: ops.flash_attention(q, k, v, causal=True, window=0, scale=0.125),
        "fp32": lambda: ops.flash_attention(q32, k32, v32, causal=True, window=0, scale=0.125),
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
        per_call, top = device_ms(torch, runs[name], launches=None if name == "library"
                                  else lambda: ops.flash_attention.launches)
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
    d256 = head_dim_256(torch, F, kernel, ops, ref)
    return dict(ms=ms, event_ms=event_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=worst,
                d256=d256)


def head_dim_256(torch, F, kernel, ops, ref):
    """gemma3-12b's attention shapes (16:8 heads of 256): both kernels
    against the plain version, causal at S=512 and the local layers' window
    1024 at S=2048; then the bf16 kernel's device time beside the library's
    and the bound."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(256)
    scale = 256 ** -0.5
    cases = [(dtype, b, s, window) for dtype in (torch.bfloat16, torch.float32)
             for b, s, window in ((4, 512, 0), (1, 2048, 1024))]
    worst, main = 0.0, None
    for dtype, b, s, window in cases:
        label = f"D=256 {str(dtype).split('.')[1]} B={b} S={s} 16:8 causal window={window}"
        q, k, v = (torch.randn(b, s, h, 256, generator=g, device=dev).to(dtype) for h in (16, 8, 8))
        out = kernel.flash_attention_fwd(q, k, v, causal=True, window=window, scale=scale)
        plain = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=True, window=window, scale=scale).transpose(1, 2)
        torch.cuda.synchronize()
        atol, rtol = TOL[str(dtype).split(".")[1]]
        diff = (out.float() - plain.float()).abs()
        err = diff.max().item()
        ok = bool(torch.isfinite(out.float()).all()) and bool((diff <= atol + rtol * plain.float().abs()).all())
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
        "kernel": lambda: ops.flash_attention(q, k, v, causal=True, window=0, scale=scale),
        "fp32": lambda: ops.flash_attention(q32, k32, v32, causal=True, window=0, scale=scale),
        "plain": lambda: ref.attention_ref(qt, kt, vt, causal=True, scale=scale),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True),
    }
    plain_ms = sum(cuda_ms(torch, runs["plain"], iters=20) for _ in range(2)) / 2
    device: dict[str, list[float]] = {"kernel": [], "library": [], "fp32": []}
    for name in ("kernel", "library", "fp32", "fp32", "library", "kernel"):
        per_call, top = device_ms(torch, runs[name], launches=None if name == "library"
                                  else lambda: ops.flash_attention.launches)
        device[name].append(per_call)
        if name != "library":
            check(top[0][2] == 20, f"flash D=256 {name}: {top[0][2]} launches of {top[0][0]} in 20 calls")
        print(f"kernel flash_attention D=256 {name} device time (profiler): {per_call:.5f} ms per "
              "call; " + "; ".join(f"{key[:48]} x{count} {t:.3f} ms" for key, t, count in top))
    ms = {n: sum(t) / len(t) for n, t in device.items()}
    bound_ms, bound_by, nbytes, flops = attention_bound(
        q, k, v, out, causal=True, window=0, flops_peak=PEAK_BF16_FLOPS)
    print(f"kernel bf16 B=4 S=512 Hq=16 Hkv=8 D=256 causal: device ms {ms['kernel']:.5f} library "
          f"device ms {ms['library']:.5f} fp32 kernel device ms {ms['fp32']:.5f} plain_ms "
          f"{plain_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by}; {nbytes / 1e6:.2f} "
          f"MB is {nbytes / PEAK_BYTES_PER_S * 1e3:.5f} ms, {flops / 1e9:.3f} GFLOP is "
          f"{flops / PEAK_BF16_FLOPS * 1e3:.5f} ms); {bound_ms / ms['kernel']:.3f} of the bound")
    return dict(ms=ms["kernel"], library_ms=ms["library"], fp32_ms=ms["fp32"], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=worst)


def check_no_spills(usage: list[str], names: tuple[str, ...]) -> None:
    """ptxas must report 0 spill bytes for each kernel instance named."""
    for name in names:
        rows = [ln for ln in usage if ln.startswith(name + ":")]
        check(len(rows) == 1, f"ptxas: no single line for {name}")
        ok = "0 bytes spill stores, 0 bytes spill loads" in rows[0]
        print(f"ptxas {rows[0]} -> {'no spills' if ok else 'SPILLS'}")
        check(ok, f"{name} spills registers")


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
        if dtype == torch.float32:
            fp32_case = (label, x, dt, a, bm, cm, y, plains["ssd_chunked"][0])

    # The fp32 kernel at the B = 1 serving shape against the recurrence in
    # float64, beside ssd_chunked's own error there.  With an fp32 cumsum the
    # kernel was 2.4x ssd_chunked's error; its float64 cumsum puts it below.
    label, x, dt, a, bm, cm, y, y_chunked = fp32_case
    rep = bm.shape[2]
    y64, _ = ssd_ref.ssd_ref(*(t.double().transpose(1, 2) for t in (x, dt)), a.double(),
                             *(t.double().repeat_interleave(x.shape[2] // rep, 2).transpose(1, 2)
                               for t in (bm, cm)))
    y64 = y64.transpose(1, 2)
    e_kernel = (y.double() - y64).abs().max().item()
    e_chunked = (y_chunked.double() - y64).abs().max().item()
    ratio = e_kernel / e_chunked
    print(f"kernel ssd_scan {label} vs ssd_ref in float64: kernel y max_abs_err {e_kernel:.3e}, "
          f"ssd_chunked {e_chunked:.3e} (|y| up to {y64.abs().max().item():.1f}); ratio "
          f"{ratio:.3f} (must be <= 1) {'ok' if ratio <= 1 else 'FAIL'}")
    check(ratio <= 1, f"{label}: the fp32 kernel is {ratio:.2f}x ssd_chunked's error against float64")

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
        per_call, top = device_ms(torch, runs[name], launches=lambda: ssd_ops.ssd_scan.launches)
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
    return dict(ms=ms, event_ms=event_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=worst,
                fp64=dict(kernel=e_kernel, ssd_chunked=e_chunked))


def serve_phase(torch, arch: str, counters: dict, per_prefill: dict, cpu_len: int,
                via_ucp: bool = False):
    """Save, restore two ways, and serve one full-size config on the card.
    ``counters`` maps each kernel to its wrapper (whose ``launches`` count);
    ``per_prefill`` gives the launches one prefill of this config must make;
    ``cpu_len`` is the prompt of the card-vs-CPU fp32 logits check;
    ``via_ucp`` adds the export of the step as UCP atoms and a third restore
    from them, and the I/O engine's checks: the save, the restores and the
    export each serial and parallel (byte- and bit-equal, walls, the disk
    floor), then a delta save and its restores."""
    from repro_torch.ckpt.restore import params_from_source
    from repro_torch.ckpt.saver import snapshot_weights, write_distributed
    from repro_torch.core.dist_ckpt import DistCheckpoint
    from repro_torch.core.engine import CheckpointEngine, default_engine, default_workers
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
    width = default_workers()
    io: dict = {}
    try:
        t0 = time.perf_counter()
        snap = snapshot_weights(params)
        snap_s = time.perf_counter() - t0
        if via_ucp:  # the serial writer first, on the same snapshot
            ser = write_distributed(snap, src_plan, 1, ckpt_root / "serial" / "step_00000001",
                                    workers=1, config_fingerprint=cfg.fingerprint())
        res = write_distributed(snap, src_plan, 1, ckpt_root / "step_00000001", workers=width,
                                config_fingerprint=cfg.fingerprint())
        del snap
        print(f"serve {arch} save: data=2,model=2 {res.bytes_written / 1e9:.3f} GB in "
              f"{res.shards_written} shards, {res.wall_time_s:.2f} s with {width} workers "
              f"(os.cpu_count() {os.cpu_count()}; {res.bytes_written / 1e9 / res.wall_time_s:.3f} "
              f"GB/s; device→host snapshot {snap_s:.2f} s)")
        check(res.bytes_written >= 3 * 4 * n_params, "checkpoint smaller than 3 fp32 kinds")
        if via_ucp:
            ser_dir, par_dir = ckpt_root / "serial" / "step_00000001", ckpt_root / "step_00000001"
            n = same_files(ser_dir, par_dir, "ranks/**/*.npy")
            same_manifests(ser_dir, par_dir)
            check((ser.bytes_written, ser.shards_written) == (res.bytes_written, res.shards_written),
                  "serial and parallel saves counted different bytes")
            print(f"serve {arch} save serial (workers=1): {ser.wall_time_s:.2f} s "
                  f"({ser.bytes_written / 1e9 / ser.wall_time_s:.3f} GB/s) against parallel "
                  f"({width} workers) {res.wall_time_s:.2f} s "
                  f"({res.wall_time_s / ser.wall_time_s:.3f} of it); {n} shard files byte-equal, "
                  "digests and manifests equal but created_at")
            floor = io_floor(f"serve {arch} save", par_dir, width, ckpt_root / "floor")
            io["save"] = dict(serial_s=ser.wall_time_s, parallel_s=res.wall_time_s, workers=width,
                              cpus=os.cpu_count(), **floor)

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
            engine = default_engine(dev)
            check(len(engine.handles) == 0 and len(engine.atoms) == 0,
                  f"{mesh_str}: the restore left {len(engine.handles)} handles and "
                  f"{len(engine.atoms)} atoms in the default engine")
            check(rp.mode.value == expect, f"{mesh_str}: planned {rp.mode.value}, want {expect}")
            check(set(flat) == set(saved), f"{mesh_str}: restored parameter set differs")
            for name, t in flat.items():
                check(torch.equal(t, saved[name]), f"{mesh_str}: {name} differs from the save")
            print(f"serve {arch} restore {mesh_str}: {rp.mode.value} in {restore_s:.2f} s "
                  f"({default_engine(dev).workers} workers; consolidated in memory: "
                  f"{rp.consolidate_params}); bit-equal to the save")
            if via_ucp:
                transforms = rp.transforms if expect == "reshard_stream" else None
                with CheckpointEngine(dev, workers=1) as serial:
                    t0 = time.perf_counter()
                    ser_flat = params_from_source(DistCheckpoint.open(step_dir), tplan, dev,
                                                  transforms=transforms, engine=serial)
                    torch.cuda.synchronize()
                    ser_s = time.perf_counter() - t0
                check(all(torch.equal(ser_flat[n], t) for n, t in flat.items()),
                      f"{mesh_str}: serial and parallel restores differ")
                del ser_flat
                print(f"serve {arch} restore {mesh_str} serial (workers=1): {ser_s:.2f} s; "
                      f"bit-equal to the default engine's restore (raw shards: both read "
                      "inline from mmap'd files)")
                io[f"restore {expect}"] = dict(serial_s=ser_s, parallel_s=restore_s)
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
        if via_ucp:
            runs["via_ucp"] = serve_via_ucp(torch, arch, step_dir, src_plan, plan_for, saved,
                                            prompts, counts, reset, per_prefill, by_dtype)
            check(torch.equal(runs["via_ucp"]["seq"], a), "the VIA_UCP restore serves other tokens")
            print(f"serve {arch} VIA_UCP tokens identical to the other restores'")
            io["export"] = serial_export(torch, arch, step_dir, ckpt_root / "serial_export.ucp",
                                         runs["via_ucp"])
            io["delta"] = serve_delta(torch, arch, cfg, saved, src_plan, plan_for, step_dir, width)
            runs["io"] = io

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


def serve_via_ucp(torch, arch, step_dir, src_plan, plan_for, saved, prompts, counts, reset,
                  per_prefill, by_dtype):
    """Export the weights-only step as UCP atoms, restore weights-only from
    them (VIA_UCP, forced) under data=1,model=1, serve."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.core.plan import ResumeMode
    from repro_torch.core.pytree import unflatten_from_paths
    from repro_torch.launch.serve import generate, restore_params

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ucp, cstats = CheckpointManager(step_dir.parent, src_plan).export_ucp(device=dev)
    export_s = time.perf_counter() - t0
    check(cstats is not None, "export_ucp converted nothing")
    t0 = time.perf_counter()
    problems = ucp.validate()
    validate_s = time.perf_counter() - t0
    print(f"serve {arch} export_ucp: {cstats.params} params, {cstats.atoms_written} atoms, "
          f"{cstats.bytes_written / 1e9:.3f} GB in {export_s:.2f} s "
          f"({cstats.bytes_written / 1e9 / export_s:.3f} GB/s); validate() == [] "
          f"{problems == []} ({validate_s:.2f} s)")
    check(problems == [], f"export_ucp: {problems[:3]}")
    tlm, tplan = plan_for("data=1,model=1")
    t0 = time.perf_counter()
    flat, rp = restore_params(step_dir, tplan, dev, force_mode=ResumeMode.VIA_UCP)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(rp.mode is ResumeMode.VIA_UCP, f"restore mode {rp.mode}")
    check(set(flat) == set(saved), "VIA_UCP: restored parameter set differs")
    for name, t in flat.items():
        check(torch.equal(t, saved[name]), f"VIA_UCP: {name} differs from the save")
    params_c = tlm.registry.cast(unflatten_from_paths(flat), torch.bfloat16)
    del flat
    generate(tlm, params_c, prompts, 17)
    reset()
    seq, prefill_s, decode_s = generate(tlm, params_c, prompts, 17)
    launches = counts()
    check(launches == per_prefill, f"VIA_UCP: kernel launches {launches}, want {per_prefill}")
    dtypes = by_dtype("bfloat16")
    print(f"serve {arch} restore data=1,model=1 via_ucp (forced) from the atoms in "
          f"{restore_s:.2f} s; bit-equal to the save; prefill 4x512 {prefill_s * 1e3:.2f} ms, "
          f"decode {decode_s * 1e3 / 16:.3f} ms/token, kernel launches {launches}, by dtype {dtypes}")
    return dict(seq=seq.cpu(), export_s=export_s, export_gb=cstats.bytes_written / 1e9,
                restore_s=restore_s, atoms=cstats.atoms_written, ucp=ucp)


def serial_export(torch, label, step_dir, out_dir, parallel: dict) -> dict:
    """``convert_to_ucp`` of a step through a serial engine (workers=1),
    against the parallel export already made: the same atoms, digests and
    files, ``validate() == []``, both walls."""
    from repro_torch.core.convert import convert_to_ucp
    from repro_torch.core.dist_ckpt import DistCheckpoint
    from repro_torch.core.engine import CheckpointEngine

    dev = torch.device("cuda")
    shutil.rmtree(out_dir, ignore_errors=True)
    with CheckpointEngine(dev, workers=1) as serial:
        t0 = time.perf_counter()
        ucp, stats = convert_to_ucp(DistCheckpoint.open(step_dir), str(out_dir), engine=serial)
        torch.cuda.synchronize()
        ser_s = time.perf_counter() - t0
    par = parallel["ucp"]
    check(ucp.manifest.atoms == par.manifest.atoms, f"{label}: serial and parallel atoms differ")
    n = same_files(out_dir, par.root, "atoms/**/*.npy")
    problems = ucp.validate()
    check(problems == [], f"{label} serial export: {problems[:3]}")
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"{label} export serial (workers=1): {stats.bytes_written / 1e9:.3f} GB in {ser_s:.2f} s "
          f"({stats.bytes_written / 1e9 / ser_s:.3f} GB/s) against parallel "
          f"{parallel['export_s']:.2f} s; {n} atom files byte-equal, digests equal, validate() == []")
    return dict(serial_s=ser_s, parallel_s=parallel["export_s"], gb=stats.bytes_written / 1e9)


def serve_delta(torch, arch, cfg, saved, src_plan, plan_for, step_dir, width) -> dict:
    """A delta save at step 2 of the step-1 weights with ``final_norm``
    changed: shards written and inherited, bytes, wall; its tip restored
    DIRECT, RESHARD_STREAM and VIA_UCP (forced), each bit-equal to a full
    save of the same weights."""
    from repro_torch.ckpt.restore import params_from_source
    from repro_torch.ckpt.saver import snapshot_weights, write_distributed
    from repro_torch.core.dist_ckpt import DistCheckpoint
    from repro_torch.core.plan import ResumeMode
    from repro_torch.core.pytree import unflatten_from_paths
    from repro_torch.launch.serve import restore_params

    dev = torch.device("cuda")
    weights = dict(saved)
    weights["final_norm"] = saved["final_norm"] + 1.0
    snap = snapshot_weights(unflatten_from_paths(weights))
    root = step_dir.parent
    res = write_distributed(snap, src_plan, 2, root / "step_00000002", workers=width,
                            save_mode="delta", base=DistCheckpoint.open(step_dir),
                            config_fingerprint=cfg.fingerprint())
    full = write_distributed(snap, src_plan, 2, root / "full" / "step_00000002", workers=width,
                             config_fingerprint=cfg.fingerprint())
    del snap
    tip = DistCheckpoint.open(root / "step_00000002")
    own = set(tip.manifest.shard_digests) - set(tip.manifest.shard_sources)
    check(res.mode == "delta" and tip.manifest.base_step == 1, f"delta save: {res.mode}")
    check(own and all(k.endswith("final_norm@fp32") for k in own),
          f"the delta wrote {sorted(own)[:4]}, not final_norm's fp32 shards alone")
    check(res.shards_written == len(own) and res.shards_inherited == full.shards_written - len(own),
          f"delta counts {res.shards_written} written, {res.shards_inherited} inherited")
    print(f"serve {arch} delta save step 2 (final_norm changed): {res.shards_written} shards "
          f"written, {res.shards_inherited} inherited, {res.bytes_written} bytes in "
          f"{res.wall_time_s:.3f} s; a full save of the same weights {full.bytes_written / 1e9:.3f} "
          f"GB in {full.wall_time_s:.2f} s")
    want = params_from_source(DistCheckpoint.open(root / "full" / "step_00000002"), src_plan, dev)
    check(torch.equal(want["final_norm"], weights["final_norm"]), "the full save lost final_norm")
    walls = {}
    for mesh_str, force, expect in (("data=2,model=2", None, "direct"),
                                    ("data=1,model=1", None, "reshard_stream"),
                                    ("data=1,model=1", ResumeMode.VIA_UCP, "via_ucp")):
        _, tplan = plan_for(mesh_str)
        t0 = time.perf_counter()
        flat, rp = restore_params(root / "step_00000002", tplan, dev, force_mode=force)
        torch.cuda.synchronize()
        walls[expect] = time.perf_counter() - t0
        check(rp.mode.value == expect, f"delta tip {mesh_str}: {rp.mode.value}, want {expect}")
        check(flat.keys() == want.keys() and all(torch.equal(flat[n], t) for n, t in want.items()),
              f"delta tip {expect}: not bit-equal to the full save")
        del flat
        print(f"serve {arch} delta tip restore {mesh_str} {expect}: {walls[expect]:.2f} s, "
              "bit-equal to the full save of the same weights")
    del want
    return dict(written=res.shards_written, inherited=res.shards_inherited,
                bytes=res.bytes_written, delta_s=res.wall_time_s, full_s=full.wall_time_s,
                restore_s=walls)


def gemma_phase(torch, counters: dict, layers: int = 6, cpu_len: int = 32):
    """gemma3-12b at full width, depth cut to one local:global period, on
    the card: a bf16 prefill of 4 x 512 tokens (one flash launch a layer,
    head dim 256, all bf16), then the card's fp32 logits against the port's
    CPU path.  Returns the measurements."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import decode as D

    dev = torch.device("cuda")
    full = get_config("gemma3-12b")
    cfg = dataclasses.replace(full, num_layers=layers)
    check(cfg.num_layers == len(cfg.layer_pattern), "the cut is not one local:global period")
    lm = build_model(cfg, compute_dtype=torch.bfloat16)
    flash = counters["flash_attention"]
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = lm.registry.num_params()
    print(f"gemma3-12b: d {cfg.d_model}, {cfg.num_heads}:{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied "
          f"{cfg.tie_embeddings}, window {cfg.sliding_window}, pattern {cfg.layer_pattern}; depth cut "
          f"from {full.num_layers} to {cfg.num_layers} layers (one local:global period); "
          f"{n_params} params initialised on the card in {time.perf_counter() - t0:.2f} s")
    params_c = lm.registry.cast(params, torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (4, 512),
                            generator=torch.Generator().manual_seed(2)).to(dev)

    def prefill():
        with torch.inference_mode():
            return D.prefill(lm, params_c, D.init_cache(lm, 4, 512, device=dev), prompts)[0]

    prefill()  # warm-up at the timed shapes
    flash.launches = 0
    flash.launches_by_dtype = dict.fromkeys(flash.launches_by_dtype, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = prefill()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches, by_dtype = flash.launches, dict(flash.launches_by_dtype)
    check(launches == layers and by_dtype == {"bfloat16": layers, "float32": 0},
          f"gemma3 prefill: flash launches {launches} {by_dtype}, want {layers} bf16")
    check(tuple(logits.shape) == (4, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"gemma3 prefill logits {tuple(logits.shape)} or non-finite")
    wall, busy, rows = device_profile(torch, prefill, top=None)
    mine = [(key, ms, n) for key, ms, n in rows if TC_SYMBOL["flash_attention"] in key]
    check(len(mine) == 1 and mine[0][2] == layers, f"profiled gemma3 prefill: {mine}")
    print(f"gemma3 prefill 4x512 bf16: {prefill_ms:.2f} ms of wall, flash launches {launches} "
          f"{by_dtype}; profiled: device busy {busy:.3f} ms (wall {wall:.2f} ms with the profiler "
          f"on), {mine[0][0][:40]} {mine[0][1]:.3f} ms over {mine[0][2]} launches")
    for key, ms, count in rows[:6]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    del params_c, logits

    # Right by the repo's own means: the card's fp32 path against the CPU's.
    flm = build_model(cfg, compute_dtype=torch.float32)
    toks = prompts[:1, :cpu_len]
    with torch.inference_mode():
        flash.launches = 0
        flash.launches_by_dtype = dict.fromkeys(flash.launches_by_dtype, 0)
        lg_gpu, _ = D.prefill(flm, params, D.init_cache(flm, 1, cpu_len, device=dev), toks)
        launches, by_dtype = flash.launches, dict(flash.launches_by_dtype)
        cpu_params = _to_cpu(params)
        del params
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        lg_cpu, _ = D.prefill(flm, cpu_params, D.init_cache(flm, 1, cpu_len), toks.cpu())
        cpu_s = time.perf_counter() - t0
    check(launches == layers and by_dtype == {"bfloat16": 0, "float32": layers},
          f"gemma3 fp32 prefill: flash launches {launches} {by_dtype}, want {layers} fp32")
    check(bool(torch.isfinite(lg_gpu).all()), "gemma3 fp32 logits not finite")
    err = (lg_gpu.cpu() - lg_cpu).abs().max().item()
    print(f"gemma3 check fp32 logits card vs CPU ({cpu_len} tokens, CPU prefill {cpu_s:.1f} s): "
          f"max_abs_err {err:.3e} (tolerance 1e-3; |logit| up to {lg_cpu.abs().max().item():.2f}); "
          f"flash launches by dtype {by_dtype}")
    check(err <= 1e-3, "gemma3: card and CPU logits disagree")
    return dict(launches=layers, prefill_ms=prefill_ms, prefill_device_ms=busy,
                prefill_kernel_ms=mine[0][1], logits_err=err)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


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


def build_all(kernels) -> dict[str, list[str]]:
    """Build every kernel source at once (one nvcc each, in parallel);
    returns ptxas' line per kernel, by source."""
    with ThreadPoolExecutor(len(kernels)) as pool:
        reports = dict(zip(kernels, pool.map(lambda k: k.build()[1], kernels.values())))
    usage = {}
    for name, report in reports.items():
        print(f"build {name}: {'compiled' if report['compiled'] else 'cached'} in "
              f"{report['seconds']:.2f} s -> {Path(report['library']).relative_to(ROOT)}")
        usage[name] = ptxas_usage(report["ptxas"])
        for ln in usage[name]:
            print(f"  ptxas: {ln}")
    return usage


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
        wrapper = bq_ops.block_quantize if name == "quantize_blocks" else bq_ops.block_dequantize
        for which in ("kernel", "general", "general", "kernel"):
            per_call, top = device_ms(torch, fns[which], launches=lambda: wrapper.launches)
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


def train_export_ucp(torch, bq_ops, manager, n_coded: int) -> dict:
    """Export the coded step as UCP atoms on the card: every coded moment
    shard decoded once by the (vector) dequantize kernel; the atoms
    validate."""
    dev = torch.device("cuda")
    fn = bq_ops.block_dequantize
    before, by_before = fn.launches, dict(fn.launches_by_variant)
    t0 = time.perf_counter()
    ucp, stats = manager.export_ucp(3, device=dev)
    export_s = time.perf_counter() - t0
    launches = fn.launches - before
    by_variant = {k: fn.launches_by_variant[k] - by_before[k] for k in by_before}
    check(stats is not None, "export_ucp converted nothing")
    t0 = time.perf_counter()
    problems = ucp.validate()
    validate_s = time.perf_counter() - t0
    gb = stats.bytes_written / 1e9
    print(f"train export_ucp step 3: {stats.params} params, {stats.atoms_written} atoms, {gb:.3f} "
          f"GB written in {export_s:.2f} s ({gb / export_s:.3f} GB/s); dequantize launches "
          f"{launches} (coded shards read {n_coded}) by variant {by_variant}; validate() == [] "
          f"{problems == []} ({validate_s:.2f} s)")
    check(launches == n_coded and by_variant == {"vector": n_coded, "general": 0},
          f"export_ucp: dequantize launches {launches} {by_variant}, want {n_coded} vector")
    check(problems == [], f"export_ucp: {problems[:3]}")
    return dict(launches=launches, atoms=stats.atoms_written, gb=gb, seconds=export_s,
                export_s=export_s, ucp=ucp)


class PhaseLaunches:
    """Block-quant launches of the train phase, counted by sub-phase."""

    def __init__(self, bq_ops):
        self.fns = {"quantize": bq_ops.block_quantize, "dequantize": bq_ops.block_dequantize}
        self.by_phase: dict[str, dict[str, int]] = {}

    def mark(self) -> dict[str, int]:
        return {k: fn.launches for k, fn in self.fns.items()}

    def since(self, label: str, mark: dict[str, int]) -> tuple[int, int]:
        got = {k: fn.launches - mark[k] for k, fn in self.fns.items()}
        self.by_phase[label] = got
        return got["quantize"], got["dequantize"]


def clone_state(torch, state):
    """A copy of a TrainState's three trees (flat, on their device)."""
    from repro_torch.core.pytree import flatten_with_paths

    return [{n: t.clone() for n, t in flatten_with_paths(tree).items()}
            for tree in (state.params, state.exp_avg, state.exp_avg_sq)]


def same_state(torch, state, flats) -> bool:
    """Params and both moments bit-equal, over each parameter's logical
    region (runtime padding differs between layouts)."""
    from repro_torch.core.pytree import flatten_with_paths

    for tree, want in zip((state.params, state.exp_avg, state.exp_avg_sq), flats):
        got = flatten_with_paths(tree)
        if got.keys() != want.keys():
            return False
        for name, t in got.items():
            region = tuple(slice(0, min(a, b)) for a, b in zip(t.shape, want[name].shape))
            if t.dtype != want[name].dtype or not torch.equal(t[region], want[name][region]):
                return False
    return True


def train_phase(torch, ops, bq_ops):
    """Train full smollm-360m; save coded under data=2,model=2, serial and
    parallel; export serial and parallel; resume under two layouts through
    serial and parallel engines; continue; then delta saves and their resume,
    and GC under an in-flight delta's pin.  Returns the launch counts and
    measurements."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.ckpt.saver import snapshot_state, write_distributed
    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config
    from repro_torch.core.dist_ckpt import DistCheckpoint
    from repro_torch.core.engine import default_workers
    from repro_torch.core.plan import ResumeMode
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    cfg, tcfg, parallel = get_config("smollm-360m"), TrainConfig(seed=0), ParallelismConfig()
    check(parallel.compute_dtype == "bfloat16" and parallel.moment_dtype == "float32",
          "train: not bf16 compute with fp32 moments")
    root = ROOT / "build" / "chip_smoke_train_ckpt"
    extra = ROOT / "build" / "chip_smoke_train_io"
    for d in (root, extra):
        shutil.rmtree(d, ignore_errors=True)
    width = default_workers()

    def trainer(mesh, **kw):
        return Trainer.create(cfg, parallel, tcfg, mesh_spec_from_string(mesh),
                              batch_size=8, seq_len=512, device=dev, **kw)

    def restore_policy(workers):
        return CheckpointPolicy(async_save=False, save_interval=1000, io_workers=workers)

    out, io = {}, {}
    try:
        ops.flash_attention.launches = 0
        for fn in (bq_ops.block_quantize, bq_ops.block_dequantize):
            fn.launches = 0
            fn.launches_by_variant = dict.fromkeys(fn.launches_by_variant, 0)
        phases = PhaseLaunches(bq_ops)
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

        mark = phases.mark()
        policy = CheckpointPolicy(codec="int8:b256", save_interval=3, async_save=True)
        src = trainer("data=2,model=2", ckpt_dir=str(root), policy=policy)
        saved, hist = src.run(src.init_state(), 0, 3)
        src.manager.close()
        drift = max(abs(h["loss"] - b) for h, b in zip(hist, baseline))
        print(f"train coded run steps 1-3: max |loss - baseline| {drift:.2e}")
        check(drift <= 2e-2, "the coded run left the baseline before saving")
        (res,) = src.save_results
        src_plan = src.plan
        step3 = src.manager.step_dir(3)
        manifest = DistCheckpoint.open(step3).manifest
        n_coded = len(manifest.shard_codecs)
        quant, dequant_save = phases.since("coded save (parallel, async)", mark)
        print(f"train save step 3 (data=2,model=2, int8:b256 moments, async, {width} workers, "
              f"os.cpu_count() {os.cpu_count()}): {res.bytes_written / 1e9:.3f} GB in "
              f"{res.shards_written} shards, {res.wall_time_s:.2f} s "
              f"({res.bytes_written / 1e9 / res.wall_time_s:.3f} GB/s); "
              f"coded {res.coded_bytes / 1e9:.3f} of raw {res.coded_raw_bytes / 1e9:.3f} GB "
              f"(ratio {res.coded_bytes / res.coded_raw_bytes:.4f}); device->host "
              f"{res.device_to_host_bytes / 1e9:.3f} GB for the coded shards; "
              f"{n_coded} coded shards, quantize launches {quant}, dequantize launches "
              f"{dequant_save}")
        check(n_coded > 0 and quant == n_coded, f"quantize launches {quant} != {n_coded} coded shards")
        check(dequant_save >= n_coded, f"dequantize launches {dequant_save} < {n_coded}")

        # The same snapshot through the serial writer: the same files.
        mark = phases.mark()
        snap = snapshot_state(saved, policy.codec)
        torch.cuda.synchronize()
        ser = write_distributed(snap, src_plan, 3, extra / "serial" / "step_00000003", workers=1,
                                codec=policy.codec, config_fingerprint=src.manager.config_fingerprint)
        del snap
        q, d = phases.since("coded save (serial)", mark)
        check(q == n_coded and d == n_coded, f"serial save: {q} quantize, {d} dequantize launches")
        n = same_files(extra / "serial" / "step_00000003", step3, "ranks/**/*.npy")
        same_manifests(extra / "serial" / "step_00000003", step3)
        print(f"train save serial (workers=1): {ser.wall_time_s:.2f} s "
              f"({ser.bytes_written / 1e9 / ser.wall_time_s:.3f} GB/s) against parallel "
              f"{res.wall_time_s:.2f} s ({res.wall_time_s / ser.wall_time_s:.3f} of it); {n} shard "
              "files byte-equal, digests and manifests equal but created_at")
        io["save"] = dict(serial_s=ser.wall_time_s, parallel_s=res.wall_time_s, workers=width,
                          cpus=os.cpu_count(), **io_floor("train save", step3, width, extra / "floor"))
        shutil.rmtree(extra / "serial", ignore_errors=True)

        saved_params = flatten_with_paths(saved.params)
        mark = phases.mark()
        export = train_export_ucp(torch, bq_ops, src.manager, n_coded)
        phases.since("export (parallel)", mark)
        mark = phases.mark()
        io["export"] = serial_export(torch, "train", step3, extra / "serial_export.ucp", export)
        _, d = phases.since("export (serial)", mark)
        check(d == n_coded, f"serial export: {d} dequantize launches, want {n_coded}")
        del src

        restore_s, stream = {}, {}
        for mesh, expect in (("data=1,model=1", "reshard_stream"), ("data=2,model=2", "direct"),
                             ("data=1,model=1", "via_ucp"), ("data=2,model=2", "via_ucp")):
            mark = phases.mark()
            tgt = trainer(mesh, ckpt_dir=str(root), policy=restore_policy(width))
            if expect == "via_ucp":
                state, info = tgt.manager.restore(dev, force_mode=ResumeMode.VIA_UCP)
                check(info.convert_stats is None, f"{mesh}: VIA_UCP converted again")
                check(same_state(torch, state, stream["state"]),
                      f"{mesh}: the VIA_UCP resume differs from the RESHARD_STREAM resume")
            else:
                state, info = tgt.init_or_restore()
            _, read = phases.since(f"resume {expect} {mesh} (parallel)", mark)
            check(info is not None and info.mode.value == expect,
                  f"{mesh}: planned {info and info.mode.value}, want {expect}")
            check(state.step == 3, f"{mesh}: restored step {state.step}")
            for name, t in flatten_with_paths(state.params).items():
                logical = tuple(slice(0, n) for n in saved_params[name].shape)
                check(torch.equal(t[logical], saved_params[name]), f"{mesh}: {name} differs")
            n_checked = served_view_matches(torch, state, src_plan, manifest)
            check(n_checked == n_coded, f"{mesh}: {n_checked} served digests checked")
            want_read = 0 if expect == "via_ucp" else n_coded  # atoms are raw
            engine = tgt.manager.engine_for(dev)
            check(read == want_read, f"{mesh}: {read} dequantize launches, want {want_read} (each "
                  f"coded file decoded once; {engine.handles.evictions} handle evictions)")
            restore_s[f"{expect} {mesh}"] = info.wall_time_s
            if expect != "via_ucp":  # the same restore through a serial engine
                mark = phases.mark()
                smgr = CheckpointManager(root, tgt.plan, policy=restore_policy(1))
                sstate, sinfo = smgr.restore(dev)
                _, sread = phases.since(f"resume {expect} {mesh} (serial)", mark)
                check(sinfo.mode.value == expect and sread == n_coded,
                      f"{mesh} serial: {sinfo.mode.value}, {sread} dequantize launches")
                check(same_state(torch, sstate, clone_state(torch, state)),
                      f"{mesh}: serial and parallel restores differ")
                print(f"train resume {mesh} {expect}: serial engine {sinfo.wall_time_s:.2f} s, "
                      f"parallel ({width} workers) {info.wall_time_s:.2f} s; all three kinds "
                      f"bit-equal; {n_coded} dequantize launches each (every coded file decoded "
                      f"once; parallel handle evictions {engine.handles.evictions})")
                io[f"restore {expect}"] = dict(serial_s=sinfo.wall_time_s,
                                               parallel_s=info.wall_time_s)
                smgr.close()
                del sstate
            if expect == "reshard_stream":
                stream["state"] = clone_state(torch, state)
            _, hist = tgt.run(state, 3, 3)
            resumed = [h["loss"] for h in hist]
            check(all(map(math.isfinite, resumed)), f"{mesh}: resumed loss not finite")
            if expect == "reshard_stream":
                stream["losses"] = resumed
            beside = (stream["losses"], "RESHARD_STREAM") if expect == "via_ucp" else \
                (baseline[3:], "baseline")
            print(f"train resume {mesh}: {info.mode.value} in {info.wall_time_s:.2f} s, params "
                  f"bit-equal to the save{', all three kinds bit-equal to the RESHARD_STREAM resume' if expect == 'via_ucp' else ''}, "
                  f"{n_checked} moment shards equal to the served view, step 3, "
                  f"{read} dequantize launches; steps 4-6 losses "
                  + ", ".join(f"{a:.4f} ({beside[1]} {b:.4f})" for a, b in zip(resumed, beside[0])))
            tgt.manager.close()
            del state, tgt
            torch.cuda.empty_cache()
        stream_losses = stream.pop("losses")
        del stream
        io["restore split"] = split_resume(torch, phases, trainer, restore_policy, step3, n_coded,
                                           saved_params, width)
        t0 = time.perf_counter()
        _, again = CheckpointManager(root, src_plan).export_ucp(3, device=dev)
        print(f"train second export_ucp: ConvertStats {again} in {time.perf_counter() - t0:.3f} s "
              "(the committed cache)")
        check(again is None, "the second export converted again")

        delta = train_delta(torch, phases, trainer, restore_policy, extra / "delta", n_coded,
                            stream_losses, width)
        gc = gc_under_pin(torch, phases, delta.pop("state"), src_plan, extra / "gc")

        flash = ops.flash_attention.launches
        check(flash == 0, f"{flash} flash-attention launches during training")
        total_q, total_d = bq_ops.block_quantize.launches, bq_ops.block_dequantize.launches
        by_variant = {"quantize": dict(bq_ops.block_quantize.launches_by_variant),
                      "dequantize": dict(bq_ops.block_dequantize.launches_by_variant)}
        check(by_variant == {"quantize": {"vector": total_q, "general": 0},
                             "dequantize": {"vector": total_d, "general": 0}},
              f"train: block-quant launches by variant {by_variant}, want all vector")
        check(sum(p["quantize"] for p in phases.by_phase.values()) == total_q
              and sum(p["dequantize"] for p in phases.by_phase.values()) == total_d,
              "block-quant launches outside the counted sub-phases")
        out = dict(quantize=total_q, dequantize=total_d, by_variant=by_variant, step_s=step_s,
                   restore_s=restore_s, export=export, by_phase=phases.by_phase, io=io,
                   delta=delta, gc=gc)
        print(f"train launches: quantize {total_q}, dequantize {total_d}, "
              f"flash_attention {flash}; block quant by variant {by_variant}; by sub-phase "
              f"{json.dumps(phases.by_phase)}")
    finally:
        for d in (root, extra):
            shutil.rmtree(d, ignore_errors=True)
    return out


def split_resume(torch, phases, trainer, restore_policy, step_dir, n_coded, saved, width):
    """A coded resume under data=4,model=1, whose regions split the coded
    shards of the data=2,model=2 save (the ZeRO-1 moments are cut over four
    data ranks, so a shard feeds two regions): each coded file must still be
    decoded once, through the parallel and the serial engine, the two
    states bit-equal; and the restore must leave no decoded shard on the
    card (its peak and retained card memory beside the state's bytes)."""
    import collections
    import gc

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.ckpt.restore import target_regions
    from repro_torch.core.dist_ckpt import DistCheckpoint, shard_digest_key
    from repro_torch.core.engine import CheckpointEngine
    from repro_torch.core.patterns import StateKind
    from repro_torch.core.pytree import flatten_with_paths

    dev = torch.device("cuda")
    mesh = "data=4,model=1"
    plan = trainer(mesh).plan
    ckpt = DistCheckpoint.open(step_dir)
    uses = collections.Counter()
    with CheckpointEngine(workers=1) as eng:
        for name, spec in plan.param_specs.items():
            for kind in (StateKind.EXP_AVG, StateKind.EXP_AVG_SQ):
                idx = eng.index_for(ckpt, name, kind)
                for region in target_regions(spec, plan.mesh, kind):
                    for rank, _, _ in idx.overlapping(region):
                        if ckpt.manifest.codec_tag(shard_digest_key(rank, name, kind)) != "raw":
                            uses[(rank, name, kind)] += 1
    split = sum(n > 1 for n in uses.values())
    check(len(uses) == n_coded and split > 0,
          f"{mesh}: {split} of {len(uses)} coded files feed more than one region")
    out, first = {"split_files": split}, None
    for label, workers in (("parallel", width), ("serial", 1)):
        mgr = CheckpointManager(step_dir.parent, plan, policy=restore_policy(workers))
        gc.collect()  # what earlier phases left in reference cycles is not the restore's
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        mark = phases.mark()
        state, info = mgr.restore(dev)
        _, read = phases.since(f"resume reshard_stream {mesh} ({label})", mark)
        leaves = [t for tree in (state.params, state.exp_avg, state.exp_avg_sq)
                  for t in flatten_with_paths(tree).values()]
        state_b = sum(t.numel() * t.element_size() for t in leaves)
        retained = torch.cuda.memory_allocated() - before - state_b
        peak = torch.cuda.max_memory_allocated() - before
        engine = mgr.engine_for(dev)
        check(info.mode.value == "reshard_stream" and state.step == 3,
              f"{mesh} {label}: {info.mode.value} step {state.step}")
        check(read == n_coded, f"{mesh} {label}: {read} dequantize launches, want {n_coded} (each "
              f"coded file decoded once; {engine.handles.evictions} handle evictions)")
        check(len(engine.handles) == 0 and len(engine.atoms) == 0,
              f"{mesh} {label}: the restore left {len(engine.handles)} handles cached")
        check(retained <= 64 << 20, f"{mesh} {label}: {retained} bytes retained beyond the state")
        for name, t in flatten_with_paths(state.params).items():
            logical = tuple(slice(0, n) for n in saved[name].shape)
            check(torch.equal(t[logical], saved[name]), f"{mesh} {label}: {name} differs")
        if first is None:
            first = clone_state(torch, state)
        else:
            check(same_state(torch, state, first), f"{mesh}: serial and parallel restores differ")
        print(f"train resume {mesh} reshard_stream ({label} engine, {workers} workers): "
              f"{info.wall_time_s:.2f} s; {split} of {n_coded} coded files feed two or more "
              f"regions, {read} dequantize launches (each decoded once; handle evictions "
              f"{engine.handles.evictions}); card memory: state {state_b / 1e9:.3f} GB, peak "
              f"{peak / 1e9:.3f} GB above it before the restore, retained beyond the state "
              f"{retained} bytes, engine caches empty"
              + ("; all three kinds bit-equal to the parallel restore" if label == "serial" else ""))
        out[label] = dict(seconds=info.wall_time_s, peak_gb=peak / 1e9, retained_b=retained,
                          state_gb=state_b / 1e9)
        mgr.close()
        del state, leaves
        torch.cuda.empty_cache()
    return out


def train_delta(torch, phases, trainer, restore_policy, root, n_coded, stream_losses, width):
    """The coded policy with ``save_mode="delta"`` through two saves (steps 2
    and 3): AdamW changes every shard, so the second save is a delta that
    inherits nothing.  Then resume the tip under data=1,model=1 and hold
    steps 4-6 against the full-save resume's losses."""
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.core.dist_ckpt import DistCheckpoint
    from repro_torch.core.pytree import flatten_with_paths

    mark = phases.mark()
    policy = CheckpointPolicy(codec="int8:b256", save_interval=1000, async_save=True,
                              save_mode="delta")
    d = trainer("data=2,model=2", ckpt_dir=str(root), policy=policy)
    s2, _ = d.run(d.init_state(), 0, 2)
    d.manager.save(s2, 2)
    s3, _ = d.run(s2, 2, 1)
    d.manager.save(s3, 3)
    d.save_results += d.manager.wait()
    d.manager.close()
    r2, r3 = d.save_results
    m3 = DistCheckpoint.open(d.manager.step_dir(3)).manifest
    q, dq = phases.since("delta run: full save + delta save", mark)
    check((r2.mode, r3.mode, m3.save_mode, m3.base_step) == ("full", "delta", "delta", 2),
          f"delta run: {r2.mode}, {r3.mode}, base {m3.base_step}")
    check(r3.shards_inherited == 0 and r3.shards_written == r2.shards_written,
          f"delta after a train step: {r3.shards_written} written, {r3.shards_inherited} inherited")
    check(q == 2 * n_coded, f"delta run: {q} quantize launches, want {2 * n_coded}")
    print(f"train delta saves: step 2 full {r2.bytes_written / 1e9:.3f} GB in {r2.wall_time_s:.2f} s; "
          f"step 3 delta (base 2) {r3.shards_written} shards written, {r3.shards_inherited} "
          f"inherited ({r3.bytes_written / 1e9:.3f} GB in {r3.wall_time_s:.2f} s): AdamW changed "
          "every shard, so the delta inherits nothing")
    mark = phases.mark()
    tgt = trainer("data=1,model=1", ckpt_dir=str(root), policy=restore_policy(width))
    state, info = tgt.init_or_restore()
    _, read = phases.since("delta tip resume reshard_stream (parallel)", mark)
    check(info.mode.value == "reshard_stream" and info.step == 3 and state.step == 3,
          f"delta tip resume: {info.mode.value} step {info.step}")
    check(read == n_coded, f"delta tip resume: {read} dequantize launches, want {n_coded}")
    want = flatten_with_paths(s3.params)
    for name, t in flatten_with_paths(state.params).items():
        logical = tuple(slice(0, n) for n in want[name].shape)
        check(torch.equal(t[logical], want[name]), f"delta tip resume: {name} differs")
    _, hist = tgt.run(state, 3, 3)
    losses = [h["loss"] for h in hist]
    gap = max(abs(a - b) for a, b in zip(losses, stream_losses))
    print(f"train delta tip resume data=1,model=1 reshard_stream in {info.wall_time_s:.2f} s, params "
          f"bit-equal to the delta run's; steps 4-6 losses "
          + ", ".join(f"{a:.4f} (full-save resume {b:.4f})" for a, b in zip(losses, stream_losses))
          + f"; max gap {gap:.2e} (tolerance 2e-2)")
    check(all(map(math.isfinite, losses)) and gap <= 2e-2,
          "the delta tip's resume left the full-save resume's curve")
    tgt.manager.close()
    del tgt, state, s2
    torch.cuda.empty_cache()
    return dict(full_s=r2.wall_time_s, delta_s=r3.wall_time_s, written=r3.shards_written,
                inherited=r3.shards_inherited, resume_s=info.wall_time_s, loss_gap=gap, state=s3)


def gc_under_pin(torch, phases, state, plan, root):
    """An async manager with ``keep_last=1`` and ``save_mode="delta"``: a
    full save at 10; a delta at 30 that stalls after resolving its base; a
    full rebase at 40 whose GC must keep step 10 (the pinned base); the delta
    commits and restores; the next GC collects the dead chain."""
    import repro_torch.ckpt.saver as saver_mod
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.core.dist_ckpt import DistCheckpoint
    from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths
    from repro_torch.train.optimizer import TrainState

    dev = torch.device("cuda")
    mark = phases.mark()
    policy = CheckpointPolicy(codec="int8:b256", async_save=True, save_mode="delta",
                              full_interval=2, keep_last=1)
    mgr = CheckpointManager(root, plan, policy=policy)
    flat = flatten_with_paths(state.params)
    flat["final_norm"] = flat["final_norm"] + 1.0
    bumped = TrainState(unflatten_from_paths(flat), state.exp_avg, state.exp_avg_sq, state.step)
    real = saver_mod.write_distributed
    started, gate = threading.Event(), threading.Event()

    def stalled(snap, plan_, step, root_, **kw):
        if step == 30:  # resolve (and pin) the base as the writer does, then stall
            kw["base"] = kw["base"]()
            started.set()
            gate.wait(600)
        return real(snap, plan_, step, root_, **kw)

    saver_mod.write_distributed = stalled
    try:
        t0 = time.perf_counter()
        mgr.save(state, 10, block=True)  # seq 0: full, the future base
        mgr.save(bumped, 30)  # seq 1: a delta, queued; it stalls after resolving 10
        check(started.wait(600), "the delta never resolved its base")
        mgr.save(bumped, 40, block=True)  # seq 2: a full rebase; its GC keeps {40} + pins
        survived = mgr.step_dir(10).exists()
    finally:
        gate.set()
        saver_mod.write_distributed = real
    check(survived, "gc collected the base of an in-flight delta")
    deadline = time.perf_counter() + 600
    while 30 not in mgr.steps() and time.perf_counter() < deadline:
        time.sleep(0.05)
    if 30 not in mgr.steps():
        mgr.wait()  # surfaces the writer's error
    check(mgr.steps() == [10, 30, 40], f"steps {mgr.steps()}, want [10, 30, 40]")
    m30 = DistCheckpoint.open(mgr.step_dir(30)).manifest
    own = set(m30.shard_digests) - set(m30.shard_sources)
    check(m30.base_step == 10 and own and all(k.endswith("final_norm@fp32") for k in own),
          f"the delta at 30 wrote {sorted(own)[:4]}")
    restored, info = mgr.restore(dev, step=30)
    want = flatten_with_paths(bumped.params)
    check(all(torch.equal(t, want[n]) for n, t in flatten_with_paths(restored.params).items()),
          "the delta at 30 does not restore its params")
    del restored
    results = mgr.wait()  # GC: the pin died with the save
    check(mgr.steps() == [40] and not mgr.step_dir(10).exists() and not mgr.step_dir(30).exists(),
          f"after the rebase GC left {mgr.steps()}")
    mgr.close()
    (r30,) = results
    phases.since("gc under pin: full, delta, full saves and a restore", mark)
    wall = time.perf_counter() - t0
    print(f"train GC under a pin: base 10 survived the GC of rebase 40 while the delta at 30 was "
          f"in flight; 30 committed ({r30.shards_written} shards written, {r30.shards_inherited} "
          f"inherited, coded moments inherited from 10), restored {info.mode.value} bit-equal, "
          f"then GC left {mgr.steps()} ({wall:.2f} s)")
    return dict(written=r30.shards_written, inherited=r30.shards_inherited, seconds=wall)


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

    usage = build_all({"flash_attention": kernel, "block_quant": bq_kernel, "ssd_scan": ssd_kernel})
    check_no_spills(usage["flash_attention"], ("fwd_kernel_tc<256>", "fwd_kernel<float, 256>"))
    k = kernel_phase(torch, F, kernel, ops, ref)
    bq = block_quant_phase(torch, bq_ops, bq_ref)
    ssd = ssd_phase(torch, F, ssd_ops, ssd_ref)
    counters = {"flash_attention": ops.flash_attention, "ssd_scan": ssd_ops.ssd_scan}
    runs = serve_phase(torch, "smollm-360m", counters,
                       {"flash_attention": 32, "ssd_scan": 0}, cpu_len=48, via_ucp=True)
    ssm_runs = serve_phase(torch, "mamba2-130m", counters,
                           {"flash_attention": 0, "ssd_scan": 24}, cpu_len=512)
    gemma = gemma_phase(torch, counters)
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
        "d256_ms": k["d256"]["ms"],
        "d256_library_ms": k["d256"]["library_ms"],
        "d256_fp32_ms": k["d256"]["fp32_ms"],
        "d256_plain_ms": k["d256"]["plain_ms"],
        "d256_bound_ms": k["d256"]["bound_ms"],
        "d256_bound_by": k["d256"]["bound_by"],
        "d256_max_abs_err": k["d256"]["max_abs_err"],
        "d256_launches": gemma["launches"],
        "d256_shape": "bf16 B=4 S=512 16:8 heads of 256, causal (gemma3-12b)",
        "gemma3_prefill_device_ms": gemma["prefill_device_ms"],
        "gemma3_prefill_kernel_ms": gemma["prefill_kernel_ms"],
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
            "launches_by_phase": {k: v[which] for k, v in train["by_phase"].items()},
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
        if name == "dequantize_blocks":
            rows[-1]["convert_launches"] = train["export"]["launches"]
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
    print(json.dumps({"io": {"serve smollm-360m": runs["io"], "train smollm-360m": train["io"],
                             "train delta": train["delta"], "train gc under pin": train["gc"]}}))
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
