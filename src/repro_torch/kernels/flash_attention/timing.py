"""Device time of the bf16 flash-attention kernel at the main path's shapes,
beside cuDNN's and the bound, for comparing two checkouts on one card.

Run as a script on a machine with a card, once for each checkout's ``src``
in one command (in turns: parent, change, change, parent), so both are
timed on the same card::

    python src/repro_torch/kernels/flash_attention/timing.py --src OLD/src --tag parent
    python src/repro_torch/kernels/flash_attention/timing.py --src src --tag change

Each run imports ``repro_torch`` from ``--src`` (building that checkout's
kernel) and prints one JSON line per shape: the kernel's device time per
launch (the profiler's, over 20 launches through ``ops.flash_attention``),
the symbol it ran, cuDNN's (``scaled_dot_product_attention`` pinned to the
cuDNN backend; a yardstick the port never calls), and the bound: the
larger of the bytes over 3.35 TB/s and the FLOPs over 989 TFLOP/s (an
H100 SXM's), from ``ops.launch_cost``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# label: (B, Sq, Skv, q heads, kv heads, D, Dv, causal, q_offset) — the
# shapes chip_smoke.py's kernel phase times
SHAPES = {
    "smollm 15:5 of 64": (4, 512, 512, 15, 5, 64, 64, True, 0),
    "gemma3 16:8 of 256": (4, 512, 512, 16, 8, 256, 256, True, 0),
    "mixtral 48:8 of 128": (4, 512, 512, 48, 8, 128, 128, True, 0),
    "deepseek 128:128 of (192, 128)": (4, 512, 512, 128, 128, 192, 128, True, 0),
    "jamba 64:8 of 128": (4, 512, 512, 64, 8, 128, 128, True, 0),
    "mixtral rank 24:4 of 128": (4, 512, 512, 24, 4, 128, 128, True, 0),
    "deepseek rank 64:64 of (192, 128)": (4, 512, 512, 64, 64, 192, 128, True, 0),
    "vlm rank 16:4 of 128, 512 x 1600": (4, 512, 1600, 16, 4, 128, 128, False, 0),
    "whisper rank 3:3 of 64, 1500 x 1500": (4, 1500, 1500, 3, 3, 64, 64, False, 0),
    "vlm cross 32:8 of 128, 512 x 1600": (4, 512, 1600, 32, 8, 128, 128, False, 0),
    "vlm self 32:8 of 128": (4, 512, 512, 32, 8, 128, 128, True, 0),
    "whisper encoder 6:6 of 64, 1500 x 1500": (4, 1500, 1500, 6, 6, 64, 64, False, 0),
    "whisper self 6:6 of 64, 432 x 432": (4, 432, 432, 6, 6, 64, 64, True, 0),
    "whisper cross 6:6 of 64, 432 x 1500": (4, 432, 1500, 6, 6, 64, 64, False, 0),
    "smollm rank 1 15:5 of 64, 256 x 512 at q_offset 256": (4, 256, 512, 15, 5, 64, 64, True, 256),
}


def device_ms(torch, fn, calls: int = 20) -> tuple[float, str]:
    """Device milliseconds a call of the busiest kernel ``fn`` launches, and
    its name, from one profiled run of ``calls`` warm calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    us, key = max(rows)
    return us / 1e3 / calls, key


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the src directory of the checkout to time")
    ap.add_argument("--tag", required=True, help="a name for this checkout in the output")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.kernels.flash_attention import ops

    if not torch.cuda.is_available():
        raise SystemExit("timing.py needs a CUDA device")
    card = torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, (b, sq, skv, hq, hkv, d, dv, causal, off) in SHAPES.items():
        q = torch.randn(b, sq, hq, d, generator=g, device="cuda").bfloat16()
        k = torch.randn(b, skv, hkv, d, generator=g, device="cuda").bfloat16()
        v = torch.randn(b, skv, hkv, dv, generator=g, device="cuda").bfloat16()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        scale = d ** -0.5
        ms, symbol = device_ms(torch, lambda: ops.flash_attention(
            q, k, v, causal=causal, scale=scale, q_offset=off))
        mask = dict(attn_mask=causal_lower_right(sq, skv)) if off else dict(is_causal=causal)

        def library():
            with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
                return F.scaled_dot_product_attention(qt, kt, vt, scale=scale, enable_gqa=True,
                                                      **mask)

        try:
            lib_ms, lib_symbol = device_ms(torch, library)
        except RuntimeError as e:  # cuDNN refuses the inputs: no yardstick
            lib_ms, lib_symbol = None, str(e).splitlines()[0][:120]
        flops, nbytes = ops.launch_cost(q, k, v, causal=causal, window=0, q_offset=off)
        bound_ms = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3
        print(json.dumps({"tag": args.tag, "shape": label, "ms": ms, "symbol": symbol[:60],
                          "cudnn_ms": lib_ms, "cudnn_symbol": lib_symbol[:60],
                          "bound_ms": bound_ms, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
