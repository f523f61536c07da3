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
   (``fwd_kernel_tc<256, 256>``, ``fwd_kernel<float, 256, 256>``) or the
   MLA ones (``fwd_kernel_tc<192, 128>``, ``fwd_kernel<float, 192, 128>``)
   spill;
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
   device time, the plain version's event time and the bound; then the
   same for mixtral-8x22b's head layout (48:8 heads of 128; its window 4096
   at S=8192), and for deepseek-v2's MLA (128:128 heads, q and k of 192, v
   of 128, no window; there also the bf16 kernel's event time, and the
   library is the first fused ``scaled_dot_product_attention`` backend
   that takes a v head dim other than q's, named, checked against the
   kernel, with the others' reasons for refusing), and for
   jamba-1.5-large-398b's (64:8 heads of 128, no window); then k and v of
   their own length, with no mask: llama-3.2-vision-11b's cross layer
   (B=4, 512 queries against 1600 source rows, 32:8 heads of 128) and its
   causal self layers (S=512), whisper-tiny's encoder (B=4, 1500 x 1500,
   6:6 heads of 64: a ragged last tile) and cross layers (432 x 1500), each
   as the layouts above (the bound counts the pairs each mask allows, a
   causal row seeing at most Skv keys); and causal launches at 512 x 1600
   and 1600 x 512 (8:2 heads of 128) against the plain version only;
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
   computes this function, so no library time); then at
   jamba-1.5-large-398b's shape (B=4, S=512, H=128, P=128, G=1, N=128,
   chunk 256; fp32 at B=1) both kernels against ``ssd_chunked`` and
   ``ssd_ref`` in float64, the bf16 kernel's device and event times, the
   fp32 kernel's device time, the plain version's event time and the bound;
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
8a. hot, the in-memory tier and elastic resume on full smollm-360m (4.34 GB
   of fp32 state), the whole phase under one obs tracer: 4 steps under
   data=2,model=2 with ``CheckpointPolicy(hot_interval=2, disk_interval=4,
   codec="int8:b256", hot_replication=1, hot_max_snapshots=2)`` (steps 2
   and 4 captured into host memory, step 4 drained to disk with every coded
   moment shard encoded on the card: 60 quantize and 60 dequantize
   launches); the uninterrupted run's steps 5-6; rank 1 lost (its buddy 0
   holds its fragments): HOT_DIRECT under data=2,model=2 and HOT_RESHARD
   under the mesh ``rebuild_on`` proposes for one device (data=1,model=1,
   ``wqkv`` consolidated in all three kinds), each bit-equal to the
   captured state with no checkpoint file opened (a spy on
   ``DistCheckpoint.open``, the trace's ``engine.handle.miss``), 2 steps
   after each (after HOT_DIRECT the uninterrupted losses within 1e-5); the
   whole buddy group {0, 1} lost: no hot plan (``restore.hot_skip``) and
   RESHARD_STREAM from the drained step (60 dequantize launches, params
   bit-equal, every moment shard the served view), 2 steps; each restore
   split by its spans; the Chrome trace exported and validated; the
   phase's directories removed;
8b. fanout, full smollm-360m: a publisher trains under data=2,model=2
   with ``CheckpointPolicy(codec="int8:b256", save_interval=2, keep_last=1,
   registry=PublicationRegistry(...))`` (60 quantize launches a save); its
   step 2 (seq 1) goes to 8 ``FleetReplica``s under data=1,model=1
   (RESHARD_STREAM, ``wqkv`` consolidated) that share one card engine and
   sync from threads: each bit-equal to ``params_from_source`` of the step
   on the card, one set of tensors (``data_ptr``), each fp32 shard read from
   disk once, 0 block-quant launches; the sync's wall and ``FanoutStats``;
   2 independent readers with private engines restore the same step (wall
   each, aggregate GB/s of both ways); replicas 0 and 7 and a direct
   restore serve 4 x 512 and 16 steps in bf16 (32 flash launches a
   prefill), equal tokens; a poisoned peer copy is caught by a new replica
   (digest failure, refetch, holder evicted, bit-equal); seq 2 (step 4,
   every weight changed) is synced under an obs tracer (``serve.sync``,
   ``serve.fetch``, ``serve.publish`` spans and the ``serve.*`` counters),
   every parameter rebuilt, bit-equal; seq 3 (step 5, ``final_norm``
   changed) updates only ``final_norm`` in place, every other tensor kept;
   the card memory the fleet keeps after seq 1, 2 and 3 (one set, not one
   a publication); then the chaos sweep of seeds 0-2 with the harness's
   state on the card, each report ok with the CPU run's schedule and
   events;
9. mixtral-8x22b (the MoE family) at full width: d 6144, 48:8 heads of
   128, 8 experts top-2 of d_ff 16384, vocab 32768, window 4096.
   serve-moe, depth cut from 56 to 1 layer (2,906,720,256 params): init
   on the card; a save under data=2,model=2 (expert parallelism) of the
   fp32 weights and bf16 zero moments coded ``int8:b256`` on the card
   (one quantize launch a coded shard), beside the disk floor
   measured on its largest files; weights-only restores under data=1,model=1
   (RESHARD_STREAM) and data=2,model=2 (DIRECT), each bit-equal to the
   save, then a read floor of the same fp32 files; from each, a bf16
   prefill of 4 x 512 (1 flash launch at D = 128, counted) and 16
   greedy decode steps, equal tokens, the share of routed slots dropped
   by capacity (none in decode); the profiled prefill and decode; one MoE
   layer's routing, dispatch, expert matmuls and combine timed apart; a 1
   x 8192 prefill and 16 decode steps past it (the 4096-slot ring holds
   the last window, then wraps).  In fp32 on the card: the flash path
   against the plain attention, compared by the experts each token is
   routed to (flips and their top-2 margins reported; the logits of the
   tokens no flip reaches within 1e-3), and the ring against a full cache
   over 8192 + 8 tokens (logits within 1e-3, equal tokens).
   train-moe, depth cut to 1 layer (2,906,720,256 params), bf16 compute
   and bf16 Adam moments, remat full, 8 x 512: 6 baseline steps under
   data=1,model=4 (EP; step ms, tokens/s, peak card memory, dropped
   share, one profiled step), whose bf16 first-moment shard of
   ``we_gate`` (1 x 2 x 6144 x 16384, the save's largest) is coded
   ``int8:b256`` by the kernels and by their plain version, byte-equal;
   3 steps saved with ``int8:b256`` under EP
   (quantize launches = coded shards, beside the disk floor); resumed
   under data=2,model=2 with ``expert_parallel=False`` (expert-TP):
   RESHARD_STREAM, step 3, one dequantize launch a coded shard, every
   shard digest of the save equal to the restored state re-cut under the
   Source plan (params bit-equal, moments the codec's served view), then
   3 more steps with finite losses beside the baseline's;
10. serve-mla: deepseek-v2-236b (MLA) at full width: d 5120, 128 heads,
   q_lora 1536, kv_lora 512, nope 128, rope 64, v 128, 160 experts top-6
   of d_ff 1536 and 2 shared, vocab 102400; depth cut from 60 to 2 layers
   (the dense head layer and one MoE layer; 5,358,679,040 params): init
   on the card; the fp32 weights alone (21.4 GB) saved under data=2,model=2
   with expert parallelism, beside the disk floor on its largest files;
   weights-only restores under data=1,model=1 (RESHARD_STREAM) and
   data=2,model=2 (DIRECT), each bit-equal to the save, then a read floor
   of the same files; from each, a bf16 prefill of 4 x 512 (exactly 2
   flash launches, both bf16 at (D, Dv) = (192, 128), recorded at the
   kernel's wrapper) and 16 greedy decode steps through the absorbed
   latent cache, equal tokens; the profiled prefill (the flash share of
   its device time) and decode.  In fp32 on the card: the flash path
   against the plain attention by the experts each token is routed to
   (the logits of the tokens no flip reaches within 1e-3), and 16 decode
   steps after a kernel prefill against the same steps after a plain one
   (the logits of every step and row routed alike within 1e-3);
11. serve-hybrid: jamba-1.5-large-398b at full width: d 8192, 64:8 heads
   of 128, Mamba-2 with d_inner 16384 in 128 heads of 128, state 128,
   conv 4, 16 experts top-2 of d_ff 24576, dense d_ff 24576, vocab 65536;
   depth cut from 72 layers (9 periods of 8) to 2 with the pattern
   ``("attn", "mamba")``, a real period's layers 4 and 5 (11,898,463,872
   params): bf16 weights drawn on the card tensor by tensor; saved under
   data=2,model=2 with expert parallelism and ``param_dtype="bfloat16"``
   (23.8 GB), beside the disk floor; weights-only restores under
   data=1,model=1 (RESHARD_STREAM) and data=2,model=2 (DIRECT), each
   bit-equal to the save, then a read floor; from each, a bf16 prefill of
   4 x 512 (exactly 1 flash and 1 SSD launch, both bf16) and 16 greedy
   decode steps through the mixed cache, equal tokens, the share of slots
   dropped; the profiled prefill (flash and SSD times), its MoE block and
   Mamba-2 projections by CUDA events, the profiled decode.  Then, the
   bf16 trees freed, in fp32 on the card: the kernel path against the
   plain attention and ``ssd_chunked`` by the experts chosen (the logits
   of the tokens no flip reaches within 1e-3); the phase's peak memory;
12. train-ssm: mamba2-130m at full width and depth (128,983,488 params),
   8 x 512 from ``train/data.py``, bf16 compute, fp32 master and moments,
   remat full: the first step's gradients through ``ssd_chunked`` (every
   one finite) and through the reference's unmasked form (kept here; its
   non-finite ``a_log``/``dt_bias`` gradients printed, informative); 6
   baseline steps under data=2,model=2 (finite losses and gradient norms,
   step ms, one profiled step); 3 steps saved ``int8:b256`` (quantize
   launches == coded shards, and one dequantize each for the served
   digest); resumed under data=1,model=1 (RESHARD_STREAM, the fused
   ``in_proj`` of the weights and both moments consolidated) and
   data=2,model=2 (DIRECT), each with one dequantize launch a coded shard
   and every shard digest checked, then 3 more steps; then the kernels
   against their plain version byte for byte on an ``in_proj`` moment
   shard, and their times there;
13. serve-vlm: llama-3.2-vision-11b at full width (d 4096, 32:8 heads of
   128, d_ff 14336, vocab 128256, a gated cross layer every 5 reading 1600
   x 4096 source embeds), depth cut from 40 to 5 layers (one period:
   ``self0..self3`` and ``cross``; 2,141,237,249 params): fp32 weights
   from a seeded generator on the card, ``cross_gate`` set from the seed
   to a value in ±[0.5, 1.5) (the init's 0 makes the cross layer add
   nothing); saved under data=2,model=2 (8.6 GB), beside the disk floor;
   weights-only restores under data=1,model=1 (RESHARD_STREAM: ``wqkv``
   and ``cross_wkv`` consolidated) and data=2,model=2 (DIRECT), each
   bit-equal to the save, then a read floor; from each, a bf16 prefill of
   4 x 512 with the serve CLI's bf16 source embeds (exactly 5 flash
   launches, recorded at the wrapper: 4 causal 512 x 512 and 1 non-causal
   512 x 1600) and 16 greedy decode steps, equal tokens; the profiled
   prefill and decode.  In fp32 on the card: the kernel path against the
   plain attention through the prefill and 16 decode steps, logits within
   1e-3; another source moves the logits;
14. serve-encdec: whisper-tiny at full width and depth (d 384, 6 heads of
   64, 4 encoder layers over 1500 frames, 4 decoder layers, vocab 51865
   padded to 51866 under data=2,model=2; 56,355,840 params), the same way
   with prompts of 4 x 432 (prompt and 16 steps fill whisper's 448-token
   text context): 12 flash launches a prefill (4 encoder 1500 x 1500 with
   no mask, then each decoder layer's causal 432 x 432 and its 432 x 1500
   cross launch); the RESHARD_STREAM restore strips the vocab padding;
15. train-encdec: whisper-tiny, 8 x 448 tokens with 1500 frames from
   ``train/data.py``, bf16 compute, fp32 master and moments, remat full:
   6 baseline steps under data=2,model=2, 3 saved ``int8:b256`` (both
   block-quant kernels on whisper's moment shards, counted), resumed under
   data=1,model=1 (RESHARD_STREAM) and data=2,model=2 (DIRECT) with every
   shard digest checked (the vocab-padded ones of the RESHARD_STREAM
   resume, which lacks the padding rows, against the DIRECT resume), 3
   steps each, within 2e-2 of the baseline while saving;
16. the I/O line (JSON: the walls above), the kernels line (JSON: each row
   names its variants; ``ms`` is the profiler's device time per launch,
   with ``event_ms`` beside it; rows 2-3 add the general kernel's device
   time ``general_ms`` and the train phase's ``launches_by_variant`` and
   ``launches_by_phase``; the flash row adds the head-dim-256 times, bound
   and gemma3 launches (``d256_*``) and mixtral's D = 128 shape
   (``d128_*``, ``mixtral_*``) and deepseek-v2's (192, 128) shape
   (``d192_*``, ``deepseek_*``), every row its launches in the mixtral
   phases (``mixtral_launches``) and in serve-mla (``deepseek_launches``)
   and the block-quant rows the mixtral shard check
   (``mixtral_shard_*``), the dequantize row the export's launches
   ``convert_launches``; the flash and SSD rows jamba's shapes
   (``jamba_*``), every row its launches in serve-hybrid
   (``jamba_launches``) and train-ssm (``train_ssm_launches``), the
   block-quant rows the train-ssm shard's times (``train_ssm_shard_*``);
   the flash row the cross-attention shapes (``vlm_cross_*``,
   ``vlm_self_*``, ``encdec_encoder_*``, ``encdec_cross_*``,
   ``offset_causal_max_abs_err``) and the launches and prefill times of
   serve-vlm and serve-encdec (``vlm_*``, ``encdec_*``), every row its
   launches in train-encdec (``train_encdec_launches``); a
   prefill's device and kernel times are null where every profiler trace
   of it lost a record), the mixtral line (JSON), the deepseek line
   (JSON), the jamba line (JSON), the train_ssm line (JSON), the vlm and
   encdec lines (JSON), the ``hot`` line (JSON: phase 8a's walls, bytes,
   launches, losses and splits), the ``fanout`` line (JSON: phase 8b's
   syncs, stats, retained memory, serves and chaos seeds; the kernels line
   adds ``fanout_launches`` to the flash and block-quant rows) and the ``restore_split`` line (JSON: every
   weights-only DIRECT and RESHARD_STREAM restore of phases 6 and 9-14 run
   under a tracer, its ``restore.plan``, ``restore.prefetch`` (reads and
   region assembly) and ``restore.materialize`` (host-to-device copies,
   closed after a synchronize) seconds beside its wall and the phase's warm
   read floor; the block-quant rows add ``hot_launches``), the card line,
   then the result line (JSON, last).
"""

from __future__ import annotations

import filecmp
import functools
import gc
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
# Traces a device time may take: the profiler loses records now and then
# (at D = 128 an empty 20-call trace was followed by one with 3 launches).
TRACES = 5
# What device_ms timed by CUDA events because every trace lost records.
EVENT_TIMED: list[str] = []
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


def reset_launches(counters: dict) -> None:
    """Set every kernel wrapper's launch counts (total, and by dtype or by
    variant) to 0."""
    for fn in counters.values():
        fn.launches = 0
        for by in ("launches_by_dtype", "launches_by_variant"):
            if hasattr(fn, by):
                setattr(fn, by, dict.fromkeys(getattr(fn, by), 0))


def launch_counts(counters: dict) -> dict[str, int]:
    return {name: fn.launches for name, fn in counters.items()}


# One record per weights-only restore of a serve phase: the restore's wall
# split by its spans, beside the phase's read floor (the restore_split line).
RESTORE_SPLIT: list[dict] = []
SPLIT_SPANS = ("restore.plan", "restore.prefetch", "restore.materialize")


def traced_restore(torch, phase: str, mesh: str, restore):
    """Run ``restore()`` (a weights-only restore onto the card) under an obs
    tracer: its wall, and the seconds of its ``restore.plan``,
    ``restore.prefetch`` (reads, region assembly, decode) and
    ``restore.materialize`` (host-to-device copies; the span closes after a
    synchronize) spans, recorded in ``RESTORE_SPLIT``.  Returns what
    ``restore`` returns and the wall."""
    import repro_torch.obs as obs

    with obs.enabled() as tracer:
        t0 = time.perf_counter()
        out = restore()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = tracer.span_records()
    split = {name.split(".")[1] + "_s": sum(r["dur_us"] for r in spans if r["name"] == name) / 1e6
             for name in SPLIT_SPANS}
    check(split["prefetch_s"] > 0 and split["materialize_s"] > 0,
          f"{phase} {mesh}: the restore recorded no prefetch or materialize span")
    check(sum(split.values()) <= wall * 1.001,
          f"{phase} {mesh}: the split {split} exceeds the wall {wall:.3f} s")
    RESTORE_SPLIT.append(dict(phase=phase, mesh=mesh, total_s=wall, **split))
    return out, wall


def fmt_split(split: dict[str, float]) -> str:
    return ", ".join(f"{k[:-2]} {v:.3f} s" for k, v in split.items())


def note_split_floor(torch, phase: str, read_gb: float, read_s: float) -> None:
    """Put the phase's warm read floor beside its restores' split, and print
    the split of each."""
    for rec in RESTORE_SPLIT:
        if rec["phase"] == phase:
            rec.update(read_gb=read_gb, read_floor_s=read_s)
            print(f"restore_split {phase} {rec['mesh']}: plan {rec['plan_s']:.3f} s, prefetch "
                  f"(reads, assembly) {rec['prefetch_s']:.3f} s, materialize (host->device) "
                  f"{rec['materialize_s']:.3f} s, of {rec['total_s']:.3f} s; warm read floor "
                  f"{read_s:.3f} s for {read_gb:.3f} GB")


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


def device_ms(torch, fn, what: str, calls: int = 20, launches=None):
    """Device milliseconds per call of ``fn``: the profiler's device time of
    every kernel and copy that ``calls`` warm calls launched, over
    ``calls`` (so the host's enqueue time is not in it); with the top rows
    as (name, ms, count).

    ``launches``, where given, reads the launch counter of the wrapper that
    ``fn`` calls: a counter short of ``calls`` in a trace fails here (a
    launch was skipped).  The profiler loses records now and then, more
    often late in a long run: a trace with no device work, or with fewer
    than ``calls`` launches of its top kernel while the counter has them
    all, is taken again, up to ``TRACES`` traces.  If every trace lost
    records, the calls are timed with CUDA events instead (which also holds
    the gaps between launches), ``what`` is noted in ``EVENT_TIMED`` and
    the one row is ("CUDA events", ms, calls)."""
    for _ in range(3):
        fn()
    for _ in range(TRACES):
        before = launches() if launches is not None else 0
        _, busy, top = device_profile(torch, lambda: [fn() for _ in range(calls)], top=4)
        if launches is not None:
            counted = launches() - before
            check(counted == calls, f"{what}: the wrapper launched {counted} times in {calls} calls")
        if top and (launches is None or top[0][2] == calls):
            return busy / calls, top
        print(f"profiler recorded {top[0][2] if top else 0} launches of "
              f"{top[0][0][:48] if top else 'nothing'} in {calls} calls of {what}; profiling again")
    ms = cuda_ms(torch, fn, iters=calls)
    EVENT_TIMED.append(what)
    print(f"profiler lost records of {what} in each of {TRACES} traces: timed by CUDA events "
          f"instead, {ms:.5f} ms per call")
    return ms, [("CUDA events", ms * calls, calls)]


def ms_by(kernel: str) -> str:
    """How a kernel row's device times were taken: by the profiler, save
    those that :func:`device_ms` had to take by CUDA events."""
    lost = [w for w in EVENT_TIMED if w.startswith(kernel)]
    return "profiler device time per launch" + (
        f"; by CUDA events, the profiler having lost its records: {lost}" if lost else "")


def attention_bound(q, k, v, o, *, causal: bool, window: int, flops_peak: float):
    """Least time for the work: each input read once and the output written
    once at the memory rate, against the score and P·V products this run's
    mask allows at the peak rate of the inputs' type: 2·D FLOPs a pair for
    Q·Kᵀ and 2·Dv for P·V."""
    b, s, hq, d = q.shape
    dv, skv = v.shape[-1], k.shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, o))
    pairs = 0
    for i in range(s):  # row i sees columns lo..hi-1 (causal: at most i, and none past Skv)
        lo = max(0, i - window + 1) if window > 0 else 0
        hi = min(i + 1, skv) if causal else skv
        pairs += max(0, hi - lo)
    flops = 2.0 * (d + dv) * pairs * b * hq
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / flops_peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def device_profile(torch, fn, top: int = 6):
    """Run ``fn`` once under the profiler: (wall ms with the profiler on,
    device busy ms = the sum of kernel and copy times, the ``top`` rows by
    device time as (name, ms, count); all of them for ``top=None``).  Only device-side events are summed: the
    host ops that launched them carry the same time as their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    # One warm-up step, whose records are dropped: a trace that starts cold
    # loses the first device records of ``fn`` now and then (a prefill's
    # first flash launch, its first GEMM).
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    rows = []
    for e in prof.key_averages():
        # the schedule's step annotation spans the step on the device too
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not e.key.startswith("ProfilerStep")):
            rows.append((e.key, e.self_device_time_total / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return wall_ms, sum(r[1] for r in rows), rows[:top] if top is not None else rows


def profile_counted(torch, fn, counters: dict, kernel: str, want: int):
    """``device_profile(fn)`` whose trace should show ``want`` launches of
    ``kernel``'s tensor-core symbol, and whose wrapper must count ``want``
    (a wrapper short of it fails: a launch was skipped).  The profiler loses
    a record now and then — late in a long run, one record of the mixtral
    prefill's trace in most traces, while a fresh process records them all —
    so a short trace is taken again, up to ``TRACES`` traces.  If the last
    one is still short, the kernel's time and the device busy time were not
    measured: both are None.  Returns (wall ms, busy ms, all rows, the
    kernel's (key, ms, count))."""
    for _ in range(TRACES):
        reset_launches(counters)
        wall, busy, rows = device_profile(torch, fn, top=None)
        counted = counters[kernel].launches
        check(counted == want, f"{kernel}: the wrapper launched {counted} times, want {want}")
        mine = [(key, ms, n) for key, ms, n in rows if TC_SYMBOL[kernel] in key]
        if len(mine) == 1 and mine[0][2] == want:
            return wall, busy, rows, mine[0]
        print(f"profiler recorded {[(k[:40], n) for k, _, n in mine]} of {TC_SYMBOL[kernel]}, "
              f"the wrapper {counted} launches; profiling again")
    check(len(mine) <= 1 and sum(n for _, _, n in mine) < want,
          f"profiled {kernel}: {mine}, want {want} launches of one kernel")
    print(f"profiler: {TC_SYMBOL[kernel]} records short of {want} in each of {TRACES} traces; "
          f"its device time and the device busy time are not measured")
    return wall, None, rows, (TC_SYMBOL[kernel], None, want)


def fmt_ms(ms, spec: str = ".3f") -> str:
    """A device time for print: "not measured" where the trace was short."""
    return "not measured" if ms is None else f"{ms:{spec}} ms"


def profile_serving(torch, D, lm, params, prompts, counters: dict, kernel: str, want: int,
                    source_embeds=None):
    """Where the serving time goes on the device: one prefill (whose trace
    must show ``want`` launches of ``kernel``: :func:`profile_counted`) and
    16 decode steps, each under the profiler (which slows the host, so the
    idle shares are upper bounds).  Returns {phase: (wall ms, busy ms, top
    rows)} and the prefill's kernel row (key, ms, count)."""
    b, s = prompts.shape
    with torch.inference_mode():
        cache = D.init_cache(lm, b, s + 17, device=prompts.device)
        cur = prompts[:, -1:].clone()
        out = {}
        wall, busy, rows, mine = profile_counted(
            torch, lambda: D.prefill(lm, params, cache, prompts, source_embeds=source_embeds),
            counters, kernel, want)
        out["prefill"] = (wall, busy, rows)
        out["decode x16"] = device_profile(
            torch, lambda: [D.decode_step(lm, params, cache, cur) for _ in range(16)], top=None)
        for name, (wall, busy, rows) in out.items():
            idle = "not measured" if busy is None else f"{max(0.0, 1 - busy / wall):.3f}"
            print(f"profile {name}: wall {wall:.2f} ms (profiler on), device busy "
                  f"{fmt_ms(busy, '.2f')}, idle share {idle}")
            for key, ms, count in rows[:6]:
                print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    return out, mine


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
        per_call, top = device_ms(torch, runs[name], f"flash_attention_fwd {name}",
                                  launches=None if name == "library"
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
    d256 = head_layout(torch, F, kernel, ops, ref, hq=16, hkv=8, d=256, long=(1, 2048, 1024),
                       label="gemma3-12b")
    d128 = head_layout(torch, F, kernel, ops, ref, hq=48, hkv=8, d=128, long=(1, 8192, 4096),
                       label="mixtral-8x22b")
    d192 = head_layout(torch, F, kernel, ops, ref, hq=128, hkv=128, d=192, dv=128, long=None,
                       label="deepseek-v2-236b MLA")
    jamba = head_layout(torch, F, kernel, ops, ref, hq=64, hkv=8, d=128, long=None,
                        label="jamba-1.5-large-398b")
    # cross-attention: k and v of their own length, with no mask
    vlm_cross = head_layout(torch, F, kernel, ops, ref, hq=32, hkv=8, d=128, long=None,
                            s=512, skv=1600, causal=False, label="llama-3.2-vision-11b cross")
    vlm_self = head_layout(torch, F, kernel, ops, ref, hq=32, hkv=8, d=128, long=None,
                           label="llama-3.2-vision-11b self")
    enc = head_layout(torch, F, kernel, ops, ref, hq=6, hkv=6, d=64, long=None, s=1500,
                      causal=False, label="whisper-tiny encoder")
    enc_self = head_layout(torch, F, kernel, ops, ref, hq=6, hkv=6, d=64, long=None, s=432,
                           label="whisper-tiny self")
    enc_cross = head_layout(torch, F, kernel, ops, ref, hq=6, hkv=6, d=64, long=None, s=432,
                            skv=1500, causal=False, label="whisper-tiny cross")
    offset = offset_causal_rows(torch, kernel, ref)
    return dict(ms=ms, event_ms=event_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=worst,
                d256=d256, d128=d128, d192=d192, jamba=jamba, vlm_cross=vlm_cross,
                vlm_self=vlm_self, encdec_encoder=enc, encdec_self=enc_self,
                encdec_cross=enc_cross,
                offset_causal=offset)


def offset_causal_rows(torch, kernel, ref) -> dict:
    """Causal launches at Sq != Skv (row i sees keys 0..i, the reference's
    mask; rows past Skv see every key), both kernels against the plain
    version only: 512 queries against 1600 keys and 1600 against 512, 8:2
    heads of 128, B=2."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for sq, skv in ((512, 1600), (1600, 512)):
            q, k, v = (torch.randn(2, n, h, 128, generator=g, device=dev).to(dtype)
                       for n, h in ((sq, 8), (skv, 2), (skv, 2)))
            out = kernel.flash_attention_fwd(q, k, v, causal=True, window=0, scale=128 ** -0.5)
            plain = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                      causal=True, scale=128 ** -0.5).transpose(1, 2)
            torch.cuda.synchronize()
            atol, rtol = TOL[name]
            diff = (out.float() - plain.float()).abs()
            err = diff.max().item()
            ok = bool(torch.isfinite(out.float()).all()) and bool(
                (diff <= atol + rtol * plain.float().abs()).all())
            print(f"kernel {name} B=2 Sq={sq} Skv={skv} 8:2 heads of 128 causal: max_abs_err "
                  f"{err:.3e} (tolerance atol {atol} rtol {rtol}) {'ok' if ok else 'FAIL'}")
            check(ok, f"{name} causal Sq={sq} Skv={skv}: kernel disagrees with its plain version")
            worst[f"{name} {sq}x{skv}"] = err
    return worst


def sdpa_backend(torch, F, qt, kt, vt, scale: float):
    """The first fused ``scaled_dot_product_attention`` backend (cuDNN,
    flash, memory-efficient) that takes these inputs, as (name, a call
    pinned to it), and each backend's reason where it refused them (PyTorch
    warns why, then raises).  A yardstick only: the port never calls it."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    reasons = {}
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        def call(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale)

        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            try:
                call()
                torch.cuda.synchronize()
                return backend.name, call, reasons
            except RuntimeError as e:
                why = [str(w.message).splitlines()[0] for w in seen] or [str(e).splitlines()[0]]
                reasons[backend.name] = "; ".join(why)[:300]
    return None, None, reasons


def head_layout(torch, F, kernel, ops, ref, *, hq: int, hkv: int, d: int, long: tuple | None,
                label: str, dv: int | None = None, s: int = 512, skv: int | None = None,
                causal: bool = True):
    """One model's attention shapes (``hq``:``hkv`` heads, q and k of ``d``,
    v of ``dv``, default ``d``; ``s`` queries against ``skv`` keys, default
    ``s``; ``causal`` or with no mask): both kernels against the plain
    version at B=4 and at ``long`` = (B, S, window) with the model's
    sliding window, where it has one; then the bf16 kernel's device time at
    B=4 beside the library's and the bound.  gemma3-12b: 16:8 heads of 256,
    window 1024 at S=2048; mixtral-8x22b: 48:8 heads of 128, window 4096 at
    S=8192; deepseek-v2: 128:128 heads, D = 192 and Dv = 128, no window;
    llama-vision's cross layer 512 x 1600 and whisper's encoder 1500 x 1500
    and cross layers 432 x 1500, with no mask; whisper's decoder 432 x 432,
    causal.  Where Dv != D, the library
    is the first fused backend of ``scaled_dot_product_attention`` that
    takes the inputs (:func:`sdpa_backend`), checked against the kernel;
    None, with PyTorch's reasons, where none does."""
    dv = dv or d
    skv = skv or s
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(d + dv + s + skv)
    scale = d ** -0.5
    mask = "causal" if causal else "no mask"
    cases = [(dtype, b, sq, window) for dtype in (torch.bfloat16, torch.float32)
             for b, sq, window in ((4, s, 0),) + ((long,) if long else ())]
    worst, main = 0.0, None
    for dtype, b, sq, window in cases:
        sk = skv if sq == s else sq
        tag = (f"D={d} Dv={dv} {str(dtype).split('.')[1]} B={b} Sq={sq} Skv={sk} {hq}:{hkv} "
               f"{mask} window={window}")
        q, k, v = (torch.randn(b, n, h, w, generator=g, device=dev).to(dtype)
                   for n, h, w in ((sq, hq, d), (sk, hkv, d), (sk, hkv, dv)))
        out = kernel.flash_attention_fwd(q, k, v, causal=causal, window=window, scale=scale)
        plain = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=causal, window=window, scale=scale).transpose(1, 2)
        torch.cuda.synchronize()
        atol, rtol = TOL[str(dtype).split(".")[1]]
        diff = (out.float() - plain.float()).abs()
        err = diff.max().item()
        ok = bool(torch.isfinite(out.float()).all()) and bool((diff <= atol + rtol * plain.float().abs()).all())
        print(f"kernel {tag}: max_abs_err {err:.3e} (tolerance atol {atol} rtol {rtol}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{tag}: kernel disagrees with its plain version")
        del plain, diff
        if dtype == torch.bfloat16:
            worst = max(worst, err)
            if main is None:
                main = (q, k, v, out)
    q, k, v, out = main
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    q32, k32, v32 = (t.float() for t in (q, k, v))
    runs = {
        "kernel": lambda: ops.flash_attention(q, k, v, causal=causal, window=0, scale=scale),
        "fp32": lambda: ops.flash_attention(q32, k32, v32, causal=causal, window=0, scale=scale),
        "plain": lambda: ref.attention_ref(qt, kt, vt, causal=causal, scale=scale),
        "library": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=True),
    }
    backend, reasons = "default dispatch", {}
    if dv != d:
        backend, runs["library"], reasons = sdpa_backend(torch, F, qt, kt, vt, scale)
        print(f"library for D={d} Dv={dv}: {backend or 'none'}; refused: {reasons}")
        if backend is None:
            del runs["library"]
        else:
            lib = runs["library"]().transpose(1, 2).float()
            atol, rtol = TOL["bfloat16"]
            lib_err = (lib - out.float()).abs().max().item()
            check(bool(((lib - out.float()).abs() <= atol + rtol * lib.abs()).all()),
                  f"D={d} Dv={dv}: the kernel and {backend} disagree ({lib_err:.3e})")
            print(f"library {backend} agrees with the kernel to {lib_err:.3e} (tolerance atol "
                  f"{atol} rtol {rtol})")
            del lib
    plain_ms = sum(cuda_ms(torch, runs["plain"], iters=20) for _ in range(2)) / 2
    event_ms = cuda_ms(torch, runs["kernel"], iters=20)
    device: dict[str, list[float]] = {"kernel": [], "library": [], "fp32": []}
    order = ("kernel", "library", "fp32", "fp32", "library", "kernel")
    for name in (n for n in order if n in runs):
        per_call, top = device_ms(torch, runs[name], f"flash_attention_fwd D={d} {label} {name}",
                                  launches=None if name == "library"
                                  else lambda: ops.flash_attention.launches)
        device[name].append(per_call)
        if name != "library":
            check(top[0][2] == 20, f"flash D={d} {name}: {top[0][2]} launches of {top[0][0]} in 20 calls")
        print(f"kernel flash_attention D={d} {name} device time (profiler): {per_call:.5f} ms per "
              "call; " + "; ".join(f"{key[:48]} x{count} {t:.3f} ms" for key, t, count in top))
    ms = {n: sum(t) / len(t) if t else None for n, t in device.items()}
    bound_ms, bound_by, nbytes, flops = attention_bound(
        q, k, v, out, causal=causal, window=0, flops_peak=PEAK_BF16_FLOPS)
    print(f"kernel bf16 B=4 Sq={s} Skv={skv} Hq={hq} Hkv={hkv} D={d} Dv={dv} {mask} ({label}): device ms "
          f"{ms['kernel']:.5f} (event {event_ms:.5f}) library ({backend}) device ms "
          f"{fmt_ms(ms['library'], '.5f')} fp32 kernel device ms {ms['fp32']:.5f} plain_ms "
          f"{plain_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by}; {nbytes / 1e6:.2f} MB is "
          f"{nbytes / PEAK_BYTES_PER_S * 1e3:.5f} ms, {flops / 1e9:.3f} GFLOP is "
          f"{flops / PEAK_BF16_FLOPS * 1e3:.5f} ms); {bound_ms / ms['kernel']:.3f} of the bound")
    return dict(ms=ms["kernel"], event_ms=event_ms, library_ms=ms["library"],
                library_backend=backend, library_refused=reasons, fp32_ms=ms["fp32"],
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=worst)


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
        per_call, top = device_ms(torch, runs[name], f"ssd_scan_fwd {name}",
                                  launches=lambda: ssd_ops.ssd_scan.launches)
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


def ssd_layout(torch, F, ssd_ops, ssd_ref, shape: tuple, chunk: int, label: str):
    """One model's SSD shapes (``shape`` = (B, S, H, P, G, N)): both
    kernels against ``ssd_chunked`` and against ``ssd_ref`` in float64 (bf16
    at B, fp32 at B = 1), each within the tolerances of
    ``tests/test_kernels.py``; then the bf16 kernel's device and event
    times at B beside the fp32 kernel's device time, ``ssd_chunked``'s event
    time and the bound.  jamba-1.5-large-398b: H = 128, P = 128 (two column
    tiles a head), N = 128, G = 1, chunk 256."""
    from repro_torch.models.common import ParamDef, ParamRegistry
    from repro_torch.models.ssm import ssd_chunked

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    b, s, h, p, groups, n = shape
    dt_bias = ParamRegistry([ParamDef("dt_bias", (h,), ("ssm_heads",), init="ssm_dt")]).init(g)
    a = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)  # the ssm_alog init: A = -(1..H)
    worst, main = 0.0, None
    for dtype, bsz in ((torch.bfloat16, b), (torch.float32, 1)):
        x = torch.randn(bsz, s, h, p, generator=g, device=dev).to(dtype)
        dt = F.softplus(torch.randn(bsz, s, h, generator=g, device=dev) + dt_bias["dt_bias"])
        bm, cm = (torch.randn(bsz, s, groups, n, generator=g, device=dev).to(dtype) for _ in "bc")
        y, hT = ssd_ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk)
        rep = h // groups
        y64, h64 = ssd_ref.ssd_ref(
            *(t.double().transpose(1, 2) for t in (x, dt)), a.double(),
            *(t.double().repeat_interleave(rep, 2).transpose(1, 2) for t in (bm, cm)))
        plains = {"ssd_chunked": ssd_chunked(x, dt, a, bm, cm, chunk=chunk),
                  "ssd_ref float64": (y64.transpose(1, 2), h64)}
        torch.cuda.synchronize()
        tag = f"{str(dtype).removeprefix('torch.')} B={bsz} S={s} H={h} P={p} G={groups} N={n} chunk {chunk}"
        check(bool(torch.isfinite(y.float()).all() and torch.isfinite(hT).all()),
              f"ssd {tag}: non-finite output")
        atol, rtol = SSD_TOL[str(dtype).removeprefix("torch.")]
        for name, (py, ph) in plains.items():
            dy = (y.double() - py.double()).abs()
            dh = (hT.double() - ph.double()).abs()
            ey, eh = dy.max().item(), dh.max().item()
            ok = (bool((dy <= atol + rtol * py.double().abs()).all())
                  and bool((dh <= SSD_H_TOL[0] + SSD_H_TOL[1] * ph.double().abs()).all()))
            print(f"kernel ssd_scan {tag} ({label}) vs {name}: y max_abs_err {ey:.3e} (atol "
                  f"{atol} rtol {rtol}), h_final max_abs_err {eh:.3e} (atol/rtol {SSD_H_TOL[0]}) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"ssd {tag}: kernel disagrees with {name}")
            if dtype == torch.bfloat16:
                worst = max(worst, ey)
        del plains, y64, h64
        if main is None:
            main = (x, dt, bm, cm, y, hT)
    x, dt, bm, cm, y, hT = main
    x32, b32, c32 = (t.float() for t in (x, bm, cm))
    runs = {
        "kernel": lambda: ssd_ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk),
        "fp32": lambda: ssd_ops.ssd_scan(x32, dt, a, b32, c32, chunk=chunk),
        "plain": lambda: ssd_chunked(x, dt, a, bm, cm, chunk=chunk),
    }
    plain_ms = sum(cuda_ms(torch, runs["plain"], iters=10) for _ in range(2)) / 2
    event_ms = cuda_ms(torch, runs["kernel"], iters=20)
    device: dict[str, list[float]] = {"kernel": [], "fp32": []}
    for name in ("kernel", "fp32", "fp32", "kernel"):
        per_call, top = device_ms(torch, runs[name], f"ssd_scan_fwd {label} {name}",
                                  launches=lambda: ssd_ops.ssd_scan.launches)
        device[name].append(per_call)
        check(top[0][2] == 20, f"ssd {label} {name}: {top[0][2]} launches of {top[0][0]} in 20 calls")
        print(f"kernel ssd_scan {label} {name} device time (profiler): {per_call:.5f} ms per call; "
              + "; ".join(f"{key[:48]} x{count} {t:.3f} ms" for key, t, count in top))
    ms = {k: sum(v) / len(v) for k, v in device.items()}
    bound_ms, bound_by, nbytes, flops = ssd_bound(x, bm, cm, y, hT, dt, a, chunk,
                                                  flops_peak=PEAK_BF16_FLOPS)
    print(f"kernel ssd_scan bf16 B={b} S={s} H={h} P={p} G={groups} N={n} chunk {chunk} ({label}): "
          f"device ms {ms['kernel']:.5f} (event {event_ms:.5f}) fp32 kernel device ms "
          f"{ms['fp32']:.5f} plain_ms {plain_ms:.4f} (ssd_chunked) bound_ms {bound_ms:.5f} "
          f"({bound_by}; {nbytes / 1e6:.2f} MB is {nbytes / PEAK_BYTES_PER_S * 1e3:.5f} ms, "
          f"{flops / 1e9:.3f} GFLOP in the causal triangle is "
          f"{flops / PEAK_BF16_FLOPS * 1e3:.5f} ms); {bound_ms / ms['kernel']:.3f} of the bound; "
          "library_ms None (no single PyTorch call)")
    return dict(ms=ms["kernel"], event_ms=event_ms, fp32_ms=ms["fp32"], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=worst)


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

    reset = functools.partial(reset_launches, counters)
    counts = functools.partial(launch_counts, counters)

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
            (flat, rp), restore_s = traced_restore(
                torch, arch, mesh_str, lambda: restore_params(step_dir, tplan, dev))
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
                ((name, want),) = ((n, w) for n, w in per_prefill.items() if w)
                prof, (key, ms, n) = profile_serving(torch, D, tlm, params_c, prompts,
                                                     counters, name, want)
                busy = prof["prefill"][1]
                share = "" if ms is None else f" ({ms / busy:.3f} of it)"
                print(f"serve {arch} prefill device time {fmt_ms(busy)}; {key[:48]} "
                      f"{fmt_ms(ms)} over {n} launches{share}")
                runs[mesh_str].update(prefill_device_ms=busy, prefill_kernel_ms=ms)
            del params_c
        a, b = runs["data=1,model=1"]["seq"], runs["data=2,model=2"]["seq"]
        check(torch.equal(a, b), "RESHARD_STREAM and DIRECT restores serve different tokens")
        print(f"serve {arch} tokens identical across restores; sample {a[0, :8].tolist()}")
        _, read_gb, read_s = fp32_read_floor(step_dir, width)
        note_split_floor(torch, arch, read_gb, read_s)
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
    reset_launches({"flash_attention": flash})
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
    wall, busy, rows, row = profile_counted(torch, prefill, {"flash_attention": flash},
                                            "flash_attention", layers)
    mine = [row]
    print(f"gemma3 prefill 4x512 bf16: {prefill_ms:.2f} ms of wall, flash launches {launches} "
          f"{by_dtype}; profiled: device busy {fmt_ms(busy)} (wall {wall:.2f} ms with the "
          f"profiler on), {mine[0][0][:40]} {fmt_ms(mine[0][1])} over {mine[0][2]} launches")
    for key, ms, count in rows[:6]:
        print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    del params_c, logits

    # Right by the repo's own means: the card's fp32 path against the CPU's.
    flm = build_model(cfg, compute_dtype=torch.float32)
    toks = prompts[:1, :cpu_len]
    with torch.inference_mode():
        reset_launches({"flash_attention": flash})
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
            per_call, top = device_ms(torch, fns[which], f"{name} {which}",
                                      launches=lambda: wrapper.launches)
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
    from repro_torch.core.patterns import StateKind
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
            n_checked, _ = digests_match(torch, {StateKind.EXP_AVG: state.exp_avg,
                                                 StateKind.EXP_AVG_SQ: state.exp_avg_sq},
                                         src_plan, manifest, width)
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


# ---------------------------------------------------------------------------
# mixtral-8x22b (the MoE slice)
# ---------------------------------------------------------------------------

MIXTRAL_PARAMS = {2: 5_410_781_184, 1: 2_906_720_256}  # at full width, by depth


def hot_phase(torch, bq_ops) -> dict:
    """The hot in-memory tier at the full width and depth of smollm-360m
    (362 M params, 4.34 GB of fp32 state), under one obs tracer: 4 steps
    under data=2,model=2 with ``hot_interval=2, disk_interval=4`` and
    ``int8:b256`` moments (step 2 a capture, step 4 a capture and a coded
    drain on the card); the uninterrupted run's steps 5-6; then one rank
    lost whose buddy holds its fragments: HOT_DIRECT under data=2,model=2
    and HOT_RESHARD under the mesh ``rebuild_on`` proposes for one device
    (data=1,model=1: ``wqkv`` and both moments consolidated in memory),
    each bit-equal to the captured step-4 state with no checkpoint file
    opened; then the whole buddy group lost: no hot plan
    (``restore.hot_skip``), and ``restore_latest`` falls through to
    RESHARD_STREAM from the drained coded step.  2 steps after each resume
    (finite; after HOT_DIRECT the uninterrupted run's losses).  The trace is
    exported and validated.  Returns the phase's record."""
    import repro_torch.core.dist_ckpt as dist_ckpt
    import repro_torch.obs as obs
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config
    from repro_torch.core.engine import default_workers
    from repro_torch.core.patterns import StateKind
    from repro_torch.core.plan import ResumeMode, TargetSpec
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.elastic import ElasticEvent, hot_recover, rebuild_on
    from repro_torch.hot import plan_hot_recovery
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    cfg, tcfg, parallel = get_config("smollm-360m"), TrainConfig(seed=0), ParallelismConfig()
    root = ROOT / "build" / "chip_smoke_hot"
    shutil.rmtree(root, ignore_errors=True)
    phases = PhaseLaunches(bq_ops)
    opened: list = []
    real_open = dist_ckpt.DistCheckpoint.open.__func__

    def spy_open(cls, path):
        opened.append(path)
        return real_open(cls, path)

    def losses(hist, what):
        out = [h["loss"] for h in hist]
        check(all(map(math.isfinite, out)), f"hot: {what} losses {out} not finite")
        return out

    def hot_restore(what, fn):
        """A hot restore with DistCheckpoint.open spied on and the handle
        cache's misses counted: neither may move."""
        n_open, misses = len(opened), tracer.counters().get("engine.handle.miss", 0)
        dist_ckpt.DistCheckpoint.open = classmethod(spy_open)
        try:
            state, info = fn()
        finally:
            dist_ckpt.DistCheckpoint.open = classmethod(real_open)
        check(len(opened) == n_open and tracer.counters().get("engine.handle.miss", 0) == misses,
              f"hot: {what} opened {opened[n_open:]} (handle misses "
              f"{tracer.counters().get('engine.handle.miss', 0) - misses})")
        return state, info

    def spans_since(n: int, name: str) -> list[dict]:
        return [r for r in tracer.span_records()[n:] if r["name"] == name]

    def split_since(n: int) -> dict[str, float]:
        """The seconds of a restore's spans recorded since ``n`` spans."""
        return {name.split(".")[1] + "_s": sum(r["dur_us"] for r in spans_since(n, name)) / 1e6
                for name in SPLIT_SPANS}

    out: dict = {}
    try:
        with obs.enabled() as tracer:
            # a ring budget that holds both snapshots (resident bytes count
            # each fragment once per holder)
            policy = CheckpointPolicy(hot_interval=2, disk_interval=4, codec="int8:b256",
                                      hot_replication=1, hot_max_snapshots=2,
                                      hot_max_bytes=64 << 30)
            run = Trainer.create(cfg, parallel, tcfg, mesh_spec_from_string("data=2,model=2"),
                                 batch_size=8, seq_len=512, ckpt_dir=str(root / "ck"),
                                 policy=policy, device=dev)
            mgr = run.manager
            mark = phases.mark()
            state4, hist = run.run(run.init_state(), 0, 4)
            quant, dequant = phases.since("hot: 4 steps, captures at 2 and 4, drain of 4", mark)
            first = losses(hist, "steps 1-4")
            check(mgr.steps() == [4], f"hot: committed steps {mgr.steps()}, want [4]")
            check([s.step for s in mgr.hot.snapshots()] == [2, 4],
                  f"hot: ring {[s.step for s in mgr.hot.snapshots()]}, want [2, 4]")
            manifest = dist_ckpt.DistCheckpoint.open(mgr.step_dir(4)).manifest
            n_coded = len(manifest.shard_codecs)
            check(n_coded > 0 and quant == n_coded and dequant == n_coded,
                  f"hot: drain {quant} quantize, {dequant} dequantize launches, want {n_coded} "
                  "each (encode on the card, then the served digest's decode)")
            (drain,) = run.save_results
            # per hot step: the device->host snapshot (save.stage), then the
            # slices, digests and holders into the ring (hot.capture)
            stages, captures = ([r["dur_us"] / 1e6 for r in tracer.span_records()
                                 if r["name"] == name] for name in ("save.stage", "hot.capture"))
            resident = mgr.hot.resident_nbytes
            stored = sum(s.stored_nbytes for s in mgr.hot.snapshots())
            print(f"hot smollm-360m 32 layers, data=2,model=2, 8x512: steps 1-4 losses "
                  f"{[round(v, 4) for v in first]}; captures at 2 and 4: device->host snapshot "
                  f"{', '.join(f'{c:.2f}' for c in stages)} s, then into the ring "
                  f"{', '.join(f'{c:.2f}' for c in captures)} s (ring {stored / 1e9:.3f} GB stored, "
                  f"{resident / 1e9:.3f} GB resident over the holders); drain of step 4 "
                  f"{drain.bytes_written / 1e9:.3f} GB in {drain.shards_written} shards, "
                  f"{drain.wall_time_s:.2f} s, coded {drain.coded_bytes / 1e9:.3f} of "
                  f"{drain.coded_raw_bytes / 1e9:.3f} GB; {quant} quantize and {dequant} "
                  f"dequantize launches ({n_coded} coded shards)")
            want = [flatten_with_paths(t) for t in (state4.params, state4.exp_avg,
                                                    state4.exp_avg_sq)]
            plain = Trainer.create(cfg, parallel, tcfg, mesh_spec_from_string("data=2,model=2"),
                                   batch_size=8, seq_len=512, device=dev)
            _, hist = plain.run(state4, 4, 2)
            uninterrupted = losses(hist, "uninterrupted steps 5-6")

            # one rank lost, its buddy alive: HOT_DIRECT, then HOT_RESHARD
            mark = phases.mark()
            n_spans = len(tracer.span_records())
            state, info = hot_restore("HOT_DIRECT", lambda: hot_recover(
                mgr, ElasticEvent(3, "failure", (1,)), dev))
            direct_split = split_since(n_spans)
            check(info.mode is ResumeMode.HOT_DIRECT and info.step == 4 and state.step == 4,
                  f"hot: rank 1 lost: {info.mode.value} step {info.step}, want hot_direct 4")
            check(same_state(torch, state, want), "hot: HOT_DIRECT differs from the captured state")
            direct_s = info.wall_time_s
            _, hist = plain.run(state, 4, 2)
            after_direct = losses(hist, "HOT_DIRECT steps 5-6")
            gap = max(abs(a - b) for a, b in zip(after_direct, uninterrupted))
            check(gap <= 1e-5, f"hot: HOT_DIRECT steps 5-6 {after_direct} vs uninterrupted "
                  f"{uninterrupted}")
            del state
            one = rebuild_on(ElasticEvent(1, "failure"), cfg, parallel, tcfg, batch_size=8,
                             seq_len=512, ckpt_dir=str(root / "one"), device=dev)
            check(one.mesh == mesh_spec_from_string("data=1,model=1"),
                  f"hot: rebuild_on proposed {one.mesh} for one device")
            n_spans = len(tracer.span_records())
            state, info = hot_restore("HOT_RESHARD", lambda: hot_recover(
                mgr, ElasticEvent(1, "failure"), dev, target_plan=one.plan))
            check(info.mode is ResumeMode.HOT_RESHARD and info.step == 4,
                  f"hot: under data=1,model=1 {info.mode.value}, want hot_reshard")
            reshard_split = split_since(n_spans)
            check(same_state(torch, state, want), "hot: HOT_RESHARD differs from the captured state")
            fused = [n for n in one.plan.param_specs if n.endswith("wqkv")]
            merged = [r["attrs"]["param"] for r in spans_since(n_spans, "restore.consolidate")]
            check(fused and sorted(merged) == sorted(fused * 3),
                  f"hot: HOT_RESHARD consolidated {sorted(set(merged))}, want {fused} in all "
                  "three kinds")
            reshard_s = info.wall_time_s
            _, hist = one.run(state, 4, 2)
            after_reshard = losses(hist, "HOT_RESHARD steps 5-6")
            reshard_gap = max(abs(a - b) for a, b in zip(after_reshard, uninterrupted))
            del state
            _, hot_d = phases.since("hot: HOT_DIRECT and HOT_RESHARD", mark)
            check(hot_d == 0, f"hot: {hot_d} dequantize launches in the hot restores (raw memory)")
            print(f"hot rank 1 lost (buddy 0 holds its fragments): HOT_DIRECT data=2,model=2 in "
                  f"{direct_s:.2f} s ({fmt_split(direct_split)}), HOT_RESHARD data=1,model=1 "
                  f"({fmt_split(reshard_split)}; rebuild_on's mesh for one "
                  f"device; {fused} consolidated in all three kinds) in {reshard_s:.2f} s; both "
                  f"bit-equal to the captured step 4, no checkpoint file opened; steps 5-6 after "
                  f"HOT_DIRECT {after_direct} (uninterrupted {uninterrupted}, max gap {gap:.2e}), "
                  f"after HOT_RESHARD {after_reshard} (max gap {reshard_gap:.2e})")

            # the whole buddy group {0, 1} lost: disk, from the drained coded step
            n_events = len(tracer.event_records())
            mgr.hot.fail_ranks({0})
            target = TargetSpec(one.plan.mesh, one.plan.param_specs)
            check(plan_hot_recovery(mgr.hot, target, min_step=mgr.latest_step()) is None,
                  "hot: a plan from snapshots that lost a whole buddy group")
            skipped = [e["attrs"]["step"] for e in tracer.event_records()[n_events:]
                       if e["name"] == "restore.hot_skip"]
            check(skipped == [4], f"hot: restore.hot_skip for steps {skipped}, want [4]")
            mark = phases.mark()
            n_spans = len(tracer.span_records())
            state, info = mgr.restore_latest(dev, target_plan=one.plan)
            fall_split = split_since(n_spans)
            _, fall_d = phases.since("hot: fall-through RESHARD_STREAM from the drained step", mark)
            check(info.mode is ResumeMode.RESHARD_STREAM and info.step == 4,
                  f"hot: fall-through {info.mode.value} step {info.step}, want reshard_stream 4")
            check(fall_d == n_coded, f"hot: fall-through {fall_d} dequantize launches, "
                  f"want {n_coded}")
            for name, t in flatten_with_paths(state.params).items():
                check(torch.equal(t, want[0][name]), f"hot: fall-through {name} differs")
            n_checked, _ = digests_match(torch, {StateKind.EXP_AVG: state.exp_avg,
                                                 StateKind.EXP_AVG_SQ: state.exp_avg_sq},
                                         mgr.plan, manifest, default_workers())
            check(n_checked == n_coded, f"hot: {n_checked} of {n_coded} served digests checked")
            fall_s = info.wall_time_s
            _, hist = one.run(state, 4, 2)
            after_fall = losses(hist, "fall-through steps 5-6")
            del state
            print(f"hot buddy group {{0, 1}} lost: no hot plan (restore.hot_skip at step 4), "
                  f"RESHARD_STREAM from the drained step 4 in {fall_s:.2f} s "
                  f"({fmt_split(fall_split)}) with {fall_d} "
                  f"dequantize launches, params bit-equal, {n_checked} moment shards equal to "
                  f"the served view; steps 5-6 {after_fall}")
            mgr.close()
            one.manager.close()
            trace = obs.write_chrome_trace(root / "trace.json", tracer)
        doc = json.loads(trace.read_text())
        n_complete = obs.validate_chrome_trace(doc)
        counters = doc["otherData"]["counters"]
        check(counters.get("hot.captures") == 2 and counters.get("restore.count") == 3,
              f"hot: trace counters {counters}")
        out = dict(snapshot_s=stages, capture_s=captures, stored_gb=stored / 1e9,
                   resident_gb=resident / 1e9,
                   hot_direct_s=direct_s, hot_reshard_s=reshard_s, hot_direct_split=direct_split,
                   hot_reshard_split=reshard_split, fall_through_split=fall_split,
                   drain_s=drain.wall_time_s,
                   drain_gb=drain.bytes_written / 1e9, quantize=quant, dequantize=dequant,
                   fall_through=info.mode.value, fall_through_s=fall_s,
                   fall_through_dequantize=fall_d, hot_direct_loss_gap=gap,
                   hot_reshard_loss_gap=reshard_gap, trace_spans=n_complete,
                   trace_events=len(doc["traceEvents"]), losses=dict(
                       first=first, uninterrupted=uninterrupted, hot_direct=after_direct,
                       hot_reshard=after_reshard, fall_through=after_fall),
                   launches_by_phase=phases.by_phase)
        print(f"hot trace: {n_complete} spans validate ({len(doc['traceEvents'])} events), "
              f"{trace.stat().st_size / 1e6:.2f} MB")
    finally:
        dist_ckpt.DistCheckpoint.open = classmethod(real_open)
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


FANOUT_REPLICAS = 8


def card_bytes(torch, value) -> int:
    """Bytes of the card tensors in a cache entry (a tensor or a mapping)."""
    if isinstance(value, dict):
        return sum(card_bytes(torch, v) for v in value.values())
    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        return value.numel() * value.element_size()
    return 0


def fanout_phase(torch, bq_ops, counters) -> dict:
    """Fan-out on full smollm-360m: a publisher trains under data=2,model=2
    with ``CheckpointPolicy(codec="int8:b256", save_interval=2, keep_last=1,
    registry=...)`` and publishes each commit; a fleet of 8 replicas under
    data=1,model=1 (RESHARD_STREAM, ``wqkv`` consolidated), sharing one card
    engine and syncing from threads, restores it through digest-checked
    peer reads, bit-equal to a direct restore, with each fp32 shard read
    from disk once; 2 independent readers restore the same step for
    comparison; replicas 0 and 7 serve 4 x 512 through the flash kernel (32
    launches a prefill), with the tokens of a direct-restore serve; seq 2
    (every weight changed) and seq 3 (``final_norm`` alone) update the
    fleet in place, the card memory it keeps measured after each; a corrupt
    peer is caught and fetched again; one sync is traced; and the chaos
    sweep runs 3 seeds with the harness's state on the card, each the CPU
    run's schedule.  Returns the phase's record."""
    import dataclasses

    import repro_torch.obs as obs
    from repro_torch.chaos.sweep import run_seed, sweep
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.ckpt.restore import params_from_source
    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config
    from repro_torch.core.dist_ckpt import DistCheckpoint
    from repro_torch.core.engine import CheckpointEngine
    from repro_torch.core.plan import TargetSpec, stream_transforms
    from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths
    from repro_torch.dist.sharding import make_plan, vocab_multiple
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.launch.serve import generate, restore_params, serving_parallelism
    from repro_torch.models import build_model
    from repro_torch.serve import FanoutStats, FleetReplica, PublicationRegistry
    from repro_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    cfg, tcfg, parallel = get_config("smollm-360m"), TrainConfig(seed=0), ParallelismConfig()
    root = ROOT / "build" / "chip_smoke_fanout"
    shutil.rmtree(root, ignore_errors=True)
    phases = PhaseLaunches(bq_ops)
    mesh11 = mesh_spec_from_string("data=1,model=1")
    spar = serving_parallelism(mesh11)
    lm = build_model(cfg, vocab_multiple=vocab_multiple(spar, mesh11), compute_dtype=torch.bfloat16)
    plan = make_plan(cfg, lm.registry, spar, mesh11)
    registry = PublicationRegistry(name="fanout")
    stats = FanoutStats()
    engine = CheckpointEngine(dev)
    prompts = torch.randint(0, cfg.vocab_size, (4, 512),
                            generator=torch.Generator().manual_seed(1)).to(dev)
    per_prefill = {"flash_attention": 32, "ssd_scan": 0}
    reset = functools.partial(reset_launches, counters)
    counts = functools.partial(launch_counts, counters)
    out: dict = {"replicas": FANOUT_REPLICAS}

    def direct(step):
        """params_from_source of the step's directory on the card, through a
        private engine: a reader of its own.  Returns the weights and the
        wall."""
        ckpt = DistCheckpoint.open(mgr.step_dir(step))
        tr = stream_transforms(ckpt.manifest, TargetSpec(plan.mesh, plan.param_specs))
        t0 = time.perf_counter()
        with CheckpointEngine(dev) as private:
            flat = params_from_source(ckpt, plan, dev, transforms=tr, engine=private)
            torch.cuda.synchronize()
        return flat, time.perf_counter() - t0

    def same_as(reps, want, what):
        for r in reps:
            got = r.flat_params()
            check(got.keys() == want.keys(), f"fanout: {what}: {r.name}'s parameter set differs")
            for name, t in got.items():
                check(torch.equal(t, want[name]), f"fanout: {what}: {r.name} {name} differs")

    def fleet_sync(label, reps):
        mark = phases.mark()
        before = stats.as_dict()
        errs: list = []

        def one(r):
            try:
                check(r.sync(), f"fanout: {label}: {r.name} had no publication")
            except BaseException as e:  # surfaced below, on the main thread
                errs.append(e)

        threads = [threading.Thread(target=one, args=(r,), name=f"replica-{r.name}") for r in reps]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), f"fanout: {label}: a sync hung")
        if errs:
            raise errs[0]
        quant, dequant = phases.since(f"fanout: {label}", mark)
        check(quant == dequant == 0, f"fanout: {label}: {quant} quantize and {dequant} "
              "dequantize launches (a weights-only fleet reads raw fp32 shards on the host)")
        now = stats.as_dict()
        return wall, {k: now[k] - before[k] for k in now}

    def retained(label):
        gc.collect()
        torch.cuda.synchronize()
        got = dict(fleet_gb=(torch.cuda.memory_allocated() - base) / 1e9,
                   engine_card_gb=sum(card_bytes(torch, v) for v in
                                      list(engine.atoms._entries.values())) / 1e9)
        check(got["fleet_gb"] <= one_set / 1e9 * 1.05 + 0.064,
              f"fanout: after {label} the fleet keeps {got['fleet_gb']:.3f} GB on the card "
              f"(one set is {one_set / 1e9:.3f} GB)")
        return got

    def serve(params_flat, what):
        params_c = lm.registry.cast(unflatten_from_paths(params_flat), torch.bfloat16)
        reset()
        seq, prefill_s, decode_s = generate(lm, params_c, prompts, 17)
        got = counts()
        check(got == per_prefill, f"fanout: {what}: launches {got} in one prefill, "
              f"want {per_prefill}")
        check(tuple(seq.shape) == (4, 17), f"fanout: {what}: tokens {tuple(seq.shape)}")
        return seq.cpu(), dict(prefill_ms=prefill_s * 1e3, decode_ms=decode_s * 1e3 / 16,
                               launches=got["flash_attention"])

    try:
        policy = CheckpointPolicy(codec="int8:b256", save_interval=2, keep_last=1,
                                  registry=registry)
        run = Trainer.create(cfg, parallel, tcfg, mesh_spec_from_string("data=2,model=2"),
                             batch_size=8, seq_len=512, ckpt_dir=str(root / "ck"), policy=policy,
                             device=dev)
        mgr = run.manager
        reps = [FleetReplica(f"r{i}", registry, plan, dev, engine=engine, stats=stats)
                for i in range(FANOUT_REPLICAS)]

        # seq 1: step 2, full
        mark = phases.mark()
        t0 = time.perf_counter()
        state, _ = run.run(run.init_state(), 0, 2)
        train2_s = time.perf_counter() - t0
        q2, _ = phases.since("fanout: steps 1-2, save of 2", mark)
        pub1 = registry.current()
        check(pub1 is not None and (pub1.seq, pub1.step, pub1.kind) == (1, 2, "full"),
              f"fanout: after step 2 the registry holds {pub1}")
        n_coded = len(pub1.manifest.shard_codecs)
        check(q2 == n_coded == 60, f"fanout: save of 2 made {q2} quantize launches "
              f"({n_coded} coded shards), want 60")
        torch.cuda.synchronize()
        gc.collect()
        base = torch.cuda.memory_allocated()
        full_s, full_stats = fleet_sync("seq 1 full sync", reps)
        one_set = sum(t.numel() * t.element_size() for t in reps[0].flat_params().values())
        kept1 = retained("seq 1")  # before any other reader's copy exists
        want, _ = direct(2)
        same_as(reps, want, "seq 1")
        for name, t in reps[0].flat_params().items():
            check(all(r.flat_params()[name].data_ptr() == t.data_ptr() for r in reps),
                  f"fanout: the replicas hold copies of {name}, not one tensor")
        fp32 = [k for k in pub1.digests if k.endswith("@fp32")]
        check(full_stats["disk_fetches"] == len(fp32) and full_stats["disk_bytes_read"] == one_set,
              f"fanout: seq 1 read {full_stats['disk_fetches']} shards, "
              f"{full_stats['disk_bytes_read']} bytes from disk ({len(fp32)} fp32 shards, "
              f"{one_set} bytes)")
        check(full_stats["disk_bytes_read"] <= 2 * one_set,
              "fanout: fleet disk bytes over twice one reader's payload")
        out["seq1"] = dict(sync_s=full_s, stats=full_stats, **kept1)
        print(f"fanout smollm-360m: {FANOUT_REPLICAS} replicas data=1,model=1 from step 2 "
              f"(trained under data=2,model=2; {n_coded} coded moment shards, {q2} quantize "
              f"launches; steps 1-2 and the save {train2_s:.2f} s): full sync {full_s:.2f} s, "
              f"{FANOUT_REPLICAS * one_set / 1e9 / full_s:.3f} GB/s aggregate "
              f"({one_set / 1e9:.3f} GB of fp32 weights a replica); {full_stats}; "
              f"card memory kept {out['seq1']['fleet_gb']:.3f} GB (engine's entries "
              f"{out['seq1']['engine_card_gb']:.3f} GB); all bit-equal to a direct restore, "
              "one tensor set, 0 block-quant launches")

        # 2 independent readers of the same step, each its own engine
        walls: list = [None, None]

        def reader(i):
            flat, walls[i] = direct(2)
            check(all(torch.equal(flat[n], want[n]) for n in want),
                  f"fanout: independent reader {i} differs")

        threads = [threading.Thread(target=reader, args=(i,)) for i in range(2)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        both_s = time.perf_counter() - t0
        check(all(w is not None for w in walls), "fanout: an independent reader failed")
        out["independent"] = dict(reader_s=walls, wall_s=both_s,
                                  aggregate_gb_s=2 * one_set / 1e9 / both_s)
        out["seq1"]["aggregate_gb_s"] = FANOUT_REPLICAS * one_set / 1e9 / full_s
        print(f"fanout 2 independent readers (private engines, concurrent): "
              f"{', '.join(f'{w:.2f}' for w in walls)} s each, {both_s:.2f} s together, "
              f"{out['independent']['aggregate_gb_s']:.3f} GB/s aggregate; the fleet "
              f"{out['seq1']['aggregate_gb_s']:.3f} GB/s aggregate")

        # serve from replicas 0 and 7 and from a direct restore of step 2
        d_flat, _ = restore_params(mgr.step_dir(2), plan, dev)
        serve(reps[0].flat_params(), "warm-up")  # the timed runs start warm
        served = {}
        for label, flat in (("replica 0", reps[0].flat_params()),
                            ("replica 7", reps[-1].flat_params()), ("direct", d_flat)):
            served[label] = serve(flat, label)
        del d_flat, flat  # the loop's name would keep the direct restore on the card
        seqs = [v[0] for v in served.values()]
        check(all(torch.equal(a, seqs[0]) for a in seqs),
              "fanout: replicas 0 and 7 and the direct restore serve other tokens")
        out["serve"] = {k: v[1] for k, v in served.items()}
        print(f"fanout serve 4x512 + 16 steps: " + "; ".join(
            f"{k} prefill {v['prefill_ms']:.2f} ms, decode {v['decode_ms']:.3f} ms/token, "
            f"{v['launches']} flash launches" for k, v in out["serve"].items())
            + f"; equal tokens, sample {seqs[0][0, :8].tolist()}")

        # a corrupt peer: poison one holder of one shard, sync a new replica
        key = next(k for k in fp32 if "wqkv" in k)
        skey = f"{key}@{pub1.digests[key]}"
        holder = registry.holders(skey)[0]
        registry.poison_holder(holder, skey)
        vstats = FanoutStats()
        victim = FleetReplica("victim", registry, plan, dev, engine=CheckpointEngine(dev),
                              stats=vstats)
        t0 = time.perf_counter()
        check(victim.sync(), "fanout: the victim had no publication")
        victim_s = time.perf_counter() - t0
        same_as([victim], want, "the replica behind a corrupt peer")
        check(vstats.digest_failures >= 1 and vstats.refetches >= 1,
              f"fanout: corrupt peer not caught: {vstats.as_dict()}")
        check(holder not in registry.holders(skey) and "victim" in registry.holders(skey),
              f"fanout: holders of {key} after the corrupt fetch: {registry.holders(skey)}")
        out["corrupt_peer"] = dict(sync_s=victim_s, stats=vstats.as_dict(), shard=key)
        print(f"fanout corrupt peer ({holder}'s copy of {key}): a new replica with its own "
              f"engine synced in {victim_s:.2f} s, {vstats.as_dict()}; holder evicted, "
              "bit-equal")
        registry.unsubscribe(victim.subscription)
        victim.engine.close()
        del victim, want, served, seqs

        # seq 2: step 4, every weight changed, traced
        with obs.enabled() as tracer:
            mark = phases.mark()
            state, _ = run.run(state, 2, 2)
            q4, _ = phases.since("fanout: steps 3-4, save of 4", mark)
            pub2 = registry.current()
            check((pub2.seq, pub2.step, pub2.kind) == (2, 4, "delta"),
                  f"fanout: after step 4 the registry holds seq {pub2.seq} step {pub2.step}")
            names = set(plan.param_specs)
            check(pub2.changed_params >= names, "fanout: seq 2 left some weight unchanged")
            delta_s, delta_stats = fleet_sync("seq 2 delta sync", reps)
        kept2 = retained("seq 2")
        check(all(r.last_update == frozenset(names) for r in reps),
              "fanout: seq 2 did not rebuild every parameter")
        want, _ = direct(4)
        same_as(reps, want, "seq 2")
        del want
        out["seq2"] = dict(sync_s=delta_s, stats=delta_stats, quantize=q4, **kept2)
        span_names = {r["name"] for r in tracer.span_records()}
        serve_counters = {k: v for k, v in tracer.counters().items() if k.startswith("serve.")}
        check({"serve.sync", "serve.fetch", "serve.publish"} <= span_names,
              f"fanout: traced sync lacks serve spans ({sorted(span_names)})")
        check(serve_counters.get("serve.syncs") == FANOUT_REPLICAS
              and serve_counters.get("serve.publications") == 1
              and serve_counters.get("serve.disk_fetches") == delta_stats["disk_fetches"] > 0,
              f"fanout: serve counters {serve_counters}")
        out["trace"] = dict(spans=len(tracer.span_records()), serve_counters=serve_counters)
        print(f"fanout seq 2 (step 4, {len(pub2.changed)} shards changed, {q4} quantize "
              f"launches): delta sync {delta_s:.2f} s rebuilt all {len(names)} params, "
              f"bit-equal to a direct restore; {delta_stats}; card memory kept "
              f"{out['seq2']['fleet_gb']:.3f} GB; traced: {len(tracer.span_records())} spans, "
              f"counters {serve_counters}")

        # seq 3: step 5 = step 4 with final_norm changed
        params5 = dict(state.params)
        params5["final_norm"] = state.params["final_norm"] * 1.5
        state5 = dataclasses.replace(state, params=params5, step=5)
        mark = phases.mark()
        mgr.save(state5, 5, block=True)
        q5, _ = phases.since("fanout: save of 5 (final_norm changed)", mark)
        check(q5 == 60, f"fanout: save of 5 made {q5} quantize launches, want 60")
        pub3 = registry.current()
        check((pub3.seq, pub3.step) == (3, 5) and pub3.changed_params == {"final_norm"},
              f"fanout: seq 3 changed {sorted(pub3.changed_params)}, want final_norm")
        ptrs = {n: t.data_ptr() for n, t in reps[0].flat_params().items()}
        inplace_s, inplace_stats = fleet_sync("seq 3 in-place sync", reps)
        kept3 = retained("seq 3")
        check(all(r.last_update == frozenset({"final_norm"}) for r in reps),
              f"fanout: seq 3 rebuilt {sorted(reps[0].last_update)}")
        now = reps[0].flat_params()
        check(all(now[n].data_ptr() == ptrs[n] for n in now if n != "final_norm")
              and now["final_norm"].data_ptr() != ptrs["final_norm"],
              "fanout: the in-place delta replaced an unchanged tensor")
        want, _ = direct(5)
        same_as(reps, want, "seq 3")
        del want, now, state, state5, params5
        out["seq3"] = dict(sync_s=inplace_s, stats=inplace_stats, quantize=q5, **kept3)
        print(f"fanout seq 3 (step 5, final_norm changed): in-place sync {inplace_s:.3f} s "
              f"(the full sync {full_s:.2f} s); {inplace_stats}; every other tensor kept; "
              f"card memory kept after seq 1, 2, 3: "
              f"{[round(out[k]['fleet_gb'], 3) for k in ('seq1', 'seq2', 'seq3')]} GB "
              f"(engine's entries "
              f"{[round(out[k]['engine_card_gb'], 3) for k in ('seq1', 'seq2', 'seq3')]} GB)")
        mgr.close()
        del reps
        engine.close()

        # chaos: 3 seeds with the harness's state on the card, each the CPU run's schedule
        t0 = time.perf_counter()
        res = sweep(range(3))
        chaos_s = time.perf_counter() - t0
        check(res.ok, f"fanout: chaos sweep on the card: {res.describe()}")
        for rep in res.reports:
            cpu = run_seed(rep.seed, device="cpu")
            check(not rep.violations and rep.schedule == cpu.schedule
                  and rep.events_completed == cpu.events_completed,
                  f"fanout: chaos seed {rep.seed}: card {rep.events_completed} events, "
                  f"CPU {cpu.events_completed}")
        out["chaos"] = dict(seconds=chaos_s, seeds=[dict(
            seed=r.seed, ok=r.ok, events_completed=r.events_completed, faults=len(r.schedule),
            config=r.config) for r in res.reports])
        print(f"fanout chaos sweep, seeds 0-2 on the card: {res.describe()} in {chaos_s:.2f} s; "
              "schedules and events equal to the CPU runs'")
        out["launches_by_phase"] = phases.by_phase
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def mixtral(layers: int):
    """mixtral-8x22b at full width with its depth cut to ``layers`` (every
    layer is alike: sliding window 4096 and 8 experts top-2)."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config("mixtral-8x22b")
    return full, dataclasses.replace(full, num_layers=layers)


class MoeLog:
    """Records every MoE routing while it is open: the experts chosen, the
    top-k margin (k-th minus (k+1)-th probability) and the kept slots."""

    def __init__(self, torch):
        from repro_torch.models import moe

        self.torch, self.moe = torch, moe
        self.routes: list[tuple] = []
        self.keeps: list = []

    def __enter__(self):
        torch, moe = self.torch, self.moe
        route, assign = moe.route, moe.assign_slots
        self._saved = route, assign

        def recording_route(xg, router_w, k):
            probs, gate_k, idx_k = route(xg, router_w, k)
            # detached: a record holding the autograd graph would keep a
            # training step's activations alive
            top = torch.topk(probs.detach(), k + 1, dim=-1).values
            self.routes.append((idx_k.cpu(), (top[..., k - 1] - top[..., k]).cpu()))
            return probs, gate_k, idx_k

        def recording_assign(idx_k, e, c):
            slot, keep, oh = assign(idx_k, e, c)
            self.keeps.append(keep.cpu())
            return slot, keep, oh

        moe.route, moe.assign_slots = recording_route, recording_assign
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe.assign_slots = self._saved

    def dropped_share(self) -> float:
        kept = sum(int(k.sum()) for k in self.keeps)
        total = sum(k.numel() for k in self.keeps)
        return 1.0 - kept / total if total else 0.0


def disk_used_gb() -> float:
    """GB in use on the disk that holds the checkpoints."""
    return shutil.disk_usage(ROOT).used / 1e9


def write_floor_rate(step_dir: Path, workers: int, scratch: Path, budget: float = 2e9) -> float:
    """GB/s of writing and fsyncing files of the sizes a save wrote, from
    ``workers`` threads, measured on its largest files up to ``budget``
    bytes (a 20-30 GB save is not written again, to keep the disk writes
    of a phase under ~40 GB)."""
    sizes = sorted((p.stat().st_size for p in step_dir.glob("ranks/**/*.npy")), reverse=True)
    take, total = [], 0
    for n in sizes:
        if total >= budget:
            break
        take.append(n)
        total += n
    return total / 1e9 / disk_floor(take, workers, scratch)


def fp32_read_floor(step_dir: Path, workers: int) -> tuple[int, float, float]:
    """The fp32 shard files of a checkpoint (what a weights-only restore
    reads) read whole from ``workers`` threads: (files, GB, seconds)."""
    from repro_torch.core.dist_ckpt import DistCheckpoint
    from repro_torch.core.patterns import StateKind

    ck = DistCheckpoint.open(step_dir)
    files = sorted({ck.shard_path(r, n, StateKind.FP32) for n in ck.manifest.params
                    for r in ck.writing_ranks(n, StateKind.FP32)})
    gb = sum(p.stat().st_size for p in files) / 1e9
    return len(files), gb, read_floor_s(files, workers)


def read_floor_s(paths: list[Path], workers: int) -> float:
    """Seconds to read ``paths`` whole from ``workers`` threads (page cache
    or disk, as the restore finds them): the floor of a restore that reads
    those bytes."""
    def read(p: Path) -> int:
        with open(p, "rb", buffering=0) as f:
            buf = bytearray(1 << 24)
            n = 0
            while True:
                got = f.readinto(buf)
                if not got:
                    return n
                n += got

    t0 = time.perf_counter()
    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(read, paths))
    return time.perf_counter() - t0


def digests_match(torch, trees: dict, plan, manifest, workers: int) -> tuple[int, int]:
    """Re-cut every saved shard of ``trees`` ({kind: nested tensors}) under
    the Source ``plan`` and hash it on ``workers`` threads: each must equal
    the manifest's digest (raw kinds: the bytes saved, so bit-equal; coded
    kinds: the codec's served view).  A parameter restored without the
    Source's vocab padding (a model=1 restore strips it) lacks the padding
    rows the save wrote, which training moves off zero (weight decay): its
    shards are skipped.  Returns (shards checked, shards skipped)."""
    from repro_torch.core.dist_ckpt import shard_digest_key
    from repro_torch.core.layout import slice_shard
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.core.tensor_io import content_digest

    jobs, skipped = [], 0
    for kind, tree in trees.items():
        for name, t in flatten_with_paths(tree).items():
            spec = plan.param_specs[name]
            layout = spec.layout_for(kind, plan.mesh)
            keys = [(r, shard_digest_key(r, name, kind)) for r in range(len(layout.entries))]
            keys = [(r, key) for r, key in keys if key in manifest.shard_digests]
            if tuple(t.shape) == tuple(spec.runtime_shape):
                jobs.append((t, layout, keys))
            else:
                skipped += len(keys)

    def one(job) -> int:
        t, layout, keys = job
        for rank, key in keys:
            got = content_digest(slice_shard(t, layout, rank))
            check(got == manifest.shard_digests[key], f"{key}: not the saved bytes")
        return len(keys)

    with ThreadPoolExecutor(workers) as pool:
        return sum(pool.map(one, jobs)), skipped


def coded_shard_check(torch, bq_ops, bq_ref, plan, tree, name: str, *, label: str = "mixtral",
                      dtype=None) -> dict:
    """The block-quant kernels at a save's shape: rank 0's shard of
    ``name`` in ``tree`` (a moment of ``dtype``, default bf16) under
    ``plan``, coded int8:b256 through the kernels and through their plain
    version on the same card tensor.  Codes, scales and decoded values must
    be equal byte for byte, and the decode within half a block scale of the
    input (int8's rounding step, with fp32 rounding on top)."""
    dtype = dtype or torch.bfloat16
    from repro_torch.core.layout import slice_shard
    from repro_torch.core.patterns import StateKind
    from repro_torch.core.pytree import flatten_with_paths

    spec = plan.param_specs[name]
    t = flatten_with_paths(tree)[name]
    check(tuple(t.shape) == tuple(spec.runtime_shape), f"{name}: {tuple(t.shape)} unpadded")
    shard = slice_shard(t, spec.layout_for(StateKind.EXP_AVG, plan.mesh), 0)
    check(shard.dtype == dtype, f"{name}: moment shard {shard.dtype}, want {dtype}")
    fns = (bq_ops.block_quantize, bq_ops.block_dequantize)
    reset_launches(dict(enumerate(fns)))
    q, sc = bq_ops.block_quantize(shard, block=256, dtype="int8")
    d = bq_ops.block_dequantize(q, sc, count=shard.numel())
    took = [fn.launches_by_variant for fn in fns]
    check(took == [{"vector": 1, "general": 0}] * 2, f"{name} shard: launches by variant {took}")
    blocks = bq_ref.blocked(shard, block=256)
    pq, ps = bq_ref.quantize_blocks(blocks, dtype="int8")
    pd = bq_ref.dequantize_blocks(pq, ps, count=shard.numel())
    same = torch.equal(q, pq) and same_by_nan_class(torch, sc, ps) and same_by_nan_class(torch, d, pd)
    err = (d - pd).abs().max().item()
    step = (d - blocks.reshape(-1)[:shard.numel()]).abs().reshape(-1, 256) / sc[:, None]
    worst = step.nan_to_num(0.0).max().item()  # an all-zero block has scale 0 and error 0
    print(f"kernel block_quant {label} {name} moment shard {tuple(shard.shape)} "
          f"({shard.numel()} {str(dtype).removeprefix('torch.')} elements, int8:b256): q, "
          "scales and decoded equal to the plain "
          f"version byte for byte: {same} (max_abs_err {err:.1e}); decode off the input by up "
          f"to {worst:.6f} of its block's scale (bound 0.5 + 2^-15)")
    check(same and bool(torch.isfinite(d).all()), f"block_quant {name} shard: kernel disagrees "
          "with its plain version")
    check(worst <= 0.5 + 2 ** -15, f"block_quant {name} shard: decode off by {worst} scales")
    del q, sc, d, pq, ps, pd, blocks, step
    return dict(name=name, shape=list(shard.shape), numel=shard.numel(), max_abs_err=err,
                worst_scale_step=worst)


def moe_breakdown(torch, lm, params_c, prompts, label: str = "mixtral") -> dict:
    """Time of one MoE layer's steps at the serving prefill's shapes (layer
    0's input, captured in a prefill), by CUDA events: routing and slot
    assignment, dispatch (the gather), the expert matmuls, and combine."""
    from repro_torch.models import lm as lm_mod
    from repro_torch.models import decode as D
    from repro_torch.models import moe

    captured = []
    block = lm_mod.moe_block

    def capture(h, *args, **kw):
        if not captured:
            captured.append((h, args, kw))
        return block(h, *args, **kw)

    lm_mod.moe_block = capture
    try:
        with torch.inference_mode():
            D.prefill(lm, params_c, D.init_cache(lm, *prompts.shape, device=prompts.device),
                      prompts)
    finally:
        lm_mod.moe_block = block
    (h, (router, wg, wu, wd, cfg), kw), = captured
    b, s, d = h.shape
    e, k = cfg.num_experts, cfg.top_k
    c = moe.capacity_per_group(s, cfg)
    with torch.inference_mode():
        xg = h.reshape(b, s, d)
        _, gate_k, idx = moe.route(xg, router, k)
        slot, keep, _ = moe.assign_slots(idx, e, c)
        buf = moe.dispatch(xg, slot, e, c)
        y = moe.experts(buf, wg, wu, wd)
        steps = {
            "route and slots": lambda: moe.assign_slots(moe.route(xg, router, k)[2], e, c),
            "dispatch": lambda: moe.dispatch(xg, slot, e, c),
            "experts (3 bmm + silu)": lambda: moe.experts(buf, wg, wu, wd),
            "combine": lambda: moe.combine(y, slot, gate_k * keep),
            "moe_block": lambda: moe.moe_block(h, router, wg, wu, wd, cfg, **kw),
        }
        # CUDA events over 20 back-to-back calls: each step is 0.1-5 ms of
        # device work, and a profiler trace that lost a record would read low
        ms = {name: cuda_ms(torch, fn, iters=20) for name, fn in steps.items()}
    flops = 3 * 2 * b * e * c * d * wg.shape[-1]
    floor = flops / PEAK_BF16_FLOPS * 1e3
    print(f"{label} MoE layer at B={b} S={s} (groups {b}, capacity {c} slots an expert a group), "
          "CUDA-event ms a call: " + ", ".join(f"{n} {t:.3f}" for n, t in ms.items())
          + f"; the expert matmuls are {flops / 1e12:.2f} TFLOP ({floor:.3f} ms at the bf16 peak)")
    check(ms["experts (3 bmm + silu)"] >= floor, "the expert matmuls timed below their bound")
    return ms


class FlashShapes:
    """Records the (dtype, D, Dv) of every flash kernel launch while it is
    open (a shim around the wrapper's ``kernel.flash_attention_fwd``), and
    in ``calls`` its (dtype, Sq, Skv, causal)."""

    def __init__(self, kernel):
        self.kernel, self.shapes, self.calls = kernel, [], []

    def __enter__(self):
        launch = self._saved = self.kernel.flash_attention_fwd

        def recording(q, k, v, **kw):
            dtype = str(q.dtype).removeprefix("torch.")
            self.shapes.append((dtype, q.shape[-1], v.shape[-1]))
            self.calls.append((dtype, q.shape[1], k.shape[1], bool(kw["causal"])))
            return launch(q, k, v, **kw)

        self.kernel.flash_attention_fwd = recording
        return self

    def __exit__(self, *exc):
        self.kernel.flash_attention_fwd = self._saved


def capacity_drops(log: MoeLog, per_forward: int) -> tuple[float, float]:
    """The shares of slots dropped by capacity in a logged ``generate``: its
    prefill (the first ``per_forward`` routings, one a MoE layer) and its
    decode steps (the rest)."""
    def dropped(keeps) -> float:
        return 1.0 - sum(int(k.sum()) for k in keeps) / sum(k.numel() for k in keeps)

    return dropped(log.keeps[:per_forward]), dropped(log.keeps[per_forward:])


def save_weights(torch, label: str, cfg, plan, saved: dict, root: Path, width: int) -> tuple:
    """Save the weights ``saved`` ({path: tensor on the card}) alone under
    ``plan`` as step 1 under ``root`` (a serving checkpoint): fp32 leaves
    through a host snapshot timed apart, bf16 ones as they are; the bytes
    written checked, beside the disk floor.  Returns the step directory and
    the save's record."""
    from repro_torch.ckpt.saver import write_distributed
    from repro_torch.core.patterns import StateKind
    from repro_torch.launch.serve import latest_step_dir

    fp32 = all(t.dtype == torch.float32 for t in saved.values())
    t0 = time.perf_counter()
    snap = {n: {StateKind.FP32: t.cpu().numpy() if fp32 else t} for n, t in saved.items()}
    snap_s = time.perf_counter() - t0
    res = write_distributed(snap, plan, 1, root / "step_00000001", workers=width,
                            config_fingerprint=cfg.fingerprint())
    del snap
    step_dir = latest_step_dir(root)
    check(step_dir is not None, f"{label}: no committed step")
    nbytes = sum(t.numel() * t.element_size() for t in saved.values())
    check(res.bytes_written == nbytes, f"{label} save wrote {res.bytes_written} bytes, want {nbytes}")
    rate = write_floor_rate(step_dir, width, root / "floor")
    gb = res.bytes_written / 1e9
    print(f"{label} save data=2,model=2 (moe_mode {plan.moe_mode}): {gb:.3f} GB of "
          f"{'fp32' if fp32 else 'bf16'} weights in {res.shards_written} shards, "
          f"{res.wall_time_s:.2f} s with {width} workers ({gb / res.wall_time_s:.3f} GB/s; "
          + (f"device→host snapshot {snap_s:.2f} s" if fp32 else "device→host included")
          + f"); disk floor {gb / rate:.2f} s ({rate:.3f} GB/s from {width} threads, on its "
          f"largest files up to 2 GB); disk {disk_used_gb():.1f} GB used")
    return step_dir, dict(gb=gb, seconds=res.wall_time_s, floor_s=gb / rate, floor_gb_s=rate,
                          workers=width, **({"snapshot_s": snap_s} if fp32 else {}))


def serve_restores(torch, label: str, cfg, plan_for, step_dir: Path, saved: dict, prompts,
                   counters: dict, kernel, per_prefill: dict, *, source_embeds=None,
                   cache_len: int = 0, on_run=None, on_direct=None) -> dict:
    """The serve path from a checkpoint: weights-only restores of
    ``step_dir`` under data=1,model=1 (RESHARD_STREAM) and data=2,model=2
    (DIRECT), planned by ``plan_for(mesh) -> (lm, plan)``, each bit-equal
    to ``saved`` (a model=1 restore lacks the Source's vocab padding: its
    region); from each, after a warm-up, a bf16 prefill of ``prompts``
    (with ``source_embeds``) and 16 greedy decode steps whose launches must
    be ``per_prefill``; ``on_run(shapes, log)`` checks the flash launches
    (:class:`FlashShapes`) and routings (:class:`MoeLog`) recorded and
    returns what the run's record and line add; the same tokens from both
    restores; the DIRECT run's prefill and decode profiled, and
    ``on_direct(lm, params, profile)`` adds its own breakdown; the read
    floor of the weight files.  Returns the record."""
    from repro_torch.core.engine import default_workers
    from repro_torch.core.pytree import unflatten_from_paths
    from repro_torch.launch.serve import generate, restore_params
    from repro_torch.models import decode as D

    width = default_workers()
    b, s = prompts.shape
    gen_kw = dict(cache_len=cache_len, source_embeds=source_embeds)
    out, runs = {}, {}
    for mesh_str, expect in (("data=1,model=1", "reshard_stream"), ("data=2,model=2", "direct")):
        tlm, tplan = plan_for(mesh_str)
        (flat, rp), restore_s = traced_restore(
            torch, label, mesh_str, lambda: restore_params(step_dir, tplan, prompts.device))
        check(rp.mode.value == expect, f"{label} {mesh_str}: {rp.mode.value}, want {expect}")
        check(set(flat) == set(saved), f"{label} {mesh_str}: restored parameter set differs")
        for name, t in flat.items():
            region = tuple(slice(0, n) for n in t.shape)
            check(torch.equal(t, saved[name][region]), f"{label} {mesh_str}: {name} differs")
        print(f"{label} restore {mesh_str}: {rp.mode.value} in {restore_s:.2f} s (consolidated "
              f"in memory: {rp.consolidate_params}; embed {tuple(flat['embed'].shape)}); "
              "bit-equal to the save")
        params_c = tlm.registry.cast(unflatten_from_paths(flat), torch.bfloat16)
        del flat
        torch.cuda.empty_cache()
        generate(tlm, params_c, prompts, 17, **gen_kw)  # warm-up at the timed shapes
        reset_launches(counters)
        with FlashShapes(kernel) as shapes, MoeLog(torch) as log:
            seq, prefill_s, decode_s = generate(tlm, params_c, prompts, 17, **gen_kw)
        launches = launch_counts(counters)
        check(launches == per_prefill, f"{label} {mesh_str}: launches {launches}")
        check(tuple(seq.shape) == (b, 17) and bool(((seq >= 0) & (seq < cfg.vocab_size)).all()),
              f"{label} {mesh_str}: tokens {tuple(seq.shape)}")
        extra, note = on_run(shapes, log) if on_run else ({}, "")
        print(f"{label} serve {mesh_str}: prefill {b}x{s} {prefill_s * 1e3:.2f} ms, decode "
              f"{decode_s * 1e3 / 16:.3f} ms/token (batch {b}, 16 steps), launches {launches}, "
              f"flash (dtype, Sq, Skv, causal) {shapes.calls}{note}")
        runs[mesh_str] = dict(seq=seq.cpu(), prefill_ms=prefill_s * 1e3,
                              decode_ms=decode_s * 1e3 / 16, restore_s=restore_s,
                              launches=launches, **extra)
        if expect == "direct":
            prof, mine = profile_serving(torch, D, tlm, params_c, prompts, counters,
                                         "flash_attention", per_prefill["flash_attention"],
                                         source_embeds=source_embeds)
            busy = prof["prefill"][1]
            out.update(prefill_device_ms=busy, decode_device_ms=prof["decode x16"][1] / 16,
                       prefill_kernel_ms=mine[1])
            share = (f"{mine[1] / busy:.4f}" if busy is not None and mine[1] is not None
                     else "not measured")
            print(f"{label} prefill {b}x{s} profiled: device busy {fmt_ms(busy)}, flash "
                  f"{fmt_ms(mine[1])} over {mine[2]} launches, a share of {share}")
            if on_direct:
                out.update(on_direct(tlm, params_c, prof))
        del params_c
        torch.cuda.empty_cache()
    # the read floor after the restores: the bytes they read, as warm in the
    # page cache as the second restore found them
    n_files, read_gb, read_s = fp32_read_floor(step_dir, width)
    print(f"{label} restore read floor: the {n_files} weight shard files, {read_gb:.3f} GB, "
          f"read in {read_s:.2f} s from {width} threads ({read_gb / read_s:.3f} GB/s), after "
          f"the restores: RESHARD_STREAM {runs['data=1,model=1']['restore_s']:.2f} s, DIRECT "
          f"{runs['data=2,model=2']['restore_s']:.2f} s")
    out["read_floor"] = dict(gb=read_gb, seconds=read_s)
    note_split_floor(torch, label, read_gb, read_s)
    a, b = runs["data=1,model=1"]["seq"], runs["data=2,model=2"]["seq"]
    check(torch.equal(a, b), f"{label}: RESHARD_STREAM and DIRECT restores serve other tokens")
    print(f"{label} tokens identical across restores; sample {a[0, :8].tolist()}")
    out["runs"] = {k: {n: v for n, v in r.items() if n != "seq"} for k, r in runs.items()}
    out["launches"] = runs["data=1,model=1"]["launches"]
    return out


def decode_check(torch, flm, params, prompts, counters: dict, lm_mod, full_attention,
                 launches: int, label: str, *, source_embeds=None, routed: bool = False,
                 steps: int = 16) -> dict:
    """fp32 on the card: prefill ``prompts`` (with ``source_embeds``)
    through the flash kernel (``launches`` launches), then ``steps`` decode
    steps, against the same prefill through the plain attention and the
    same steps (both fed the kernel path's greedy tokens); every step's
    logits within 1e-3.  With ``routed`` (one MoE layer, the last, whose
    attention reads the layers before it), a flip moves only its own
    token's logits and never the cache, so the (step, row) pairs whose
    routing differs between the paths are left out."""
    from repro_torch.models import decode as D

    b, s = prompts.shape
    outs, fed = [], []
    with torch.inference_mode():
        for plain in (False, True):
            kernel_fn = lm_mod.flash_attention
            if plain:
                lm_mod.flash_attention = lambda q, k, v, *, causal, window: full_attention(
                    q, k, v, causal=causal, window=window)
            try:
                reset_launches(counters)
                cache = D.init_cache(flm, b, s + steps, device=prompts.device)
                with MoeLog(torch) as log:
                    logits, cache = D.prefill(flm, params, cache, prompts,
                                              source_embeds=source_embeds)
                    lgs = [logits.cpu()]
                    for i in range(steps):
                        if not plain:
                            fed.append(lgs[-1].argmax(-1)[:, None])
                        lg, cache = D.decode_step(flm, params, cache, fed[i].to(prompts.device))
                        lgs.append(lg[:, -1].cpu())
                n = counters["flash_attention"].launches
            finally:
                lm_mod.flash_attention = kernel_fn
            check(n == (0 if plain else launches), f"{label} fp32 check: {n} flash launches")
            # the last routing of the prefill, then one a step: [b] rows each
            routes = (torch.stack([log.routes[0][0][:, -1]] + [r[0][:, -1] for r in log.routes[1:]])
                      if routed else None)
            outs.append((torch.stack(lgs), routes))
    (k_lg, k_rt), (p_lg, p_rt) = outs
    same = (k_rt == p_rt).all(-1) if routed else torch.ones(k_lg.shape[:2], dtype=torch.bool)
    check(bool(torch.isfinite(k_lg).all()), f"{label} fp32 logits not finite")
    err = (k_lg - p_lg).abs()[same].max().item()
    print(f"{label} fp32 check: prefill {b}x{s} through the kernel ({launches} fp32 launches) vs "
          f"the plain attention, then {steps} decode steps each: {int(same.sum())} of "
          f"{same.numel()} (step, row) pairs compared"
          + (" (those routed alike)" if routed else "")
          + f", logits max_abs_err {err:.3e} (tolerance 1e-3; largest logit "
          f"{p_lg.abs().max().item():.3f})")
    check(err <= 1e-3, f"{label}: the kernel path and the plain path disagree ({err:.3e})")
    return dict(max_abs_err=err, steps=steps, compared=int(same.sum()), of=same.numel())


def moe_serve_phase(torch, counters: dict, bq_ops, kernel, layers: int = 1):
    """mixtral-8x22b at full width, depth cut to ``layers`` (one, so the whole
    smoke stays near 1,000 s of its 1,200 s limit): save under
    data=2,model=2 (EP; fp32 weights, bf16 zero moments coded int8:b256 on
    the card); the serve path from it (:func:`serve_restores`:
    RESHARD_STREAM and DIRECT restores bit-equal to the save, a bf16
    prefill of 4 x 512 with one flash launch a layer at D = 128, 16 greedy
    decode steps, the same tokens), a 1 x 8192 prefill and decode past the
    4096 window;
    then, in fp32 on the card, the routing of the kernel path against the
    plain path and the ring against a full cache."""
    import dataclasses

    from repro_torch.ckpt.saver import write_distributed
    from repro_torch.core.codec import CodecPolicy
    from repro_torch.core.dist_ckpt import DistCheckpoint
    from repro_torch.core.engine import default_workers
    from repro_torch.core.patterns import StateKind
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.dist.sharding import make_plan, vocab_multiple
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.launch.serve import latest_step_dir, serving_parallelism
    from repro_torch.models import build_model
    from repro_torch.models import lm as lm_mod
    from repro_torch.models.attention import full_attention

    dev = torch.device("cuda")
    full, cfg = mixtral(layers)
    per_prefill = {"flash_attention": layers, "ssd_scan": 0}

    def plan_for(mesh_str, dtype=torch.bfloat16):
        mesh = mesh_spec_from_string(mesh_str)
        parallel = dataclasses.replace(serving_parallelism(mesh), moment_dtype="bfloat16")
        lm = build_model(cfg, vocab_multiple=vocab_multiple(parallel, mesh), compute_dtype=dtype)
        return lm, make_plan(cfg, lm.registry, parallel, mesh)

    reset = functools.partial(reset_launches, counters)
    counts = functools.partial(launch_counts, counters)

    def dtypes():
        return {name: dict(fn.launches_by_dtype) for name, fn in counters.items()}

    lm, src_plan = plan_for("data=2,model=2")
    n_params = lm.registry.num_params()
    check(src_plan.moe_mode == "ep", f"data=2,model=2 plans moe_mode {src_plan.moe_mode}")
    check(n_params == MIXTRAL_PARAMS[layers], f"{n_params} params at {layers} layers")
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"mixtral-8x22b: d {cfg.d_model}, {cfg.num_heads}:{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, {cfg.moe.num_experts} experts top-{cfg.moe.top_k} of d_ff "
          f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab_size}, window {cfg.sliding_window}; depth cut "
          f"from {full.num_layers} to {layers} layers; {n_params} params ({4 * n_params / 1e9:.1f} "
          f"GB fp32) initialised on the card in {time.perf_counter() - t0:.2f} s")
    root = ROOT / "build" / "chip_smoke_ckpt_mixtral"
    shutil.rmtree(root, ignore_errors=True)
    width = default_workers()
    out: dict = {}
    try:
        # Save: the fp32 weights off the card; the zero moments of a run
        # before its first step, bf16 on the card and coded int8:b256 there
        # (the quantize kernel), as a training checkpoint's are; raw bf16
        # moments would make the checkpoint 43.3 GB instead of 32.5 GB, and
        # the smoke keeps each phase's disk writes under ~40 GB.
        t0 = time.perf_counter()
        saved = flatten_with_paths(params)
        zeros = {n: torch.zeros(tuple(t.shape), dtype=torch.bfloat16, device=dev)
                 for n, t in saved.items()}
        snap = {n: {StateKind.FP32: t.cpu().numpy(), StateKind.EXP_AVG: zeros[n],
                    StateKind.EXP_AVG_SQ: zeros[n]} for n, t in saved.items()}
        snap_s = time.perf_counter() - t0
        reset_launches({"quantize": bq_ops.block_quantize})
        res = write_distributed(snap, src_plan, 1, root / "step_00000001", workers=width,
                                codec=CodecPolicy.moments("int8:b256"),
                                config_fingerprint=cfg.fingerprint())
        quant = bq_ops.block_quantize.launches
        del snap, zeros
        torch.cuda.empty_cache()
        step_dir = latest_step_dir(root)
        check(step_dir is not None, "mixtral: no committed step")
        manifest = DistCheckpoint.open(step_dir).manifest
        n_coded = len(manifest.shard_codecs)
        check(manifest.params["layers.blk.we_gate"].states[StateKind.EXP_AVG].dtype == "bfloat16",
              "mixtral: moments not saved in bf16")
        check(n_coded > 0 and quant == n_coded, f"mixtral save: {quant} quantize launches for "
              f"{n_coded} coded shards")
        check(res.bytes_written >= 6 * n_params, "mixtral checkpoint smaller than fp32 + 2 int8")
        rate = write_floor_rate(step_dir, width, root / "floor")
        gb = res.bytes_written / 1e9
        print(f"mixtral save data=2,model=2 (moe_mode ep): {gb:.3f} GB (fp32 weights; bf16 zero "
              f"moments coded int8:b256 on the card, {n_coded} shards, {quant} quantize launches) "
              f"in {res.shards_written} shards, {res.wall_time_s:.2f} s with {width} workers "
              f"({gb / res.wall_time_s:.3f} GB/s; device→host snapshot of the weights "
              f"{snap_s:.2f} s); disk floor {gb / rate:.2f} s ({rate:.3f} GB/s from {width} "
              f"threads, on its largest files up to 2 GB); disk {disk_used_gb():.1f} GB used")
        out["save"] = dict(gb=gb, seconds=res.wall_time_s, snapshot_s=snap_s,
                           floor_s=gb / rate, floor_gb_s=rate, workers=width, quantize=quant)

        prompts = torch.randint(0, cfg.vocab_size, (4, 512),
                                generator=torch.Generator().manual_seed(3)).to(dev)

        def on_run(shapes, log):
            want = {"flash_attention": {"bfloat16": layers, "float32": 0},
                    "ssd_scan": {"bfloat16": 0, "float32": 0}}
            check(dtypes() == want, f"mixtral: launches by dtype {dtypes()}")
            prefill_drop, decode_drop = capacity_drops(log, layers)
            check(decode_drop == 0.0, "a decode step dropped a token (capacity 1, top-2)")
            return (dict(prefill_drop=prefill_drop),
                    f" (bf16); dropped by capacity: prefill {prefill_drop:.4f} of the slots, "
                    f"decode {decode_drop:.4f}")

        def on_direct(tlm, params_c, prof):
            return dict(moe_ms=moe_breakdown(torch, tlm, params_c, prompts),
                        **long_prefill(torch, cfg, tlm, params_c, reset, counts, per_prefill))

        out.update(serve_restores(torch, "mixtral", cfg, plan_for, step_dir, saved, prompts,
                                  counters, kernel, per_prefill, on_run=on_run,
                                  on_direct=on_direct))

        # Right by the repo's own means, in fp32 on the card: the kernel path
        # against the plain path (routing compared by the experts chosen),
        # and the 4096-slot ring against a full cache past the window.
        flm = build_model(cfg, compute_dtype=torch.float32)
        out["routing"] = routing_check(torch, flm, params, prompts, reset, counts, lm_mod,
                                       full_attention, layers)
        full_stage = [dataclasses.replace(st, body=tuple(dataclasses.replace(ld, window=-1)
                                                         for ld in st.body),
                                          windows=(cfg.sliding_window,) * st.count)
                      for st in flm.stages]
        out["ring"] = ring_check(torch, cfg, flm, dataclasses.replace(flm, stages=full_stage),
                                 params)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def ring_holds(torch, slot_pos, n: int) -> bool:
    """Whether every ring slot j of ``slot_pos`` [L, B, C] holds the one of
    the last C positions before ``n`` that is j modulo C."""
    c = slot_pos.shape[-1]
    want = torch.arange(n - c, n, device=slot_pos.device, dtype=slot_pos.dtype)
    want = want[torch.argsort(want % c)]
    return bool((slot_pos == want).all())


def long_prefill(torch, cfg, lm, params_c, reset, counts, per_prefill) -> dict:
    """A 1 x 8192 bf16 prefill and 16 decode steps past it: the 4096-slot
    ring holds the last window and wraps; one flash launch a layer."""
    from repro_torch.models import decode as D

    dev = params_c["embed"].device
    s, gen, c = 8192, 16, cfg.sliding_window
    toks = torch.randint(0, cfg.vocab_size, (1, s), generator=torch.Generator().manual_seed(4)).to(dev)
    with torch.inference_mode():
        for _ in range(2):  # the first run warms the shapes up; the second is timed
            cache = D.init_cache(lm, 1, s + gen, device=dev)
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with MoeLog(torch) as log:
                logits, cache = D.prefill(lm, params_c, cache, toks)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            launches = counts()
            slot_pos = cache["layers"]["blk"]["slot_pos"]
            check(tuple(slot_pos.shape) == (cfg.num_layers, 1, c), f"ring {tuple(slot_pos.shape)}")
            check(ring_holds(torch, slot_pos, s), "the ring does not hold the last window")
            cur = logits.argmax(-1)[:, None]
            t0 = time.perf_counter()
            for _ in range(gen):
                lg, cache = D.decode_step(lm, params_c, cache, cur)
                cur = lg[:, -1].argmax(-1)[:, None]
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
    check(launches == per_prefill, f"mixtral 8192 prefill launches {launches}")
    check(ring_holds(torch, slot_pos, s + gen), "the decode steps did not wrap the ring")
    check(bool(torch.isfinite(lg).all()), "mixtral 8192: non-finite logits")
    drop = log.dropped_share()
    print(f"mixtral prefill 1x{s} bf16: {prefill_s * 1e3:.2f} ms, flash launches {launches}; "
          f"decode {decode_s * 1e3 / gen:.3f} ms/token past it, the {c}-slot ring wrapped "
          f"(it holds positions {s + gen - c}-{s + gen - 1}); dropped by capacity "
          f"{drop:.4f} of the prefill's slots")
    return dict(long_prefill_ms=prefill_s * 1e3, long_decode_ms=decode_s * 1e3 / gen,
                long_prefill_drop=drop)


def routing_check(torch, flm, params, prompts, reset, counts, lm_mod, full_attention,
                  layers: int, label: str = "mixtral", ssd_chunked=None,
                  want: dict | None = None, mixes_after: bool = False) -> dict:
    """fp32 logits of the 4 x 512 prompts on the card through the kernels
    and through their plain versions (the plain attention; with
    ``ssd_chunked``, also the plain SSD scan): the experts chosen compared
    token by token (a flip is a routing that differs), the logits of every
    token the flips cannot reach within 1e-3.  ``want`` is the kernel path's
    launches (default: ``layers`` flash launches).  The MoE layers are the
    last ones (deepseek-v2's dense head layer comes first), so a flip
    reaches later positions only through a later MoE layer's attention;
    ``mixes_after`` says a sequence mixer follows the last MoE layer too
    (jamba's Mamba-2 layer), so every flip reaches the later positions."""
    want = want or {"flash_attention": layers}
    plain = {"flash_attention": lambda q, k, v, *, causal, window: full_attention(
        q, k, v, causal=causal, window=window)}
    if ssd_chunked is not None:
        plain["ssd_scan"] = ssd_chunked
    with torch.inference_mode():
        reset()
        with MoeLog(torch) as klog:
            k_logits, _ = flm.forward(params, prompts)
        launches = counts()
        kernels = {name: getattr(lm_mod, name) for name in plain}
        for name, fn in plain.items():
            setattr(lm_mod, name, fn)
        try:
            with MoeLog(torch) as plog:
                p_logits, _ = flm.forward(params, prompts)
        finally:
            for name, fn in kernels.items():
                setattr(lm_mod, name, fn)
    check(all(launches[n] == w for n, w in want.items()),
          f"fp32 kernel forward: launches {launches}, want {want}")
    check(counts() == launches, "the plain forward launched a kernel")
    b, s = prompts.shape
    reach = torch.zeros(b, s, dtype=torch.bool)  # tokens a flip can have moved
    flipped, margins = 0, []
    for layer, ((ki, km), (pi, _)) in enumerate(zip(klog.routes, plog.routes)):
        differ = (ki != pi).any(-1)  # [b, s]
        flipped += int(differ.sum())
        margins += km[differ].tolist()
        reach |= differ
        if mixes_after or layer < len(klog.routes) - 1:  # a later mixer carries it on
            first = torch.where(differ.any(1), differ.float().argmax(1), torch.full((b,), s))
            reach |= torch.arange(s)[None, :] >= first[:, None]
    kept = ~reach
    err = (k_logits.cpu() - p_logits.cpu()).abs()[kept].max().item() if bool(kept.any()) else 0.0
    share = flipped / (b * s * len(klog.routes))
    print(f"{label} fp32 routing, kernel path vs plain path on the card ({b}x{s} tokens, "
          f"{layers} layers): {flipped} flipped routings ({share:.5f} of them), smallest top-k "
          f"margin among them {min(margins) if margins else float('nan'):.3e}; logits of the "
          f"{int(kept.sum())} tokens no flip reaches: max_abs_err {err:.3e} (tolerance 1e-3)")
    check(bool(torch.isfinite(k_logits).all()), f"{label} fp32 logits not finite")
    check(err <= 1e-3, f"{label}: kernel and plain logits disagree")
    check(all(m <= 1e-4 for m in margins), f"{label}: a routing flipped above fp32 rounding")
    return dict(flipped=flipped, share=share, min_margin=min(margins) if margins else None,
                max_abs_err=err, compared=int(kept.sum()))


def ring_check(torch, cfg, ring_lm, full_lm, params, steps: int = 8) -> dict:
    """fp32, 1 x 8192 then ``steps`` decode steps: the model with its
    4096-slot ring against the same model reading a full cache (the window
    applied by position): the same logits within 1e-3 and greedy tokens."""
    from repro_torch.models import decode as D

    dev = params["embed"].device
    s = 8192
    toks = torch.randint(0, cfg.vocab_size, (1, s), generator=torch.Generator().manual_seed(5)).to(dev)
    outs, slots = [], []
    with torch.inference_mode():
        for lm in (ring_lm, full_lm):
            cache = D.init_cache(lm, 1, s + steps, device=dev)
            slots.append(cache["layers"]["blk"]["k"].shape[2])
            logits, cache = D.prefill(lm, params, cache, toks)
            seq, lgs = [logits.argmax(-1)], [logits.cpu()]
            for _ in range(steps):
                lg, cache = D.decode_step(lm, params, cache, seq[-1][:, None])
                seq.append(lg[:, -1].argmax(-1))
                lgs.append(lg[:, -1].cpu())
            outs.append((torch.stack(seq, 1).cpu(), torch.stack(lgs)))
            del cache
    check(slots == [cfg.sliding_window, s + steps], f"cache slots {slots}")
    err = (outs[0][1] - outs[1][1]).abs().max().item()
    same = torch.equal(outs[0][0], outs[1][0])
    print(f"mixtral fp32 ring check: 1x{s} prefill and {steps} decode steps, the {slots[0]}-slot "
          f"ring against a full {slots[1]}-slot cache: max_abs_err {err:.3e} (tolerance 1e-3), "
          f"greedy tokens equal {same}")
    check(err <= 1e-3 and same, "mixtral: the ring and the full cache disagree")
    return dict(max_abs_err=err, slots=slots[0])


def moe_train_phase(torch, bq_ops, bq_ref, counters: dict, layers: int = 1):
    """mixtral-8x22b at full width, depth cut to ``layers``, bf16 compute
    and bf16 Adam moments: 6 baseline steps under data=1,model=4 (EP), whose
    first-moment shard of ``we_gate`` holds the block-quant kernels against
    their plain version at the save's largest shape; then 3 steps saved with
    ``int8:b256`` under EP, resumed under data=2,model=2 with expert-TP
    (RESHARD_STREAM), every shard's digest checked against the restored
    state, and 3 more steps."""
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.configs import ParallelismConfig, TrainConfig
    from repro_torch.core.dist_ckpt import DistCheckpoint
    from repro_torch.core.engine import default_workers
    from repro_torch.core.patterns import StateKind
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.train.trainer import Trainer

    import dataclasses

    dev = torch.device("cuda")
    _, cfg = mixtral(layers)
    tcfg = TrainConfig(seed=0)
    ep = ParallelismConfig(moment_dtype="bfloat16")
    tp = dataclasses.replace(ep, expert_parallel=False)
    root = ROOT / "build" / "chip_smoke_train_mixtral"
    shutil.rmtree(root, ignore_errors=True)
    width = default_workers()
    b, s = 8, 512

    def trainer(parallel, mesh, **kw):
        return Trainer.create(cfg, parallel, tcfg, mesh_spec_from_string(mesh), batch_size=b,
                              seq_len=s, device=dev, **kw)

    fns = {"quantize": bq_ops.block_quantize, "dequantize": bq_ops.block_dequantize}

    out: dict = {}
    try:
        counters["flash_attention"].launches = 0
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated() / 1e9
        check(before < 1.0, f"{before:.2f} GB of the card in use before the mixtral train phase")
        base = trainer(ep, "data=1,model=4")
        n_params = base.lm.registry.num_params()
        check(base.plan.moe_mode == "ep", f"data=1,model=4 plans {base.plan.moe_mode}")
        check(n_params == MIXTRAL_PARAMS[layers], f"{n_params} params at {layers} layers")
        torch.cuda.reset_peak_memory_stats()
        with MoeLog(torch) as log:  # no reference here to the initial state: run() drops it
            state, hist = base.run(base.init_state(), 0, 6)
        peak = torch.cuda.max_memory_allocated() / 1e9
        baseline = [h["loss"] for h in hist]
        step_s = sorted(h["dt"] for h in hist[1:])[len(hist[1:]) // 2]
        drop = log.dropped_share()
        print(f"mixtral train baseline: {layers} layer at full width, {n_params} params (fp32 "
              f"master {4 * n_params / 1e9:.1f} GB, bf16 moments {4 * n_params / 1e9:.1f} GB "
              f"together), {b}x{s} tokens, bf16 compute, remat full, data=1,model=4 (ep); 6 steps: "
              f"losses {[round(v, 4) for v in baseline]}, aux {[round(h['aux'], 4) for h in hist]}; "
              f"median step {step_s * 1e3:.1f} ms ({b * s / step_s:.0f} tokens/s); peak card "
              f"memory {peak:.2f} GB; dropped by capacity {drop:.4f} of the routed slots")
        check(all(map(math.isfinite, baseline)), "mixtral baseline loss not finite")
        batch = base.batch(6)
        wall, busy, top = device_profile(torch, lambda: base.step_fn(state, batch))
        print(f"profile mixtral train step: wall {wall:.2f} ms (profiler on), device busy "
              f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / wall):.3f}")
        for key, ms, count in top:
            print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")
        out.update(step_ms=step_s * 1e3, tokens_s=b * s / step_s, peak_gb=peak, dropped=drop,
                   step_device_ms=busy)
        out["shard_check"] = coded_shard_check(torch, bq_ops, bq_ref, base.plan,
                                               state.exp_avg, "layers.blk.we_gate")
        del state, base
        torch.cuda.empty_cache()

        reset_launches(fns)
        policy = CheckpointPolicy(codec="int8:b256", save_interval=3, async_save=True)
        src = trainer(ep, "data=1,model=4", ckpt_dir=str(root), policy=policy)
        hist = src.run(src.init_state(), 0, 3)[1]  # the final state is dropped here
        src.manager.close()
        quant = fns["quantize"].launches
        drift = max(abs(h["loss"] - x) for h, x in zip(hist, baseline))
        check(drift <= 2e-2, f"the saving run left the baseline ({drift:.2e}) before its save")
        (res,) = src.save_results
        step3 = src.manager.step_dir(3)
        manifest = DistCheckpoint.open(step3).manifest
        src_plan = src.plan
        n_coded = len(manifest.shard_codecs)
        check(n_coded > 0 and quant == n_coded, f"quantize launches {quant}, coded shards {n_coded}")
        check(manifest.params["layers.blk.we_up"].states[StateKind.EXP_AVG].dtype == "bfloat16",
              "moments not bf16 in the manifest")
        del src
        torch.cuda.empty_cache()
        gb = res.bytes_written / 1e9
        rate = write_floor_rate(step3, width, root / "floor")
        print(f"mixtral train save step 3 (data=1,model=4 ep, int8:b256 bf16 moments, async, "
              f"{width} workers): {gb:.3f} GB in {res.shards_written} shards, {res.wall_time_s:.2f} "
              f"s ({gb / res.wall_time_s:.3f} GB/s; disk floor {gb / rate:.2f} s at {rate:.3f} "
              f"GB/s; disk {disk_used_gb():.1f} GB used); coded {res.coded_bytes / 1e9:.3f} of raw {res.coded_raw_bytes / 1e9:.3f} GB; "
              f"device->host {res.device_to_host_bytes / 1e9:.3f} GB; {n_coded} coded shards, "
              f"quantize launches {quant}")

        torch.cuda.reset_peak_memory_stats()
        tgt = trainer(tp, "data=2,model=2", ckpt_dir=str(root),
                      policy=CheckpointPolicy(async_save=False, save_interval=1000))
        check(tgt.plan.moe_mode == "tp", f"--no-ep data=2,model=2 plans {tgt.plan.moe_mode}")
        reset_launches(fns)
        state, info = tgt.init_or_restore()
        restored_gb = torch.cuda.memory_allocated() / 1e9
        dequant = fns["dequantize"].launches
        check(info is not None and info.mode.value == "reshard_stream",
              f"mixtral resume: {info and info.mode.value}, want reshard_stream")
        check(state.step == 3 and dequant == n_coded,
              f"mixtral resume: step {state.step}, {dequant} dequantize launches for {n_coded}")
        t0 = time.perf_counter()
        n_checked, _ = digests_match(torch, {StateKind.FP32: state.params,
                                             StateKind.EXP_AVG: state.exp_avg,
                                             StateKind.EXP_AVG_SQ: state.exp_avg_sq},
                                     src_plan, manifest, width)
        digest_s = time.perf_counter() - t0
        check(n_checked == len(manifest.shard_digests),
              f"{n_checked} of {len(manifest.shard_digests)} shard digests checked")
        # run() must hold the only reference to the restored state: it drops
        # each state once the next exists (the card holds two, not three)
        box = [state]
        del state
        checked_gb = torch.cuda.memory_allocated() / 1e9
        hist = tgt.run(box.pop(), 3, 3, log=lambda rec: print(
            f"  resumed step {rec['step']}: loss {rec['loss']:.4f}, card memory in use "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True))[1]
        peak = torch.cuda.max_memory_allocated() / 1e9
        resumed = [h["loss"] for h in hist]
        check(all(map(math.isfinite, resumed)), "mixtral resumed loss not finite")
        print(f"mixtral train resume data=2,model=2 --no-ep (moe_mode tp): {info.mode.value} in "
              f"{info.wall_time_s:.2f} s (write floor of those bytes {gb / rate:.2f} s), step 3, "
              f"{dequant} dequantize launches; all {n_checked} shard digests of the save equal "
              f"the restored state re-cut under the Source plan (params bit-equal, moments the "
              f"codec's served view; {digest_s:.2f} s); steps 4-6 losses "
              + ", ".join(f"{x:.4f} (baseline {y:.4f})" for x, y in zip(resumed, baseline[3:]))
              + f"; card memory in use after the restore {restored_gb:.2f} GB, after the digest "
              f"check {checked_gb:.2f} GB, peak {peak:.2f} GB")
        tgt.manager.close()
        del tgt
        torch.cuda.empty_cache()
        check(counters["flash_attention"].launches == 0, "flash launched during training")
        out.update(save_s=res.wall_time_s, save_gb=gb, floor_s=gb / rate, resume_s=info.wall_time_s,
                   quantize=quant, dequantize=dequant, coded=n_coded, resumed=resumed,
                   baseline=baseline, resume_peak_gb=peak)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


DEEPSEEK_PARAMS = {2: 5_358_679_040}  # at full width, by depth


def mla_serve_phase(torch, counters: dict, kernel, layers: int = 2):
    """deepseek-v2-236b (MLA) at full width, depth cut to ``layers`` (the
    dense head layer and one MoE layer): the fp32 weights saved under
    data=2,model=2 with expert parallelism; the serve path from it
    (:func:`serve_restores`: RESHARD_STREAM and DIRECT restores bit-equal
    to the save, a bf16 prefill of 4 x 512 with one flash launch a layer at
    D = 192, Dv = 128, 16 greedy decode steps through the absorbed latent
    cache, the same tokens, the profiled prefill and decode).  Then in fp32
    on the card: the kernel path against the plain attention, by routing
    (``routing_check``), and 16 decode steps after a kernel prefill against
    the same steps after a plain prefill (:func:`decode_check`)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.engine import default_workers
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.dist.sharding import make_plan, vocab_multiple
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.launch.serve import serving_parallelism
    from repro_torch.models import build_model
    from repro_torch.models import lm as lm_mod
    from repro_torch.models.attention import full_attention

    dev = torch.device("cuda")
    full = get_config("deepseek-v2-236b")
    cfg = dataclasses.replace(full, num_layers=layers)
    m = cfg.mla
    pair = (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim)
    per_prefill = {"flash_attention": layers, "ssd_scan": 0}
    reset = functools.partial(reset_launches, counters)
    counts = functools.partial(launch_counts, counters)

    def plan_for(mesh_str, dtype=torch.bfloat16):
        mesh = mesh_spec_from_string(mesh_str)
        parallel = serving_parallelism(mesh)
        lm = build_model(cfg, vocab_multiple=vocab_multiple(parallel, mesh), compute_dtype=dtype)
        return lm, make_plan(cfg, lm.registry, parallel, mesh)

    def on_run(shapes, log):
        check(shapes.shapes == [("bfloat16", *pair)] * layers,
              f"deepseek: flash launches (dtype, D, Dv) {shapes.shapes}")
        prefill_drop, decode_drop = capacity_drops(log, 1)
        return {}, (f", (dtype, D, Dv) {shapes.shapes}; dropped by capacity: prefill "
                    f"{prefill_drop:.4f} of the slots, decode {decode_drop:.4f}")

    lm, src_plan = plan_for("data=2,model=2")
    n_params = lm.registry.num_params()
    check(src_plan.moe_mode == "ep", f"data=2,model=2 plans moe_mode {src_plan.moe_mode}")
    check(n_params == DEEPSEEK_PARAMS[layers], f"{n_params} params at {layers} layers")
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"deepseek-v2-236b: d {cfg.d_model}, {cfg.num_heads} heads, MLA q_lora {m.q_lora_rank} "
          f"kv_lora {m.kv_lora_rank} nope {m.qk_nope_head_dim} rope {m.qk_rope_head_dim} v "
          f"{m.v_head_dim}, {cfg.moe.num_experts} experts top-{cfg.moe.top_k} of d_ff "
          f"{cfg.moe.d_ff_expert} and {cfg.moe.num_shared} shared, dense d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; depth cut from {full.num_layers} to {layers} layers; {n_params} "
          f"params ({4 * n_params / 1e9:.2f} GB fp32) initialised on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    root = ROOT / "build" / "chip_smoke_ckpt_deepseek"
    shutil.rmtree(root, ignore_errors=True)
    prompts = torch.randint(0, cfg.vocab_size, (4, 512),
                            generator=torch.Generator().manual_seed(6)).to(dev)
    saved = flatten_with_paths(params)
    try:
        # the fp32 weights alone (a serving checkpoint: 21.4 GB)
        step_dir, save = save_weights(torch, "deepseek", cfg, src_plan, saved, root,
                                      default_workers())
        out = serve_restores(torch, "deepseek", cfg, plan_for, step_dir, saved, prompts, counters,
                             kernel, per_prefill, on_run=on_run)
        out["save"] = save
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # Right by the repo's own means, in fp32 on the card: the kernel path
    # against the plain path, by the experts chosen, then through decode.
    flm = build_model(cfg, compute_dtype=torch.float32)
    with FlashShapes(kernel) as shapes:
        out["routing"] = routing_check(torch, flm, params, prompts, reset, counts, lm_mod,
                                       full_attention, layers, label="deepseek")
    check(shapes.shapes == [("float32", *pair)] * layers, f"deepseek fp32 flash {shapes.shapes}")
    out["decode_check"] = decode_check(torch, flm, params, prompts, counters, lm_mod,
                                       full_attention, layers, "deepseek", routed=True)
    return out


JAMBA_PARAMS = 11_898_463_872  # at full width, cut to a period's layers 4 and 5


def init_bf16(torch, registry, seed: int, dev) -> dict:
    """Weights drawn on the card in fp32 tensor by tensor, in registry
    order from one seeded generator, each cast to bf16 at once (a whole
    fp32 tree beside its bf16 copy would not fit)."""
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.models.common import ParamRegistry

    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for d in registry:
        (leaf,) = flatten_with_paths(ParamRegistry([d]).init(g)).values()
        out[d.path] = leaf.to(torch.bfloat16)
        del leaf
    return out


def mamba_gemm_ms(torch, cfg, params_c, tokens: int) -> dict:
    """CUDA-event ms of the Mamba-2 layer's two projections at a prefill of
    ``tokens`` rows: in_proj [tokens, d] x [d, 2 di + 2 G N + H] and
    out_proj [tokens, di] x [di, d], bf16, on random rows."""
    p = params_c["periods"]["p1_mamba"]
    w_in, w_out = p["in_proj"][0], p["out_proj"][0]
    g = torch.Generator(device=w_in.device).manual_seed(7)
    h = torch.randn(tokens, w_in.shape[0], generator=g, device=w_in.device).to(torch.bfloat16)
    y = torch.randn(tokens, w_out.shape[0], generator=g, device=w_in.device).to(torch.bfloat16)
    with torch.inference_mode():
        return {"in_proj": cuda_ms(torch, lambda: h @ w_in, iters=20),
                "out_proj": cuda_ms(torch, lambda: y @ w_out, iters=20)}


def hybrid_serve_phase(torch, counters: dict, kernel):
    """jamba-1.5-large-398b (the hybrid family) at full width, depth cut to
    a period's layers 4 and 5: bf16 weights initialised on the card tensor
    by tensor, saved under data=2,model=2 with expert parallelism and
    ``param_dtype="bfloat16"`` (a serving checkpoint); the serve path from
    it (:func:`serve_restores`: RESHARD_STREAM, with the experts and the
    fused ``in_proj`` resliced or consolidated, and DIRECT restores
    bit-equal to the save, a bf16 prefill of 4 x 512 with exactly 1 flash
    and 1 SSD launch, 16 greedy decode steps through the mixed cache, the
    same tokens, the profiled prefill and its breakdown).  Then in fp32 on
    the card (the bf16 trees freed): the kernel path against the plain
    attention and ``ssd_chunked`` by the experts chosen and by the logits
    no routing flip reaches; the peak card memory."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.engine import default_workers
    from repro_torch.core.pytree import unflatten_from_paths
    from repro_torch.dist.sharding import make_plan, vocab_multiple
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.launch.serve import serving_parallelism
    from repro_torch.models import build_model
    from repro_torch.models import lm as lm_mod
    from repro_torch.models.attention import full_attention
    from repro_torch.models.ssm import ssd_chunked

    dev = torch.device("cuda")
    full = get_config("jamba-1.5-large-398b")
    # a real period's layers 4 and 5: attention with the 16-expert MoE,
    # then Mamba-2 with the dense MLP
    cfg = dataclasses.replace(full, num_layers=2, hybrid_pattern=("attn", "mamba"))
    s_cfg = cfg.ssm
    per_prefill = {"flash_attention": 1, "ssd_scan": 1}
    reset = functools.partial(reset_launches, counters)
    counts = functools.partial(launch_counts, counters)

    def plan_for(mesh_str, dtype=torch.bfloat16):
        mesh = mesh_spec_from_string(mesh_str)
        parallel = dataclasses.replace(serving_parallelism(mesh), param_dtype="bfloat16")
        lm = build_model(cfg, vocab_multiple=vocab_multiple(parallel, mesh), compute_dtype=dtype)
        return lm, make_plan(cfg, lm.registry, parallel, mesh)

    def on_run(shapes, log):
        got = {name: dict(fn.launches_by_dtype) for name, fn in counters.items()}
        want = {name: {"bfloat16": n, "float32": 0} for name, n in per_prefill.items()}
        check(got == want, f"jamba launches by dtype {got}, want {want}")
        prefill_drop, decode_drop = capacity_drops(log, 1)
        return (dict(prefill_dropped=prefill_drop, decode_dropped=decode_drop),
                f" (bf16); dropped by capacity: prefill {prefill_drop:.4f} of the slots, decode "
                f"{decode_drop:.4f}")

    def on_direct(tlm, params_c, prof):
        rows = prof["prefill"][2]
        ssd_rows = [r for r in rows if TC_SYMBOL["ssd_scan"] in r[0]]
        ssd_ms = ssd_rows[0][1] if len(ssd_rows) == 1 and ssd_rows[0][2] == 1 else None
        moe_ms = moe_breakdown(torch, tlm, params_c, prompts, label="jamba")
        gemm_ms = mamba_gemm_ms(torch, cfg, params_c, 4 * 512)
        print(f"jamba prefill 4x512 profiled: SSD scan {fmt_ms(ssd_ms)} (1 launch); by CUDA "
              f"events: the MoE block {moe_ms['moe_block']:.3f} ms (experts "
              f"{moe_ms['experts (3 bmm + silu)']:.3f}), the Mamba-2 GEMMs in_proj "
              f"{gemm_ms['in_proj']:.3f} and out_proj {gemm_ms['out_proj']:.3f} ms")
        return dict(prefill_ssd_ms=ssd_ms, moe_ms=moe_ms, mamba_gemm_ms=gemm_ms)

    gc.collect()
    torch.cuda.empty_cache()
    lm, src_plan = plan_for("data=2,model=2")
    n_params = lm.registry.num_params()
    check(src_plan.moe_mode == "ep", f"data=2,model=2 plans moe_mode {src_plan.moe_mode}")
    check(n_params == JAMBA_PARAMS, f"{n_params} params at 2 layers")
    check([(ld.name, ld.moe) for ld in lm.stages[0].body] == [("p0_attn", True),
                                                              ("p1_mamba", False)],
          f"jamba cut: stages {lm.stages}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    saved = init_bf16(torch, lm.registry, 0, dev)
    torch.cuda.synchronize()
    print(f"jamba-1.5-large-398b: d {cfg.d_model}, {cfg.num_heads}:{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, Mamba-2 d_inner {s_cfg.d_inner(cfg.d_model)} in "
          f"{s_cfg.n_heads(cfg.d_model)} heads of {s_cfg.head_dim}, state {s_cfg.d_state}, conv "
          f"{s_cfg.d_conv}; {cfg.moe.num_experts} experts top-{cfg.moe.top_k} of d_ff "
          f"{cfg.moe.d_ff_expert}, dense d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; depth cut from "
          f"{full.num_layers} layers in periods of {len(full.hybrid_pattern)} to 2 (pattern "
          f"{cfg.hybrid_pattern}); {n_params} params ({2 * n_params / 1e9:.2f} GB bf16) "
          f"initialised on the card in {time.perf_counter() - t0:.2f} s (peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
    root = ROOT / "build" / "chip_smoke_ckpt_jamba"
    shutil.rmtree(root, ignore_errors=True)
    prompts = torch.randint(0, cfg.vocab_size, (4, 512),
                            generator=torch.Generator().manual_seed(8)).to(dev)
    try:
        # the bf16 weights alone (a serving checkpoint: 23.8 GB)
        step_dir, save = save_weights(torch, "jamba", cfg, src_plan, saved, root,
                                      default_workers())
        out = serve_restores(torch, "jamba", cfg, plan_for, step_dir, saved, prompts, counters,
                             kernel, per_prefill, on_run=on_run, on_direct=on_direct)
        out["save"] = save
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # Right by the repo's own means, in fp32 on the card (the bf16 trees
    # freed first): the kernel path against the plain attention and
    # ssd_chunked, by the experts chosen and the logits no flip reaches.
    params = unflatten_from_paths({n: saved.pop(n).float() for n in list(saved)})
    torch.cuda.empty_cache()
    flm = build_model(cfg, compute_dtype=torch.float32)
    out["routing"] = routing_check(torch, flm, params, prompts, reset, counts, lm_mod,
                                   full_attention, 1, label="jamba", ssd_chunked=ssd_chunked,
                                   want=per_prefill, mixes_after=True)
    check({n: fn.launches_by_dtype["float32"] for n, fn in counters.items()} == per_prefill,
          "jamba fp32 check: the kernel path's launches were not fp32")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"jamba peak card memory over the phase: {out['peak_gb']:.2f} GB")
    del params
    torch.cuda.empty_cache()
    return out


MAMBA2_PARAMS = 128_983_488  # mamba2-130m at full width and depth


def unmasked_ssd_chunked(torch, x, dt, a, bmat, cmat, *, chunk: int, h0=None):
    """``ssd_chunked`` in the reference's form (``repro/models/ssm.py``),
    kept here to show the repair at full width: the intra-chunk decay is
    ``where(tri, exp(seg), 0)``, exp taken of every entry and masked after,
    so where seg overflows above the diagonal the backward multiplies a
    zero gradient by inf.  The package masks seg before the exp."""
    from repro_torch.models.ssm import _broadcast_groups

    bsz, s, h, p = x.shape
    n = bmat.shape[-1]
    nc = s // chunk
    bq = _broadcast_groups(bmat, h).reshape(bsz, nc, chunk, h, n).float()
    cq = _broadcast_groups(cmat, h).reshape(bsz, nc, chunk, h, n).float()
    xq = x.reshape(bsz, nc, chunk, h, p)
    dtq = dt.reshape(bsz, nc, chunk, h)
    cum = torch.cumsum((dtq * a[None, None, None, :]).float(), dim=2)
    total = cum[:, :, -1, :]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    l_mask = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    xdt = xq.float() * dtq[..., None]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp",
                           torch.einsum("bcqhn,bckhn->bcqkh", cq, bq) * l_mask, xdt)
    decay_to_end = torch.exp(total[:, :, None, :] - cum)
    s_chunk = torch.einsum("bcqhp,bcqhn->bchpn", xdt * decay_to_end[..., None], bq)
    hprev = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device) if h0 is None else h0
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hprev)
        hprev = hprev * torch.exp(total[:, c])[:, :, None, None] + s_chunk[:, c]
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", cq * torch.exp(cum)[..., None],
                           torch.stack(h_prevs, 1))
    return (y_intra + y_inter).reshape(bsz, s, h, p).to(x.dtype), hprev


def first_step_grads(torch, lm, params, batch, lm_mod, ssd_form=None) -> dict:
    """The gradients of the first step's loss (``lm.loss_fn``) with respect
    to every parameter; ``ssd_form`` stands in for ``ssd_chunked``."""
    from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths

    leaves = {n: t.detach().requires_grad_(True) for n, t in flatten_with_paths(params).items()}
    real = lm_mod.ssd_chunked
    if ssd_form is not None:
        lm_mod.ssd_chunked = ssd_form
    try:
        loss, _ = lm.loss_fn(unflatten_from_paths(leaves), batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        lm_mod.ssd_chunked = real
    return dict(zip(leaves, grads))


def shard_kernel_times(torch, bq_ops, bq_ref, shard) -> dict:
    """The block-quant kernels (int8:b256) on one moment shard: each
    kernel's device time per call (the profiler, 20 warm calls) and event
    time, the plain version's event time, and the bound (each input read
    once, each output written once, at the memory rate)."""
    x = shard.reshape(-1)
    n = x.numel()
    blocks = bq_ref.blocked(x, block=256)
    q, s = bq_ops.block_quantize(x, block=256, dtype="int8")
    runs = {
        "quantize_blocks": (bq_ops.block_quantize,
                            lambda: bq_ops.block_quantize(x, block=256, dtype="int8"),
                            lambda: bq_ref.quantize_blocks(blocks, dtype="int8")),
        "dequantize_blocks": (bq_ops.block_dequantize,
                              lambda: bq_ops.block_dequantize(q, s, count=n),
                              lambda: bq_ref.dequantize_blocks(q, s, count=n)),
    }
    nbytes = x.element_size() * n + n + 4 * blocks.shape[0]  # fp32 in or out, codes, scales
    out = {}
    for name, (wrapper, kernel_fn, plain_fn) in runs.items():
        per_call, top = device_ms(torch, kernel_fn, f"{name} mamba2 moment shard",
                                  launches=lambda: wrapper.launches)
        check(top[0][2] == 20, f"{name}: {top[0][2]} launches of {top[0][0]} in 20 calls")
        out[name] = dict(ms=per_call, event_ms=cuda_ms(torch, kernel_fn, iters=20),
                         plain_ms=cuda_ms(torch, plain_fn, iters=20),
                         bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, numel=n)
        print(f"kernel {name} int8:b256 on a {tuple(shard.shape)} moment shard ({n} elements): "
              f"device ms {per_call:.5f} (event {out[name]['event_ms']:.5f}), plain_ms "
              f"{out[name]['plain_ms']:.4f}, bound_ms {out[name]['bound_ms']:.5f} (bytes: "
              f"{nbytes / 1e6:.2f} MB); {top[0][0][:48]}")
    return out


def coded_train_loop(torch, cfg, label: str, fns: dict, counters: dict, root: Path, *,
                     b: int, s: int, base=None, state0=None) -> tuple[dict, object, object]:
    """The train path with its checkpoint loop, at ``b`` x ``s`` tokens from
    ``train/data.py`` (bf16 compute, fp32 master and moments, remat full):
    6 baseline steps under data=2,model=2 (``base``, from ``state0``;
    finite losses and gradient norms, step ms, one profiled step); 3 steps
    saved with ``int8:b256`` (quantize launches == coded shards, and one
    dequantize each for the served digest), within 2e-2 of the baseline;
    resumed under data=1,model=1 (RESHARD_STREAM, fused projections of the
    weights and both coded moments consolidated) and data=2,model=2
    (DIRECT), each with one dequantize launch a coded shard and every
    shard digest checked, then 3 more steps with finite losses.  No flash
    launch (training takes the plain attention).  Returns the record, the
    last resumed state and the Source plan."""
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.configs import ParallelismConfig, TrainConfig
    from repro_torch.core.dist_ckpt import DistCheckpoint
    from repro_torch.core.engine import default_workers
    from repro_torch.core.patterns import StateKind
    from repro_torch.core.plan import TargetSpec, plan_resume
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    tcfg, parallel = TrainConfig(seed=0), ParallelismConfig()
    width = default_workers()

    def trainer(mesh, **kw):
        return Trainer.create(cfg, parallel, tcfg, mesh_spec_from_string(mesh), batch_size=b,
                              seq_len=s, device=dev, **kw)

    def finite(hist, what):
        bad = [h for h in hist if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]))]
        check(not bad, f"{label} {what}: a loss or gradient norm is not finite: {bad[:1]}")

    out: dict = {"launches_by_variant": {}}
    base = base or trainer("data=2,model=2")
    state0 = state0 or base.init_state()
    counters["flash_attention"].launches = 0
    torch.cuda.reset_peak_memory_stats()
    state, hist = base.run(state0, 0, 6)
    del state0
    finite(hist, "baseline")
    baseline = [h["loss"] for h in hist]
    step_s = sorted(h["dt"] for h in hist[1:])[len(hist[1:]) // 2]
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label} train baseline data=2,model=2: 6 steps, losses "
          f"{[round(v, 4) for v in baseline]}, grad norms "
          f"{[round(h['grad_norm'], 4) for h in hist]}; median step {step_s * 1e3:.1f} ms "
          f"({b * s / step_s:.0f} tokens/s); peak card memory {peak:.2f} GB")
    wall, busy, top = device_profile(torch, lambda: base.step_fn(state, base.batch(6)))
    print(f"profile {label} train step: wall {wall:.2f} ms (profiler on), device busy "
          f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / wall):.3f}")
    for key, ms, count in top:
        print(f"  {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    out.update(step_ms=step_s * 1e3, tokens_s=b * s / step_s, peak_gb=peak,
               step_device_ms=busy, baseline=baseline)
    del state, base
    torch.cuda.empty_cache()

    # The main path: the counts set to 0 here and read at the end.
    reset_launches(fns)
    policy = CheckpointPolicy(codec="int8:b256", save_interval=3, async_save=True)
    src = trainer("data=2,model=2", ckpt_dir=str(root), policy=policy)
    state, hist = src.run(src.init_state(), 0, 3)
    src.manager.close()
    finite(hist, "saving run")
    drift = max(abs(h["loss"] - x) for h, x in zip(hist, baseline))
    check(drift <= 2e-2, f"{label}: the saving run left the baseline ({drift:.2e})")
    quant, save_dequant = fns["quantize"].launches, fns["dequantize"].launches
    (res,) = src.save_results
    step3 = src.manager.step_dir(3)
    manifest = DistCheckpoint.open(step3).manifest
    n_coded = len(manifest.shard_codecs)
    # the save decodes each coded shard once too: the served digest's view
    check(n_coded > 0 and quant == save_dequant == n_coded, f"{label}: quantize launches "
          f"{quant}, dequantize {save_dequant}, coded shards {n_coded}")
    gb = res.bytes_written / 1e9
    rate = write_floor_rate(step3, width, root / "floor")
    print(f"{label} train save step 3 (data=2,model=2, int8:b256 fp32 moments, async, {width} "
          f"workers): {gb:.3f} GB in {res.shards_written} shards, {res.wall_time_s:.2f} s "
          f"(disk floor {gb / rate:.2f} s at {rate:.3f} GB/s); coded "
          f"{res.coded_bytes / 1e9:.3f} of raw {res.coded_raw_bytes / 1e9:.3f} GB; "
          f"{n_coded} coded shards, quantize launches {quant} by variant "
          f"{fns['quantize'].launches_by_variant}")
    src_plan = src.plan
    del state, src
    torch.cuda.empty_cache()

    resumed, stream = {}, {}
    for mesh, expect in (("data=1,model=1", "reshard_stream"), ("data=2,model=2", "direct")):
        tgt = trainer(mesh, ckpt_dir=str(root),
                      policy=CheckpointPolicy(async_save=False, save_interval=1000))
        before = fns["dequantize"].launches
        state, info = tgt.init_or_restore()
        dequant = fns["dequantize"].launches - before
        check(info is not None and info.mode.value == expect,
              f"{label} resume {mesh}: {info and info.mode.value}, want {expect}")
        check(state.step == 3 and dequant == n_coded,
              f"{label} resume {mesh}: step {state.step}, {dequant} dequantize launches for "
              f"{n_coded} coded shards")
        trees = {StateKind.FP32: state.params, StateKind.EXP_AVG: state.exp_avg,
                 StateKind.EXP_AVG_SQ: state.exp_avg_sq}
        n_checked, n_stripped = digests_match(torch, trees, src_plan, manifest, width)
        check(n_checked + n_stripped == len(manifest.shard_digests)
              and (n_stripped == 0 or expect == "reshard_stream"),
              f"{label} {mesh}: {n_checked} + {n_stripped} of {len(manifest.shard_digests)} "
              "digests checked")
        if expect == "reshard_stream":
            stream = {kind: {n: t.clone() for n, t in flatten_with_paths(tree).items()}
                      for kind, tree in trees.items()}
        else:  # every digest checked: each RESHARD_STREAM leaf equals its region
            for kind, tree in trees.items():
                for name, got in flatten_with_paths(tree).items():
                    t = stream[kind][name]
                    check(torch.equal(t, got[tuple(slice(0, n) for n in t.shape)]),
                          f"{label}: RESHARD_STREAM {name} {kind.value} differs from DIRECT")
            del stream
        consolidated = plan_resume(manifest, TargetSpec(tgt.plan.mesh, tgt.plan.param_specs)
                                   ).consolidate_params
        state, hist = tgt.run(state, 3, 3)
        tgt.manager.close()
        finite(hist, f"resume {mesh}")
        resumed[expect] = [h["loss"] for h in hist]
        gap = max(abs(x - y) for x, y in zip(resumed[expect], baseline[3:]))
        check(gap <= 2e-2, f"{label} resume {mesh}: steps 4-6 left the baseline ({gap:.2e})")
        print(f"{label} train resume {mesh}: {info.mode.value} in {info.wall_time_s:.2f} s "
              f"(consolidated in memory: {sorted(consolidated)}), "
              f"step 3, {dequant} dequantize launches; {n_checked} shard digests of the "
              f"save equal the restored state re-cut under the Source plan"
              + (f" ({n_stripped} more, restored without the vocab padding, held against "
                 "the DIRECT resume)" if n_stripped else "")
              + ("; every leaf equals the RESHARD_STREAM resume's in its region"
                 if expect == "direct" else "")
              + "; steps 4-6 losses "
              + ", ".join(f"{x:.4f} (baseline {y:.4f})" for x, y in zip(resumed[expect],
                                                                     baseline[3:]))
              + ", grad norms " + ", ".join(f"{h['grad_norm']:.4f}" for h in hist))
        out[f"resume_{expect}_s"] = info.wall_time_s
        del tgt
        torch.cuda.empty_cache()
    check(counters["flash_attention"].launches == 0, "flash launched during training")
    out.update(save_s=res.wall_time_s, save_gb=gb, floor_s=gb / rate, coded=n_coded,
               resumed=resumed)
    for name, fn in fns.items():
        out[name] = fn.launches
        out["launches_by_variant"][name] = dict(fn.launches_by_variant)
    print(f"{label} train launches (the saving run and both resumes): quantize "
          f"{out['quantize']}, dequantize {out['dequantize']} (coded shards {n_coded}: "
          f"decoded once by the save, once by each resume); by variant "
          f"{out['launches_by_variant']}")
    check(out["dequantize"] == 3 * n_coded, f"{label}: {out['dequantize']} dequantize launches")
    return out, state, src_plan


def ssm_train_phase(torch, bq_ops, bq_ref, counters: dict):
    """mamba2-130m at full width and depth, 8 x 512 from ``train/data.py``,
    bf16 compute, fp32 master and moments, remat full.  The first step's
    gradients through ``ssd_chunked`` (all finite) and through the
    reference's unmasked form (its non-finite ``a_log``/``dt_bias``
    gradients counted); then :func:`coded_train_loop` (the fused
    ``in_proj`` of the weights and both coded moments consolidated through
    the dequantize kernel on the RESHARD_STREAM resume); then the kernels
    against their plain version byte for byte on an ``in_proj`` moment
    shard, and their times there."""
    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config
    from repro_torch.core.layout import slice_shard
    from repro_torch.core.patterns import StateKind
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.models import lm as lm_mod
    from repro_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    cfg = get_config("mamba2-130m")
    root = ROOT / "build" / "chip_smoke_train_mamba2"
    shutil.rmtree(root, ignore_errors=True)
    b, s = 8, 512
    fns = {"quantize": bq_ops.block_quantize, "dequantize": bq_ops.block_dequantize}
    try:
        gc.collect()
        torch.cuda.empty_cache()
        base = Trainer.create(cfg, ParallelismConfig(), TrainConfig(seed=0),
                              mesh_spec_from_string("data=2,model=2"), batch_size=b, seq_len=s,
                              device=dev)
        n_params = base.lm.registry.num_params()
        check(n_params == MAMBA2_PARAMS, f"mamba2-130m: {n_params} params")
        state0 = base.init_state()
        batch = base.batch(0)
        grads = first_step_grads(torch, base.lm, state0.params, batch, lm_mod)
        bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all())]
        ssm_names = [n for n in grads if n.endswith((".a_log", ".dt_bias"))]
        old = first_step_grads(torch, base.lm, state0.params, batch, lm_mod,
                               functools.partial(unmasked_ssd_chunked, torch))
        old_bad = {n: int((~torch.isfinite(old[n])).sum()) for n in ssm_names}
        dt_max = float(torch.nn.functional.softplus(state0.params["layers"]["blk"]["dt_bias"]).max())
        print(f"mamba2 first step's gradients ({n_params} params, {b}x{s} tokens, bf16, remat "
              f"full): through ssd_chunked {sum(g.numel() for g in grads.values())} values, "
              f"non-finite in {len(bad)} parameters; through the reference's unmasked form "
              f"(informative): non-finite a_log/dt_bias gradients {old_bad} of "
              f"{sum(old[n].numel() for n in ssm_names)} (A up to {cfg.ssm.n_heads(cfg.d_model)}, "
              f"softplus(dt_bias) up to {dt_max:.4f})")
        check(not bad, f"mamba2: non-finite gradients through ssd_chunked in {bad[:4]}")
        grad_check = dict(nonfinite_params=len(bad), unmasked_nonfinite=old_bad)
        del grads, old

        out, state, src_plan = coded_train_loop(torch, cfg, "mamba2", fns, counters, root,
                                                b=b, s=s, base=base, state0=state0)
        out["grad_check"] = grad_check
        del base, state0

        # Outside the main path's counts: the kernels against their plain
        # version, then their times, on the largest moment shard (in_proj's).
        name = "layers.blk.in_proj"
        out["shard_check"] = coded_shard_check(torch, bq_ops, bq_ref, src_plan, state.exp_avg,
                                               name, label="mamba2", dtype=torch.float32)
        spec = src_plan.param_specs[name]
        shard = slice_shard(flatten_with_paths(state.exp_avg)[name],
                            spec.layout_for(StateKind.EXP_AVG, src_plan.mesh), 0)
        out["shard_times"] = shard_kernel_times(torch, bq_ops, bq_ref, shard)
        del state, shard
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


VLM_PARAMS = 2_141_237_249      # llama-3.2-vision-11b at full width, one period (5 layers)
WHISPER_PARAMS = 56_355_840     # whisper-tiny as configured (4 + 4 layers, no cut)


def cross_serve_phase(torch, counters: dict, kernel, *, arch: str, layers: int | None,
                      prompt_len: int, n_params: int, want: list, label: str) -> dict:
    """A cross-attention config (llama-vision: ``vlm``; whisper: ``encdec``)
    at full width, depth cut to ``layers`` where given: fp32 weights from a
    seeded generator on the card (llama-vision's ``cross_gate``, whose init
    is 0 and would make the cross layer add nothing, set to values from
    [0.5, 1.5) with a random sign from the seed); saved under
    data=2,model=2; the serve path from it (:func:`serve_restores`:
    RESHARD_STREAM, with ``wqkv`` and ``cross_wkv`` consolidated and
    whisper's vocab padding stripped, and DIRECT restores bit-equal to the
    save; a bf16 prefill of 4 x ``prompt_len`` with the serve CLI's bf16
    source embeds, its flash launches recorded at the wrapper: ``want``
    lists each one's (dtype, Sq, Skv, causal); 16 greedy decode steps, the
    same tokens; the profiled prefill and decode).  Then in fp32 on the
    card: the kernel path against the plain attention through the prefill
    and 16 decode steps (:func:`decode_check`); and another source moves
    the logits."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.engine import default_workers
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.dist.sharding import make_plan, vocab_multiple
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.launch.serve import draw_source_embeds, serving_parallelism
    from repro_torch.models import build_model
    from repro_torch.models import decode as D
    from repro_torch.models import lm as lm_mod
    from repro_torch.models.attention import full_attention

    dev = torch.device("cuda")
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers) if layers else full
    per_prefill = {"flash_attention": len(want), "ssd_scan": 0}
    cache_len = prompt_len + 16

    def plan_for(mesh_str, dtype=torch.bfloat16):
        mesh = mesh_spec_from_string(mesh_str)
        parallel = serving_parallelism(mesh)
        lm = build_model(cfg, vocab_multiple=vocab_multiple(parallel, mesh), compute_dtype=dtype)
        return lm, make_plan(cfg, lm.registry, parallel, mesh)

    def on_run(shapes, log):
        check(shapes.calls == want, f"{label}: flash launches (dtype, Sq, Skv, causal) "
              f"{shapes.calls}, want {want}")
        return {}, ""

    lm, src_plan = plan_for("data=2,model=2")
    logical = build_model(cfg).registry.num_params()  # without the vocab padding of model=2
    check(logical == n_params, f"{label}: {logical} params")
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    gates = None
    if cfg.cross_attn is not None:
        gate = params["periods"]["cross"]["cross_gate"]
        g = torch.Generator(device=dev).manual_seed(1)
        mag = torch.rand(gate.shape, generator=g, device=dev) + 0.5
        sign = torch.randint(0, 2, gate.shape, generator=g, device=dev) * 2 - 1
        gate.copy_(mag * sign)
        gates = gate.flatten().tolist()
    torch.cuda.synchronize()
    src_what = (f"{cfg.cross_attn.source_len} x {cfg.cross_attn.source_dim} source embeds, a "
                f"cross layer every {cfg.cross_attn.every_k_layers}"
                if cfg.cross_attn else
                f"an encoder of {cfg.encoder.num_layers} layers over {cfg.encoder.source_len} "
                "frames")
    print(f"{arch}: d {cfg.d_model}, {cfg.num_heads}:{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (padded to "
          f"{lm.vocab_padded} under data=2,model=2), {src_what}; "
          + (f"depth cut from {full.num_layers} to {cfg.num_layers} layers; " if layers else
             f"{cfg.num_layers} decoder layers, no cut; ")
          + f"{n_params} params ({4 * n_params / 1e9:.3f} GB fp32) initialised on the card in "
          f"{time.perf_counter() - t0:.2f} s" + (f"; cross_gate set to {gates} (the init's 0 "
                                                 "would hide the cross layer)" if gates else ""))
    root = ROOT / "build" / f"chip_smoke_ckpt_{label}"
    shutil.rmtree(root, ignore_errors=True)
    prompts = torch.randint(0, cfg.vocab_size, (4, prompt_len),
                            generator=torch.Generator().manual_seed(6)).to(dev)
    src = draw_source_embeds(cfg, 4, 7, dev)  # the serve CLI's draw: bf16, from the seed
    saved = flatten_with_paths(params)
    try:
        step_dir, save = save_weights(torch, label, cfg, src_plan, saved, root, default_workers())
        out = {"source_shape": list(src.shape)}
        out.update(serve_restores(torch, label, cfg, plan_for, step_dir, saved, prompts,
                                  counters, kernel, per_prefill, source_embeds=src,
                                  cache_len=cache_len, on_run=on_run))
        out["save"] = save
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del saved
    torch.cuda.empty_cache()

    # Right by the repo's own means, in fp32 on the card: the kernel path
    # against the plain attention, through the prefill and decode.
    flm = build_model(cfg, vocab_multiple=2, compute_dtype=torch.float32)
    check(flm.vocab_padded == lm.vocab_padded, f"{label}: fp32 model vocab {flm.vocab_padded}")
    fp32_want = [("float32", *c[1:]) for c in want]
    with FlashShapes(kernel) as shapes:
        out["fp32_check"] = decode_check(torch, flm, params, prompts, counters, lm_mod,
                                         full_attention, len(want), label, source_embeds=src)
    check(shapes.calls == fp32_want, f"{label} fp32 flash launches {shapes.calls}")
    # another source moves the logits (the cross layers read it)
    other = draw_source_embeds(cfg, 4, 8, dev)
    with torch.inference_mode():
        la, _ = D.prefill(flm, params, D.init_cache(flm, 4, cache_len, device=dev), prompts,
                          source_embeds=src)
        lb, _ = D.prefill(flm, params, D.init_cache(flm, 4, cache_len, device=dev), prompts,
                          source_embeds=other)
    moved = (la - lb).abs().max().item()
    print(f"{label} fp32: another source moves the last position's logits by up to {moved:.4f}")
    check(moved > 1e-2, f"{label}: the logits do not depend on the source ({moved:.2e})")
    out["source_moves_logits"] = moved
    del params, flm
    gc.collect()
    torch.cuda.empty_cache()
    return out


def encdec_train_phase(torch, bq_ops, counters: dict) -> dict:
    """whisper-tiny at full width and depth (56,355,840 params; vocab
    51,865 padded to 51,866 under data=2,model=2), 8 x 448 tokens with
    1500 source frames from ``train/data.py``: :func:`coded_train_loop`
    (the encoder's and decoder's fused projections and both coded moments
    consolidated on the RESHARD_STREAM resume, the vocab padding stripped)."""
    from repro_torch.configs import get_config

    cfg = get_config("whisper-tiny")
    root = ROOT / "build" / "chip_smoke_train_whisper"
    shutil.rmtree(root, ignore_errors=True)
    fns = {"quantize": bq_ops.block_quantize, "dequantize": bq_ops.block_dequantize}
    try:
        gc.collect()
        torch.cuda.empty_cache()
        out, state, _ = coded_train_loop(torch, cfg, "whisper", fns, counters, root, b=8, s=448)
        check(tuple(state.params["embed"].shape) == (51866, 384),
              f"whisper DIRECT resume embed {tuple(state.params['embed'].shape)}")
        del state
        torch.cuda.empty_cache()
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

    usage = build_all({"flash_attention": kernel, "block_quant": bq_kernel, "ssd_scan": ssd_kernel})
    check_no_spills(usage["flash_attention"], ("fwd_kernel_tc<256, 256>", "fwd_kernel<float, 256, 256>",
                                               "fwd_kernel_tc<192, 128>", "fwd_kernel<float, 192, 128>"))
    k = kernel_phase(torch, F, kernel, ops, ref)
    bq = block_quant_phase(torch, bq_ops, bq_ref)
    ssd = ssd_phase(torch, F, ssd_ops, ssd_ref)
    ssd_jamba = ssd_layout(torch, F, ssd_ops, ssd_ref, (4, 512, 128, 128, 1, 128), 256,
                           "jamba-1.5-large-398b")
    counters = {"flash_attention": ops.flash_attention, "ssd_scan": ssd_ops.ssd_scan}
    runs = serve_phase(torch, "smollm-360m", counters,
                       {"flash_attention": 32, "ssd_scan": 0}, cpu_len=48, via_ucp=True)
    ssm_runs = serve_phase(torch, "mamba2-130m", counters,
                           {"flash_attention": 0, "ssd_scan": 24}, cpu_len=512)
    gemma = gemma_phase(torch, counters)
    train = train_phase(torch, ops, bq_ops)
    bq_counters = {"quantize": bq_ops.block_quantize, "dequantize": bq_ops.block_dequantize}
    reset_launches(bq_counters)
    hot = hot_phase(torch, bq_ops)
    hot_bq = launch_counts(bq_counters)  # the drain's encode and digest, the fall-through's decode
    check(hot_bq == {"quantize": hot["quantize"],
                     "dequantize": hot["dequantize"] + hot["fall_through_dequantize"]},
          f"hot: block-quant launches {hot_bq} outside the counted sub-phases")
    reset_launches(bq_counters)
    fanout = fanout_phase(torch, bq_ops, counters)
    fanout_bq = launch_counts(bq_counters)  # the publisher's saves; the fleet's syncs make none
    check(fanout_bq == {k: sum(v[k] for v in fanout["launches_by_phase"].values())
                        for k in fanout_bq},
          f"fanout: block-quant launches {fanout_bq} outside the counted sub-phases")
    moe_serve = moe_serve_phase(torch, counters, bq_ops, kernel)
    moe_train = moe_train_phase(torch, bq_ops, bq_ref, counters)
    reset_launches(bq_counters)
    mla = mla_serve_phase(torch, counters, kernel)
    mla_bq = launch_counts(bq_counters)  # the phase saves its weights uncoded: none
    check(mla_bq == {"quantize": 0, "dequantize": 0}, f"serve-mla: block-quant launches {mla_bq}")
    reset_launches(bq_counters)
    hybrid = hybrid_serve_phase(torch, counters, kernel)
    hybrid_bq = launch_counts(bq_counters)  # bf16 weights saved uncoded: none
    check(hybrid_bq == {"quantize": 0, "dequantize": 0},
          f"serve-hybrid: block-quant launches {hybrid_bq}")
    reset_launches(counters)
    train_ssm = ssm_train_phase(torch, bq_ops, bq_ref, counters)
    train_ssm_kernels = launch_counts(counters)  # training goes through the plain versions
    # llama-vision: 4 causal self layers, then the gated cross layer at 512 x 1600
    reset_launches(bq_counters)
    vlm = cross_serve_phase(torch, counters, kernel, arch="llama-3.2-vision-11b", layers=5,
                            prompt_len=512, n_params=VLM_PARAMS, label="vlm",
                            want=[("bfloat16", 512, 512, True)] * 4
                            + [("bfloat16", 512, 1600, False)])
    # whisper: 4 encoder layers over 1500 frames, then each decoder layer's
    # causal self-attention and its cross-attention to the encoder's output
    encdec = cross_serve_phase(torch, counters, kernel, arch="whisper-tiny", layers=None,
                               prompt_len=432, n_params=WHISPER_PARAMS, label="encdec",
                               want=[("bfloat16", 1500, 1500, False)] * 4
                               + [("bfloat16", 432, 432, True), ("bfloat16", 432, 1500, False)] * 4)
    cross_bq = launch_counts(bq_counters)  # both serve phases save their weights uncoded: none
    check(cross_bq == {"quantize": 0, "dequantize": 0},
          f"serve-vlm and serve-encdec: block-quant launches {cross_bq}")
    reset_launches(counters)
    train_encdec = encdec_train_phase(torch, bq_ops, counters)
    train_encdec_kernels = launch_counts(counters)

    rows = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "variant": VARIANT["flash_attention_fwd"],
        "launches": runs["data=1,model=1"]["launches"]["flash_attention"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"]["kernel"],
        "ms_by": ms_by("flash_attention_fwd"),
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
        "d256_event_ms": k["d256"]["event_ms"],
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
        "d128_ms": k["d128"]["ms"],
        "d128_event_ms": k["d128"]["event_ms"],
        "d128_library_ms": k["d128"]["library_ms"],
        "d128_fp32_ms": k["d128"]["fp32_ms"],
        "d128_plain_ms": k["d128"]["plain_ms"],
        "d128_bound_ms": k["d128"]["bound_ms"],
        "d128_bound_by": k["d128"]["bound_by"],
        "d128_max_abs_err": k["d128"]["max_abs_err"],
        "d128_shape": "bf16 B=4 S=512 48:8 heads of 128, causal (mixtral-8x22b)",
        "mixtral_launches": moe_serve["launches"]["flash_attention"],
        "mixtral_prefill_device_ms": moe_serve["prefill_device_ms"],
        "mixtral_prefill_kernel_ms": moe_serve["prefill_kernel_ms"],
        "d192_ms": k["d192"]["ms"],
        "d192_event_ms": k["d192"]["event_ms"],
        "d192_library_ms": k["d192"]["library_ms"],
        "d192_library_backend": k["d192"]["library_backend"],
        "d192_library_refused": k["d192"]["library_refused"],
        "d192_fp32_ms": k["d192"]["fp32_ms"],
        "d192_plain_ms": k["d192"]["plain_ms"],
        "d192_bound_ms": k["d192"]["bound_ms"],
        "d192_bound_by": k["d192"]["bound_by"],
        "d192_max_abs_err": k["d192"]["max_abs_err"],
        "d192_shape": "bf16 B=4 S=512 128:128 heads, q and k of 192, v of 128, causal "
                      "(deepseek-v2-236b MLA)",
        "deepseek_launches": mla["launches"]["flash_attention"],
        "deepseek_prefill_device_ms": mla["prefill_device_ms"],
        "deepseek_prefill_kernel_ms": mla["prefill_kernel_ms"],
        **{f"jamba_{key}": k["jamba"][key] for key in (
            "ms", "event_ms", "library_ms", "fp32_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err")},
        "jamba_shape": "bf16 B=4 S=512 64:8 heads of 128, causal (jamba-1.5-large-398b)",
        "jamba_launches": hybrid["launches"]["flash_attention"],
        "jamba_prefill_device_ms": hybrid["prefill_device_ms"],
        "jamba_prefill_kernel_ms": hybrid["prefill_kernel_ms"],
        "train_ssm_launches": train_ssm_kernels["flash_attention"],
        **{f"{tag}_{key}": k[tag][key] for tag in ("vlm_cross", "vlm_self", "encdec_encoder",
                                                   "encdec_self", "encdec_cross") for key in (
            "ms", "event_ms", "library_ms", "fp32_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err")},
        "vlm_cross_shape": "bf16 B=4 Sq=512 Skv=1600 32:8 heads of 128, no mask "
                           "(llama-3.2-vision-11b's cross layer)",
        "vlm_self_shape": "bf16 B=4 S=512 32:8 heads of 128, causal (llama-3.2-vision-11b)",
        "encdec_encoder_shape": "bf16 B=4 S=1500 6:6 heads of 64, no mask (whisper-tiny's "
                                "encoder)",
        "encdec_self_shape": "bf16 B=4 S=432 6:6 heads of 64, causal (whisper-tiny's decoder "
                             "self-attention)",
        "encdec_cross_shape": "bf16 B=4 Sq=432 Skv=1500 6:6 heads of 64, no mask "
                              "(whisper-tiny's cross layers)",
        "offset_causal_max_abs_err": k["offset_causal"],
        "vlm_launches": vlm["launches"]["flash_attention"],
        "vlm_prefill_device_ms": vlm["prefill_device_ms"],
        "vlm_prefill_kernel_ms": vlm["prefill_kernel_ms"],
        "encdec_launches": encdec["launches"]["flash_attention"],
        "encdec_prefill_device_ms": encdec["prefill_device_ms"],
        "encdec_prefill_kernel_ms": encdec["prefill_kernel_ms"],
        "train_encdec_launches": train_encdec_kernels["flash_attention"],
        "fanout_launches": {k: v["launches"] for k, v in fanout["serve"].items()},
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
            "ms_by": ms_by(name),
            "event_ms": bq[name]["event_ms"]["kernel"],
            "general_ms": bq[name]["ms"]["general"],
            "plain_ms": bq[name]["event_ms"]["plain"],
            "bound_ms": bq[name]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        })
        rows[-1]["mixtral_launches"] = moe_train[which] + (
            moe_serve["save"]["quantize"] if which == "quantize" else 0)
        rows[-1]["mixtral_shard_numel"] = moe_train["shard_check"]["numel"]
        rows[-1]["mixtral_shard_max_abs_err"] = moe_train["shard_check"]["max_abs_err"]
        rows[-1]["deepseek_launches"] = mla_bq[which]
        rows[-1]["jamba_launches"] = hybrid_bq[which]
        rows[-1]["train_ssm_launches"] = train_ssm[which]
        rows[-1]["train_ssm_launches_by_variant"] = train_ssm["launches_by_variant"][which]
        rows[-1]["vlm_encdec_serve_launches"] = cross_bq[which]
        rows[-1]["train_encdec_launches"] = train_encdec[which]
        rows[-1]["train_encdec_launches_by_variant"] = train_encdec["launches_by_variant"][which]
        rows[-1]["train_ssm_shard_numel"] = train_ssm["shard_times"][name]["numel"]
        rows[-1]["train_ssm_shard_max_abs_err"] = train_ssm["shard_check"]["max_abs_err"]
        for key in ("ms", "event_ms", "plain_ms", "bound_ms"):
            rows[-1][f"train_ssm_shard_{key}"] = train_ssm["shard_times"][name][key]
        if name == "dequantize_blocks":
            rows[-1]["convert_launches"] = train["export"]["launches"]
        rows[-1]["fanout_launches"] = fanout_bq[which]
        rows[-1]["fanout_launches_by_phase"] = {k: v[which]
                                                for k, v in fanout["launches_by_phase"].items()}
        rows[-1]["hot_launches"] = hot_bq[which]
        rows[-1]["hot_launches_by_phase"] = {k: v[which]
                                             for k, v in hot["launches_by_phase"].items()}
    rows.append({
        "name": "ssd_scan_fwd",
        "route": "cuda",
        "source": SSD_SOURCE,
        "replaces": SSD_REPLACES,
        "variant": VARIANT["ssd_scan_fwd"],
        "launches": ssm_runs["data=1,model=1"]["launches"]["ssd_scan"],
        "max_abs_err": ssd["max_abs_err"],
        "ms": ssd["ms"]["kernel"],
        "ms_by": ms_by("ssd_scan_fwd"),
        "event_ms": ssd["event_ms"]["kernel"],
        "fp32_ms": ssd["ms"]["fp32"],
        "plain_ms": ssd["event_ms"]["plain"],
        "bound_ms": ssd["bound_ms"],
        "bound_by": ssd["bound_by"],
        "library_ms": None,
        "prefill_device_ms": ssm_runs["data=2,model=2"]["prefill_device_ms"],
        "prefill_kernel_ms": ssm_runs["data=2,model=2"]["prefill_kernel_ms"],
        "mixtral_launches": moe_serve["launches"]["ssd_scan"],
        "deepseek_launches": mla["launches"]["ssd_scan"],
        **{f"jamba_{key}": ssd_jamba[key] for key in (
            "ms", "event_ms", "fp32_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")},
        "jamba_shape": "bf16 B=4 S=512 H=128 P=128 G=1 N=128 chunk 256 (jamba-1.5-large-398b)",
        "jamba_launches": hybrid["launches"]["ssd_scan"],
        "jamba_prefill_kernel_ms": hybrid["prefill_ssd_ms"],
        "train_ssm_launches": train_ssm_kernels["ssd_scan"],
        "vlm_launches": vlm["launches"]["ssd_scan"],
        "encdec_launches": encdec["launches"]["ssd_scan"],
        "train_encdec_launches": train_encdec_kernels["ssd_scan"],
    })
    print(json.dumps({"io": {"serve smollm-360m": runs["io"], "train smollm-360m": train["io"],
                             "train delta": train["delta"], "train gc under pin": train["gc"],
                             "serve mixtral-8x22b": {"save": moe_serve["save"],
                                                     "read_floor": moe_serve["read_floor"],
                                                     "restores": moe_serve["runs"]},
                             "train mixtral-8x22b": {k: moe_train[k] for k in (
                                 "save_s", "save_gb", "floor_s", "resume_s")},
                             "serve deepseek-v2-236b": {"save": mla["save"],
                                                        "read_floor": mla["read_floor"],
                                                        "restores": mla["runs"]},
                             "serve jamba-1.5-large-398b": {"save": hybrid["save"],
                                                            "read_floor": hybrid["read_floor"],
                                                            "restores": hybrid["runs"]},
                             "train mamba2-130m": {k: train_ssm[k] for k in (
                                 "save_s", "save_gb", "floor_s", "resume_reshard_stream_s",
                                 "resume_direct_s")},
                             "serve llama-3.2-vision-11b": {"save": vlm["save"],
                                                            "read_floor": vlm["read_floor"],
                                                            "restores": vlm["runs"]},
                             "serve whisper-tiny": {"save": encdec["save"],
                                                    "read_floor": encdec["read_floor"],
                                                    "restores": encdec["runs"]},
                             "train whisper-tiny": {k: train_encdec[k] for k in (
                                 "save_s", "save_gb", "floor_s", "resume_reshard_stream_s",
                                 "resume_direct_s")}}}))
    print(json.dumps({"mixtral": {"serve": {k: v for k, v in moe_serve.items()
                                            if k not in ("save", "read_floor", "runs")},
                                  "train": moe_train}}))
    print(json.dumps({"deepseek": {k: v for k, v in mla.items()
                                   if k not in ("save", "read_floor", "runs")}}))
    print(json.dumps({"jamba": {k: v for k, v in hybrid.items()
                                if k not in ("save", "read_floor", "runs")}}))
    print(json.dumps({"train_ssm": train_ssm}))
    print(json.dumps({"vlm": {k: v for k, v in vlm.items()
                              if k not in ("save", "read_floor", "runs")}}))
    print(json.dumps({"encdec": {"serve": {k: v for k, v in encdec.items()
                                           if k not in ("save", "read_floor", "runs")},
                                 "train": train_encdec}}))
    print(json.dumps({"hot": {k: v for k, v in hot.items() if k != "launches_by_phase"}}))
    print(json.dumps({"fanout": {k: v for k, v in fanout.items() if k != "launches_by_phase"}}))
    print(json.dumps({"restore_split": RESTORE_SPLIT}))
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
