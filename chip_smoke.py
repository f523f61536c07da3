#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, any failure exits non-zero (no phase catches its own failure, and
nothing falls back to the CPU or to a plain version):

1. device  — require CUDA; print the card's name and power limit as
   ``nvidia-smi`` reports them;
2. build   — compile the three kernel sources of this checkout with nvcc
   (sm_90a), one process each, started together; print the build seconds
   and ptxas' report, and fail if a bf16 flash instance of the main path
   (the wgmma kernel's ``fwd_kernel_wgmma<64, 64, 128>``, ``<128, 128,
   128>``, ``<256, 256, 64>`` and ``<192, 128, 128>``) or the fp32 ones at
   the head dims 256 and (192, 128) spill;
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
   causal row seeing at most Skv keys); causal launches at 512 x 1600
   and 1600 x 512 (8:2 heads of 128) against the plain version only; and
   at a ``q_offset`` (row i at position ``q_offset + i``): smollm-360m's
   rank-1 prefill under sequence parallelism over model=2 (B=4, 256 rows at
   offset 256 against 512 keys, 15:5 heads of 64) and a windowed ragged
   one, both kernels against the plain version, then the bf16 kernel's
   device time beside the fp32 kernel's, the plain version's, the bound and
   the library's (``scaled_dot_product_attention`` with
   ``causal_lower_right(256, 512)``, its backend named);
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
4a. collectives — 2 ranks as 2 spawned processes on the one card, a gloo
   group with CUDA tensors (NCCL puts no two ranks on one device) through
   a ``FileStore``; each builds smollm-360m at full width, its depth cut
   from 32 to 2 layers (``CUT_LAYERS``), from seed 0 (the same
   weights on both, checked), bf16 compute and remat, and runs 4 steps of
   a fresh 4 x 512 batch from ``train/data.py`` (seeded by step and rank),
   forward and backward with no update, every parameter's fp32 gradient
   through ``repro_torch.dist.compressed_psum`` with its own residual
   (one quantize and one dequantize launch a parameter).  Checks: step 0's
   codes and scales bit-equal to the plain version of the same tensors;
   every step, |synced - all_reduce(acc)| within the sum over ranks of
   block absmax / 254 (plus fp32 slack; the uncompressed all-reduce runs
   for this check only); per rank, sum_t sent_t = sum_t g_t - e_T within
   1e-5 of sum |g|, and ||sum synced - sum true|| / ||sum true|| < 0.05;
   exactly n_params launches of each kernel a rank and step; no flash
   launch (a recorded gradient takes the plain attention); both ranks exit
   0 within 240 s.  Prints the wire bytes and ratio, each step's sync wall,
   its all-reduce share (s, GB/s) and the kernels' CUDA-event ms;
4b. multirank — the multi-rank training runtime on smollm-360m at full
   width, its depth cut from 32 to 2 layers (``CUT_LAYERS``; 8 x 512
   global, bf16 compute): a one-process baseline (data=1,model=1, 6
   steps); 2 spawned ranks on the one card (gloo with CUDA tensors, a
   ``FileStore``) through ``Trainer.create(..., group=)`` under
   data=2,model=1, steps 1-2 with each rank writing its own ``int8:b256``
   shards at step 2; 2 new ranks under data=1,model=2 resuming step 2
   (RESHARD_STREAM) for steps 3-4, computed partitioned over the model
   axis (the stream's 512 positions split over model=2, MLP and vocab over
   model, attention by query rows from the gathered attention weights:
   each step's split adds ``tp_s``), which
   then serve step 2's weights restored weights-only under data=1,model=2
   (RESHARD_STREAM, ``wqkv`` consolidated; a 4 x 512 prefill, 32 flash
   launches a rank: rank 0 256 x 256 rows, rank 1 256 x 512 at
   ``q_offset`` 256; 16 greedy decode steps), held against one process's
   serve of the same step (prefill logits within 0.1, tokens equal up to
   the first step whose top-2 margin is under it), and serve it again
   from a cache sharded over its length (``shard_cache_seq``: half of
   every ``k``/``v``/``slot_pos`` a rank, fp32 tokens equal to the
   replicated cache's, bf16 tokens within 0.1 of its top logit); one process under
   data=1,model=1 resuming step 2; then the ``pipe`` stage: 2 new ranks
   resume step 2 under pipe=2,data=1,model=1 (RESHARD_STREAM, the DP -> PP
   move), each computing only its chunk of the layers (rank 0 layer 0,
   rank 1 layer 1: the stream handed along by a ``broadcast`` over the
   pair's two-member group, each step's split adds ``pipe_s`` and
   ``pipe_bytes``) for steps 3-4 and saving its own ``int8:b256`` shards at
   step 4; the same ranks resume step 4 under data=1,model=2 with tensor
   parallelism off (RESHARD_STREAM, PP -> SP) and take steps 5-6, each its
   256 rows of the stream from replicated weights; one process resumes step
   4 under data=1,model=1 for steps 5-6; and the ``fsdp`` stage: 2 new
   ranks train smollm-360m at ``FSDP_LAYERS`` (8) layers under
   data=2,model=1 from seed 0 (each layer's weights gathered over the data
   ranks where the layer reads them, and again in its recompute), two
   steps, each rank's step-2 peak (``max_memory_allocated`` less the
   memory before the state) held against the dry run's prediction of the
   same step under a fake 2-rank group (arguments exactly, the peak within
   ``DRYRUN_PEAK_TOL``; the cell traced in a process that sees no card,
   beside the phase), its losses against one process's within 2e-2, each
   step's split with ``gather_bytes``.  Checks (each fails the smoke): the gloo probe takes
   CUDA tensors for the runtime's collectives (all eight probed, values
   checked, are printed: point-to-point ``send``/``recv`` each waited with
   a time limit); steps 1-2, both resumes' steps 3-4 and the pipe stage's
   steps 3-6 finite and within 2e-2 of the baseline (steps 5-6 also of the
   one-process resume of step 4); each pipe rank's compute tree and the
   layers it computed only its chunk; the ranks' step-4 save equal to one
   process's save of the gathered state, their quantize launches summing to
   its, all vector; no flash launch in the stage; the 2-rank checkpoint's digests, codec tags
   and files equal to one process's save of the gathered step-2 state; the
   ranks' quantize and dequantize launches summing to that save's, all
   vector; each resumed rank's state bit-equal to ``slice_shard`` of a
   one-process restore; no launch while training; both worlds exit 0
   within 300 s.  Prints each step's wall split into gather, forward and
   backward, all-reduce (s, GB/s) and update, the gather through gloo's
   CUDA ``all_gather`` beside one through pinned host buffers, each rank's
   save and restore (s, bytes, shard bytes) and peak card memory;
4b2. multirank-survivors — 4 spawned ranks of the same model under
   data=4,model=1 (``int8:b256``, a hot capture a step) take steps 1-2;
   ranks 1 and 3 exit, ranks 0 and 2 re-form a group (``reform_group``)
   and recover HOT_RESHARD under the data=2,model=1 ``rebuild_on``
   proposes (no file opened, no block-quant launch, shards bit-equal to
   the gathered state's), take step 3 (within 2e-2 of the baseline) and
   save it coded (digests equal to one process's save of the gathered
   state, 18 quantize launches a rank);
4c. multirank-tp — tensor-parallel compute on gpt3-350m at full width (d
   1024, 16:16 heads of 64, d_ff 4096, vocab 51200), ``TP_LAYERS`` (6) of
   its 24 layers, 8 x 512,
   bf16 compute, remat full: a one-process baseline (steps 1-2
   from seed 0), then 2 spawned ranks under data=1,model=2 computing by
   heads (8:8 a rank, nothing gathered over the model axis) for steps
   1-2, each saving its own ``int8:b256`` shards at step 2 (its quantize
   launches one per coded shard it owns), then serving step 2 restored
   weights-only (DIRECT): 24 flash launches a rank a prefill at 8:8 heads,
   held against one process's serve as in 4b; losses within 2e-2 of the
   baseline;
4d. multirank-hot — the hot tier, delta drains and fan-out under a group:
   2 spawned ranks of smollm-360m at full width, ``CUT_LAYERS`` (2) of its
   32 layers (8 x 512, bf16) under
   data=2,model=1 with ``CheckpointPolicy(codec="int8:b256",
   hot_interval=2, disk_interval=2, hot_replication=1, save_mode="delta",
   full_interval=2)`` and a ``PublicationRegistry`` on rank 0: captures at
   steps 2 and 4 (each rank stages its own shards and receives its buddy's
   over gloo, digest-checked), drained coded on the card (step 2 full,
   step 4 a delta on it), each drain's tables equal to a one-process
   persist of the gathered state; a ``FleetReplica`` in rank 0's process
   syncs both publications (full, then delta), bit-equal to the gathered
   weights, and prefills 4 x 512 (8 flash launches, finite logits);
   HOT_RESHARD of step 4 under data=1,model=2 on both ranks, bit-equal to
   ``slice_shard`` of the gathered state with no file opened; then rank 1's
   process exits and rank 0 destroys the group and recovers alone under
   data=1,model=1 from its own memory (bit-equal, no file opened) and
   takes a step.  Prints each capture's device->host, slice-and-digest and
   exchange seconds and bytes, each drain's seconds, shards and launches,
   and the recovery's spans;
4e. multirank-ssm — Mamba-2 by SSM heads: mamba2-130m at full width and
   depth (24 layers, 24 heads of 64, state 128), 8 x 512, bf16; a
   one-process baseline (steps 1-4 from seed 0), then 2 spawned ranks
   under data=1,model=2 (12 heads a rank; ``conv_w`` the one weight
   gathered over the model axis) for steps 1-2, each saving its own
   ``int8:b256`` shards at step 2, resuming step 2 under data=2,model=1
   (RESHARD_STREAM) for steps 3-4, then serving step 2 by heads (DIRECT:
   24 SSD launches a rank at H = 12, bf16, and an fp32 prefill through the
   fp32 kernel); losses within 2e-2 of the baseline; the fp32 prefill
   logits within 1e-3 of one process's through ``ssd_chunked``; the bf16
   serve held against one process's through the SSD kernel within the
   larger of 0.1 and twice that process's own bf16 error (its bf16 logits
   against its fp32 ones), prefill and every greedy token;
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
   and the same at one rank's heads of mamba2-130m under model=2 (H = 12);
6. serve, smollm-360m at full width cut to ``CUT_LAYERS`` (2 of 32) layers,
   and then full mamba2-130m (24
   layers), each: init on the card from a seeded generator;
   ``write_distributed`` of the weights under data=2,model=2; weights-only
   restore under data=1,model=1 (RESHARD_STREAM, fused QKV or the five-part
   ``in_proj`` consolidated) and data=2,model=2 (DIRECT), each bit-equal to
   the save; prefill 4 × 512 tokens and 16 greedy decode steps from each
   restore, every kernel's launches counted around each run (smollm: 8
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
8. train, smollm-360m at full width, its depth cut from 32 to 2 layers
   (``CUT_LAYERS``: the smoke's time budget), seed 0, batch 8 × seq 512
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
8b. fanout, smollm-360m at full width, ``CUT_LAYERS`` layers: a publisher
   trains under data=2,model=2
   with ``CheckpointPolicy(codec="int8:b256", save_interval=2, keep_last=1,
   registry=PublicationRegistry(...))`` (60 quantize launches a save); its
   step 2 (seq 1) goes to 8 ``FleetReplica``s under data=1,model=1
   (RESHARD_STREAM, ``wqkv`` consolidated) that share one card engine and
   sync from threads: each bit-equal to ``params_from_source`` of the step
   on the card, one set of tensors (``data_ptr``), each fp32 shard read from
   disk once, 0 block-quant launches; the sync's wall and ``FanoutStats``;
   2 independent readers with private engines restore the same step (wall
   each, aggregate GB/s of both ways); replicas 0 and 7 and a direct
   restore serve 4 x 512 and 16 steps in bf16 (8 flash launches a
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
8c. dryrun (right after train, before 8a) — the dry run
   (``python -m repro_torch.launch.dryrun``) in processes that see no card
   (``CUDA_VISIBLE_DEVICES=""``), started together: three production cells
   of smollm-360m on the 16×16 mesh (``train_4k --grad-accum 2``,
   ``prefill_32k``, ``decode_32k --shard-cache-seq``), each ``ok``; the
   prefill's record shows the flash stand-in at (64, 64), one launch for
   each of the 32 layers; the decode's cache bytes a rank are those of the
   length-sharded ``cache_pspecs``; each record's memory, roofline,
   dominant term and wall printed.  Then the prediction against the card:
   one more such process runs ``run_cell`` on one rank (data=1,model=1) for
   the train phase's config (``CUT_LAYERS`` layers, 8 × 512, bf16 compute,
   remat full) and a 4 × 512 prefill, while this process runs the same
   step and prefill for real from fresh random weights: the record's
   argument bytes equal the state's and the batch's bytes on the card
   exactly; its peak (arguments + temporaries) is within 10% or 256 MiB
   of ``max_memory_allocated`` over the real step less the memory
   allocated before the state was made; its ``dot_flops`` within 1% of the
   profiler's FLOPs (``with_flops``) over the mm-family ops of the same
   step that launched work on the card (not the one a layer's recompute
   aborts); its flash stand-ins equal the real prefill's launches; the
   roofline's seconds printed beside the step's measured wall and device
   time (the ``dryrun`` line, JSON);
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
   multirank-moe, the paper's Fig. 10 move on compute: the same config, 8 x
   512, bf16 compute and moments, 2 spawned ranks under data=1,model=2,
   steps 1-2 with expert parallelism (4 of 8 experts a rank, attention
   24:4 heads of 128 a rank, the vocab split), each saving its own
   ``int8:b256`` shards at step 2; the same ranks resume step 2 under
   expert-TP (RESHARD_STREAM, ``moe_expert`` consolidated: 8192 of each
   expert's 16384 a rank) for steps 3-4; then a weights-only DIRECT serve
   of step 2 (one flash launch a rank at 24:4 of 128, 16 greedy decode
   steps) held against one process's serve after the ranks exit; losses
   within 2e-2 of train-moe's baseline steps 1-4 (the ranks' init shards
   and batches shown equal to that run's), the same expert picks on both
   ranks, each rank's peak card memory;
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
   multirank-mla, MLA by heads: the freed parent spawns 2 ranks under
   data=1,model=2 that restore serve-mla's checkpoint (kept for them:
   RESHARD_STREAM, each its own shards, 64 of 128 heads and 80 of 160
   experts a rank, the latent projections whole) and serve 4 x 512
   prompts: exactly 2 bf16 flash launches a rank at 64:64 of (192, 128),
   16 decode steps through the whole latent cache, the same experts on
   both ranks, held against one process's serve of the same step;
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
   1e-3; another source moves the logits; multirank-vlm, cross-attention
   by heads: 2 ranks restore serve-vlm's checkpoint under data=1,model=2
   (RESHARD_STREAM) and serve 4 x 512 prompts with the serve CLI's source
   embeds: exactly 5 bf16 flash launches a rank at 16:4 of 128 (4 causal
   512 x 512, 1 non-causal 512 x 1600), 16 decode steps, held against one
   process's serve;
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
   steps each, within 2e-2 of the baseline while saving; multirank-encdec,
   the encoder-decoder by heads: the same config and batches on 2 ranks
   under data=1,model=2 (3:3 heads of 64 a rank; the encoder's 1500 frames
   and the decoder's 448 positions each seq-sharded), steps 1-2 with each
   rank's ``int8:b256`` save, steps 3-4 resumed under data=2,model=1
   (RESHARD_STREAM, each rank's state bit-equal to its shard of a
   one-process restore), losses within 2e-2 of train-encdec's baseline
   (the ranks' init shards and batches equal to its), then a DIRECT serve
   of step 2 by heads: 4 x 432 prompts, exactly 12 bf16 flash launches a
   rank at 3:3 of 64, 16 decode steps, held against one process's serve;
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
   read floor; the block-quant rows add ``hot_launches``), the
   ``collectives`` line (JSON: phase 4a; every row adds
   ``collectives_launches``, the block-quant rows by variant too), the
   ``multirank_pipe`` line (JSON: phase 4b's pipe stage: each step's split
   ``pipe_s``, ``pipe_bytes``, ``grad_s``, ``all_reduce_s``, ``update_s``,
   the losses and gaps, the launches by phase, each rank's chunk,
   compute-weight bytes and peak card memory, the stage's seconds; the flash
   row adds ``multirank_pipe_launches``, 0 a rank), the
   ``multirank`` line (JSON: phase 4b; the block-quant rows add
   ``multirank_launches`` and ``multirank_launches_by_phase``, the pipe
   stage's phases included, the flash row its serve's launches by rank), the ``multirank_tp`` line (JSON: phase
   4c; every row adds ``multirank_tp_launches``), the flash row's
   ``q_offset`` shape (``qoff_*``), the ``multirank_mla``,
   ``multirank_vlm`` and ``multirank_encdec`` lines (JSON: each rank's
   steps split into ``tp_s`` and bytes, ``grad_s`` and update, saves,
   restores, prefill and decode times, flash launches and shapes, peak
   card memory; the flash row adds their launches by rank and the per-rank
   shapes ``deepseek_rank_*``, ``vlm_rank_*``, ``whisper_rank_*``, the
   block-quant rows ``multirank_encdec_launches``), the ``phase_seconds`` line (JSON: each
   phase's wall, the smoke's budget), the card line, then the result line
   (JSON, last).
"""

from __future__ import annotations

import dataclasses
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
# The train, collectives and multirank phases' depth: smollm-360m's 32
# layers cut to 8 (full width) when the smoke reached 1,110 s of its 1,200 s
# limit (train, collectives), and 1,054 s with the multirank-hot stage
# (multirank); then serve smollm-360m, fanout and multirank-hot too, for the
# multirank-moe and multirank-ssm stages (their 66 s and the mixtral ranks'
# run would take the smoke past 1,200 s); then all six to 4, when the
# multirank-mla, -vlm and -encdec stages took the smoke to 1,155 s, and to 2
# (with multirank-tp's gpt3-350m to ``TP_LAYERS``) at 1,176 s
CUT_LAYERS = 2
# What device_ms timed by CUDA events because every trace lost records.
EVENT_TIMED: list[str] = []
TOL = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 1e-5)}  # (atol, rtol), tests/test_kernels.py
# The tensor-core (bf16) kernel of each source, as the profiler names it.
TC_SYMBOL = {"flash_attention": "fwd_kernel_wgmma", "ssd_scan": "ssd_kernel_tc"}
VARIANT = {
    "flash_attention_fwd": "bf16 at D >= 64 (every prefill of the main path): fwd_kernel_wgmma, "
                           "persistent (a block an SM taking 128-row q-tiles from a counter, "
                           "L2-sized chunks of heads, heaviest first), a TMA producer warpgroup "
                           "and two consumer warpgroups, wgmma for Q·Kᵀ (shared memory) and "
                           "P·V (P in registers), a 2-stage K/V mbarrier ring, softmax "
                           "overlapped with the products; bf16 at D <= 32: fwd_kernel_tc, "
                           "mma.sync m16n8k16; fp32: fwd_kernel, CUDA cores",
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


def attention_bound(q, k, v, o, *, causal: bool, window: int, flops_peak: float,
                    q_offset: int = 0):
    """Least time for the work: each input read once and the output written
    once at the memory rate, against the score and P·V products this run's
    mask allows at the peak rate of the inputs' type: 2·D FLOPs a pair for
    Q·Kᵀ and 2·Dv for P·V (row i at position ``q_offset + i``)."""
    b, s, hq, d = q.shape
    dv, skv = v.shape[-1], k.shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, o))
    pairs = 0
    for i in range(q_offset, q_offset + s):  # position i sees columns lo..hi-1 (causal: at
        lo = max(0, i - window + 1) if window > 0 else 0  # most i, and none past Skv)
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
        if hasattr(counters[kernel], "launches_by_variant"):  # flash: every bf16 prefill's
            took = counters[kernel].launches_by_variant       # launch is the wgmma kernel's
            check(took == dict.fromkeys(took, 0) | {"wgmma": want},
                  f"{kernel}: launches by variant {took}, want {want} wgmma")
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
    # a rank's heads of mixtral-8x22b at model=2 (the multirank-moe serve)
    mixtral_rank = head_layout(torch, F, kernel, ops, ref, hq=24, hkv=4, d=128, long=None,
                               label="mixtral-8x22b rank of model=2")
    # a rank's heads at model=2 of the partitioned MLA, vlm and encdec serves
    deepseek_rank = head_layout(torch, F, kernel, ops, ref, hq=64, hkv=64, d=192, dv=128,
                                long=None, label="deepseek-v2-236b MLA rank of model=2")
    vlm_rank = head_layout(torch, F, kernel, ops, ref, hq=16, hkv=4, d=128, long=None, s=512,
                           skv=1600, causal=False,
                           label="llama-3.2-vision-11b cross, rank of model=2")
    whisper_rank = head_layout(torch, F, kernel, ops, ref, hq=3, hkv=3, d=64, long=None, s=1500,
                               causal=False, label="whisper-tiny encoder, rank of model=2")
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
    qoff = q_offset_rows(torch, F, kernel, ops, ref)
    return dict(ms=ms, event_ms=event_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=worst,
                d256=d256, d128=d128, d192=d192, jamba=jamba, mixtral_rank=mixtral_rank,
                deepseek_rank=deepseek_rank, vlm_rank=vlm_rank, whisper_rank=whisper_rank,
                vlm_cross=vlm_cross,
                vlm_self=vlm_self, encdec_encoder=enc, encdec_self=enc_self,
                encdec_cross=enc_cross,
                offset_causal=offset, qoff=qoff)


QOFF_SHAPE = (4, 256, 512, 15, 5, 64, 256)  # smollm-360m's rank 1 at model=2: B, Sq, Skv, heads, D, q_offset
# the other launches of the multi-rank serves (B, Sq, Skv, q heads, kv
# heads, window, q_offset): gpt3-350m by heads (8:8 a rank), smollm-360m's rank 0
MAIN_PATH_ROWS = ((4, 512, 512, 8, 8, 0, 0), (4, 256, 256, 15, 5, 0, 0))


def q_offset_rows(torch, F, kernel, ops, ref) -> dict:
    """The kernel at a ``q_offset`` (row i at position ``q_offset + i``):
    smollm-360m's rank-1 prefill under sequence parallelism over model=2
    (B 4, 256 query rows at offset 256 against 512 keys, 15:5 heads of 64,
    causal), a windowed, ragged one (B 2, 200 rows at offset 500 against
    700 keys, window 128, 8:2 heads of 64), and the multi-rank serves' other
    launches (``MAIN_PATH_ROWS``: gpt3-350m's 8:8 heads a rank at 512 x 512,
    smollm-360m's rank 0 at 256 x 256, offset 0), both kernels against the
    plain version; then at the first shape the bf16 kernel's device time beside
    the fp32 kernel's, the plain version's event time, the bound, and the
    library: ``scaled_dot_product_attention`` with the lower-right causal
    mask (``torch.nn.attention.bias.causal_lower_right``, the same mask at
    Sq = 256, Skv = 512), checked against the kernel, the device kernel it
    dispatches to named from a profile."""
    from torch.nn.attention.bias import causal_lower_right

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(256)
    b, sq, skv, hq, hkv, d, off = QOFF_SHAPE
    scale = d ** -0.5
    worst, main = {}, None
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for bb, n_q, n_kv, h_q, h_kv, window, q_off in ((b, sq, skv, hq, hkv, 0, off),
                                                        (2, 200, 700, 8, 2, 128, 500),
                                                        *MAIN_PATH_ROWS):
            q, k, v = (torch.randn(bb, n, h, d, generator=g, device=dev).to(dtype)
                       for n, h in ((n_q, h_q), (n_kv, h_kv), (n_kv, h_kv)))
            out = kernel.flash_attention_fwd(q, k, v, causal=True, window=window, scale=scale,
                                             q_offset=q_off)
            plain = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                      causal=True, window=window, scale=scale,
                                      q_offset=q_off).transpose(1, 2)
            torch.cuda.synchronize()
            atol, rtol = TOL[name]
            diff = (out.float() - plain.float()).abs()
            err = diff.max().item()
            ok = bool(torch.isfinite(out.float()).all()) and bool(
                (diff <= atol + rtol * plain.float().abs()).all())
            tag = (f"{name} B={bb} Sq={n_q} Skv={n_kv} {h_q}:{h_kv} heads of {d} causal "
                   f"window={window} q_offset={q_off}")
            print(f"kernel {tag}: max_abs_err {err:.3e} (tolerance atol {atol} rtol {rtol}) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"{tag}: kernel disagrees with its plain version")
            worst[tag] = err
            if dtype == torch.bfloat16 and main is None:
                main = (q, k, v, out)
    q, k, v, out = main
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    q32, k32, v32 = (t.float() for t in (q, k, v))
    mask = causal_lower_right(sq, skv)
    runs = {
        "kernel": lambda: ops.flash_attention(q, k, v, causal=True, scale=scale, q_offset=off),
        "fp32": lambda: ops.flash_attention(q32, k32, v32, causal=True, scale=scale,
                                            q_offset=off),
        "plain": lambda: ref.attention_ref(qt, kt, vt, causal=True, scale=scale, q_offset=off),
        "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                          scale=scale, enable_gqa=True),
    }
    lib = runs["library"]().transpose(1, 2).float()
    atol, rtol = TOL["bfloat16"]
    lib_err = (lib - out.float()).abs().max().item()
    check(bool(((lib - out.float()).abs() <= atol + rtol * lib.abs()).all()),
          f"q_offset: the kernel and the lower-right causal library call disagree ({lib_err:.3e})")
    del lib
    top = device_profile(torch, runs["library"], top=1)[2]
    backend = top[0][0] if top else "not named by the profiler"  # its busiest device kernel
    print(f"library causal_lower_right({sq}, {skv}): {backend[:90]}; agrees with the kernel "
          f"to {lib_err:.3e} (tolerance atol {atol} rtol {rtol})")
    plain_ms = sum(cuda_ms(torch, runs["plain"], iters=20) for _ in range(2)) / 2
    event_ms = cuda_ms(torch, runs["kernel"], iters=50)
    device: dict[str, list[float]] = {"kernel": [], "library": [], "fp32": []}
    for name in ("kernel", "library", "fp32", "fp32", "library", "kernel"):
        per_call, top = device_ms(torch, runs[name], f"flash_attention_fwd q_offset {name}",
                                  launches=None if name == "library"
                                  else lambda: ops.flash_attention.launches)
        device[name].append(per_call)
        print(f"kernel flash_attention q_offset {name} device time (profiler): {per_call:.5f} ms "
              "per call; " + "; ".join(f"{key[:48]} x{count} {t:.3f} ms" for key, t, count in top))
    ms = {n: sum(t) / len(t) for n, t in device.items()}
    bound_ms, bound_by, nbytes, flops = attention_bound(
        q, k, v, out, causal=True, window=0, flops_peak=PEAK_BF16_FLOPS, q_offset=off)
    print(f"kernel bf16 B={b} Sq={sq} Skv={skv} {hq}:{hkv} D={d} causal q_offset={off} "
          f"(smollm-360m rank 1 of model=2): device ms {ms['kernel']:.5f} (event {event_ms:.5f}) "
          f"library ({backend[:40]}) device ms {ms['library']:.5f} fp32 kernel device ms "
          f"{ms['fp32']:.5f} plain_ms {plain_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by}; "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP); {bound_ms / ms['kernel']:.3f} of "
          "the bound")
    return dict(ms=ms["kernel"], event_ms=event_ms, library_ms=ms["library"],
                library_backend=backend, fp32_ms=ms["fp32"], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=max(e for t, e in worst.items() if t.startswith("bfloat16")),
                max_abs_err_by_case=worst)


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
                via_ucp: bool = False, layers: int | None = None):
    """Save, restore two ways, and serve one full-size config on the card.
    ``counters`` maps each kernel to its wrapper (whose ``launches`` count);
    ``per_prefill`` gives the launches one prefill of this config must make;
    ``cpu_len`` is the prompt of the card-vs-CPU fp32 logits check;
    ``via_ucp`` adds the export of the step as UCP atoms and a third restore
    from them, and the I/O engine's checks: the save, the restores and the
    export each serial and parallel (byte- and bit-equal, walls, the disk
    floor), then a delta save and its restores.  ``layers`` cuts the depth
    (the smoke's time budget)."""
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
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)

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
    """Train smollm-360m (full width, ``CUT_LAYERS`` layers); save coded
    under data=2,model=2, serial and parallel; export serial and parallel;
    resume under two layouts through serial and parallel engines; continue;
    then delta saves and their resume, and GC under an in-flight delta's
    pin.  Returns the launch counts and measurements."""
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
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=CUT_LAYERS)
    tcfg, parallel = TrainConfig(seed=0), ParallelismConfig()
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
        print(f"train baseline smollm-360m {cfg.num_layers} layers, 8x512 tokens, 6 steps: losses "
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
    cfg, tcfg, parallel = dataclasses.replace(get_config("smollm-360m"), num_layers=CUT_LAYERS), TrainConfig(seed=0), ParallelismConfig()
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
    per_prefill = {"flash_attention": cfg.num_layers, "ssd_scan": 0}
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
    open (a shim around the wrapper's ``kernel.flash_attention_fwd``), in
    ``calls`` its (dtype, Sq, Skv, causal), in ``offsets`` its ``q_offset``
    and in ``heads`` its (Hq, Hkv)."""

    def __init__(self, kernel):
        self.kernel, self.shapes, self.calls, self.offsets, self.heads = kernel, [], [], [], []

    def __enter__(self):
        launch = self._saved = self.kernel.flash_attention_fwd

        def recording(q, k, v, **kw):
            dtype = str(q.dtype).removeprefix("torch.")
            self.shapes.append((dtype, q.shape[-1], v.shape[-1]))
            self.calls.append((dtype, q.shape[1], k.shape[1], bool(kw["causal"])))
            self.offsets.append(int(kw.get("q_offset", 0)))
            self.heads.append((q.shape[2], k.shape[2]))
            return launch(q, k, v, **kw)

        self.kernel.flash_attention_fwd = recording
        return self

    def __exit__(self, *exc):
        self.kernel.flash_attention_fwd = self._saved


class SsdHeads:
    """Records the (dtype, H) of every SSD kernel launch while it is open (a
    shim around the wrapper's ``kernel.ssd_scan_fwd``) in ``heads``."""

    def __init__(self, kernel):
        self.kernel, self.heads = kernel, []

    def __enter__(self):
        launch = self._saved = self.kernel.ssd_scan_fwd

        def recording(x, *args, **kw):
            self.heads.append((str(x.dtype).removeprefix("torch."), x.shape[2]))
            return launch(x, *args, **kw)

        self.kernel.ssd_scan_fwd = recording
        return self

    def __exit__(self, *exc):
        self.kernel.ssd_scan_fwd = self._saved


def routes_digest(log: MoeLog) -> str:
    """A digest of every expert a logged run picked, in order (the same on
    every model rank of a partitioned run, which routes all of its data
    replica's tokens)."""
    h = hashlib.sha256()
    for idx, _ in log.routes:
        h.update(idx.numpy().tobytes())
    return f"{len(log.routes)}:{h.hexdigest()[:16]}"


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
                lm_mod.flash_attention = lambda q, k, v, *, causal, window, q_offset=0: (
                    full_attention(q, k, v, causal=causal, window=window, q_offset=q_offset))
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
    plain = {"flash_attention": lambda q, k, v, *, causal, window, q_offset=0: full_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset)}
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
    the same steps after a plain prefill (:func:`decode_check`).  The
    checkpoint stays for the multirank-mla stage: its step directory is the
    record's ``step_dir``, for the caller to remove."""
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
    # the fp32 weights alone (a serving checkpoint: 21.4 GB)
    step_dir, save = save_weights(torch, "deepseek", cfg, src_plan, saved, root, default_workers())
    out = serve_restores(torch, "deepseek", cfg, plan_for, step_dir, saved, prompts, counters,
                         kernel, per_prefill, on_run=on_run)
    out["save"] = save

    # Right by the repo's own means, in fp32 on the card: the kernel path
    # against the plain path, by the experts chosen, then through decode.
    flm = build_model(cfg, compute_dtype=torch.float32)
    with FlashShapes(kernel) as shapes:
        out["routing"] = routing_check(torch, flm, params, prompts, reset, counts, lm_mod,
                                       full_attention, layers, label="deepseek")
    check(shapes.shapes == [("float32", *pair)] * layers, f"deepseek fp32 flash {shapes.shapes}")
    out["decode_check"] = decode_check(torch, flm, params, prompts, counters, lm_mod,
                                       full_attention, layers, "deepseek", routed=True)
    out["step_dir"] = step_dir
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
    the logits.  The checkpoint stays for a multi-rank stage: its step
    directory is the record's ``step_dir``, for the caller to remove."""
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
    step_dir, save = save_weights(torch, label, cfg, src_plan, saved, root, default_workers())
    out = {"source_shape": list(src.shape)}
    out.update(serve_restores(torch, label, cfg, plan_for, step_dir, saved, prompts, counters,
                              kernel, per_prefill, source_embeds=src, cache_len=cache_len,
                              on_run=on_run))
    out["save"] = save
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
    out["step_dir"] = step_dir
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


COLLECTIVES_WORLD = 2        # ranks, as processes on the one card (gloo: NCCL refuses two)
COLLECTIVES_STEPS = 4
COLLECTIVES_BATCH = (4, 512)  # each rank's batch a step
COLLECTIVES_JOIN_S = 240     # a rank still running after this fails the smoke
COLLECTIVES_REL_BOUND = 0.05  # tests/test_collectives.py:64
COLLECTIVES_RANK_GB = 24     # card memory a rank may need (smollm's gradients and sums)
FP32_EPS = 2.0 ** -23


def collectives_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of the collectives phase, in a spawned process (module level,
    so the spawned interpreter finds it in ``chip_smoke`` re-imported as
    ``__mp_main__``).  Full smollm-360m from seed 0 (the same weights on
    every rank, checked), bf16 compute with remat; each of
    ``COLLECTIVES_STEPS`` steps takes a fresh batch from ``train/data.py``
    seeded by step and rank, a forward and backward pass and no update, and
    sends every parameter's fp32 gradient through ``compressed_psum`` with
    its own residual.  Checks each step and writes what it measured to
    ``rank<r>.json``; any failure raises, so the process exits non-zero."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.configs import ParallelismConfig, get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths
    from repro_torch.dist import collectives
    from repro_torch.kernels.block_quant import kernel as bq_kernel
    from repro_torch.kernels.block_quant import ops as bq_ops
    from repro_torch.kernels.block_quant import ref as bq_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import build_model
    from repro_torch.train.data import batch_for_step

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda")
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVES_JOIN_S))
    try:
        _, report = bq_kernel.build()
        check(not report["compiled"], f"rank {rank} rebuilt the block-quant kernels")
        cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=CUT_LAYERS)
        parallel = ParallelismConfig()
        lm = build_model(cfg, vocab_multiple=1, compute_dtype=getattr(torch, parallel.compute_dtype),
                         remat=parallel.remat)
        flat = flatten_with_paths(lm.init(torch.Generator(device=dev).manual_seed(0)))
        names = list(flat)
        n_elems = sum(t.numel() for t in flat.values())
        # the same weights on every rank: a float64 fingerprint a tensor, on the host
        fp = torch.stack([t.double().sum() for t in flat.values()]).cpu()
        fp0 = fp.clone()
        dist.broadcast(fp0, 0)
        check(torch.equal(fp, fp0), f"rank {rank}: weights differ from rank 0's")

        # spies on the module's own calls: the step-0 bit check against the
        # plain version, the sent values, CUDA-event times and the all-reduce share
        real_q, real_dq, real_dist = collectives.quantize_int8, collectives.dequantize_int8, collectives.dist
        cur = {"name": None, "step": 0}
        sum_sent: dict = {}
        events: dict[str, list] = {"quantize": [], "dequantize": []}
        code_diff = {"elements": 0, "scales": 0}
        ar = {"s": 0.0, "bytes": 0}

        def timed(kind, fn, *a, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            events[kind].append((e0, e1))
            return out

        def spy_quantize(x, *, block=256):
            q, scales = timed("quantize", real_q, x, block=block)
            if cur["step"] == 0:
                pq, ps = bq_ref.quantize_blocks(bq_ref.blocked(x, block=block), dtype="int8")
                code_diff["elements"] += int((q.view(torch.uint8) != pq.view(torch.uint8)).sum())
                code_diff["scales"] += int((scales.view(torch.int32) != ps.view(torch.int32)).sum())
            return q, scales

        def spy_dequantize(q, scales, shape):
            sent = timed("dequantize", real_dq, q, scales, shape)
            n = cur["name"]
            sum_sent[n] = sent.clone() if n not in sum_sent else sum_sent[n].add_(sent)
            return sent

        class DistSpy:
            ReduceOp = dist.ReduceOp
            is_available = staticmethod(dist.is_available)
            is_initialized = staticmethod(dist.is_initialized)

            @staticmethod
            def all_reduce(t, op, group=None):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dist.all_reduce(t, op=op, group=group)
                torch.cuda.synchronize()
                ar["s"] += time.perf_counter() - t0
                ar["bytes"] += t.numel() * t.element_size()

        collectives.quantize_int8, collectives.dequantize_int8 = spy_quantize, spy_dequantize
        collectives.dist = DistSpy
        fns = {"quantize": bq_ops.block_quantize, "dequantize": bq_ops.block_dequantize}
        reset_launches(fns)
        fa_ops.flash_attention.launches = 0

        err = {n: torch.zeros_like(t) for n, t in flat.items()}
        sum_g = {n: torch.zeros_like(t) for n, t in flat.items()}
        sum_abs = {n: torch.zeros_like(t) for n, t in flat.items()}
        sum_synced = {n: torch.zeros_like(t) for n, t in flat.items()}
        b, s = COLLECTIVES_BATCH
        steps, bound_ratio = [], 0.0
        t_ready = time.perf_counter()
        for step in range(COLLECTIVES_STEPS):
            cur["step"] = step
            full = batch_for_step(cfg, ShapeSpec("train", s, b, "train"), step, seed=rank,
                                  batch_override=b, seq_override=s)
            batch = {"tokens": torch.from_numpy(full["tokens"]).long().to(dev)}
            t0 = time.perf_counter()
            leaves = {n: t.detach().requires_grad_(True) for n, t in flat.items()}
            loss, _ = lm.loss_fn(unflatten_from_paths(leaves), batch)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            loss = float(loss.detach())
            del leaves
            torch.cuda.synchronize()
            grad_s = time.perf_counter() - t0
            check(all(g.dtype == torch.float32 for g in grads.values()), "gradients not fp32")

            before = {k: dict(fn.launches_by_variant) for k, fn in fns.items()}
            ar["s"], ar["bytes"] = 0.0, 0
            events["quantize"].clear()
            events["dequantize"].clear()
            sync_s, check_s, worst = 0.0, 0.0, 0.0
            for n in names:
                g = grads.pop(n)
                acc = g + err[n]  # what compressed_psum sends, for the sum bound
                cur["name"] = n
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                synced, err[n] = collectives.compressed_psum(g, err[n])
                torch.cuda.synchronize()
                sync_s += time.perf_counter() - t0
                # the uncompressed sum and the bound, for the check only
                t0 = time.perf_counter()
                bound = bq_ref.blocked(acc, block=256).abs().amax(dim=1) / 254
                dist.all_reduce(bound)
                dist.all_reduce(acc)
                bound = bound.repeat_interleave(256)[:acc.numel()].reshape(acc.shape)
                # the scale's and the division's roundings (~130 eps of the bound),
                # the product's and the two sums' (an eps of each value)
                slack = 256 * FP32_EPS * bound + 2 * FP32_EPS * (acc.abs() + synced.abs())
                ratio = (synced - acc).abs() / (bound + slack).clamp_min(torch.finfo(torch.float32).tiny)
                worst = max(worst, float(ratio.max()))
                torch.cuda.synchronize()
                check_s += time.perf_counter() - t0
                sum_g[n].add_(g)
                sum_abs[n].add_(g.abs())
                sum_synced[n].add_(synced)
                del g, acc, synced, bound, slack, ratio
            torch.cuda.synchronize()
            by_variant = {k: {v: fn.launches_by_variant[v] - before[k][v] for v in before[k]}
                          for k, fn in fns.items()}
            check(all(sum(v.values()) == len(names) for v in by_variant.values()),
                  f"rank {rank} step {step}: launches {by_variant}, want {len(names)} of each")
            check(worst <= 1.0, f"rank {rank} step {step}: |synced - all_reduce(acc)| is "
                                f"{worst:.3f} x the bound sum(absmax / 254)")
            bound_ratio = max(bound_ratio, worst)
            steps.append({
                "step": step, "loss": loss, "grad_s": grad_s, "sync_s": sync_s,
                "all_reduce_s": ar["s"], "all_reduce_gb_s": ar["bytes"] / ar["s"] / 1e9,
                "check_s": check_s,
                "quantize_ms": sum(e0.elapsed_time(e1) for e0, e1 in events["quantize"]),
                "dequantize_ms": sum(e0.elapsed_time(e1) for e0, e1 in events["dequantize"]),
                "launches_by_variant": by_variant,
            })
            if step == 0:
                check(code_diff == {"elements": 0, "scales": 0},
                      f"rank {rank} step 0: kernel codes differ from the plain version: {code_diff}")
        loop_s = time.perf_counter() - t_ready

        # per rank, telescoping: sum_t sent_t == sum_t g_t - e_T, within 1e-5 of sum|g|
        tele = 0.0
        for n in names:
            diff = (sum_sent[n] - (sum_g[n] - err[n])).abs().max()
            tele = max(tele, float(diff / sum_abs[n].max().clamp_min(1e-30)))
        check(tele <= 1e-5, f"rank {rank}: telescoping identity off by {tele:.3g} of sum|g|")
        # the relative error of the synced total against the true total
        num = den = 0.0
        for n in names:
            true = sum_g[n]
            dist.all_reduce(true)
            num += float(((sum_synced[n] - true).double() ** 2).sum())
            den += float((true.double() ** 2).sum())
        rel = math.sqrt(num / den)
        check(rel < COLLECTIVES_REL_BOUND, f"rank {rank}: ||sum synced - sum true|| / ||sum true|| "
                                           f"= {rel:.4f} >= {COLLECTIVES_REL_BOUND}")
        check(fa_ops.flash_attention.launches == 0,
              f"rank {rank}: {fa_ops.flash_attention.launches} flash launches while training")
        wire = sum(-(-t.numel() // 256) * (256 + 4) for t in flat.values())
        result = {
            "rank": rank, "n_params": len(names), "elements": n_elems,
            "fp32_bytes": 4 * n_elems, "wire_bytes": wire, "steps": steps,
            "step0_code_mismatches": code_diff, "sum_bound_max_ratio": bound_ratio,
            "telescoping_max": tele, "rel_error": rel,
            "flash_launches": fa_ops.flash_attention.launches,
            "launches": {k: fn.launches for k, fn in fns.items()},
            "launches_by_variant": {k: dict(fn.launches_by_variant) for k, fn in fns.items()},
            "setup_s": t_ready - t_start, "loop_s": loop_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def collectives_phase(torch) -> dict:
    """Two ranks on the one card, as processes of a gloo group (NCCL puts no
    two ranks on one device; gloo takes CUDA tensors for ``all_reduce``):
    :func:`collectives_rank` in each; joined with a timeout (a rank still
    running is killed, and fails the smoke, as does a non-zero exit).
    Returns the phase's measurements, summed and by rank."""
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    held = torch.cuda.memory_allocated()
    check(free >= COLLECTIVES_WORLD * COLLECTIVES_RANK_GB * 1e9,
          f"collectives: {free / 1e9:.1f} GB free of {total / 1e9:.1f} GB, the parent holds "
          f"{held / 1e9:.2f} GB; the ranks need {COLLECTIVES_WORLD * COLLECTIVES_RANK_GB} GB")
    out_dir = ROOT / "build" / "chip_smoke_collectives"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    procs = WARM.run(collectives_rank, [(r, COLLECTIVES_WORLD, str(out_dir / "store"), str(out_dir))
                                        for r in range(COLLECTIVES_WORLD)])
    try:
        deadline = time.monotonic() + COLLECTIVES_JOIN_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        wall = time.perf_counter() - t0
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        check(not hung, f"collectives: ranks {hung} still running after {COLLECTIVES_JOIN_S} s")
        codes = [p.exitcode for p in procs]
        check(codes == [0] * COLLECTIVES_WORLD, f"collectives: rank exit codes {codes}")
        ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
                 for r in range(COLLECTIVES_WORLD)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(out_dir, ignore_errors=True)
    WARM.fill()
    first = ranks[0]
    check(all(r["elements"] == first["elements"] and r["n_params"] == first["n_params"]
              for r in ranks), "collectives: ranks disagree on the model")
    per_step = [{
        "step": i,
        "losses": [r["steps"][i]["loss"] for r in ranks],
        **{k: max(r["steps"][i][k] for r in ranks) for k in (
            "grad_s", "sync_s", "all_reduce_s", "check_s", "quantize_ms", "dequantize_ms")},
        "all_reduce_gb_s": min(r["steps"][i]["all_reduce_gb_s"] for r in ranks),
    } for i in range(COLLECTIVES_STEPS)]
    out = {
        "world": COLLECTIVES_WORLD, "backend": "gloo", "tensors": "cuda",
        "model": f"smollm-360m, full width, {CUT_LAYERS} of 32 layers",
        "batch": list(COLLECTIVES_BATCH),
        "steps": COLLECTIVES_STEPS,
        "n_params": first["n_params"], "elements": first["elements"],
        "fp32_bytes": first["fp32_bytes"], "wire_bytes": first["wire_bytes"],
        "wire_ratio": first["fp32_bytes"] / first["wire_bytes"],
        "per_step": per_step,
        "max_step0_code_mismatches": max(sum(r["step0_code_mismatches"].values()) for r in ranks),
        "max_sum_bound_ratio": max(r["sum_bound_max_ratio"] for r in ranks),
        "max_telescoping": max(r["telescoping_max"] for r in ranks),
        "max_rel_error": max(r["rel_error"] for r in ranks),
        "launches": {k: sum(r["launches"][k] for r in ranks) for k in ("quantize", "dequantize")},
        "launches_by_variant": {k: {v: sum(r["launches_by_variant"][k][v] for r in ranks)
                                    for v in first["launches_by_variant"][k]}
                                for k in ("quantize", "dequantize")},
        "flash_launches": sum(r["flash_launches"] for r in ranks),
        "setup_s": [r["setup_s"] for r in ranks], "loop_s": [r["loop_s"] for r in ranks],
        "peak_gb": [r["peak_gb"] for r in ranks],
        "parent_free_gb": free / 1e9, "parent_held_gb": held / 1e9,
        "phase_s": wall,
    }
    want = COLLECTIVES_WORLD * COLLECTIVES_STEPS * first["n_params"]
    check(out["launches"] == {"quantize": want, "dequantize": want},
          f"collectives: launches {out['launches']}, want {want} of each")
    print(f"collectives smollm-360m: {COLLECTIVES_WORLD} ranks (gloo, CUDA tensors), "
          f"{out['n_params']} params, {out['elements']:,} elements, "
          f"{out['fp32_bytes'] / 1e9:.3f} GB fp32 -> {out['wire_bytes'] / 1e9:.4f} GB on the wire "
          f"(x{out['wire_ratio']:.3f}); phase {wall:.1f} s")
    for st in per_step:
        print(f"  step {st['step']}: losses {[round(v, 4) for v in st['losses']]}, sync "
              f"{st['sync_s']:.3f} s of which all-reduce {st['all_reduce_s']:.3f} s "
              f"({st['all_reduce_gb_s']:.2f} GB/s), quantize {st['quantize_ms']:.3f} ms, "
              f"dequantize {st['dequantize_ms']:.3f} ms (CUDA events)")
    print(f"  checks: step-0 code mismatches {out['max_step0_code_mismatches']}, sum bound "
          f"{out['max_sum_bound_ratio']:.4f} of its limit, telescoping {out['max_telescoping']:.3g}"
          f" of sum|g|, relative error {out['max_rel_error']:.5f}; launches "
          f"{out['launches_by_variant']}")
    return out


MULTIRANK_WORLD = 2        # ranks, as processes on the one card (gloo: NCCL refuses two)
# The global batch a step (rows, positions; a row holds one more token, the
# last label), 4 rows a rank under data=2; 512 positions split over model=2,
# so the partitioned steps run sequence-parallel
MULTIRANK_BATCH = (8, 512)
MULTIRANK_JOIN_S = 300      # a world still running after this fails the smoke
MULTIRANK_TOL = 2e-2        # tests/test_reconfig_e2e.py: the paper's accepted divergence
MULTIRANK_CODEC = "int8:b256"
MULTIRANK_MESH = {"save": "data=2,model=1", "resume": "data=1,model=2"}
# The multirank phase's fsdp stage: smollm-360m at full width and 8 of its 32
# layers under data=2,model=1 (FSDP: each rank holds half of every weight and
# moment, and gathers each layer's weights where the layer reads them), two
# steps from seed 0, each rank's peak held against the dry run's 2-rank
# prediction of the same step (DRYRUN_PEAK_TOL)
FSDP_LAYERS = 8
FSDP_MESH = "data=2,model=1"
FSDP_PREDICT = """
import argparse, dataclasses, json, torch
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.core.layout import MeshSpec
from repro_torch.launch import dryrun
cfg = dataclasses.replace(get_config("smollm-360m"), num_layers={layers})
args = argparse.Namespace(remat="full", grad_accum=1, moment_dtype=None, param_dtype=None,
                          no_fsdp=False, cast_params=False, shard_cache_seq=False)
rec = dryrun.run_cell("smollm-360m", "train", False, args,
                      mesh=MeshSpec((("data", 2), ("model", 1))),
                      shape=ShapeSpec("train", {seq}, {rows}, "train"), cfg=cfg)
print(json.dumps(rec))
assert not torch.cuda.is_initialized(), "the dry run initialized CUDA"
"""
# The multirank phase's pipe stage: step 2 resumed by pipeline stages, then
# step 4 by sequence rows with tensor parallelism off
PIPE_MESH = "pipe=2,data=1,model=1"
SP_MESH = "data=1,model=2"
GLOO_PROBES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single", "send", "recv")
# send and recv are probed by 2 processes of their own: on a device pointer
# gloo's TCP transport aborts the sending process (no exception to catch)
GLOO_P2P = ("send", "recv")
GLOO_P2P_S = 60             # the point-to-point probe's time limit
RUNTIME_COLLECTIVES = ("all_reduce", "broadcast", "all_gather")  # what the runtime sends gloo
SERVE_BATCH = (4, 512)     # a multi-rank serve's prompts
SERVE_GEN = 17             # tokens generate() returns: the prefill's and 16 greedy decode steps
# bf16 prefill logits of a partitioned serve against one process's: the
# bf16 logits bound of tests/test_torch_serve.py (the partial sums of the
# row-parallel products round to bf16 before they are added)
SERVE_LOGIT_TOL = 0.1
# fp32 prefill logits of a partitioned serve against one process's through
# the plain versions (the card-vs-CPU fp32 logits bound of the serve phases)
SERVE_FP32_TOL = 1e-3
TP_ARCH = "gpt3-350m"      # the multirank-tp phase: the paper's Table 4 model, heads 16:16
TP_LAYERS = 6              # of its 24: cut to 12, then 6, each time the smoke passed 1,050 s
TP_MESH = "data=1,model=2"
# The multirank-hot stage: 2 ranks of smollm-360m under data=2,model=1, each
# holding 4.34 GB a snapshot (its fp32 weights and moments, its buddy's
# moments); a ring of 2 snapshots keeps 17.4 GB of host memory over the 2
HOT_MESH = "data=2,model=1"
SURVIVORS_WORLD = 4        # the multirank-survivors stage: 4 ranks on the one card
SURVIVORS_MESH = "data=4,model=1"
SURVIVORS_FAILED = (1, 3)  # their processes exit; ranks 0 and 2 re-form a group of 2
HOT_RESHARD_MESH = "data=1,model=2"
HOT_RING = 2


def gloo_cuda_probe(torch, dist) -> dict[str, str]:
    """Which collectives gloo takes with CUDA tensors (torch as installed):
    each tried once on a small card tensor, in a group of its own, its values
    checked; "ok", "wrong values" or the error's first line.  A probe only:
    the runtime's collectives (``RUNTIME_COLLECTIVES``) must be "ok".
    ``send`` and ``recv`` are :func:`gloo_p2p_probe`'s."""
    g = dist.new_group(backend="gloo")
    n, me, dev = g.size(), dist.get_rank(g), torch.device("cuda")
    m = 4 * n
    xs = [torch.arange(m, dtype=torch.float32, device=dev) + 100 * r for r in range(n)]
    x = xs[me]

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y, group=g)
        return torch.equal(y, sum(xs))

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0, group=g)
        return torch.equal(y, xs[0])

    def all_gather():
        ys = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(ys, x, group=g)
        return all(torch.equal(a, b) for a, b in zip(ys, xs))

    def all_gather_into_tensor():
        y = torch.empty(n * m, device=dev)
        dist.all_gather_into_tensor(y, x, group=g)
        return torch.equal(y, torch.cat(xs))

    def reduce_scatter_tensor():
        y = torch.empty(m // n, device=dev)
        dist.reduce_scatter_tensor(y, x, group=g)
        return torch.equal(y, sum(xs)[me * (m // n):(me + 1) * (m // n)])

    def all_to_all_single():
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=g)
        k = m // n
        return torch.equal(y, torch.cat([xs[r][me * k:(me + 1) * k] for r in range(n)]))

    calls = {f.__name__: f for f in (all_reduce, broadcast, all_gather, all_gather_into_tensor,
                                     reduce_scatter_tensor, all_to_all_single)}
    out = {}
    for name in (n for n in GLOO_PROBES if n not in GLOO_P2P):
        try:
            right = calls[name]()
            torch.cuda.synchronize()
            out[name] = "ok" if right else "wrong values"
        except Exception as e:  # the probe's answer: recorded, nothing falls back
            out[name] = f"{type(e).__name__}: {str(e).strip().splitlines()[0][:160]}"
    dist.barrier()
    return out


def gloo_p2p_rank(rank: int, store: str, out_dir: str) -> None:
    """One of the 2 processes of the point-to-point probe (spawned): rank 0
    sends a card tensor (``send``) to rank 1's ``recv``; each writes what it saw
    to ``p2p<rank>.json`` ("posted" before the call) and its standard error
    to ``p2p<rank>.err``, then exits without a teardown."""
    import datetime

    import torch
    import torch.distributed as dist

    import resource

    resource.setrlimit(resource.RLIMIT_CORE, (0, 0))  # an abort leaves no core file
    out = Path(out_dir)
    err = os.open(out / f"p2p{rank}.err", os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(err, 2)  # gloo's abort message
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=GLOO_P2P_S))
    name = GLOO_P2P[rank]
    record = out / f"p2p{rank}.json"
    record.write_text(json.dumps({name: "posted"}))
    x = torch.arange(8, dtype=torch.float32, device="cuda")
    try:
        if rank == 0:
            dist.send(x, dst=1)
            res = "ok"
        else:
            y = torch.empty_like(x)
            dist.recv(y, src=0)
            res = "ok" if torch.equal(y, x) else "wrong values"
    except Exception as e:  # the probe's answer: recorded, nothing falls back
        res = f"{type(e).__name__}: {str(e).strip().splitlines()[0][:160]}"
    record.write_text(json.dumps({name: res}))
    sys.stderr.flush()
    os._exit(0)  # a failed pair's teardown may block


def gloo_p2p_probe(torch, out_dir: Path):
    """Start the point-to-point probe's 2 processes (:func:`gloo_p2p_rank`);
    the returned function joins them (killed after ``GLOO_P2P_S``) and
    gives {"send": ..., "recv": ...}: "ok", the error's first line, or the
    process's death with the last line it wrote to its standard error."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    store = out_dir / "store_p2p"
    procs = [ctx.Process(target=gloo_p2p_rank, args=(r, str(store), str(out_dir)))
             for r in range(2)]
    for p in procs:
        p.start()

    def finish() -> dict[str, str]:
        deadline = time.monotonic() + 2 * GLOO_P2P_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        out = {}
        for r, (p, name) in enumerate(zip(procs, GLOO_P2P)):
            if p.is_alive():
                p.kill()
                p.join()
                out[name] = f"still waiting after {2 * GLOO_P2P_S} s: killed"
                continue
            rec = out_dir / f"p2p{r}.json"
            res = json.loads(rec.read_text())[name] if rec.exists() else "no record"
            if p.exitcode != 0:
                lines = [ln for ln in (out_dir / f"p2p{r}.err").read_text().splitlines()
                         if ln.strip()]
                res = (f"the process died (exit {p.exitcode}) after '{res}': "
                       f"{lines[-1].strip()[:160] if lines else 'nothing on stderr'}")
            out[name] = res
        return out

    return finish


def gather_routes(torch, dist, plan, local: dict, reps: int = 2) -> dict:
    """The runtime's ``gather_full`` of every weight (gloo's own CUDA
    ``all_gather``) against the same gather through pinned host buffers (the
    route the runtime would need if gloo refused CUDA tensors), in turns:
    seconds per route and whether the two agree bit for bit.  Every rank
    runs it together."""
    from repro_torch.core.patterns import StateKind
    from repro_torch.dist.sharding import gather_full

    world = dist.group.WORLD
    n = world.size()
    layouts = {k: plan.param_specs[k].layout_for(StateKind.FP32, plan.mesh) for k in local}

    def staged(t, layout):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for _ in range(n)]
        dist.all_gather(outs, host, group=world)
        full = torch.empty(layout.global_shape, dtype=t.dtype, device=t.device)
        for r in layout.primary_ranks():
            shard = outs[r].to(t.device, non_blocking=True)
            for e in layout.entries[r]:
                full[e.atom_index()] = shard[e.shard_index()]
        return full

    routes = {"staged": staged, "direct": lambda t, layout: gather_full(t, layout, world)}
    times: dict[str, list[float]] = {k: [] for k in routes}
    got: dict = {}
    for route in ("staged", "direct") * reps:
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        full = {k: routes[route](t, layouts[k]) for k, t in local.items()}
        torch.cuda.synchronize()
        times[route].append(time.perf_counter() - t0)
        got.setdefault(route, full)
        del full
    same = all(torch.equal(got["staged"][k].view(torch.int32), got["direct"][k].view(torch.int32))
               for k in local)
    return {"staged_s": times["staged"], "direct_s": times["direct"], "bit_equal": same,
            "bytes": sum(t.numel() * t.element_size() for t in got["staged"].values())}


def serve_prompts(torch, cfg, device, prompt_len: int = SERVE_BATCH[1]):
    """The multi-rank serves' prompts: ``SERVE_BATCH`` rows of
    ``prompt_len`` tokens from a seed, and for a vlm or encdec config the
    serve CLI's source embeds from another (the same on every rank)."""
    from repro_torch.launch.serve import draw_source_embeds

    b = SERVE_BATCH[0]
    prompts = torch.randint(0, cfg.vocab_size, (b, prompt_len),
                            generator=torch.Generator().manual_seed(7)).to(device)
    return prompts, draw_source_embeds(cfg, b, 8, device)


def rank_serve(torch, dist, cfg, mesh_str: str, step_dir: Path, expect: str, out_dir: Path,
               label: str, fp32_prefill: bool = False, moment_dtype: str = "float32",
               prompt_len: int = SERVE_BATCH[1], seq_cache: bool = False) -> dict:
    """One rank of a multi-rank serve, in a spawned process of a world: the
    serve CLI's path (a rank context over ``mesh_str``, the rank's own
    weight shards restored weights-only, gathered over the data axes once,
    the weights it does not compute locally over the model axis), bf16,
    on ``prompt_len`` tokens a row (and the source embeds of a vlm or
    encdec config, :func:`serve_prompts`);
    a warm-up ``generate`` of 2 tokens, then a counted prefill (every flash launch's
    shape, ``q_offset`` and heads recorded, every SSD launch's heads; the
    experts every MoE layer picks, as a digest; its logits gathered over the
    vocab shards) and a timed ``generate`` of ``SERVE_GEN`` tokens; with
    ``fp32_prefill`` first a prefill of fp32 weights in fp32 (the kernels'
    fp32 versions).  The plan takes the save's ``moment_dtype`` (a layout
    that differs only there is not DIRECT).  Rank 0 saves the logits and
    tokens for the parent's comparison.  With ``seq_cache`` a second
    timed ``generate`` under ``shard_cache_seq=True`` (:func:`seq_cache_decode`)."""
    from repro_torch.core.pytree import unflatten_from_paths
    from repro_torch.dist.sharding import RankGroups, make_plan, vocab_multiple
    from repro_torch.dist.tensor_parallel import TensorParallel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.launch.serve import generate, rank_weights, restore_params, serving_parallelism
    from repro_torch.models import build_model
    from repro_torch.models import decode as D

    dev = torch.device("cuda")
    mesh = mesh_spec_from_string(mesh_str)
    par = dataclasses.replace(serving_parallelism(mesh), moment_dtype=moment_dtype)
    lm = build_model(cfg, vocab_multiple=vocab_multiple(par, mesh))
    plan = make_plan(cfg, lm.registry, par, mesh)
    ranks = RankGroups.create(dist.group.WORLD, plan, par)
    lm.tp = TensorParallel(ranks, cfg)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    flat, rp = restore_params(step_dir, plan, dev, rank=ranks.rank, group=dist.group.WORLD)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(rp.mode.value == expect, f"{label} serve rank {ranks.rank}: {rp.mode.value}, want {expect}")
    shard_gb = sum(t.numel() * t.element_size() for t in flat.values()) / 1e9
    t0 = time.perf_counter()
    comp = rank_weights(lm, ranks, flat)
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    del flat
    prompts, source = serve_prompts(torch, cfg, dev, prompt_len)
    b, s = prompts.shape
    logits32 = None
    if fp32_prefill:
        lm32 = dataclasses.replace(lm, compute_dtype=torch.float32)
        with torch.inference_mode():
            logits32, _ = D.prefill(lm32, unflatten_from_paths(comp),
                                    D.init_cache(lm32, b, s, device=dev), prompts,
                                    source_embeds=source)
            logits32 = lm.tp.gather_vocab(logits32, cfg.vocab_size).cpu()
    params = lm.registry.cast(unflatten_from_paths(comp), torch.bfloat16)
    params32 = unflatten_from_paths(comp) if seq_cache else None
    del comp
    # warm-up: the prefill and a decode step at the timed shapes
    generate(lm, params, prompts, 2, source_embeds=source)
    fns = {"flash_attention": fa_ops.flash_attention, "ssd_scan": ssd_ops.ssd_scan}
    reset_launches(fns)
    with (torch.inference_mode(), FlashShapes(fa_kernel) as shapes, SsdHeads(ssd_kernel) as ssd,
          MoeLog(torch) as log):
        logits, _ = D.prefill(lm, params, D.init_cache(lm, b, s + SERVE_GEN, device=dev), prompts,
                              source_embeds=source)
        logits = lm.tp.gather_vocab(logits, cfg.vocab_size)
    counted = launch_counts(fns)
    launches = counted["flash_attention"]
    lm.tp.seconds, lm.tp.bytes = 0.0, 0
    seq, prefill_s, decode_s = generate(lm, params, prompts, SERVE_GEN, source_embeds=source)
    tp_s, tp_bytes = lm.tp.seconds, lm.tp.bytes
    if ranks.rank == 0:
        torch.save({"logits": logits.float().cpu(), "seq": seq.cpu(), "logits32": logits32},
                   out_dir / f"{label}_serve.pt")
    extra = {}
    if seq_cache:
        extra["seq_cache"] = seq_cache_decode(torch, dist, lm, plan, par, params, params32,
                                              prompts, seq)
    return {**extra, "mode": rp.mode.value, "consolidated": sorted(rp.consolidate_params),
            "restore_s": restore_s, "shard_gb": shard_gb, "gather_s": gather_s,
            "prefill_ms": prefill_s * 1e3, "decode_ms": decode_s * 1e3 / (SERVE_GEN - 1),
            "tp_s": tp_s, "tp_bytes": tp_bytes, "heads_local": lm.tp.heads,
            "gathered": sorted(lm.tp.gathered), "flash_launches": launches,
            "flash_calls": shapes.calls, "flash_dims": shapes.shapes,
            "flash_offsets": shapes.offsets,
            "flash_heads": shapes.heads, "ssd_launches": counted["ssd_scan"],
            "ssd_heads": ssd.heads, "ssm_heads_local": lm.tp.ssm_heads,
            "routes": routes_digest(log)}


def seq_cache_decode(torch, dist, lm, plan, par, params, params32, prompts, seq) -> dict:
    """A rank's serve again with its cache sharded over its length
    (``ParallelismConfig(shard_cache_seq=True)``, a cache of an even length
    so the model size divides it): a warm-up, then a timed bf16 ``generate``
    of ``SERVE_GEN`` tokens, and the replicated-cache decode (``lm``) fed
    those tokens, its top logit and the fed token's logit at each step;
    then both caches' greedy decodes in fp32 from the fp32 weights
    ``params32`` (bf16 rounds the two combines apart, and random weights
    leave near-ties a rounding flips).  Returns the bytes a rank holds of
    every ``k``/``v``/``slot_pos`` entry under both caches, the bf16 tokens'
    gap to that decode's top logit and the steps where they equal ``seq``
    (the replicated cache's), whether the fp32 tokens are equal, the
    decode's ms/token and the prefill's flash launches; every check is the
    parent's."""
    from repro_torch.dist.sharding import RankGroups
    from repro_torch.dist.tensor_parallel import TensorParallel
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import decode as D

    b, s = prompts.shape
    cache_len = s + SERVE_GEN + (s + SERVE_GEN) % lm.tp.size
    seq_par = dataclasses.replace(par, shard_cache_seq=True)
    lm_seq = dataclasses.replace(
        lm, tp=TensorParallel(RankGroups.create(dist.group.WORLD, plan, seq_par), lm.cfg))
    entries = ("k", "v", "slot_pos")
    held = {}
    for label, m in (("replicated", lm), ("seq_sharded", lm_seq)):
        cache = flatten_with_paths(D.init_cache(m, b, cache_len, device="meta"))
        held[label] = {p: t.numel() * t.element_size() for p, t in cache.items()
                       if p.split(".")[-1] in entries}
    generate(lm_seq, params, prompts, 2, cache_len=cache_len)  # warm-up
    lm_seq.tp.seconds, lm_seq.tp.bytes = 0.0, 0
    launches = fa_ops.flash_attention.launches
    seq2, prefill_s, decode_s = generate(lm_seq, params, prompts, SERVE_GEN, cache_len=cache_len)
    launches = fa_ops.flash_attention.launches - launches
    fed = seq2.to(prompts.device)
    gaps = []
    with torch.inference_mode():
        cache = D.init_cache(lm, b, cache_len, device=prompts.device)
        lg, cache = D.prefill(lm, params, cache, prompts)
        for i in range(SERVE_GEN):
            lgf = lm.tp.gather_vocab(lg, lm.cfg.vocab_size).float()
            gaps.append((lgf.max(-1).values - lgf.gather(-1, fed[:, i:i + 1])[:, 0]).max().item())
            if i + 1 < SERVE_GEN:
                lg, cache = D.decode_step(lm, params, cache, fed[:, i:i + 1])
                lg = lg[:, -1]
    del cache, lg
    fp32 = [generate(dataclasses.replace(m, compute_dtype=torch.float32), params32, prompts,
                     SERVE_GEN, cache_len=cache_len)[0].cpu() for m in (lm, lm_seq)]
    torch.cuda.empty_cache()
    return {"cache_len": cache_len, "held_bytes": held, "top_gap": max(gaps),
            "bf16_equal_steps": (seq2.cpu() == seq.cpu()).sum(1).tolist(),
            "fp32_tokens_equal": bool(torch.equal(*fp32)),
            "prefill_ms": prefill_s * 1e3, "decode_ms": decode_s * 1e3 / (SERVE_GEN - 1),
            "tp_s": lm_seq.tp.seconds, "tp_bytes": lm_seq.tp.bytes, "flash_launches": launches}


def one_process_serve(torch, cfg, step_dir: Path, fed, plain: bool = True,
                      fp32_prefill: bool = False, prompt_len: int = SERVE_BATCH[1]) -> dict:
    """The same step restored weights-only by one process (data=1,model=1)
    and served in bf16 with the plain attention in place of the flash
    kernel (``full_attention`` on fp32 copies of q, k and v, swapped in as
    :func:`decode_check` swaps it; no flash launch) and ``ssd_chunked`` in
    place of the SSD kernel (no SSD launch), or with ``plain`` off through
    both kernels, fed the multi-rank
    serve's tokens ``fed`` [B, SERVE_GEN]: the prefill's logits, and at each
    step its argmax, its top logit and the logit of the fed token; with
    ``fp32_prefill`` also the logits of an fp32 prefill through the plain
    attention and ``ssd_chunked``; ``prompt_len`` and the source embeds as
    the multi-rank serve's (:func:`serve_prompts`)."""
    from repro_torch.core.pytree import unflatten_from_paths
    from repro_torch.dist.sharding import make_plan, vocab_multiple
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.launch.serve import restore_params, serving_parallelism
    from repro_torch.models import build_model
    from repro_torch.models import decode as D
    from repro_torch.models import lm as lm_mod
    from repro_torch.models.attention import full_attention
    from repro_torch.models.ssm import ssd_chunked

    dev = torch.device("cuda")
    mesh = mesh_spec_from_string("data=1,model=1")
    par = serving_parallelism(mesh)
    lm = build_model(cfg, vocab_multiple=vocab_multiple(par, mesh))
    flat, rp = restore_params(step_dir, make_plan(cfg, lm.registry, par, mesh), dev)
    prompts, source = serve_prompts(torch, cfg, dev, prompt_len)
    b, s = prompts.shape
    fed = fed.to(dev)
    own, top, at_fed = [], [], []
    kernel_fn, launches = lm_mod.flash_attention, fa_ops.flash_attention.launches
    ssd_fn, ssd_launches = lm_mod.ssd_scan, ssd_ops.ssd_scan.launches
    lm_mod.flash_attention = lambda q, k, v, *, causal, window, q_offset=0: full_attention(
        q.float(), k.float(), v.float(), causal=causal, window=window,
        q_offset=q_offset).to(q.dtype)
    lm_mod.ssd_scan = ssd_chunked
    logits32 = None
    try:
        if fp32_prefill:
            lm32 = dataclasses.replace(lm, compute_dtype=torch.float32)
            with torch.inference_mode():
                logits32 = D.prefill(lm32, unflatten_from_paths(flat),
                                     D.init_cache(lm32, b, s, device=dev), prompts,
                                     source_embeds=source)[0].cpu()
        if not plain:
            lm_mod.flash_attention, lm_mod.ssd_scan = kernel_fn, ssd_fn
        params = lm.registry.cast(unflatten_from_paths(flat), torch.bfloat16)
        del flat
        with torch.inference_mode():
            cache = D.init_cache(lm, b, s + SERVE_GEN, device=dev)
            logits, cache = D.prefill(lm, params, cache, prompts, source_embeds=source)
            first, lg = logits.float().cpu(), logits
            for i in range(SERVE_GEN):
                lgf = lg.float()
                own.append(lgf.argmax(-1).cpu())
                top.append(lgf.max(-1).values.cpu())
                at_fed.append(lgf.gather(-1, fed[:, i:i + 1])[:, 0].cpu())
                if i + 1 < SERVE_GEN:
                    lg, cache = D.decode_step(lm, params, cache, fed[:, i:i + 1])
                    lg = lg[:, -1]
    finally:
        lm_mod.flash_attention, lm_mod.ssd_scan = kernel_fn, ssd_fn
    check(not plain or (fa_ops.flash_attention.launches == launches
                        and ssd_ops.ssd_scan.launches == ssd_launches),
          "the one-process serve launched the flash or the SSD kernel")
    del params, cache
    torch.cuda.empty_cache()
    return {"mode": rp.mode.value, "logits": first, "own": torch.stack(own, 1),
            "top": torch.stack(top, 1), "at_fed": torch.stack(at_fed, 1), "logits32": logits32}


def hold_serve(torch, label: str, ranked: dict, one: dict, tol: float = SERVE_LOGIT_TOL) -> dict:
    """A multi-rank serve (rank 0's saved prefill logits and greedy tokens)
    against one process serving the same step through the plain attention,
    fed the same tokens (:func:`one_process_serve`): the prefill logits
    within ``SERVE_LOGIT_TOL``, and at every step of every row the
    multi-rank serve's token within ``SERVE_LOGIT_TOL`` of one process's
    top logit, so a token differs from one process's argmax only at a
    near-tie (which may go either way after bf16 rounding); ``tol`` where a
    stage sets its own limit (``SERVE_LOGIT_TOL`` else)."""
    err = (ranked["logits"] - one["logits"]).abs().max().item()
    check(err <= tol, f"{label}: prefill logits {err:.4f} from one process's (tolerance {tol})")
    gap = one["top"] - one["at_fed"]  # [B, SERVE_GEN], 0 where the tokens agree
    worst = gap.max().item()
    check(worst <= tol, f"{label}: a greedy token {worst:.4f} under one process's "
                        f"top logit (tolerance {tol})")
    equal = (one["own"] == ranked["seq"]).sum(1).tolist()
    print(f"{label}: prefill logits within {err:.4f} of one process's (tolerance {tol}); fed the "
          f"same tokens, one process's argmax equals the greedy token at {equal} of {SERVE_GEN} "
          f"steps a row, every greedy token within {worst:.4f} of one process's top logit "
          f"(tolerance {tol})")
    return {"logits_max_abs_err": err, "equal_steps": equal, "top_gap": worst, "tolerance": tol}


def multirank_rank(rank: int, world: int, store: str, out_dir: str, stage: str) -> None:
    """One rank of the multirank phase, in a spawned process: smollm-360m
    at full width, ``CUT_LAYERS`` layers, through ``Trainer.create(...,
    group=WORLD)`` on the one card.
    ``stage="save"``: data=2,model=1 from seed 0, steps 1-2 with an
    ``int8:b256`` save at step 2 (each rank writes its own shards), then the
    gathered state saved by one process (rank 0) for its digests.
    ``stage="resume"``: data=1,model=2 resumes step 2 (RESHARD_STREAM), the
    state held bit for bit against ``slice_shard`` of a one-process
    restore, then steps 3-4, computed partitioned over the model axis
    (MLP and vocab over model, attention by query rows); then the same
    ranks serve step 2's weights under data=1,model=2 (:func:`rank_serve`).
    ``stage="tp"``: gpt3-350m under data=1,model=2 from seed 0, steps 1-2
    partitioned (attention by heads) with each rank saving its own
    ``int8:b256`` shards at step 2, then the same ranks serve step 2
    (DIRECT).  ``stage="hot"``: the hot tier, delta drains and fan-out under
    the group (:func:`multirank_hot_rank`).  Writes what it measured to
    ``<stage><r>.json``; any failure raises, so the process exits
    non-zero."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.ckpt.saver import snapshot_state, write_distributed
    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config
    from repro_torch.core.dist_ckpt import DistCheckpoint
    from repro_torch.core.layout import slice_shard
    from repro_torch.core.patterns import StateKind
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.kernels.block_quant import kernel as bq_kernel
    from repro_torch.kernels.block_quant import ops as bq_ops
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.train.trainer import Trainer, gather_state

    t_start = time.perf_counter()
    if stage in ("moe", "mla"):  # two ranks of MoE state on one card: no stranded segments
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MULTIRANK_JOIN_S))
    try:
        from repro_torch.kernels.flash_attention import kernel as fa_kernel

        from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

        for built in (bq_kernel, fa_kernel) + ((ssd_kernel,) if stage == "ssm" else ()):
            _, report = built.build()
            check(not report["compiled"], f"rank {rank} rebuilt {report['library']}")
        fns = {"quantize": bq_ops.block_quantize, "dequantize": bq_ops.block_dequantize}
        out: dict = {"rank": rank, "stage": stage}
        bodies = {"tp": multirank_tp_rank, "hot": multirank_hot_rank,
                  "survivors": multirank_survivors_rank, "moe": multirank_moe_rank,
                  "ssm": multirank_ssm_rank, "mla": multirank_serve_rank,
                  "vlm": multirank_serve_rank, "encdec": multirank_encdec_rank,
                  "pipe": multirank_pipe_rank, "fsdp": multirank_fsdp_rank}
        if stage in bodies:
            body = bodies[stage]
            (Path(out_dir) / f"{stage}{rank}.json").write_text(json.dumps(
                body(torch, dist, rank, Path(out_dir), fns, t_start)))
            return
        if stage == "save":
            out["gloo_cuda"] = gloo_cuda_probe(torch, dist)
            check(all(out["gloo_cuda"][c] == "ok" for c in RUNTIME_COLLECTIVES),
                  f"gloo refuses a collective the runtime sends it on the card: {out['gloo_cuda']}")
        cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=CUT_LAYERS)
        tcfg, parallel = TrainConfig(seed=0), ParallelismConfig()
        root = Path(out_dir) / "ckpt"
        b, s = MULTIRANK_BATCH
        policy = CheckpointPolicy(codec=MULTIRANK_CODEC, save_interval=2 if stage == "save" else 1000)
        t = Trainer.create(cfg, parallel, tcfg, mesh_spec_from_string(MULTIRANK_MESH[stage]),
                           batch_size=b, seq_len=s, ckpt_dir=str(root), policy=policy,
                           group=dist.group.WORLD)
        out["device"] = str(t.device)
        torch.cuda.reset_peak_memory_stats()
        t_ready = time.perf_counter()
        if stage == "save":
            state = t.init_state()
            reset_launches(fns)
            state, hist = t.run(state, 0, 2)  # the main path: 2 steps and the save
            out["launches"] = launch_counts(fns)
            out["launches_by_variant"] = {k: dict(fn.launches_by_variant) for k, fn in fns.items()}
            (res,) = t.save_results
            out["save"] = {"s": res.wall_time_s, "bytes": res.bytes_written,
                           "shards": res.shards_written, "coded_bytes": res.coded_bytes}
            out["gather_routes"] = gather_routes(torch, dist, t.plan,
                                                 flatten_with_paths(state.params))
            check(out["gather_routes"]["bit_equal"], f"rank {rank}: the two gather routes differ")
            t0 = time.perf_counter()
            full = gather_state(state, t.plan, dist.group.WORLD)
            torch.cuda.synchronize()
            out["gather_state_s"] = time.perf_counter() - t0
            del state
            if rank == 0:  # the one-process saver of the gathered state: the digests to match
                reset_launches(fns)
                one = Path(out_dir) / "one"
                t0 = time.perf_counter()
                write_distributed(snapshot_state(full, t.manager.codec), t.plan, 2, one,
                                  codec=t.manager.codec,
                                  config_fingerprint=t.manager.config_fingerprint)
                out["one_save_s"] = time.perf_counter() - t0
                out["one_launches"] = launch_counts(fns)
                out["one_launches_by_variant"] = {k: dict(fn.launches_by_variant)
                                                  for k, fn in fns.items()}
                step2 = root / "step_00000002"
                a, c = DistCheckpoint.open(step2), DistCheckpoint.open(one)
                files = [sorted(p.relative_to(d).as_posix() for p in d.rglob("*.npy"))
                         for d in (step2, one)]
                out["check"] = {
                    "committed": a.is_committed, "digests": len(a.manifest.shard_digests),
                    "digests_equal": a.manifest.shard_digests == c.manifest.shard_digests,
                    "codecs_equal": a.manifest.shard_codecs == c.manifest.shard_codecs,
                    "files": len(files[0]), "files_equal": files[0] == files[1],
                    "bytes": sum(p.stat().st_size for p in step2.rglob("*.npy")),
                }
                shutil.rmtree(one)
            del full
            dist.barrier()
        else:
            reset_launches(fns)
            state, info = t.init_or_restore()
            check(info is not None, f"rank {rank}: nothing to resume")
            out["restore"] = {"mode": info.mode.value, "step": info.step, "s": info.wall_time_s,
                              "bytes_read": info.restore_stats.bytes_read,
                              "reason": info.reason}
            out["restore_launches"] = launch_counts(fns)
            trees = {StateKind.FP32: state.params, StateKind.EXP_AVG: state.exp_avg,
                     StateKind.EXP_AVG_SQ: state.exp_avg_sq}
            out["shard_bytes"] = sum(x.numel() * x.element_size() for tree in trees.values()
                                     for x in flatten_with_paths(tree).values())
            # the one-process restore of the same step, cut to this rank's shards
            one = CheckpointManager(str(root), t.plan,
                                    policy=CheckpointPolicy(save_interval=1000, async_save=False))
            full, _ = one.restore(t.device)
            fulls = {StateKind.FP32: full.params, StateKind.EXP_AVG: full.exp_avg,
                     StateKind.EXP_AVG_SQ: full.exp_avg_sq}
            diff = 0
            for kind, tree in trees.items():
                want = flatten_with_paths(fulls[kind])
                for name, got in flatten_with_paths(tree).items():
                    layout = t.plan.param_specs[name].layout_for(kind, t.plan.mesh)
                    cut = slice_shard(want[name], layout, rank)
                    diff += int((got.view(torch.int32) != cut.view(torch.int32)).sum())
            out["bits_differing"] = diff
            del full, fulls, want, cut
            torch.cuda.empty_cache()
            reset_launches(fns)
            state, hist = t.run(state, 2, 2)  # steps 3-4; no save
            out["run_launches"] = launch_counts(fns)
            out["gathered"] = sorted(t.lm.tp.gathered)
            out["seq_parallel"] = t.lm.tp.sp  # the last forward's decision
            del state
            torch.cuda.empty_cache()
            out["serve"] = rank_serve(torch, dist, cfg, MULTIRANK_MESH["resume"],
                                      root / "step_00000002", "reshard_stream", Path(out_dir),
                                      "multirank", seq_cache=True)
        t.manager.close()
        out["hist"] = [{k: h[k] for k in ("step", "loss", "grad_norm", "dt", "split")}
                       for h in hist]
        out["setup_s"] = t_ready - t_start
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        (Path(out_dir) / f"{stage}{rank}.json").write_text(json.dumps(out))
    finally:
        if dist.is_initialized():  # the hot stage's survivor destroys it itself
            dist.destroy_process_group()


def restore_bits_differing(torch, t, state, root: Path, rank: int) -> int:
    """Elements of a rank's restored state that differ from its
    ``slice_shard`` of a one-process restore of the same step (under the
    trainer's plan)."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.core.layout import slice_shard
    from repro_torch.core.patterns import StateKind
    from repro_torch.core.pytree import flatten_with_paths

    one = CheckpointManager(str(root), t.plan,
                            policy=CheckpointPolicy(save_interval=1000, async_save=False))
    full, _ = one.restore(t.device)
    diff = 0
    for kind, field in ((StateKind.FP32, "params"), (StateKind.EXP_AVG, "exp_avg"),
                        (StateKind.EXP_AVG_SQ, "exp_avg_sq")):
        want = flatten_with_paths(getattr(full, field))
        for name, got in flatten_with_paths(getattr(state, field)).items():
            cut = slice_shard(want[name], t.plan.param_specs[name].layout_for(kind, t.plan.mesh),
                              rank)
            diff += int((got.view(torch.int32) != cut.view(torch.int32)).sum())
    del full, want, cut
    torch.cuda.empty_cache()
    return diff


def multirank_pipe_rank(torch, dist, rank: int, out_dir: Path, fns: dict, t_start: float) -> dict:
    """One rank of the multirank phase's ``pipe`` stage: smollm-360m at full
    width, ``CUT_LAYERS`` layers, bf16 compute.  Resumes the phase's step-2
    ``int8:b256`` checkpoint (saved under data=2,model=1) under
    ``PIPE_MESH`` (RESHARD_STREAM, the DP -> PP move; each rank's state
    held bit for bit against ``slice_shard`` of a one-process restore),
    takes steps 3-4 by pipeline stages (each rank only its chunk of the
    layers: its compute tree's stacked dims and the layers it computed are
    checked) and saves its own ``int8:b256`` shards at step 4, beside one
    process's save of the gathered state (rank 0) for the digests and the
    launches; then the same ranks resume step 4 under ``SP_MESH`` with
    tensor parallelism off (RESHARD_STREAM, the PP -> SP move) and take
    steps 5-6 by sequence rows."""
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.ckpt.saver import snapshot_state, write_distributed
    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config
    from repro_torch.core.dist_ckpt import DistCheckpoint
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.train.trainer import Trainer, gather_state

    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=CUT_LAYERS)
    tcfg = TrainConfig(seed=0)
    root = out_dir / "ckpt"
    b, s = MULTIRANK_BATCH
    out: dict = {"rank": rank, "stage": "pipe"}
    reset_launches({"flash": fa_ops.flash_attention})
    t = Trainer.create(cfg, ParallelismConfig(pipe_axis="pipe"), tcfg,
                       mesh_spec_from_string(PIPE_MESH), batch_size=b, seq_len=s,
                       ckpt_dir=str(root), group=dist.group.WORLD,
                       policy=CheckpointPolicy(codec=MULTIRANK_CODEC, save_interval=4))
    pipe = t.lm.pipe
    check(pipe is not None and t.lm.tp is None, f"pipe rank {rank}: no pipeline stage")
    out["setup_s"] = time.perf_counter() - t_start
    reset_launches(fns)
    state, info = t.init_or_restore()
    check(info is not None, f"pipe rank {rank}: nothing to resume")
    out["restore"] = {"mode": info.mode.value, "step": info.step, "s": info.wall_time_s,
                      "bytes_read": info.restore_stats.bytes_read}
    out["restore_launches"] = launch_counts(fns)
    out["bits_differing"] = restore_bits_differing(torch, t, state, root, rank)
    # the weights this rank computes from: its chunk of every stack, nothing more
    _, comp = pipe.weights(flatten_with_paths(state.params))
    out["chunks"] = {k: list(v) for k, v in pipe.chunks.items()}
    out["held"] = {n: list(x.shape) for n, x in comp.items() if pipe.stacked[n]}
    out["compute_bytes"] = sum(x.numel() * x.element_size() for x in comp.values())
    out["stacked_bytes"] = sum(x.numel() * x.element_size() for n, x in comp.items()
                               if pipe.stacked[n])
    del comp
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fns)
    state, hist = t.run(state, 2, 2)  # steps 3-4 by stages, the save at step 4
    torch.cuda.synchronize()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = launch_counts(fns)
    out["launches_by_variant"] = {k: dict(fn.launches_by_variant) for k, fn in fns.items()}
    out["computed"] = [list(c) for c in pipe.computed]
    (res,) = t.save_results
    out["save"] = {"s": res.wall_time_s, "bytes": res.bytes_written, "shards": res.shards_written}
    out["hist"] = [{k: h[k] for k in ("step", "loss", "grad_norm", "dt", "split")} for h in hist]
    full = gather_state(state, t.plan, dist.group.WORLD)
    del state
    if rank == 0:  # the one-process saver of the gathered step-4 state: digests and launches
        reset_launches(fns)
        one = out_dir / "one_pipe"
        write_distributed(snapshot_state(full, t.manager.codec), t.plan, 4, one,
                          codec=t.manager.codec, config_fingerprint=t.manager.config_fingerprint)
        out["one_launches"] = launch_counts(fns)
        a, c = DistCheckpoint.open(root / "step_00000004"), DistCheckpoint.open(one)
        out["check"] = {"committed": a.is_committed,
                        "digests_equal": a.manifest.shard_digests == c.manifest.shard_digests,
                        "digests": len(a.manifest.shard_digests)}
        shutil.rmtree(one)
    del full
    t.manager.close()
    del t, pipe
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    # the PP -> SP move: tensor parallelism off, each rank its rows of the stream
    t = Trainer.create(cfg, ParallelismConfig(tensor_parallel=False), tcfg,
                       mesh_spec_from_string(SP_MESH), batch_size=b, seq_len=s,
                       ckpt_dir=str(root), group=dist.group.WORLD,
                       policy=CheckpointPolicy(codec=MULTIRANK_CODEC, save_interval=1000))
    check(t.lm.tp is not None and not t.lm.tp.tensor and t.lm.pipe is None,
          f"pipe rank {rank}: tensor parallelism off does not compute by rows")
    reset_launches(fns)
    state, info = t.init_or_restore()
    check(info is not None, f"pipe rank {rank}: nothing to resume at step 4")
    out["sp_restore"] = {"mode": info.mode.value, "step": info.step, "s": info.wall_time_s,
                         "bytes_read": info.restore_stats.bytes_read}
    out["sp_restore_launches"] = launch_counts(fns)
    out["sp_bits_differing"] = restore_bits_differing(torch, t, state, root, rank)
    reset_launches(fns)
    state, hist = t.run(state, 4, 2)  # steps 5-6 by rows; no save
    out["sp_run_launches"] = launch_counts(fns)
    out["sp_hist"] = [{k: h[k] for k in ("step", "loss", "grad_norm", "dt", "split")}
                      for h in hist]
    out["sp_seq_parallel"] = t.lm.tp.sp
    t.manager.close()
    out["flash_launches"] = fa_ops.flash_attention.launches
    return out


def multirank_fsdp_rank(torch, dist, rank: int, out_dir: Path, fns: dict, t_start: float) -> dict:
    """One rank of the multirank phase's ``fsdp`` stage: smollm-360m at full
    width, ``FSDP_LAYERS`` layers, under ``FSDP_MESH`` (each rank holds half
    of every weight and moment), bf16 compute, remat full, 8 x 512 rows a
    step (4 a rank), two steps from seed 0 with the dry run's inputs (int32
    tokens, the host int32 step counter).  Each layer's weights are gathered
    where the layer reads them (``LM.fsdp``).  Records each step's loss and
    split, the arguments' bytes and the peak of step 2:
    ``max_memory_allocated`` over it less the memory before the state."""
    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config
    from repro_torch.launch.hlo_analysis import tensors_of
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.train.trainer import Trainer

    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=FSDP_LAYERS)
    b, s = MULTIRANK_BATCH
    t = Trainer.create(cfg, ParallelismConfig(), TrainConfig(seed=0),
                       mesh_spec_from_string(FSDP_MESH), batch_size=b, seq_len=s,
                       group=dist.group.WORLD)
    check(t.lm.tp is None and t.lm.pipe is None and t.lm.fsdp is not None,
          f"fsdp rank {rank}: not the data-parallel step with the layer gather")
    nbytes = lambda tree: sum(x.numel() * x.element_size() for x in tensors_of(tree))  # noqa: E731
    out = {"rank": rank, "setup_s": time.perf_counter() - t_start}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    state = dataclasses.replace(t.init_state(), step=torch.zeros((), dtype=torch.int32))
    out["shard_bytes"] = nbytes(state.params)
    hist = []
    reset_launches(fns)
    for step in range(2):
        batch = {"tokens": t.batch(step)["tokens"].int()}
        if step == 1:  # the step the prediction is held against
            out["argument_bytes"] = nbytes((state.params, state.exp_avg, state.exp_avg_sq, batch))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = t.step_fn(state, batch)
        torch.cuda.synchronize()
        hist.append({"step": step + 1, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "dt": time.perf_counter() - t0, "split": dict(t.step_fn.split)})
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    out["launches"] = launch_counts(fns)
    out["hist"] = hist
    del state
    return out


def hold_fsdp(ranks: list[dict], one_losses: list[float], pred: dict, world_s: float) -> dict:
    """The multirank phase's fsdp stage held (each failed check raises):
    every rank's argument bytes the dry run's exactly, its step-2 peak
    within ``DRYRUN_PEAK_TOL`` of the dry run's 2-rank prediction (arguments
    + temporaries), both ranks the same losses, within ``MULTIRANK_TOL`` of
    one process's, layer gathers in every step's split, no block-quant
    launch.  Prints the stage and returns its record."""
    check(pred.get("ok") is True, f"multirank-fsdp: the dry run's 2-rank cell: {pred}")
    mem = pred["memory"]
    predicted = mem["argument_bytes_per_device"] + mem["temp_bytes_per_device"]
    for r in ranks:
        rk, tol = r["rank"], max(DRYRUN_PEAK_TOL[0] * r["peak_bytes"], DRYRUN_PEAK_TOL[1])
        check(r["argument_bytes"] == mem["argument_bytes_per_device"],
              f"multirank-fsdp rank {rk}: argument bytes {r['argument_bytes']}, the dry run's "
              f"{mem['argument_bytes_per_device']}")
        check(abs(predicted - r["peak_bytes"]) <= tol,
              f"multirank-fsdp rank {rk}: peak {r['peak_bytes']} on the card, the dry run's "
              f"{predicted} (limit ±{tol:.0f})")
        check(all(h["split"]["gather_bytes"] > 0 for h in r["hist"]),
              f"multirank-fsdp rank {rk}: no layer gather in the split")
        check(r["launches"] == {"quantize": 0, "dequantize": 0},
              f"multirank-fsdp rank {rk}: launches {r['launches']}")
    losses = [h["loss"] for h in ranks[0]["hist"]]
    check(all([h["loss"] for h in r["hist"]] == losses for r in ranks),
          "multirank-fsdp: the ranks report different losses")
    gap = max(abs(x - y) for x, y in zip(losses, one_losses))
    check(all(map(math.isfinite, losses)) and gap <= MULTIRANK_TOL,
          f"multirank-fsdp: steps 1-2 {losses} left one process's {one_losses}")
    out = {
        "model": f"smollm-360m, full width, {FSDP_LAYERS} of 32 layers", "mesh": FSDP_MESH,
        "batch": list(MULTIRANK_BATCH), "losses": losses, "one_process_losses": one_losses,
        "gap": gap, "predicted_peak_bytes": predicted,
        "predicted": {"argument_bytes": mem["argument_bytes_per_device"],
                      "temp_bytes": mem["temp_bytes_per_device"],
                      "collective_bytes": pred["per_device"]["collective_bytes"],
                      "wall_s": pred["wall_s"]},
        "ranks": [{k: r[k] for k in ("rank", "peak_bytes", "argument_bytes", "shard_bytes",
                                     "setup_s")} for r in ranks],
        "steps": [{"rank": r["rank"], **h} for r in ranks for h in r["hist"]],
        "world_s": world_s,
    }
    print(f"multirank-fsdp smollm-360m ({FSDP_LAYERS} layers, {FSDP_MESH}, each layer's weights "
          f"gathered where it reads them): losses {[round(v, 4) for v in losses]}, one process "
          f"{[round(v, 4) for v in one_losses]} (gap {gap:.5f}); world {world_s:.1f} s")
    for r in ranks:
        print(f"  rank {r['rank']}: step-2 peak {r['peak_bytes']} bytes on the card (less the "
              f"memory before the state), the dry run's 2-rank prediction {predicted} "
              f"(arguments {mem['argument_bytes_per_device']} + temporaries "
              f"{mem['temp_bytes_per_device']}): {100 * (r['peak_bytes'] - predicted) / predicted:+.2f}%")
        for h in r["hist"]:
            sp = h["split"]
            print(f"  rank {r['rank']} step {h['step']}: loss {h['loss']:.4f}, wall {h['dt']:.2f} s "
                  f"= gather {sp['gather_s']:.2f} ({sp['gather_bytes'] / 1e9:.3f} GB) + "
                  f"forward/backward {sp['grad_s']:.2f} + all-reduce {sp['all_reduce_s']:.2f} "
                  f"({sp['all_reduce_bytes'] / 1e9:.3f} GB) + update {sp['update_s']:.2f}")
    return out


PYCACHE = ROOT / "build" / "pycache"
WARM_RANKS = 2  # rank processes kept started ahead of the next world


def bytecode_cache() -> None:
    """Compile each module once for the whole run: this process writes its
    bytecode under ``build/pycache`` and every process it spawns reads it
    there.  The card's environment sets ``PYTHONDONTWRITEBYTECODE`` beside
    sources it ships without bytecode, so each of the ~30 processes of a
    run compiled torch anew (~7 s a process on the card's host; spawned
    children still write none, ``-B``)."""
    sys.pycache_prefix = str(PYCACHE)
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = str(PYCACHE)


def warm_imports() -> None:
    """What every rank imports before its first step: torch, its
    ``torch._dynamo`` (which ``torch.utils.checkpoint`` imports at its
    first call: ~5 s a process), gloo's front end and the port's trainer,
    checkpoint manager and serving modules.  Touches no CUDA."""
    import torch._dynamo  # noqa: F401
    import torch.distributed  # noqa: F401

    import repro_torch.ckpt.manager  # noqa: F401
    import repro_torch.launch.serve  # noqa: F401
    import repro_torch.models.decode  # noqa: F401
    import repro_torch.train.trainer  # noqa: F401


def warm_rank(conn) -> None:
    """A spawned rank started ahead of its world (:class:`WarmRanks`): it
    imports (:func:`warm_imports`), then waits for ``(function name,
    arguments)`` and runs it; an end of the pipe with nothing sent ends it."""
    import torch

    warm_imports()
    check(not torch.cuda.is_initialized(), "a warm rank initialized CUDA before its work")
    try:
        name, args = conn.recv()
    except EOFError:
        return
    conn.close()
    globals()[name](*args)


class WarmRanks:
    """Rank processes started ahead of their world, so that a world's
    start-up (the interpreter, :func:`warm_imports`: ~10 s a process)
    overlaps the work before it.  :meth:`run` hands a world's ranks their
    work, taking the waiting processes first and starting the rest, and
    :meth:`fill` starts ``WARM_RANKS`` for the next world; :meth:`close`
    ends the ones still waiting (``main``, whatever happens)."""

    def __init__(self) -> None:
        self.idle: list = []  # (process, the sending end of its pipe)

    def _start(self) -> None:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        recv, send = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=warm_rank, args=(recv,))
        proc.start()
        recv.close()
        self.idle.append((proc, send))

    def fill(self, n: int = WARM_RANKS) -> None:
        while len(self.idle) < n:
            self._start()

    def run(self, fn, args: list[tuple]) -> list:
        """Rank r of the world runs ``fn(*args[r])``; returns the processes."""
        self.fill(len(args))
        taken, self.idle = self.idle[:len(args)], self.idle[len(args):]
        for (proc, send), a in zip(taken, args):
            send.send((fn.__name__, a))
            send.close()
        return [proc for proc, _ in taken]

    def close(self) -> None:
        for proc, send in self.idle:
            send.close()
        for proc, _ in self.idle:
            proc.join(60)
            if proc.is_alive():
                proc.kill()
                proc.join()
        self.idle = []


WARM = WarmRanks()


def run_multirank_world(torch, stage: str, out_dir: Path, join_s: float = MULTIRANK_JOIN_S,
                        world: int = MULTIRANK_WORLD,
                        warm_next: int = WARM_RANKS) -> tuple[list[dict], float]:
    """Run the ``world`` ranks of one stage (:data:`WARM`'s), join them
    with the phase's time limit ``join_s`` (a rank still running is killed,
    and fails the smoke, as does a non-zero exit), start the next world's
    ``warm_next`` ranks, and return each rank's record and the world's
    wall."""
    store = out_dir / f"store_{stage}"
    t0 = time.perf_counter()
    procs = WARM.run(multirank_rank,
                     [(r, world, str(store), str(out_dir), stage) for r in range(world)])
    try:
        deadline = time.monotonic() + join_s
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        wall = time.perf_counter() - t0
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        check(not hung, f"multirank {stage}: ranks {hung} still running after {join_s} s")
        codes = [p.exitcode for p in procs]
        check(codes == [0] * world, f"multirank {stage}: rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    WARM.fill(warm_next)
    return [json.loads((out_dir / f"{stage}{r}.json").read_text())
            for r in range(world)], wall


def multirank_phase(torch, bq_ops) -> dict:
    """The multi-rank training runtime on the one card: a one-process
    baseline (data=1,model=1, 4 steps), 2 ranks under data=2,model=1 (steps
    1-2, each rank saving its own ``int8:b256`` shards at step 2), 2 new
    ranks under data=1,model=2 resuming step 2 (RESHARD_STREAM; steps 3-4
    computed partitioned over the model axis: MLP and vocab over model,
    attention by query rows from the gathered attention weights), which
    then serve step 2's weights (RESHARD_STREAM, ``wqkv`` consolidated;
    rank 0's prefill rows 0-255, rank 1's 256-511 at ``q_offset`` 256),
    held against one process's serve of the same step; and one process
    under data=1,model=1 resuming step 2 (2 ranks -> 1; steps 3-4).
    Returns the phase's measurements."""
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.train.trainer import Trainer

    fns = {"quantize": bq_ops.block_quantize, "dequantize": bq_ops.block_dequantize}
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=CUT_LAYERS)
    tcfg, parallel = TrainConfig(seed=0), ParallelismConfig()
    b, s = MULTIRANK_BATCH
    out_dir = ROOT / "build" / "chip_smoke_multirank"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t_phase = time.perf_counter()

    def trainer(**kw):
        return Trainer.create(cfg, parallel, tcfg, mesh_spec_from_string("data=1,model=1"),
                              batch_size=b, seq_len=s, device=torch.device("cuda"), **kw)

    predict = no_card_process(["-c", FSDP_PREDICT.format(layers=FSDP_LAYERS, seq=s, rows=b)])
    try:
        p2p = gloo_p2p_probe(torch, out_dir)  # beside the baseline: 2 small processes
        WARM.fill(4 * MULTIRANK_WORLD)  # the save, resume, fsdp and pipe worlds follow each other
        base = trainer()
        _, hist = base.run(base.init_state(), 0, 6)
        baseline = [h["loss"] for h in hist]
        check(all(map(math.isfinite, baseline)), f"multirank baseline: losses {baseline}")
        del base, hist
        base = Trainer.create(dataclasses.replace(cfg, num_layers=FSDP_LAYERS), parallel, tcfg,
                              mesh_spec_from_string("data=1,model=1"), batch_size=b, seq_len=s,
                              device=torch.device("cuda"))
        _, hist = base.run(base.init_state(), 0, 2)  # the fsdp stage's one process
        fsdp_one = [h["loss"] for h in hist]
        del base, hist
        gc.collect()
        torch.cuda.empty_cache()
        gloo_p2p = p2p()
        saved, save_wall = run_multirank_world(torch, "save", out_dir)
        resumed, resume_wall = run_multirank_world(torch, "resume", out_dir)
        fsdp, fsdp_wall = run_multirank_world(torch, "fsdp", out_dir)
        (fsdp_pred,) = finish_process(predict, "the fsdp stage's 2-rank cell", MULTIRANK_JOIN_S)
        ranked_serve = torch.load(out_dir / "multirank_serve.pt")
        one_serve = one_process_serve(torch, cfg, out_dir / "ckpt" / "step_00000002",
                                      ranked_serve["seq"])
        reset_launches(fns)
        one = trainer(ckpt_dir=str(out_dir / "ckpt"),
                      policy=CheckpointPolicy(codec=MULTIRANK_CODEC, save_interval=1000))
        state, info = one.init_or_restore()
        one_restore = launch_counts(fns)
        _, hist = one.run(state, 2, 2)
        one.manager.close()
        one_losses = [h["loss"] for h in hist]
        del one, state
        gc.collect()
        torch.cuda.empty_cache()
        # DP -> PP (steps 3-4 by stages, saved at step 4), then PP -> SP (steps 5-6)
        t_pipe = time.perf_counter()
        piped, pipe_wall = run_multirank_world(torch, "pipe", out_dir,
                                               warm_next=SURVIVORS_WORLD)
        reset_launches(fns)
        one = trainer(ckpt_dir=str(out_dir / "ckpt"),
                      policy=CheckpointPolicy(codec=MULTIRANK_CODEC, save_interval=1000))
        state, info4 = one.init_or_restore()
        one_restore4 = launch_counts(fns)
        _, hist = one.run(state, 4, 2)
        one.manager.close()
        one_losses4 = [h["loss"] for h in hist]
        del one, state
        gc.collect()
        torch.cuda.empty_cache()
        pipe_phase_s = time.perf_counter() - t_pipe
    finally:
        if predict.poll() is None:
            predict.kill()
            predict.communicate()
        shutil.rmtree(out_dir, ignore_errors=True)

    fsdp_out = hold_fsdp(fsdp, fsdp_one, fsdp_pred, fsdp_wall)
    # the 2-rank run: every rank logs the mean, so the ranks agree
    save_losses = [h["loss"] for h in saved[0]["hist"]]
    check(all(r["hist"][i]["loss"] == save_losses[i] for r in saved for i in range(2)),
          "multirank save: the ranks report different losses")
    gap_save = max(abs(x - y) for x, y in zip(save_losses, baseline[:2]))
    check(all(map(math.isfinite, save_losses)) and gap_save <= MULTIRANK_TOL,
          f"multirank: 2-rank steps 1-2 {save_losses} left the baseline {baseline[:2]}")
    chk = saved[0]["check"]
    check(chk["committed"] and chk["digests_equal"] and chk["codecs_equal"] and chk["files_equal"],
          f"multirank: the 2-rank checkpoint is not the one-process save of the gathered state "
          f"({chk})")
    per_rank = {k: [r["launches"][k] for r in saved] for k in fns}
    summed = {k: sum(v) for k, v in per_rank.items()}
    one_save = saved[0]["one_launches"]
    check(summed == one_save and all(v > 0 for v in summed.values()),
          f"multirank: the ranks' save launches {per_rank} do not sum to the one-process "
          f"save's {one_save}")
    vector = all(set(k for k, n in r["launches_by_variant"][f].items() if n) <= {"vector"}
                 for r in saved for f in fns)
    check(vector, f"multirank: a save launch was not the vector kernel: "
                  f"{[r['launches_by_variant'] for r in saved]}")
    # the 2-rank resume under another layout
    for r in resumed:
        check(r["restore"]["mode"] == "reshard_stream" and r["restore"]["step"] == 2,
              f"multirank resume rank {r['rank']}: {r['restore']}")
        check(r["bits_differing"] == 0, f"multirank resume rank {r['rank']}: {r['bits_differing']} "
                                        "elements differ from the one-process restore's shard")
        check(r["run_launches"] == {"quantize": 0, "dequantize": 0},
              f"multirank resume rank {r['rank']}: launches while training {r['run_launches']}")
    resume_losses = [h["loss"] for h in resumed[0]["hist"]]
    gap_resume = max(abs(x - y) for x, y in zip(resume_losses, baseline[2:]))
    check(all(map(math.isfinite, resume_losses)) and gap_resume <= MULTIRANK_TOL,
          f"multirank: resumed steps 3-4 {resume_losses} left the baseline {baseline[2:]}")
    check(info is not None and info.mode.value == "reshard_stream" and info.step == 2,
          f"multirank: the one-process resume of the 2-rank checkpoint: {info}")
    gap_one = max(abs(x - y) for x, y in zip(one_losses, baseline[2:]))
    check(all(map(math.isfinite, one_losses)) and gap_one <= MULTIRANK_TOL,
          f"multirank: the one-process resume's steps 3-4 {one_losses} left the baseline")
    resume_dq = sum(r["restore_launches"]["dequantize"] for r in resumed)
    half = SERVE_BATCH[1] // 2
    for r in resumed:  # partitioned: attention by query rows from the gathered weights
        sv, lo = r["serve"], r["rank"] * half
        check(r["gathered"] == ["layers.blk.wo", "layers.blk.wqkv"] and r["seq_parallel"]
              and sv["gathered"] == r["gathered"] and not sv["heads_local"],
              f"multirank resume rank {r['rank']}: gathered {r['gathered']} / {sv['gathered']}")
        check(sv["mode"] == "reshard_stream" and "layers.blk.wqkv" in sv["consolidated"],
              f"multirank serve rank {r['rank']}: {sv['mode']}, consolidated {sv['consolidated']}")
        check(sv["flash_launches"] == cfg.num_layers
              and set(map(tuple, sv["flash_calls"])) == {("bfloat16", half, lo + half, True)}
              and set(sv["flash_offsets"]) == {lo},
              f"multirank serve rank {r['rank']}: {sv['flash_launches']} flash launches "
              f"{set(map(tuple, sv['flash_calls']))} at q_offset {set(sv['flash_offsets'])}")
        check(all("tp_s" in h["split"] for h in r["hist"]),
              f"multirank resume rank {r['rank']}: no tp_s in the split")
        sc = sv["seq_cache"]
        halved = {p: (n, sc["held_bytes"]["seq_sharded"][p])
                  for p, n in sc["held_bytes"]["replicated"].items()}
        check(halved and all(2 * h == n for n, h in halved.values()),
              f"multirank serve rank {r['rank']}: a length-sharded cache holds {halved}")
        check(sc["fp32_tokens_equal"] and sc["top_gap"] <= SERVE_LOGIT_TOL,
              f"multirank serve rank {r['rank']}: the length-sharded cache's fp32 tokens "
              f"{'equal' if sc['fp32_tokens_equal'] else 'differ from'} the replicated "
              f"cache's; its bf16 tokens {sc['top_gap']:.4f} under the replicated decode's top "
              f"logit (tolerance {SERVE_LOGIT_TOL})")
    held = hold_serve(torch, "multirank serve", ranked_serve, one_serve)
    pipe_out = hold_pipe(piped, baseline, one_losses4, info4, one_restore4, pipe_wall,
                         pipe_phase_s)
    out = {
        "model": f"smollm-360m, full width, {CUT_LAYERS} of 32 layers", "world": MULTIRANK_WORLD,
        "backend": "gloo", "tensors": "cuda", "batch": list(MULTIRANK_BATCH),
        "codec": MULTIRANK_CODEC, "meshes": MULTIRANK_MESH,
        "gloo_cuda": {**saved[0]["gloo_cuda"], **gloo_p2p},
        "baseline": baseline, "save_losses": save_losses, "resume_losses": resume_losses,
        "one_process_losses": one_losses,
        "gaps": {"save": gap_save, "resume": gap_resume, "one_process": gap_one},
        "steps": {stage: [{"rank": r["rank"], **h} for r in ranks for h in r["hist"]]
                  for stage, ranks in (("save", saved), ("resume", resumed))},
        "save": [{"rank": r["rank"], **r["save"]} for r in saved],
        "commit": chk,
        "gather_state_s": [r["gather_state_s"] for r in saved],
        "gather_routes": [r["gather_routes"] for r in saved],
        "one_save_s": saved[0]["one_save_s"],
        "restore": [{"rank": r["rank"], **r["restore"], "shard_bytes": r["shard_bytes"]}
                    for r in resumed],
        "one_process_restore": {"mode": info.mode.value, "s": info.wall_time_s,
                                "bytes_read": info.restore_stats.bytes_read},
        "serve": [{"rank": r["rank"], **r["serve"]} for r in resumed],
        "serve_held": held, "one_process_serve_mode": one_serve["mode"],
        "flash_launches_by_rank": [r["serve"]["flash_launches"] for r in resumed],
        "peak_gb": {"save": [r["peak_gb"] for r in saved], "resume": [r["peak_gb"] for r in resumed]},
        "setup_s": {"save": [r["setup_s"] for r in saved], "resume": [r["setup_s"] for r in resumed]},
        "world_s": {"save": save_wall, "resume": resume_wall},
        "launches_by_rank": per_rank,
        "launches_by_phase": {
            "save_2_ranks": summed,
            "resume_2_ranks": {"quantize": 0, "dequantize": resume_dq},
            "resume_1_process": one_restore,
            "check_one_process_save": one_save,
            **pipe_out["launches_by_phase"],
        },
        "pipe": {k: pipe_out[k] for k in ("losses", "sp_losses", "one_process_losses", "gaps",
                                          "world_s", "phase_s")},
        "pipe_record": pipe_out,
        "fsdp": fsdp_out,
        "phase_s": time.perf_counter() - t_phase,
    }
    out["launches"] = {k: sum(v[k] for p, v in out["launches_by_phase"].items()
                              if not p.startswith("check_")) for k in fns}
    print(f"multirank smollm-360m ({cfg.num_layers} layers): {MULTIRANK_WORLD} ranks on the one card (gloo, CUDA tensors); "
          f"gloo takes CUDA tensors for: {[k for k, v in out['gloo_cuda'].items() if v == 'ok']}; "
          f"refuses: {{{', '.join(f'{k}: {v[:60]}' for k, v in out['gloo_cuda'].items() if v != 'ok')}}}")
    print(f"  baseline data=1,model=1 losses {[round(v, 4) for v in baseline]}; phase "
          f"{out['phase_s']:.1f} s (worlds {save_wall:.1f} s and {resume_wall:.1f} s)")
    for stage, ranks in (("save", saved), ("resume", resumed)):
        for r in ranks:
            for h in r["hist"]:
                sp = h["split"]
                gbs = sp["all_reduce_bytes"] / sp["all_reduce_s"] / 1e9 if sp["all_reduce_bytes"] else 0.0
                tp = (f" + model-group collectives {sp['tp_s']:.2f} ({sp['tp_bytes'] / 1e9:.3f} GB)"
                      if "tp_s" in sp else "")
                print(f"  {MULTIRANK_MESH[stage]} rank {r['rank']} step {h['step']}: loss "
                      f"{h['loss']:.4f}, wall {h['dt']:.2f} s = gather {sp['gather_s']:.2f} + "
                      f"forward/backward {sp['grad_s']:.2f}{tp} + all-reduce "
                      f"{sp['all_reduce_s']:.2f} ({sp['all_reduce_bytes'] / 1e9:.3f} GB, "
                      f"{gbs:.2f} GB/s) + update {sp['update_s']:.2f}")
    for r in saved:
        gr = r["gather_routes"]
        print(f"  gather of the {gr['bytes'] / 1e9:.3f} GB of fp32 weights, rank {r['rank']}: "
              f"the runtime's (gloo's CUDA all_gather) {[round(v, 3) for v in gr['direct_s']]} s, "
              f"through pinned host buffers {[round(v, 3) for v in gr['staged_s']]} s; bit-equal")
    for r in saved:
        print(f"  save step 2 rank {r['rank']}: {r['save']['bytes'] / 1e9:.3f} GB, "
              f"{r['save']['shards']} shards in {r['save']['s']:.2f} s; launches {r['launches']}; "
              f"peak {r['peak_gb']:.2f} GB")
    print(f"  commit: {chk['files']} files, {chk['bytes'] / 1e9:.3f} GB; {chk['digests']} digests "
          f"equal the one-process save's of the gathered state ({saved[0]['one_save_s']:.2f} s, "
          f"launches {one_save})")
    for r in resumed:
        rs = r["restore"]
        print(f"  resume rank {r['rank']} ({MULTIRANK_MESH['resume']}): {rs['mode']} in {rs['s']:.2f} s, "
              f"{rs['bytes_read'] / 1e9:.3f} GB read for {r['shard_bytes'] / 1e9:.3f} GB of shards; "
              f"bit-equal to the one-process restore's shard; losses "
              f"{[round(h['loss'], 4) for h in r['hist']]}; peak {r['peak_gb']:.2f} GB")
    for r in resumed:
        sv = r["serve"]
        print(f"  serve rank {r['rank']} ({MULTIRANK_MESH['resume']}): {sv['mode']} restore "
              f"{sv['restore_s']:.2f} s ({sv['shard_gb']:.3f} GB of its shards), gather "
              f"{sv['gather_s']:.2f} s, prefill 4x512 {sv['prefill_ms']:.1f} ms ({sv['flash_launches']} "
              f"flash launches {sorted(set(map(tuple, sv['flash_calls'])))} at q_offset "
              f"{sorted(set(sv['flash_offsets']))}), decode {sv['decode_ms']:.2f} ms/token, "
              f"model-group collectives {sv['tp_s']:.2f} s ({sv['tp_bytes'] / 1e9:.3f} GB)")
        sc = sv["seq_cache"]
        rep_b = sum(sc["held_bytes"]["replicated"].values())
        seq_b = sum(sc["held_bytes"]["seq_sharded"].values())
        print(f"  serve rank {r['rank']} with the cache sharded over its length "
              f"(shard_cache_seq, {sc['cache_len']} slots): k/v/slot_pos {seq_b / 1e6:.3f} MB "
              f"held against {rep_b / 1e6:.3f} MB replicated; fp32 tokens equal the "
              f"replicated cache's; bf16 tokens equal at {sc['bf16_equal_steps']} of "
              f"{SERVE_GEN} steps a row, within {sc['top_gap']:.4f} of its top logit; prefill "
              f"{sc['prefill_ms']:.1f} ms, decode {sc['decode_ms']:.2f} ms/token (replicated "
              f"{sv['decode_ms']:.2f}), model-group collectives {sc['tp_s']:.2f} s "
              f"({sc['tp_bytes'] / 1e9:.3f} GB)")
    print(f"  resume 1 process (data=1,model=1): {info.mode.value} in {info.wall_time_s:.2f} s; "
          f"losses {[round(v, 4) for v in one_losses]}; gaps to the baseline {out['gaps']}")
    return out


def hold_pipe(piped: list[dict], baseline: list[float], one_losses: list[float], info,
              one_restore: dict, world_s: float, phase_s: float) -> dict:
    """The multirank phase's pipe stage held (each failed check raises):
    both resumes RESHARD_STREAM and bit-equal to a one-process restore's
    shard; each rank held and computed only its chunk of the layers; steps
    3-4 (by stages) and 5-6 (by rows) within ``MULTIRANK_TOL`` of the
    baseline, 5-6 also of one process resuming the same step-4 checkpoint;
    the ranks' step-4 save equal to one process's save of the gathered
    state, their quantize and dequantize (the served digest) launches
    summing to its, all vector; no launch while training by rows, no flash
    launch.  Prints the stage and returns its
    record (the ``multirank_pipe`` line)."""
    size = 2
    for r in piped:
        rk = r["rank"]
        for key, step in (("restore", 2), ("sp_restore", 4)):
            check(r[key]["mode"] == "reshard_stream" and r[key]["step"] == step,
                  f"multirank-pipe rank {rk}: {key} {r[key]}")
        check(r["bits_differing"] == 0 and r["sp_bits_differing"] == 0,
              f"multirank-pipe rank {rk}: {r['bits_differing']} / {r['sp_bits_differing']} "
              "elements differ from the one-process restore's shard")
        per = -(-CUT_LAYERS // size)
        lo = min(rk * per, CUT_LAYERS)
        hi = min(lo + per, CUT_LAYERS)
        check(r["chunks"] == {"layers": [lo, hi]} and r["computed"] == [["layers", lo, hi]]
              and all(shape[0] == hi - lo for shape in r["held"].values()),
              f"multirank-pipe rank {rk}: chunks {r['chunks']}, computed {r['computed']}, held "
              f"{sorted(set(sh[0] for sh in r['held'].values()))} layers (want [{lo}, {hi}))")
        check(all("pipe_s" in h["split"] and h["split"]["pipe_bytes"] > 0 for h in r["hist"]),
              f"multirank-pipe rank {rk}: no pipe exchange in the split")
        check(r["sp_run_launches"] == {"quantize": 0, "dequantize": 0},
              f"multirank-pipe rank {rk}: launches while training by rows "
              f"{r['sp_run_launches']}")
        check(r["flash_launches"] == 0 and r["sp_seq_parallel"],
              f"multirank-pipe rank {rk}: {r['flash_launches']} flash launches, rows "
              f"{r['sp_seq_parallel']}")
    losses = [h["loss"] for h in piped[0]["hist"]]
    sp_losses = [h["loss"] for h in piped[0]["sp_hist"]]
    check(all([h["loss"] for h in r["hist"]] == losses and [h["loss"] for h in r["sp_hist"]]
              == sp_losses for r in piped), "multirank-pipe: the ranks report different losses")
    gaps = {"pipe": max(abs(x - y) for x, y in zip(losses, baseline[2:4])),
            "sp": max(abs(x - y) for x, y in zip(sp_losses, baseline[4:6])),
            "sp_one_process": max(abs(x - y) for x, y in zip(sp_losses, one_losses)),
            "one_process": max(abs(x - y) for x, y in zip(one_losses, baseline[4:6]))}
    check(all(map(math.isfinite, losses + sp_losses + one_losses))
          and max(gaps.values()) <= MULTIRANK_TOL,
          f"multirank-pipe: steps 3-4 {losses}, 5-6 {sp_losses} and one process's 5-6 "
          f"{one_losses} against the baseline {baseline}: gaps {gaps}")
    check(info is not None and info.mode.value == "reshard_stream" and info.step == 4,
          f"multirank-pipe: the one-process resume of the step-4 checkpoint: {info}")
    chk = piped[0]["check"]
    check(chk["committed"] and chk["digests_equal"],
          f"multirank-pipe: the ranks' step-4 save is not one process's save of the gathered "
          f"state ({chk})")
    fns = ("quantize", "dequantize")
    summed = {k: sum(r["launches"][k] for r in piped) for k in fns}
    one_save = piped[0]["one_launches"]
    check(summed == one_save and summed["quantize"] > 0,
          f"multirank-pipe: the ranks' save launches {[r['launches'] for r in piped]} do not "
          f"sum to the one-process save's {one_save}")
    vector = all(set(k for k, n in r["launches_by_variant"][f].items() if n) <= {"vector"}
                 for r in piped for f in fns)
    check(vector, f"multirank-pipe: a save launch was not the vector kernel: "
                  f"{[r['launches_by_variant'] for r in piped]}")
    splits = [{"rank": r["rank"], "mesh": mesh, "step": h["step"], "loss": h["loss"],
               "dt": h["dt"], **{k: h["split"].get(k) for k in (
                   "gather_s", "grad_s", "pipe_s", "pipe_bytes", "tp_s", "tp_bytes",
                   "all_reduce_s", "all_reduce_bytes", "update_s")}}
              for r in piped for mesh, hs in ((PIPE_MESH, r["hist"]), (SP_MESH, r["sp_hist"]))
              for h in hs]
    out = {
        "model": f"smollm-360m, full width, {CUT_LAYERS} of 32 layers",
        "meshes": {"pipe": PIPE_MESH, "rows": f"{SP_MESH}, tensor_parallel=False"},
        "losses": losses, "sp_losses": sp_losses, "one_process_losses": one_losses,
        "baseline": baseline, "gaps": gaps, "steps": splits,
        "restore": [{"rank": r["rank"], "pipe": r["restore"], "rows": r["sp_restore"]}
                    for r in piped],
        "one_process_restore": {"mode": info.mode.value, "s": info.wall_time_s},
        "chunks": [r["chunks"] for r in piped],
        "compute_bytes": [r["compute_bytes"] for r in piped],
        "stacked_bytes": [r["stacked_bytes"] for r in piped],
        "peak_gb": [r["peak_gb"] for r in piped],
        "save": [{"rank": r["rank"], **r["save"]} for r in piped], "commit": chk,
        "launches_by_rank": {k: [r["launches"][k] for r in piped] for k in fns},
        "launches_by_phase": {
            "pipe_resume_2_ranks": {k: sum(r["restore_launches"][k] for r in piped) for k in fns},
            "pipe_save_2_ranks": summed,
            "check_pipe_one_process_save": one_save,
            "sp_resume_2_ranks": {k: sum(r["sp_restore_launches"][k] for r in piped)
                                  for k in fns},
            "resume_step4_1_process": one_restore,
        },
        "flash_launches_by_rank": [r["flash_launches"] for r in piped],
        "setup_s": [r["setup_s"] for r in piped],
        "world_s": world_s, "phase_s": phase_s,
    }
    print(f"multirank-pipe smollm-360m ({CUT_LAYERS} layers): 2 ranks resume the data=2 step-2 "
          f"checkpoint under {PIPE_MESH} ({piped[0]['restore']['mode']}), steps 3-4 by stages "
          f"{[round(v, 4) for v in losses]}, then step 4 under {SP_MESH} with TP off "
          f"({piped[0]['sp_restore']['mode']}), steps 5-6 by rows "
          f"{[round(v, 4) for v in sp_losses]}; one process from step 4 "
          f"{[round(v, 4) for v in one_losses]}; baseline {[round(v, 4) for v in baseline]}; "
          f"gaps {gaps}; world {world_s:.1f} s, stage {phase_s:.1f} s")
    for r in piped:
        print(f"  rank {r['rank']}: chunk {r['chunks']}, computed {r['computed']}, compute "
              f"weights {r['compute_bytes'] / 1e9:.3f} GB (stacked {r['stacked_bytes'] / 1e9:.3f} "
              f"GB), peak {r['peak_gb']:.2f} GB; save step 4 {r['save']['bytes'] / 1e9:.3f} GB in "
              f"{r['save']['s']:.2f} s, launches {r['launches']}; restores "
              f"{r['restore']['s']:.2f} s and {r['sp_restore']['s']:.2f} s")
    for st in splits:
        print(f"  {st['mesh']} rank {st['rank']} step {st['step']}: loss {st['loss']:.4f}, wall "
              f"{st['dt']:.2f} s = gather {st['gather_s']:.2f} + forward/backward "
              f"{st['grad_s']:.2f} + pipe {st['pipe_s'] or 0:.3f} "
              f"({(st['pipe_bytes'] or 0) / 1e9:.4f} GB) + model group {st['tp_s'] or 0:.3f} "
              f"({(st['tp_bytes'] or 0) / 1e9:.4f} GB) + all-reduce {st['all_reduce_s']:.2f} + "
              f"update {st['update_s']:.2f}")
    return out


def multirank_tp_rank(torch, dist, rank: int, out_dir: Path, fns: dict, t_start: float) -> dict:
    """One rank of the multirank-tp world (:func:`multirank_rank`'s ``tp``
    stage): gpt3-350m at full width under ``TP_MESH``, bf16 compute, remat
    full, from seed 0: steps 1-2 with each rank saving its own
    ``int8:b256`` shards at step 2, then :func:`rank_serve` of step 2."""
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.train.trainer import Trainer

    cfg = dataclasses.replace(get_config(TP_ARCH), num_layers=TP_LAYERS)
    root = out_dir / "ckpt"
    b, s = MULTIRANK_BATCH
    t = Trainer.create(cfg, ParallelismConfig(), TrainConfig(seed=0), mesh_spec_from_string(TP_MESH),
                       batch_size=b, seq_len=s, ckpt_dir=str(root),
                       policy=CheckpointPolicy(codec=MULTIRANK_CODEC, save_interval=2),
                       group=dist.group.WORLD)
    torch.cuda.reset_peak_memory_stats()
    t_ready = time.perf_counter()
    state = t.init_state()
    reset_launches(fns)
    state, hist = t.run(state, 0, 2)  # the main path: 2 partitioned steps and the save
    launches = launch_counts(fns)
    (res,) = t.save_results
    t.manager.close()
    out = {"rank": rank, "stage": "tp", "device": str(t.device),
           "heads_local": t.lm.tp.heads, "gathered": sorted(t.lm.tp.gathered),
           "seq_parallel": t.lm.tp.sp,
           "hist": [{k: h[k] for k in ("step", "loss", "grad_norm", "dt", "split")} for h in hist],
           "launches": launches,
           "save": {"s": res.wall_time_s, "bytes": res.bytes_written,
                    "shards": res.shards_written, "coded_bytes": res.coded_bytes},
           "setup_s": t_ready - t_start, "train_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del state, t
    torch.cuda.empty_cache()
    out["serve"] = rank_serve(torch, dist, cfg, TP_MESH, root / "step_00000002", "direct",
                              out_dir, "multirank_tp")
    return out


def multirank_tp_phase(torch, bq_ops) -> dict:
    """Tensor-parallel compute on the one card: gpt3-350m at full width (d
    1024, 16:16 heads of 64, d_ff 4096, vocab 51200), ``TP_LAYERS`` of its
    24 layers, 8 x 512 a step, bf16 compute, remat full.  A
    one-process baseline (data=1,model=1, steps 1-2 from seed 0), then 2
    spawned ranks under data=1,model=2 computing by heads (8:8 a rank) for
    steps 1-2, each saving its own ``int8:b256`` shards at step 2, then
    serving step 2 restored weights-only (DIRECT) through the same ranks;
    one process serves the same step (RESHARD_STREAM) for the comparison.
    Returns the phase's measurements."""
    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config
    from repro_torch.core.dist_ckpt import DistCheckpoint
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.train.trainer import Trainer

    cfg = dataclasses.replace(get_config(TP_ARCH), num_layers=TP_LAYERS)
    b, s = MULTIRANK_BATCH
    out_dir = ROOT / "build" / "chip_smoke_multirank_tp"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t_phase = time.perf_counter()
    try:
        base = Trainer.create(cfg, ParallelismConfig(), TrainConfig(seed=0),
                              mesh_spec_from_string("data=1,model=1"), batch_size=b, seq_len=s,
                              device=torch.device("cuda"))
        n_params = sum(math.prod(d.shape) for d in base.lm.registry)
        _, hist = base.run(base.init_state(), 0, 2)
        baseline = [h["loss"] for h in hist]
        base_step_s = [h["dt"] for h in hist]
        del base, hist
        gc.collect()
        torch.cuda.empty_cache()
        ranks, wall = run_multirank_world(torch, "tp", out_dir)
        step2 = out_dir / "ckpt" / "step_00000002"
        codecs = DistCheckpoint.open(step2).manifest.shard_codecs
        coded = {r: sum(1 for k, tag in codecs.items()
                        if tag != "raw" and k.startswith(f"rank_{r:05d}/")) for r in range(2)}
        ranked = torch.load(out_dir / "multirank_tp_serve.pt")
        one = one_process_serve(torch, cfg, step2, ranked["seq"])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    losses = [h["loss"] for h in ranks[0]["hist"]]
    check(all(r["hist"][i]["loss"] == losses[i] for r in ranks for i in range(2)),
          "multirank-tp: the ranks report different losses")
    gap = max(abs(x - y) for x, y in zip(losses, baseline))
    check(all(map(math.isfinite, losses)) and gap <= MULTIRANK_TOL,
          f"multirank-tp: partitioned steps 1-2 {losses} left the baseline {baseline}")
    for r in ranks:
        check(r["heads_local"] and r["gathered"] == [] and r["seq_parallel"],
              f"multirank-tp rank {r['rank']}: heads local {r['heads_local']}, gathered "
              f"{r['gathered']}")
        check(r["launches"]["quantize"] == coded[r["rank"]] > 0,
              f"multirank-tp rank {r['rank']}: {r['launches']} quantize launches for "
              f"{coded[r['rank']]} coded shards of its own")
        sv = r["serve"]
        check(sv["flash_launches"] == cfg.num_layers
              and set(map(tuple, sv["flash_calls"])) == {("bfloat16", 512, 512, True)}
              and set(sv["flash_offsets"]) == {0}
              and set(map(tuple, sv["flash_heads"])) == {(8, 8)},
              f"multirank-tp serve rank {r['rank']}: {sv['flash_launches']} flash launches "
              f"{set(map(tuple, sv['flash_calls']))} heads {set(map(tuple, sv['flash_heads']))}")
    held = hold_serve(torch, "multirank-tp serve", ranked, one)
    out = {"model": f"{TP_ARCH}, full width, {TP_LAYERS} of 24 layers", "params": n_params,
           "world": MULTIRANK_WORLD, "mesh": TP_MESH, "batch": list(MULTIRANK_BATCH),
           "baseline": baseline, "baseline_step_s": base_step_s, "losses": losses, "gap": gap,
           "steps": [{"rank": r["rank"], **h} for r in ranks for h in r["hist"]],
           "save": [{"rank": r["rank"], **r["save"]} for r in ranks],
           "serve": [{"rank": r["rank"], **r["serve"]} for r in ranks],
           "one_process_serve_mode": one["mode"], "held": held,
           "train_peak_gb": [r["train_peak_gb"] for r in ranks],
           "setup_s": [r["setup_s"] for r in ranks], "world_s": wall,
           "launches": {k: sum(r["launches"][k] for r in ranks) for k in ("quantize", "dequantize")},
           "flash_launches_by_rank": [r["serve"]["flash_launches"] for r in ranks],
           "phase_s": time.perf_counter() - t_phase}
    print(f"multirank-tp {TP_ARCH} ({n_params:,} params): {MULTIRANK_WORLD} ranks under {TP_MESH} "
          f"by heads (8:8 a rank), 8 x 512; baseline {[round(v, 4) for v in baseline]} "
          f"({[round(v, 2) for v in base_step_s]} s a step), ranks {[round(v, 4) for v in losses]}, "
          f"gap {gap:.2e}; phase {out['phase_s']:.1f} s (world {wall:.1f} s)")
    for r in ranks:
        for h in r["hist"]:
            sp = h["split"]
            print(f"  {TP_MESH} rank {r['rank']} step {h['step']}: wall {h['dt']:.2f} s = gather "
                  f"{sp['gather_s']:.2f} + forward/backward {sp['grad_s']:.2f} + model-group "
                  f"collectives {sp['tp_s']:.2f} ({sp['tp_bytes'] / 1e9:.3f} GB) + all-reduce "
                  f"{sp['all_reduce_s']:.2f} + update {sp['update_s']:.2f}")
        sv = r["serve"]
        print(f"  rank {r['rank']}: save {r['save']['bytes'] / 1e9:.3f} GB in {r['save']['s']:.2f} s "
              f"({r['launches']}); serve restore {sv['mode']} {sv['restore_s']:.2f} s "
              f"({sv['shard_gb']:.3f} GB of its shards), gather {sv['gather_s']:.2f} s, prefill "
              f"4x512 {sv['prefill_ms']:.1f} ms ({sv['flash_launches']} flash launches at 8:8 heads), "
              f"decode {sv['decode_ms']:.2f} ms/token, model-group collectives {sv['tp_s']:.2f} s "
              f"({sv['tp_bytes'] / 1e9:.3f} GB) in the generate")
    return out


# The multirank-moe stage: mixtral-8x22b at full width, 1 of 56 layers, 2
# ranks under data=1,model=2 (EP: 4 experts a rank, then expert-TP: 8192 of
# each expert's 16384), bf16 moments as the train-moe phase
MOE_MESH = "data=1,model=2"
MOE_JOIN_S = 480            # the stage's world: 2 saves and resumes of 17 GB, a serve
# The multirank-ssm stage: mamba2-130m at full width and depth, 12 of 24 SSM
# heads a rank under data=1,model=2, resumed under data=2,model=1
SSM_MESH = {"save": "data=1,model=2", "resume": "data=2,model=1"}


def bits_sum(torch, t) -> int:
    """The sum of a tensor's 32-bit words (an equality check of two draws)."""
    return int(t.contiguous().view(torch.int32).sum(dtype=torch.int64))


def tokens_digest(tokens) -> str:
    return hashlib.sha256(tokens.cpu().long().numpy().tobytes()).hexdigest()[:16]


def multirank_moe_rank(torch, dist, rank: int, out_dir: Path, fns: dict, t_start: float) -> dict:
    """One rank of the multirank-moe world (:func:`multirank_rank`'s ``moe``
    stage): mixtral-8x22b at full width, 1 layer, bf16 compute and moments,
    from seed 0 under ``MOE_MESH`` with expert parallelism: its init shards'
    and batches' digests, steps 1-2 partitioned (4 experts a rank) with each
    rank's ``int8:b256`` save at step 2; then the same ranks resume step 2
    under expert-TP (RESHARD_STREAM) for steps 3-4 (8192 of each expert's
    16384 a rank); then :func:`rank_serve` of step 2 (DIRECT, EP).  Each
    state has one owner while ``Trainer.run`` steps it."""
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.configs import ParallelismConfig, TrainConfig
    from repro_torch.core.dist_ckpt import DistCheckpoint
    from repro_torch.core.plan import TargetSpec, plan_resume
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.train.trainer import Trainer

    _, cfg = mixtral(1)
    ep = ParallelismConfig(moment_dtype="bfloat16")
    root = out_dir / "ckpt"
    b, s = MULTIRANK_BATCH
    mesh = mesh_spec_from_string(MOE_MESH)

    def trainer(parallel, save_interval):
        return Trainer.create(cfg, parallel, TrainConfig(seed=0), mesh, batch_size=b, seq_len=s,
                              ckpt_dir=str(root), group=dist.group.WORLD,
                              policy=CheckpointPolicy(codec=MULTIRANK_CODEC,
                                                      save_interval=save_interval))

    out: dict = {"rank": rank, "stage": "moe"}
    torch.cuda.reset_peak_memory_stats()
    t = trainer(ep, 2)
    tp = t.lm.tp
    check(tp is not None and tp.moe_mode == "ep" and tp.heads and not tp.gathered,
          f"multirank-moe rank {rank}: not partitioned by experts and heads")
    box = [t.init_state()]
    out["init_bits"] = {n: bits_sum(torch, x) for n, x in flatten_with_paths(box[0].params).items()}
    out["batches"] = [tokens_digest(t.batch(i)["tokens"]) for i in range(4)]
    out["setup_s"] = time.perf_counter() - t_start
    reset_launches(fns)
    with MoeLog(torch) as log:
        state, hist = t.run(box.pop(), 0, 2)  # the main path: 2 partitioned steps and the save
    del state
    out["save_launches"] = launch_counts(fns)
    (res,) = t.save_results
    out["save"] = {"s": res.wall_time_s, "bytes": res.bytes_written, "shards": res.shards_written}
    out["ep"] = {"hist": [{k: h[k] for k in ("step", "loss", "aux", "grad_norm", "dt", "split")}
                          for h in hist], "routes": routes_digest(log),
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    t.manager.close()
    del t, tp
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tgt = trainer(dataclasses.replace(ep, expert_parallel=False), 1000)
    check(tgt.lm.tp.moe_mode == "tp", f"multirank-moe rank {rank}: {tgt.lm.tp.moe_mode}")
    step2 = root / "step_00000002"
    rp = plan_resume(DistCheckpoint.open(step2).manifest, TargetSpec(tgt.plan.mesh,
                                                                     tgt.plan.param_specs))
    reset_launches(fns)
    state, info = tgt.init_or_restore()
    out["restore"] = {"mode": info.mode.value, "step": info.step, "s": info.wall_time_s,
                      "bytes_read": info.restore_stats.bytes_read,
                      "consolidated": sorted(rp.consolidate_params),
                      "launches": launch_counts(fns)}
    box = [state]
    del state
    reset_launches(fns)
    with MoeLog(torch) as log:
        state, hist = tgt.run(box.pop(), 2, 2)  # steps 3-4 under expert-TP; no save
    del state
    out["tp"] = {"hist": [{k: h[k] for k in ("step", "loss", "aux", "grad_norm", "dt", "split")}
                          for h in hist], "routes": routes_digest(log),
                 "launches": launch_counts(fns),
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    tgt.manager.close()
    del tgt
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["serve"] = rank_serve(torch, dist, cfg, MOE_MESH, step2, "direct", out_dir,
                              "multirank_moe", moment_dtype="bfloat16")
    out["serve"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def multirank_moe_phase(torch, bq_ops, baseline: list[float]) -> dict:
    """Partitioned MoE compute on the one card, the paper's Fig. 10 move:
    mixtral-8x22b at full width cut to 1 layer (2,906,720,256 params), 8 x
    512 a step, bf16 compute and moments, remat full; 2 spawned ranks train
    steps 1-2 under data=1,model=2 with expert parallelism (4 of 8 experts
    a rank, attention 24:4 heads of 128 a rank, the vocab split), each
    saving its own ``int8:b256`` shards at step 2, then resume step 2 under
    expert-TP (RESHARD_STREAM, ``moe_expert`` consolidated) for steps 3-4,
    then serve step 2 (DIRECT, one flash launch a rank at 24:4 of 128);
    one process serves the same step after the ranks exit.  The one-process
    losses are the train-moe phase's ``baseline`` (steps 1-4 of the same
    config, seed and batches): this phase shows the ranks' init shards and
    batches equal that run's (its init redrawn here and cut by the 2-rank
    plan).  Returns the phase's measurements."""
    from repro_torch.configs import ParallelismConfig, ShapeSpec
    from repro_torch.core.layout import slice_shard
    from repro_torch.core.patterns import StateKind
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.dist.sharding import make_plan, vocab_multiple
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.models import build_model
    from repro_torch.train.data import batch_for_step

    _, cfg = mixtral(1)
    b, s = MULTIRANK_BATCH
    mesh = mesh_spec_from_string(MOE_MESH)
    par = ParallelismConfig(moment_dtype="bfloat16")
    out_dir = ROOT / "build" / "chip_smoke_multirank_moe"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t_phase = time.perf_counter()
    fns = {"quantize": bq_ops.block_quantize, "dequantize": bq_ops.block_dequantize}
    # the train-moe phase's init (Trainer.init_state: the full draw from the
    # seed on the card) cut by this stage's plan, and its batches
    lm = build_model(cfg, vocab_multiple=vocab_multiple(par, mesh))
    plan = make_plan(cfg, lm.registry, par, mesh)
    full = flatten_with_paths(lm.init(torch.Generator(device="cuda").manual_seed(0)))
    want_bits = [{n: bits_sum(torch, slice_shard(x, plan.param_specs[n].layout_for(
        StateKind.FP32, mesh), r)) for n, x in full.items()} for r in range(MULTIRANK_WORLD)]
    del full
    torch.cuda.empty_cache()
    want_batches = [tokens_digest(torch.as_tensor(batch_for_step(
        cfg, ShapeSpec("train", s, b, "train"), i, seed=0, batch_override=b,
        seq_override=s)["tokens"])) for i in range(4)]
    try:
        ranks, wall = run_multirank_world(torch, "moe", out_dir, join_s=MOE_JOIN_S)
        step2 = out_dir / "ckpt" / "step_00000002"
        ranked = torch.load(out_dir / "multirank_moe_serve.pt")
        one = one_process_serve(torch, cfg, step2, ranked["seq"])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for r in ranks:
        check(r["init_bits"] == want_bits[r["rank"]] and r["batches"] == want_batches,
              f"multirank-moe rank {r['rank']}: init or batches differ from the train-moe phase's")
    losses = [h["loss"] for h in ranks[0]["ep"]["hist"] + ranks[0]["tp"]["hist"]]
    check(all(h["loss"] == x for r in ranks for h, x in zip(r["ep"]["hist"] + r["tp"]["hist"],
                                                          losses)),
          "multirank-moe: the ranks report different losses")
    gap = max(abs(x - y) for x, y in zip(losses, baseline[:4]))
    check(all(map(math.isfinite, losses)) and gap <= MULTIRANK_TOL,
          f"multirank-moe: steps 1-4 {losses} left one process's {baseline[:4]}")
    for key in ("ep", "tp"):
        check(ranks[0][key]["routes"] == ranks[1][key]["routes"],
              f"multirank-moe {key}: the ranks routed apart")
    check(ranks[0]["serve"]["routes"] == ranks[1]["serve"]["routes"],
          "multirank-moe serve: the ranks routed apart")
    for r in ranks:
        rs, sv = r["restore"], r["serve"]
        check(rs["mode"] == "reshard_stream" and rs["step"] == 2
              and "layers.blk.we_gate" in rs["consolidated"],
              f"multirank-moe resume rank {r['rank']}: {rs['mode']}, consolidated "
              f"{rs['consolidated']}")
        check(r["save_launches"]["quantize"] > 0 and rs["launches"]["dequantize"] > 0
              and r["tp"]["launches"] == {"quantize": 0, "dequantize": 0},
              f"multirank-moe rank {r['rank']}: block-quant launches {r['save_launches']}, "
              f"{rs['launches']}, {r['tp']['launches']}")
        check(sv["mode"] == "direct" and sv["flash_launches"] == cfg.num_layers
              and set(map(tuple, sv["flash_heads"])) == {(24, 4)}
              and set(map(tuple, sv["flash_calls"])) == {("bfloat16", 512, 512, True)},
              f"multirank-moe serve rank {r['rank']}: {sv['mode']}, {sv['flash_launches']} flash "
              f"launches at heads {set(map(tuple, sv['flash_heads']))}")
    held = hold_serve(torch, "multirank-moe serve", ranked, one)
    launches = {k: sum(r["save_launches"][k] + r["restore"]["launches"][k] for r in ranks)
                for k in fns}
    out = {"model": "mixtral-8x22b, full width, 1 of 56 layers", "mesh": MOE_MESH,
           "batch": list(MULTIRANK_BATCH), "baseline": baseline[:4], "losses": losses,
           "gap": gap, "init_and_batches_equal_train_moe": True,
           "steps": [{"rank": r["rank"], "mode": key, **h} for r in ranks
                     for key in ("ep", "tp") for h in r[key]["hist"]],
           "save": [{"rank": r["rank"], **r["save"]} for r in ranks],
           "restore": [{"rank": r["rank"], **r["restore"]} for r in ranks],
           "serve": [{"rank": r["rank"], **r["serve"]} for r in ranks],
           "held": held, "one_process_serve_mode": one["mode"],
           "peak_gb": {key: [r[key]["peak_gb"] for r in ranks] for key in ("ep", "tp")}
           | {"serve": [r["serve"]["peak_gb"] for r in ranks]},
           "setup_s": [r["setup_s"] for r in ranks], "world_s": wall,
           "launches": launches,
           "launches_by_rank": {k: [r["save_launches"][k] + r["restore"]["launches"][k]
                                    for r in ranks] for k in fns},
           "flash_launches_by_rank": [r["serve"]["flash_launches"] for r in ranks],
           "phase_s": time.perf_counter() - t_phase}
    print(f"multirank-moe mixtral-8x22b (1 layer, full width): {MULTIRANK_WORLD} ranks under "
          f"{MOE_MESH}, 8 x 512; EP steps 1-2 then expert-TP steps 3-4: "
          f"{[round(v, 4) for v in losses]} against one process's {[round(v, 4) for v in baseline[:4]]} "
          f"(gap {gap:.2e}); init and batches equal train-moe's; phase {out['phase_s']:.1f} s "
          f"(world {wall:.1f} s)")
    for r in ranks:
        for key in ("ep", "tp"):
            for h in r[key]["hist"]:
                sp = h["split"]
                print(f"  {key} rank {r['rank']} step {h['step']}: loss {h['loss']:.4f} aux "
                      f"{h['aux']:.4f}, wall {h['dt']:.2f} s = gather {sp['gather_s']:.2f} + "
                      f"forward/backward {sp['grad_s']:.2f} + model-group collectives "
                      f"{sp['tp_s']:.2f} ({sp['tp_bytes'] / 1e9:.3f} GB) + update "
                      f"{sp['update_s']:.2f}; peak {r[key]['peak_gb']:.2f} GB")
        rs, sv = r["restore"], r["serve"]
        print(f"  rank {r['rank']}: save {r['save']['bytes'] / 1e9:.3f} GB in {r['save']['s']:.2f} "
              f"s ({r['save_launches']}); resume {rs['mode']} {rs['s']:.2f} s "
              f"({rs['bytes_read'] / 1e9:.3f} GB read; consolidated {rs['consolidated']}; "
              f"{rs['launches']}); serve {sv['mode']} restore {sv['restore_s']:.2f} s, prefill "
              f"4x512 {sv['prefill_ms']:.1f} ms ({sv['flash_launches']} flash at 24:4 of 128), "
              f"decode {sv['decode_ms']:.2f} ms/token, model-group collectives {sv['tp_s']:.2f} s "
              f"({sv['tp_bytes'] / 1e9:.3f} GB); serve peak {sv['peak_gb']:.2f} GB")
    return out


def multirank_ssm_rank(torch, dist, rank: int, out_dir: Path, fns: dict, t_start: float) -> dict:
    """One rank of the multirank-ssm world (:func:`multirank_rank`'s ``ssm``
    stage): mamba2-130m at full width and depth, bf16, from seed 0: steps
    1-2 under ``SSM_MESH["save"]`` by SSM heads (12 of 24 a rank) with each
    rank's ``int8:b256`` save at step 2; the same ranks resume step 2 under
    ``SSM_MESH["resume"]`` (RESHARD_STREAM) for steps 3-4; then
    :func:`rank_serve` of step 2 by heads (DIRECT)."""
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.train.trainer import Trainer

    cfg = get_config("mamba2-130m")
    root = out_dir / "ckpt"
    b, s = MULTIRANK_BATCH

    def trainer(stage, save_interval):
        return Trainer.create(cfg, ParallelismConfig(), TrainConfig(seed=0),
                              mesh_spec_from_string(SSM_MESH[stage]), batch_size=b, seq_len=s,
                              ckpt_dir=str(root), group=dist.group.WORLD,
                              policy=CheckpointPolicy(codec=MULTIRANK_CODEC,
                                                      save_interval=save_interval))

    out: dict = {"rank": rank, "stage": "ssm"}
    torch.cuda.reset_peak_memory_stats()
    t = trainer("save", 2)
    check(t.lm.tp is not None and t.lm.tp.ssm_heads
          and sorted(n.split(".")[-1] for n in t.lm.tp.gathered) == ["conv_w"],
          f"multirank-ssm rank {rank}: not by SSM heads (gathered {sorted(t.lm.tp.gathered)})")
    out["setup_s"] = time.perf_counter() - t_start
    reset_launches(fns)
    state, hist = t.run(t.init_state(), 0, 2)  # the main path: 2 steps by heads and the save
    del state
    out["save_launches"] = launch_counts(fns)
    (res,) = t.save_results
    out["save"] = {"s": res.wall_time_s, "bytes": res.bytes_written, "shards": res.shards_written}
    out["hist"] = [{k: h[k] for k in ("step", "loss", "grad_norm", "dt", "split")} for h in hist]
    t.manager.close()
    del t
    torch.cuda.empty_cache()
    tgt = trainer("resume", 1000)
    reset_launches(fns)
    state, info = tgt.init_or_restore()
    out["restore"] = {"mode": info.mode.value, "step": info.step, "s": info.wall_time_s,
                      "bytes_read": info.restore_stats.bytes_read, "launches": launch_counts(fns)}
    state, hist = tgt.run(state, 2, 2)
    out["hist"] += [{k: h[k] for k in ("step", "loss", "grad_norm", "dt", "split")} for h in hist]
    tgt.manager.close()
    del tgt, state
    torch.cuda.empty_cache()
    out["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["serve"] = rank_serve(torch, dist, cfg, SSM_MESH["save"], root / "step_00000002",
                              "direct", out_dir, "multirank_ssm", fp32_prefill=True)
    return out


def multirank_ssm_phase(torch, bq_ops) -> dict:
    """Partitioned Mamba-2 on the one card: mamba2-130m at full width and
    depth (24 layers, 24 SSM heads of 64, state 128), 8 x 512, bf16.  A
    one-process baseline (data=1,model=1, steps 1-4 from seed 0); 2 spawned
    ranks train steps 1-2 under data=1,model=2 by heads (12 a rank; the
    conv's even channel split out of line with x/B/C), each saving its own
    ``int8:b256`` shards at step 2, resume step 2 under data=2,model=1
    (RESHARD_STREAM) for steps 3-4, and serve step 2 by heads (DIRECT: 24
    SSD launches a rank at H = 12).  One process serves the same step
    through the SSD kernel (H = 24): the bf16 serve is held to it, which
    isolates the partitioning), within the larger of ``SERVE_LOGIT_TOL``
    and twice that process's own bf16 error e (its bf16 prefill logits
    against its fp32 ones): 24 Mamba-2 layers in bf16 sit ~0.2 from fp32 in
    one process already (0.246 on the CPU at init), so no bf16 path,
    partitioned or not, meets 0.1 against another, and two paths each
    within e of fp32 lie within 2e of each other; and an fp32 prefill of the ranks (the
    fp32 kernel at H = 12) is held within ``SERVE_FP32_TOL`` of one
    process's through ``ssd_chunked``, which bounds what partitioning
    adds.  The gap to one process's bf16 ``ssd_chunked`` is reported beside
    them.  Returns the phase's measurements."""
    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.train.trainer import Trainer

    cfg = get_config("mamba2-130m")
    b, s = MULTIRANK_BATCH
    nh = cfg.ssm.n_heads(cfg.d_model)
    out_dir = ROOT / "build" / "chip_smoke_multirank_ssm"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t_phase = time.perf_counter()
    fns = {"quantize": bq_ops.block_quantize, "dequantize": bq_ops.block_dequantize}
    try:
        base = Trainer.create(cfg, ParallelismConfig(), TrainConfig(seed=0),
                              mesh_spec_from_string("data=1,model=1"), batch_size=b, seq_len=s,
                              device=torch.device("cuda"))
        _, hist = base.run(base.init_state(), 0, 4)
        baseline = [h["loss"] for h in hist]
        del base, hist
        gc.collect()
        torch.cuda.empty_cache()
        ranks, wall = run_multirank_world(torch, "ssm", out_dir)
        step2 = out_dir / "ckpt" / "step_00000002"
        ranked = torch.load(out_dir / "multirank_ssm_serve.pt")
        one = one_process_serve(torch, cfg, step2, ranked["seq"], plain=False, fp32_prefill=True)
        one_plain = one_process_serve(torch, cfg, step2, ranked["seq"])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    losses = [h["loss"] for h in ranks[0]["hist"]]
    check(all([h["loss"] for h in r["hist"]] == losses for r in ranks),
          "multirank-ssm: the ranks report different losses")
    err32 = (ranked["logits32"] - one["logits32"]).abs().max().item()
    check(err32 <= SERVE_FP32_TOL, f"multirank-ssm: fp32 prefill logits {err32:.2e} from one "
                                   f"process's through ssd_chunked (tolerance {SERVE_FP32_TOL})")
    plain_gap = (ranked["logits"] - one_plain["logits"]).abs().max().item()
    print(f"multirank-ssm serve: fp32 prefill logits (the fp32 kernel at H = {nh // 2} on 2 ranks) "
          f"within {err32:.2e} of one process's through ssd_chunked (tolerance "
          f"{SERVE_FP32_TOL}); bf16 prefill logits {plain_gap:.4f} from one process's through "
          f"bf16 ssd_chunked (reported, not limited)")
    gap = max(abs(x - y) for x, y in zip(losses, baseline))
    check(all(map(math.isfinite, losses)) and gap <= MULTIRANK_TOL,
          f"multirank-ssm: steps 1-4 {losses} left one process's {baseline}")
    for r in ranks:
        rs, sv = r["restore"], r["serve"]
        check(rs["mode"] == "reshard_stream" and rs["step"] == 2,
              f"multirank-ssm resume rank {r['rank']}: {rs}")
        check(r["save_launches"]["quantize"] > 0 and rs["launches"]["dequantize"] > 0,
              f"multirank-ssm rank {r['rank']}: block-quant launches {r['save_launches']}, "
              f"{rs['launches']}")
        check(sv["mode"] == "direct" and sv["ssm_heads_local"] and sv["flash_launches"] == 0
              and sv["ssd_launches"] == cfg.num_layers
              and set(map(tuple, sv["ssd_heads"])) == {("bfloat16", nh // 2)},
              f"multirank-ssm serve rank {r['rank']}: {sv['mode']}, {sv['ssd_launches']} SSD "
              f"launches at {set(map(tuple, sv['ssd_heads']))}")
    own = (one["logits"] - one["logits32"]).abs().max().item()  # one process's bf16 error
    ranked_own = (ranked["logits"] - one["logits32"]).abs().max().item()
    tol = max(SERVE_LOGIT_TOL, 2 * own)
    print(f"multirank-ssm serve: bf16 prefill logits from one process's fp32 ones: one "
          f"process's {own:.4f}, the ranks' {ranked_own:.4f}; the bf16 limit {tol:.4f}")
    held = hold_serve(torch, "multirank-ssm serve", ranked, one, tol=tol)
    launches = {k: sum(r["save_launches"][k] + r["restore"]["launches"][k] for r in ranks)
                for k in fns}
    out = {"model": "mamba2-130m, full width and depth", "meshes": SSM_MESH,
           "batch": list(MULTIRANK_BATCH), "baseline": baseline, "losses": losses, "gap": gap,
           "fp32_prefill_max_abs_err": err32, "fp32_tolerance": SERVE_FP32_TOL,
           "bf16_gap_to_plain_ssd": plain_gap, "one_process_bf16_error": own,
           "ranks_bf16_error": ranked_own,
           "steps": [{"rank": r["rank"], **h} for r in ranks for h in r["hist"]],
           "save": [{"rank": r["rank"], **r["save"]} for r in ranks],
           "restore": [{"rank": r["rank"], **r["restore"]} for r in ranks],
           "serve": [{"rank": r["rank"], **r["serve"]} for r in ranks],
           "held": held, "one_process_serve_mode": one["mode"],
           "train_peak_gb": [r["train_peak_gb"] for r in ranks],
           "setup_s": [r["setup_s"] for r in ranks], "world_s": wall, "launches": launches,
           "ssd_launches_by_rank": [r["serve"]["ssd_launches"] for r in ranks],
           "phase_s": time.perf_counter() - t_phase}
    print(f"multirank-ssm mamba2-130m: {MULTIRANK_WORLD} ranks, steps 1-2 under "
          f"{SSM_MESH['save']} by SSM heads ({nh // 2} of {nh} a rank), 3-4 under "
          f"{SSM_MESH['resume']}: {[round(v, 4) for v in losses]} against one process's "
          f"{[round(v, 4) for v in baseline]} (gap {gap:.2e}); phase {out['phase_s']:.1f} s "
          f"(world {wall:.1f} s)")
    for r in ranks:
        for h in r["hist"]:
            sp = h["split"]
            tp = (f" + model-group collectives {sp['tp_s']:.2f} ({sp['tp_bytes'] / 1e9:.3f} GB)"
                  if "tp_s" in sp else "")
            print(f"  rank {r['rank']} step {h['step']}: loss {h['loss']:.4f}, wall {h['dt']:.2f} s "
                  f"= gather {sp['gather_s']:.2f} + forward/backward {sp['grad_s']:.2f}{tp} + "
                  f"all-reduce {sp['all_reduce_s']:.2f} + update {sp['update_s']:.2f}")
        rs, sv = r["restore"], r["serve"]
        print(f"  rank {r['rank']}: save {r['save']['bytes'] / 1e9:.3f} GB in {r['save']['s']:.2f} "
              f"s ({r['save_launches']}); resume {rs['mode']} {rs['s']:.2f} s ({rs['launches']}); "
              f"serve {sv['mode']} prefill 4x512 {sv['prefill_ms']:.1f} ms ({sv['ssd_launches']} "
              f"SSD launches at H = {nh // 2}), decode {sv['decode_ms']:.2f} ms/token, "
              f"model-group collectives {sv['tp_s']:.2f} s ({sv['tp_bytes'] / 1e9:.3f} GB); "
              f"train peak {r['train_peak_gb']:.2f} GB")
    return out


def host_available_gb() -> float:
    """MemAvailable of this host (``/proc/meminfo``), in GB."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def multirank_hot_rank(torch, dist, rank: int, out_dir: Path, fns: dict, t_start: float) -> dict:
    """One rank of the multirank-hot stage: full smollm-360m under
    data=2,model=1 through ``Trainer.create(..., group=WORLD)`` with
    ``CheckpointPolicy(codec="int8:b256", hot_interval=2, disk_interval=2,
    hot_replication=1, save_mode="delta", full_interval=2)`` and a
    ``PublicationRegistry`` on rank 0.  Steps 1-2 (the capture of 2 drained
    full), then steps 3-4 (the capture of 4 drained as a delta on 2); after
    each, rank 0's ``FleetReplica`` (data=1,model=1, in its process) syncs
    the publication, and rank 0 persists a one-process capture of the
    gathered state the same way for the digest tables.  Then HOT_RESHARD of
    step 4 under data=1,model=2 on both ranks, and rank 1's process exits:
    rank 0 destroys the group and recovers alone under the mesh
    ``rebuild_on`` proposes, from its own memory, and takes one step.
    Returns the rank's record."""
    import repro_torch.core.dist_ckpt as dist_ckpt
    import repro_torch.obs as obs
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.ckpt.saver import snapshot_state
    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config
    from repro_torch.core.layout import slice_shard
    from repro_torch.core.patterns import StateKind
    from repro_torch.core.pytree import flatten_with_paths, unflatten_from_paths
    from repro_torch.dist.sharding import make_plan, vocab_multiple
    from repro_torch.elastic import ElasticEvent, hot_recover, rebuild_on
    from repro_torch.hot import HotTier, persist_snapshot
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.launch.serve import serving_parallelism
    from repro_torch.models import build_model
    from repro_torch.models import decode as D
    from repro_torch.serve import FleetReplica, PublicationRegistry
    from repro_torch.train.trainer import Trainer, gather_state

    dev = torch.device("cuda")
    world = dist.group.WORLD
    cfg, tcfg, parallel = dataclasses.replace(get_config("smollm-360m"), num_layers=CUT_LAYERS), TrainConfig(seed=0), ParallelismConfig()
    b, s = MULTIRANK_BATCH
    root = out_dir / "hot"
    flash = {"flash_attention": fa_ops.flash_attention}
    reg = PublicationRegistry(name="multirank-hot") if rank == 0 else None
    policy = CheckpointPolicy(codec=MULTIRANK_CODEC, hot_interval=2, disk_interval=2,
                              hot_replication=1, save_mode="delta", full_interval=2,
                              hot_max_snapshots=HOT_RING, hot_max_bytes=1 << 40, registry=reg)
    t = Trainer.create(cfg, parallel, tcfg, mesh_spec_from_string(HOT_MESH), batch_size=b,
                       seq_len=s, ckpt_dir=str(root / "ck"), policy=policy, device=dev,
                       group=world)
    mgr = t.manager
    out: dict = {"rank": rank, "stage": "hot", "device": str(t.device),
                 "host_available_gb": {"start": host_available_gb()},
                 "publishes": mgr.registry is not None}
    fields = (("params", StateKind.FP32), ("exp_avg", StateKind.EXP_AVG),
              ("exp_avg_sq", StateKind.EXP_AVG_SQ))
    replica = lm11 = None
    if rank == 0:  # the fleet's replica, in rank 0's process
        mesh11 = mesh_spec_from_string("data=1,model=1")
        spar = serving_parallelism(mesh11)
        lm11 = build_model(cfg, vocab_multiple=vocab_multiple(spar, mesh11),
                           compute_dtype=torch.bfloat16)
        replica = FleetReplica("hot-r0", reg, make_plan(cfg, lm11.registry, spar, mesh11), dev)

    def logical(t_, spec):
        return t_[tuple(slice(0, n) for n in spec.logical_shape)]

    def bits_differing(got: dict, want: dict, specs) -> int:
        n = 0
        for name, g in got.items():
            a, w = logical(g, specs[name]), logical(want[name], specs[name])
            n += a.numel() if a.shape != w.shape else int(
                (a.contiguous().view(torch.uint8) != w.contiguous().view(torch.uint8)).sum())
        return n

    def one_process_drain(full, step: int, base) -> dict:
        """Rank 0: a one-process capture of the gathered state persisted
        as the group's drain was, and its tables against the group's."""
        tier = HotTier(replication=1, max_snapshots=1, max_bytes=1 << 40, engine=mgr.engine)
        t0 = time.perf_counter()
        hs, st = tier.capture(snapshot_state(full), t.plan, step,
                              config_fingerprint=mgr.config_fingerprint, device=dev)
        capture_s = time.perf_counter() - t0
        target = root / "one" / f"step_{step:08d}"
        res = persist_snapshot(hs, target, engine=mgr.engine, codec=mgr.codec,
                               save_mode=None if base is None else "delta",
                               base=None if base is None else dist_ckpt.DistCheckpoint.open(base))
        tier.clear()
        a = dist_ckpt.DistCheckpoint.open(mgr.step_dir(step)).manifest
        c = dist_ckpt.DistCheckpoint.open(target).manifest
        keys = ("shard_digests", "shard_pre_digests", "shard_codecs", "shard_sources",
                "save_mode", "base_step")
        return {"equal": {k: getattr(a, k) == getattr(c, k) for k in keys},
                "digests": len(a.shard_digests), "codecs": dict(a.shard_codecs),
                "stats": dataclasses.asdict(st), "capture_s": capture_s,
                "persist_s": res.wall_time_s, "mode": res.mode}

    t_ready = time.perf_counter()
    state = t.init_state()
    drains, syncs = [], []
    full = None
    tracer = obs.enable()  # the captures' split: span attributes
    for start in (0, 2):
        reset_launches(fns)
        state, hist = t.run(state, start, 2)  # two steps, a capture and its drain
        res = t.save_results[-1]
        drains.append({"step": res.step, "mode": res.mode, "s": res.wall_time_s,
                       "bytes": res.bytes_written, "written": res.shards_written,
                       "inherited": res.shards_inherited, "launches": launch_counts(fns),
                       "hist": [{k: h[k] for k in ("step", "loss", "dt")} for h in hist]})
        out["host_available_gb"][f"after_step_{start + 2}"] = host_available_gb()
        del full
        full = gather_state(state, t.plan, world)
        if rank == 0:
            t0 = time.perf_counter()
            check(replica.sync(), f"multirank-hot: the replica had no publication of step {start + 2}")
            syncs.append({"step": replica.step, "seq": replica.seq, "s": time.perf_counter() - t0,
                          "params_updated": len(replica.last_update)})
            drains[-1]["one_process"] = one_process_drain(
                full, start + 2, None if start == 0 else root / "one" / "step_00000002")
        dist.barrier()
    obs.disable(tracer)
    spans = tracer.span_records()
    saves = {r["span_id"] for r in spans if r["name"] == "manager.save"}
    # each of the manager's captures (not rank 0's one-process checks): its
    # attributes (ReplicaStats, stage, exchange, verify), and its
    # device->host copy, the save.stage span beside it in manager.save
    out["captures"] = [
        {**c["attrs"], "d2h_s": sum(r["dur_us"] for r in spans if r["name"] == "save.stage"
                                    and r["parent_id"] == c["parent_id"]) / 1e6}
        for c in spans if c["name"] == "hot.capture" and c["parent_id"] in saves]
    del spans, saves, tracer
    out["drains"], out["syncs"] = drains, syncs
    specs = t.plan.param_specs
    if rank == 0:  # the replica's weights, then one counted prefill on them
        out["replica_bits_differing"] = bits_differing(replica.flat_params(),
                                                       flatten_with_paths(full.params), specs)
        params_c = lm11.registry.cast(replica.params, torch.bfloat16)
        prompts, _ = serve_prompts(torch, cfg, dev)
        cache = D.init_cache(lm11, prompts.shape[0], prompts.shape[1], device=dev)
        reset_launches(flash)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = D.prefill(lm11, params_c, cache, prompts)
        torch.cuda.synchronize()
        out["replica_prefill"] = {"ms": (time.perf_counter() - t0) * 1e3,
                                  "flash_launches": launch_counts(flash)["flash_attention"],
                                  "finite": bool(torch.isfinite(logits).all()),
                                  "shape": list(logits.shape)}
        del params_c, cache, logits
        torch.cuda.empty_cache()

    opened: list = []
    real_open, real_read = dist_ckpt.DistCheckpoint.open.__func__, dist_ckpt.DistCheckpoint.read_shard

    def spy_open(cls, root_, *a, **kw):
        opened.append(str(root_))
        return real_open(cls, root_, *a, **kw)

    def spy_read(self, *a, **kw):
        opened.append(str(self.root))
        return real_read(self, *a, **kw)

    def spied(fn):
        dist_ckpt.DistCheckpoint.open = classmethod(spy_open)
        dist_ckpt.DistCheckpoint.read_shard = spy_read
        try:
            return fn()
        finally:
            dist_ckpt.DistCheckpoint.open = classmethod(real_open)
            dist_ckpt.DistCheckpoint.read_shard = real_read

    # HOT_RESHARD of step 4 under data=1,model=2 on the live ranks
    mesh12 = mesh_spec_from_string(HOT_RESHARD_MESH)
    plan12 = make_plan(cfg, build_model(cfg, vocab_multiple=vocab_multiple(parallel, mesh12)
                                        ).registry, parallel, mesh12)
    torch.cuda.synchronize()
    dist.barrier()
    reset_launches(fns)  # a hot restore decodes nothing: the fragments are raw host bytes
    t0 = time.perf_counter()
    st12, info = spied(lambda: mgr.restore_latest(dev, target_plan=plan12))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches12 = launch_counts(fns)
    diff = 0
    for field, kind in fields:
        want = flatten_with_paths(getattr(full, field))
        for name, got in flatten_with_paths(getattr(st12, field)).items():
            cut = slice_shard(want[name], plan12.param_specs[name].layout_for(kind, mesh12), rank)
            diff += int((got.contiguous().view(torch.uint8) != cut.contiguous().view(torch.uint8)
                         ).sum()) if got.shape == cut.shape else got.numel()
    rs = info.restore_stats
    out["reshard"] = {"mode": info.mode.value, "step": info.step, "s": wall,
                      "files_opened": len(opened), "bits_differing": diff,
                      "fetched_bytes": rs.fetched_bytes, "sent_bytes": rs.sent_bytes,
                      "fetch_s": rs.fetch_s, "bytes_read": rs.bytes_read,
                      "launches": launches12}
    del st12
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 1:  # this process dies; rank 0 carries on alone
        mgr.close()
        out["setup_s"] = t_ready - t_start
        return out

    dist.destroy_process_group()
    event = ElasticEvent(1, "failure", (1,))
    solo = rebuild_on(event, cfg, parallel, tcfg, batch_size=b, seq_len=s,
                      ckpt_dir=str(root / "solo"), device=dev)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    opened.clear()
    reset_launches(fns)
    with obs.enabled() as tracer:
        t0 = time.perf_counter()
        st, info = spied(lambda: hot_recover(mgr, event, dev, target_plan=solo.plan))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches_rc = launch_counts(fns)
    spans = tracer.span_records()
    split = {name: sum(r["dur_us"] for r in spans if r["name"] == name) / 1e6
             for name in ("restore.plan", "restore.tier", "restore.prefetch",
                          "restore.materialize", "restore.consolidate")}
    diff = sum(bits_differing(flatten_with_paths(getattr(st, f)),
                              flatten_with_paths(getattr(full, f)), specs) for f, _ in fields)
    del full
    torch.cuda.empty_cache()
    out["recover"] = {"mode": info.mode.value, "step": info.step, "s": wall,
                      "files_opened": len(opened), "bits_differing": diff, "spans_s": split,
                      "mesh": dict(solo.mesh.axes), "bytes_read": info.restore_stats.bytes_read,
                      "launches": launches_rc}
    _, hist = solo.run(st, info.step, 1)
    out["recover"]["step_after"] = {k: hist[0][k] for k in ("step", "loss", "dt")}
    mgr.close()
    solo.manager.close()
    out["setup_s"] = t_ready - t_start
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def multirank_hot_phase(torch, bq_ops) -> dict:
    """The hot tier, delta drains and fan-out under a group of 2 ranks on
    the one card (:func:`multirank_hot_rank`).  Checks (each fails the
    smoke): step 2 drained full and step 4 a delta on it that inherits
    nothing (AdamW changes every shard), each drain's digest tables,
    codecs, sources and base those of a one-process capture of the gathered
    state persisted the same way; the ranks' capture statistics summing to
    that capture's, their mirrored bytes the bytes that went over the
    group; each rank's quantize launches a drain the coded shards it owns,
    as many dequantize launches; the replica's syncs full then delta, its
    weights bit-equal to the gathered step-4 state, 32 flash launches in
    its prefill with finite logits; rank 1 no registry; HOT_RESHARD
    bit-equal to ``slice_shard`` of the gathered state with no file opened
    and no block-quant launch on either rank; the lone survivor's recovery
    bit-equal with no file opened and no block-quant launch, and a finite
    loss after it.  Returns the record."""
    fns = {"quantize": bq_ops.block_quantize, "dequantize": bq_ops.block_dequantize}
    out_dir = ROOT / "build" / "chip_smoke_multirank_hot"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t_phase = time.perf_counter()
    try:
        ranks, wall = run_multirank_world(torch, "hot", out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    r0, r1 = ranks
    for r in ranks:
        modes = [(d["step"], d["mode"]) for d in r["drains"]]
        check(modes == [(2, "full"), (4, "delta")], f"multirank-hot rank {r['rank']}: drains {modes}")
        check([c["step"] for c in r["captures"]] == [2, 4],
              f"multirank-hot rank {r['rank']}: captures {[c['step'] for c in r['captures']]}")
    for i, d0 in enumerate(r0["drains"]):
        one = d0["one_process"]
        check(all(one["equal"].values()), f"multirank-hot: drain of step {d0['step']} differs from "
                                          f"the one-process persist: {one['equal']}")
        written = sum(r["drains"][i]["written"] for r in ranks)
        inherited = sum(r["drains"][i]["inherited"] for r in ranks)
        check(written == one["digests"] and inherited == 0,
              f"multirank-hot: step {d0['step']} wrote {written} and inherited {inherited} of "
              f"{one['digests']} shards")
        for r in ranks:
            coded = sum(1 for k in one["codecs"] if k.startswith(f"rank_{r['rank']:05d}/"))
            got = r["drains"][i]["launches"]
            check(got["quantize"] == got["dequantize"] == coded > 0,
                  f"multirank-hot rank {r['rank']} step {d0['step']}: launches {got} for "
                  f"{coded} coded shards of its own")
        for key in ("fragments", "natural_fragments", "stored_bytes", "resident_bytes",
                    "mirrored_bytes"):
            got = sum(r["captures"][i][key] for r in ranks)
            check(got == one["stats"][key], f"multirank-hot: capture of step {d0['step']}: "
                  f"{key} {got} over the ranks, one process {one['stats'][key]}")
        moved = sum(r["captures"][i]["received_bytes"] for r in ranks)
        check(moved == sum(r["captures"][i]["sent_bytes"] for r in ranks)
              == one["stats"]["mirrored_bytes"] > 0,
              f"multirank-hot: step {d0['step']}: {moved} bytes moved, "
              f"{one['stats']['mirrored_bytes']} mirrored")
    check([(x["step"], x["seq"]) for x in r0["syncs"]] == [(2, 1), (4, 2)],
          f"multirank-hot: replica syncs {r0['syncs']}")
    check(r0["publishes"] and not r1["publishes"], "multirank-hot: only rank 0 publishes")
    check(r0["replica_bits_differing"] == 0,
          f"multirank-hot: the replica differs from the gathered state in "
          f"{r0['replica_bits_differing']} elements")
    pf = r0["replica_prefill"]
    check(pf["flash_launches"] == CUT_LAYERS and pf["finite"],
          f"multirank-hot: the replica's prefill: {pf}")
    for r in ranks:
        rs = r["reshard"]
        check((rs["mode"], rs["step"], rs["files_opened"], rs["bits_differing"])
              == ("hot_reshard", 4, 0, 0) and rs["launches"] == dict.fromkeys(fns, 0),
              f"multirank-hot rank {r['rank']}: reshard {rs}")
    rc = r0["recover"]
    check((rc["mode"], rc["step"], rc["files_opened"], rc["bits_differing"])
          == ("hot_reshard", 4, 0, 0) and rc["mesh"] == {"data": 1, "model": 1}
          and rc["launches"] == dict.fromkeys(fns, 0),
          f"multirank-hot: the lone survivor's recovery {rc}")
    check(math.isfinite(rc["step_after"]["loss"]),
          f"multirank-hot: the step after the recovery: {rc['step_after']}")
    launches = {k: sum(d["launches"][k] for r in ranks for d in r["drains"]) for k in fns}
    out = {"model": "smollm-360m, full width and depth", "world": MULTIRANK_WORLD,
           "mesh": HOT_MESH, "batch": list(MULTIRANK_BATCH), "codec": MULTIRANK_CODEC,
           "ring": HOT_RING, "ranks": ranks, "world_s": wall, "launches": launches,
           "launches_by_drain": {f"step_{d['step']}": {k: sum(r["drains"][i]["launches"][k]
                                                              for r in ranks) for k in fns}
                                 for i, d in enumerate(r0["drains"])},
           "flash_launches": pf["flash_launches"], "phase_s": time.perf_counter() - t_phase}
    print(f"multirank-hot smollm-360m: {MULTIRANK_WORLD} ranks under {HOT_MESH} on the one card; "
          f"hot_interval=2, disk_interval=2, int8:b256, delta full_interval=2; world {wall:.1f} s; "
          f"host MemAvailable {[r['host_available_gb'] for r in ranks]} GB")
    for r in ranks:
        for c in r["captures"]:
            gbs = c["received_bytes"] / c["exchange_s"] / 1e9 if c["exchange_s"] else 0.0
            print(f"  rank {r['rank']} capture {c['step']}: device->host {c['d2h_s']:.3f} s, "
                  f"slice and digest {c['stage_s']:.3f} s, mirror exchange {c['exchange_s']:.3f} s "
                  f"({c['received_bytes'] / 1e9:.3f} GB in, {c['sent_bytes'] / 1e9:.3f} GB out, "
                  f"{gbs:.3f} GB/s in), mirror digests {c['verify_s']:.3f} s; resident "
                  f"{c['resident_bytes'] / 1e9:.3f} GB, mirrored {c['mirrored_bytes'] / 1e9:.3f} GB")
        for d in r["drains"]:
            print(f"  rank {r['rank']} drain {d['step']} ({d['mode']}): {d['s']:.3f} s, "
                  f"{d['bytes'] / 1e9:.3f} GB, {d['written']} shards written, {d['inherited']} "
                  f"inherited; launches {d['launches']}; steps "
                  f"{[(h['step'], round(h['loss'], 4), round(h['dt'], 2)) for h in d['hist']]}")
        rs = r["reshard"]
        print(f"  rank {r['rank']} HOT_RESHARD {HOT_RESHARD_MESH}: {rs['s']:.3f} s, "
              f"{rs['fetched_bytes'] / 1e9:.3f} GB fetched, {rs['sent_bytes'] / 1e9:.3f} GB sent "
              f"({rs['fetch_s']:.3f} s), 0 files opened, bit-equal")
    for d in r0["drains"]:
        one = d["one_process"]
        print(f"  step {d['step']}: {one['digests']} digests equal the one-process persist's "
              f"(capture {one['capture_s']:.3f} s, persist {one['persist_s']:.3f} s)")
    for x in r0["syncs"]:
        print(f"  replica sync seq {x['seq']} (step {x['step']}): {x['s']:.3f} s, "
              f"{x['params_updated']} params rebuilt")
    print(f"  replica prefill {SERVE_BATCH[0]}x{SERVE_BATCH[1]}: {pf['ms']:.1f} ms, {pf['flash_launches']} flash launches, "
          f"finite logits; bit-equal to the gathered step-4 weights")
    print(f"  rank 1 exits; rank 0 alone ({rc['mesh']}): {rc['mode']} in {rc['s']:.3f} s "
          f"(spans {', '.join(f'{k} {v:.3f} s' for k, v in rc['spans_s'].items())}), "
          f"{rc['bytes_read'] / 1e9:.3f} GB served from its memory, 0 files opened, bit-equal; "
          f"step {rc['step_after']['step']} loss {rc['step_after']['loss']:.4f}")
    return out


def multirank_survivors_rank(torch, dist, rank: int, out_dir: Path, fns: dict,
                             t_start: float) -> dict:
    """One rank of the multirank-survivors stage: smollm-360m at full width
    and ``CUT_LAYERS`` layers under data=4,model=1 through
    ``Trainer.create(..., group=WORLD)`` with ``CheckpointPolicy(codec=
    "int8:b256", hot_interval=1, hot_replication=1)`` (nothing drained to
    disk): steps 1-2, each captured.  Then the ranks of ``SURVIVORS_FAILED``
    exit, and ranks 0 and 2 destroy the default group, re-form one of 2
    (``reform_group``), rebuild a trainer on the mesh ``propose_mesh`` gives
    them with the card's budget (``rebuild_on(..., group=)``) and recover
    through ``hot_recover(..., group=)`` with a spy on checkpoint opens and
    the block-quant counts; their shards against ``slice_shard`` of the
    gathered step-2 state; one step; one ``int8:b256`` save by the new
    group (block=True), and the new rank 0's one-process save of the
    gathered state for the digests.  Returns the rank's record."""
    import repro_torch.core.dist_ckpt as dist_ckpt
    import repro_torch.obs as obs
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.ckpt.saver import snapshot_state, write_distributed
    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config
    from repro_torch.core.layout import slice_shard
    from repro_torch.core.patterns import StateKind
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.elastic import ElasticEvent, hot_recover, rebuild_on, reform_group
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.train.trainer import Trainer, gather_state

    dev = torch.device("cuda")
    world = dist.group.WORLD
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=CUT_LAYERS)
    tcfg, parallel = TrainConfig(seed=0), ParallelismConfig()
    b, s = MULTIRANK_BATCH
    root = out_dir / "survivors"
    policy = CheckpointPolicy(codec=MULTIRANK_CODEC, hot_interval=1, disk_interval=1000,
                              hot_replication=1, hot_max_snapshots=HOT_RING,
                              hot_max_bytes=1 << 40)
    t = Trainer.create(cfg, parallel, tcfg, mesh_spec_from_string(SURVIVORS_MESH), batch_size=b,
                       seq_len=s, ckpt_dir=str(root / "old"), policy=policy, device=dev,
                       group=world)
    fields = (("params", StateKind.FP32), ("exp_avg", StateKind.EXP_AVG),
              ("exp_avg_sq", StateKind.EXP_AVG_SQ))
    out: dict = {"rank": rank, "stage": "survivors", "device": str(t.device)}
    t_ready = time.perf_counter()
    state, hist = t.run(t.init_state(), 0, 2)  # captures 1 and 2
    out["hist"] = [{k: h[k] for k in ("step", "loss", "dt")} for h in hist]
    full = gather_state(state, t.plan, world)
    del state
    torch.cuda.synchronize()
    dist.barrier()
    out["setup_s"] = t_ready - t_start
    if rank in SURVIVORS_FAILED:  # this process dies
        t.manager.close()
        out["exited"] = True
        return out

    event = ElasticEvent(SURVIVORS_WORLD - len(SURVIVORS_FAILED), "failure", SURVIVORS_FAILED)
    t0 = time.perf_counter()
    group = reform_group(event, rank, SURVIVORS_WORLD, out_dir / "rendezvous",
                         timeout=MULTIRANK_JOIN_S)
    out["reform_s"] = time.perf_counter() - t0
    new_rank = dist.get_rank(group)
    t0 = time.perf_counter()
    new = rebuild_on(event, cfg, parallel, tcfg, batch_size=b, seq_len=s,
                     ckpt_dir=str(root / "new"), device=dev, group=group,
                     policy=CheckpointPolicy(codec=MULTIRANK_CODEC, save_interval=1000,
                                             async_save=False))
    out["rebuild_s"] = time.perf_counter() - t0
    check(new is not None, f"multirank-survivors rank {rank}: a spare among 2 survivors")
    opened: list = []
    real_open, real_read = dist_ckpt.DistCheckpoint.open.__func__, dist_ckpt.DistCheckpoint.read_shard

    def spy_open(cls, root_, *a, **kw):
        opened.append(str(root_))
        return real_open(cls, root_, *a, **kw)

    def spy_read(self, *a, **kw):
        opened.append(str(self.root))
        return real_read(self, *a, **kw)

    dist_ckpt.DistCheckpoint.open = classmethod(spy_open)
    dist_ckpt.DistCheckpoint.read_shard = spy_read
    reset_launches(fns)
    try:
        with obs.enabled() as tracer:
            t0 = time.perf_counter()
            st, info = hot_recover(t.manager, event, dev, target_plan=new.plan, group=group)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        dist_ckpt.DistCheckpoint.open = classmethod(real_open)
        dist_ckpt.DistCheckpoint.read_shard = real_read
    spans = tracer.span_records()
    split = {name: sum(r["dur_us"] for r in spans if r["name"] == name) / 1e6
             for name in ("restore.plan", "restore.tier", "restore.prefetch",
                          "restore.materialize", "restore.consolidate")}
    diff = 0
    mesh = new.plan.mesh
    for field, kind in fields:
        want = flatten_with_paths(getattr(full, field))
        for name, got in flatten_with_paths(getattr(st, field)).items():
            cut = slice_shard(want[name], new.plan.param_specs[name].layout_for(kind, mesh),
                              new_rank)
            diff += int((got.contiguous().view(torch.uint8) != cut.contiguous().view(torch.uint8)
                         ).sum()) if got.shape == cut.shape else got.numel()
    del full, want, cut
    torch.cuda.empty_cache()
    rs = info.restore_stats
    out["recover"] = {"mode": info.mode.value, "step": info.step, "s": wall,
                      "files_opened": len(opened), "bits_differing": diff, "spans_s": split,
                      "mesh": dict(mesh.axes), "new_rank": new_rank,
                      "fetched_bytes": rs.fetched_bytes, "sent_bytes": rs.sent_bytes,
                      "fetch_s": rs.fetch_s, "bytes_read": rs.bytes_read,
                      "launches": launch_counts(fns)}
    st, hist = new.run(st, info.step, 1)
    out["step_after"] = {k: hist[0][k] for k in ("step", "loss", "dt")}
    out["step_after"]["split"] = dict(hist[0]["split"])
    reset_launches(fns)
    t0 = time.perf_counter()
    new.manager.save(st, 3, block=True)
    out["save"] = {"s": time.perf_counter() - t0, "launches": launch_counts(fns)}
    full3 = gather_state(st, new.plan, new.ranks.group)
    del st
    step3 = new.manager.step_dir(3)
    if new_rank == 0:  # the one-process save of the gathered state: the digests to match
        one = root / "one"
        write_distributed(snapshot_state(full3, new.manager.codec), new.plan, 3, one,
                          codec=new.manager.codec,
                          config_fingerprint=new.manager.config_fingerprint)
        a, c = dist_ckpt.DistCheckpoint.open(step3), dist_ckpt.DistCheckpoint.open(one)
        out["check"] = {
            "committed": a.is_committed, "digests": len(a.manifest.shard_digests),
            "digests_equal": a.manifest.shard_digests == c.manifest.shard_digests,
            "codecs_equal": a.manifest.shard_codecs == c.manifest.shard_codecs,
            "codecs": dict(a.manifest.shard_codecs),
            "bytes": sum(p.stat().st_size for p in step3.rglob("*.npy")),
        }
        shutil.rmtree(one)
    del full3
    dist.barrier(group=new.ranks.group)
    t.manager.close()
    new.manager.close()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def multirank_survivors_phase(torch, bq_ops, baseline: list[float]) -> dict:
    """Survivors of a rank loss re-form a group and recover from memory, on
    the one card (:func:`multirank_survivors_rank`): 4 ranks under
    data=4,model=1, ranks 1 and 3 exit after step 2.  Checks (each fails the
    smoke): the survivors' re-formed group ranks 0 and 1 (old ranks 0 and
    2) under data=2,model=1; HOT_RESHARD of step 2 with no checkpoint file
    opened and no block-quant launch, each survivor's shards bit-equal to
    ``slice_shard`` of the gathered step-2 state; step 3's loss within
    ``MULTIRANK_TOL`` of the one-process baseline's; the new group's coded
    save of step 3 committed, each rank's quantize launches the coded
    shards it owns, and its digests and codecs the one-process save's of
    the gathered state.  Returns the record."""
    fns = {"quantize": bq_ops.block_quantize, "dequantize": bq_ops.block_dequantize}
    out_dir = ROOT / "build" / "chip_smoke_multirank_survivors"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t_phase = time.perf_counter()
    try:
        ranks, wall = run_multirank_world(torch, "survivors", out_dir, world=SURVIVORS_WORLD)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    losses = [h["loss"] for h in ranks[0]["hist"]]
    gap = max(abs(x - y) for x, y in zip(losses, baseline[:2]))
    check(all([h["loss"] for h in r["hist"]] == losses for r in ranks) and gap <= MULTIRANK_TOL,
          f"multirank-survivors: steps 1-2 {losses} left the baseline {baseline[:2]}")
    dead = [r["rank"] for r in ranks if r.get("exited")]
    check(dead == list(SURVIVORS_FAILED), f"multirank-survivors: exited {dead}")
    alive = [r for r in ranks if not r.get("exited")]
    check([r["recover"]["new_rank"] for r in alive] == [0, 1],
          f"multirank-survivors: new ranks {[r['recover']['new_rank'] for r in alive]}")
    chk = alive[0]["check"]
    for r in alive:
        rc = r["recover"]
        check((rc["mode"], rc["step"], rc["files_opened"], rc["bits_differing"])
              == ("hot_reshard", 2, 0, 0) and rc["mesh"] == {"data": 2, "model": 1}
              and rc["launches"] == dict.fromkeys(fns, 0),
              f"multirank-survivors rank {r['rank']}: recovery {rc}")
        after = r["step_after"]
        check(after["step"] == 3 and abs(after["loss"] - baseline[2]) <= MULTIRANK_TOL,
              f"multirank-survivors rank {r['rank']}: step 3 loss {after['loss']} against the "
              f"baseline's {baseline[2]}")
        coded = sum(1 for k in chk["codecs"]
                    if k.startswith(f"rank_{rc['new_rank']:05d}/"))
        got = r["save"]["launches"]
        check(got["quantize"] == coded > 0,
              f"multirank-survivors rank {r['rank']}: save launches {got} for {coded} coded "
              "shards of its own")
    check(chk["committed"] and chk["digests_equal"] and chk["codecs_equal"],
          f"multirank-survivors: the new group's save is not the one-process save of the "
          f"gathered state ({ {k: v for k, v in chk.items() if k != 'codecs'} })")
    moved = sum(r["recover"]["fetched_bytes"] for r in alive)  # 0: each holds its buddy's
    check(moved == sum(r["recover"]["sent_bytes"] for r in alive),
          f"multirank-survivors: {moved} bytes fetched, "
          f"{sum(r['recover']['sent_bytes'] for r in alive)} sent")
    launches = {k: sum(r["save"]["launches"][k] for r in alive) for k in fns}
    out = {"model": f"smollm-360m, full width, {CUT_LAYERS} of 32 layers",
           "world": SURVIVORS_WORLD, "mesh": SURVIVORS_MESH, "failed": list(SURVIVORS_FAILED),
           "batch": list(MULTIRANK_BATCH), "codec": MULTIRANK_CODEC, "losses": losses,
           "gap": gap, "ranks": ranks, "world_s": wall, "launches": launches,
           "step_after_gap": max(abs(r["step_after"]["loss"] - baseline[2]) for r in alive),
           "commit": {k: v for k, v in chk.items() if k != "codecs"},
           "phase_s": time.perf_counter() - t_phase}
    print(f"multirank-survivors smollm-360m ({CUT_LAYERS} layers): {SURVIVORS_WORLD} ranks under "
          f"{SURVIVORS_MESH}; ranks {list(SURVIVORS_FAILED)} exit after step 2; world "
          f"{wall:.1f} s; steps 1-2 losses {[round(v, 4) for v in losses]} (gap {gap:.4f})")
    for r in alive:
        rc, after = r["recover"], r["step_after"]
        sp = after["split"]
        print(f"  old rank {r['rank']} -> rank {rc['new_rank']} of {rc['mesh']}: re-form "
              f"{r['reform_s']:.3f} s, rebuild {r['rebuild_s']:.3f} s; {rc['mode']} of step "
              f"{rc['step']} in {rc['s']:.3f} s (fetch {rc['fetched_bytes'] / 1e9:.3f} GB in, "
              f"{rc['sent_bytes'] / 1e9:.3f} GB out in {rc['fetch_s']:.3f} s; "
              f"{', '.join(f'{k} {v:.3f} s' for k, v in rc['spans_s'].items())}), 0 files "
              f"opened, bit-equal; step 3 loss {after['loss']:.4f} (baseline {baseline[2]:.4f}) "
              f"in {after['dt']:.2f} s = gather {sp['gather_s']:.2f} + forward/backward "
              f"{sp['grad_s']:.2f} + all-reduce {sp['all_reduce_s']:.2f} + update "
              f"{sp['update_s']:.2f}; coded save of step 3 {r['save']['s']:.2f} s, launches "
              f"{r['save']['launches']}; peak {r['peak_gb']:.2f} GB")
    print(f"  the new group's save: {chk['digests']} digests and codecs equal the one-process "
          f"save's of the gathered state; {chk['bytes'] / 1e9:.3f} GB")
    return out

# The partitioned MLA, cross-attention and encoder-decoder stages: 2 ranks
# under data=1,model=2 on the one card, by heads (deepseek-v2 64 of 128 a
# rank, llama-vision 16:4 of 32:8, whisper 3:3 of 6:6)
CROSS_MESH = "data=1,model=2"
CROSS_JOIN_S = 420          # a world: a restore of half a 21.4 GB checkpoint a rank, a serve
ENCDEC_RESUME_MESH = "data=2,model=1"
ENCDEC_BATCH = (8, 448)     # train-encdec's batch: 8 rows of 448 positions, 1500 frames
ENCDEC_PROMPT = 432         # serve-encdec's prompts
CROSS_STAGES = {            # stage: (arch, layers or None for the config's depth)
    "mla": ("deepseek-v2-236b", 2),
    "vlm": ("llama-3.2-vision-11b", 5),
    "encdec": ("whisper-tiny", None),
}


def cross_stage_cfg(stage: str):
    from repro_torch.configs import get_config

    arch, layers = CROSS_STAGES[stage]
    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def batch_digest(torch, batch: dict) -> str:
    """A digest of a batch's tokens and, where it has them, its source
    embeds (float32 bytes)."""
    h = hashlib.sha256(batch["tokens"].cpu().long().numpy().tobytes())
    if "source_embeds" in batch:
        h.update(batch["source_embeds"].cpu().float().numpy().tobytes())
    return h.hexdigest()[:16]


def multirank_serve_rank(torch, dist, rank: int, out_dir: Path, fns: dict, t_start: float) -> dict:
    """One rank of the multirank-mla or multirank-vlm world
    (:func:`multirank_rank`'s ``mla`` and ``vlm`` stages): :func:`rank_serve`
    of the serve phase's checkpoint (saved under data=2,model=2, restored
    under ``CROSS_MESH``: RESHARD_STREAM) by heads, at the prompt length
    ``spec.json`` names; no block-quant launch (the weights were saved
    uncoded)."""
    spec = json.loads((out_dir / "spec.json").read_text())
    cfg = cross_stage_cfg(spec["stage"])
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fns)
    serve = rank_serve(torch, dist, cfg, CROSS_MESH, Path(spec["step_dir"]), "reshard_stream",
                       out_dir, f"multirank_{spec['stage']}", prompt_len=spec["prompt_len"])
    serve["block_quant_launches"] = launch_counts(fns)
    serve["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return {"rank": rank, "stage": spec["stage"], "setup_s": time.perf_counter() - t_start,
            "serve": serve}


def multirank_encdec_rank(torch, dist, rank: int, out_dir: Path, fns: dict,
                          t_start: float) -> dict:
    """One rank of the multirank-encdec world (:func:`multirank_rank`'s
    ``encdec`` stage): whisper-tiny at full width and depth, bf16 compute,
    fp32 moments, remat full, ``ENCDEC_BATCH`` from seed 0 under
    ``CROSS_MESH`` (3:3 heads of 64 a rank; the encoder's 1500 frames and
    the decoder's 448 positions each seq-sharded): its init shards' and
    batches' digests, steps 1-2 partitioned with each rank's ``int8:b256``
    save at step 2; the same ranks resume step 2 under
    ``ENCDEC_RESUME_MESH`` (RESHARD_STREAM, each rank's state bit-equal to
    its shard of a one-process restore) for steps 3-4; then
    :func:`rank_serve` of step 2 (DIRECT) by heads."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.ckpt.policy import CheckpointPolicy
    from repro_torch.configs import ParallelismConfig, TrainConfig
    from repro_torch.core.layout import slice_shard
    from repro_torch.core.patterns import StateKind
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.train.trainer import Trainer

    cfg = cross_stage_cfg("encdec")
    root = out_dir / "ckpt"
    b, s = ENCDEC_BATCH

    def trainer(mesh_str, save_interval):
        return Trainer.create(cfg, ParallelismConfig(), TrainConfig(seed=0),
                              mesh_spec_from_string(mesh_str), batch_size=b, seq_len=s,
                              ckpt_dir=str(root), group=dist.group.WORLD,
                              policy=CheckpointPolicy(codec=MULTIRANK_CODEC,
                                                      save_interval=save_interval))

    def record(hist):
        return [{k: h[k] for k in ("step", "loss", "grad_norm", "dt", "split")} for h in hist]

    out: dict = {"rank": rank, "stage": "encdec"}
    torch.cuda.reset_peak_memory_stats()
    t = trainer(CROSS_MESH, 2)
    tp = t.lm.tp
    check(tp is not None and tp.heads and not tp.gathered,
          f"multirank-encdec rank {rank}: not partitioned by heads")
    box = [t.init_state()]
    out["init_bits"] = {n: bits_sum(torch, x) for n, x in flatten_with_paths(box[0].params).items()}
    out["batches"] = [batch_digest(torch, t.batch(i)) for i in range(4)]
    out["setup_s"] = time.perf_counter() - t_start
    reset_launches(fns)
    state, hist = t.run(box.pop(), 0, 2)  # the main path: 2 partitioned steps and the save
    del state
    out["save_launches"] = launch_counts(fns)
    (res,) = t.save_results
    out["save"] = {"s": res.wall_time_s, "bytes": res.bytes_written, "shards": res.shards_written}
    out["tp"] = {"hist": record(hist), "sp": tp.sp, "enc_sp": tp.enc_sp,
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    t.manager.close()
    del t, tp
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tgt = trainer(ENCDEC_RESUME_MESH, 1000)
    check(tgt.lm.tp is None, f"multirank-encdec rank {rank}: a model axis of 1 partitions")
    reset_launches(fns)
    state, info = tgt.init_or_restore()
    out["restore"] = {"mode": info.mode.value, "step": info.step, "s": info.wall_time_s,
                      "bytes_read": info.restore_stats.bytes_read,
                      "launches": launch_counts(fns)}
    whole, _ = CheckpointManager(str(root), tgt.plan, policy=CheckpointPolicy(
        save_interval=1000, async_save=False)).restore(tgt.device)
    diff = 0
    for kind, tree, want in ((StateKind.FP32, state.params, whole.params),
                             (StateKind.EXP_AVG, state.exp_avg, whole.exp_avg),
                             (StateKind.EXP_AVG_SQ, state.exp_avg_sq, whole.exp_avg_sq)):
        want = flatten_with_paths(want)
        for n, got in flatten_with_paths(tree).items():
            cut = slice_shard(want[n], tgt.plan.param_specs[n].layout_for(kind, tgt.mesh), rank)
            diff += int((got.view(torch.int32) != cut.view(torch.int32)).sum())
    out["restore"]["bits_differing"] = diff
    del whole, want, cut
    box = [state]
    del state
    reset_launches(fns)
    state, hist = tgt.run(box.pop(), 2, 2)  # steps 3-4 under data parallelism; no save
    del state
    out["dp"] = {"hist": record(hist), "launches": launch_counts(fns),
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    tgt.manager.close()
    del tgt
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(fns)
    out["serve"] = rank_serve(torch, dist, cfg, CROSS_MESH, root / "step_00000002", "direct",
                              out_dir, "multirank_encdec", prompt_len=ENCDEC_PROMPT)
    out["serve"]["block_quant_launches"] = launch_counts(fns)
    out["serve"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def check_rank_serve(label: str, sv: dict, rank: int, expect: str, want_calls: list,
                     want_heads: tuple, want_dims: tuple) -> None:
    """A rank's serve by heads: the restore's mode, exactly the flash
    launches ``want_calls`` (dtype, Sq, Skv, causal) at ``want_heads`` and
    (D, Dv) ``want_dims``, nothing gathered over the model axis."""
    check(sv["mode"] == expect, f"{label} serve rank {rank}: {sv['mode']}, want {expect}")
    check(sv["heads_local"] and not sv["gathered"],
          f"{label} serve rank {rank}: not by heads (gathered {sv['gathered']})")
    calls = [tuple(c) for c in sv["flash_calls"]]
    check(sv["flash_launches"] == len(want_calls) and calls == [tuple(c) for c in want_calls],
          f"{label} serve rank {rank}: {sv['flash_launches']} flash launches {calls}, want "
          f"{want_calls}")
    check(set(map(tuple, sv["flash_heads"])) == {want_heads}
          and set(map(tuple, sv["flash_dims"])) == {("bfloat16", *want_dims)},
          f"{label} serve rank {rank}: flash heads {set(map(tuple, sv['flash_heads']))}, "
          f"(dtype, D, Dv) {set(map(tuple, sv['flash_dims']))}")


def print_rank_serve(label: str, r: dict, sv: dict, prompt: str) -> None:
    print(f"  {label} rank {r['rank']}: serve {sv['mode']} restore {sv['restore_s']:.2f} s "
          f"({sv['shard_gb']:.3f} GB of fp32 shards; consolidated {sv['consolidated']}), "
          f"prefill {prompt} {sv['prefill_ms']:.1f} ms ({sv['flash_launches']} flash launches at "
          f"{sorted(set(map(tuple, sv['flash_heads'])))} heads), decode {sv['decode_ms']:.2f} "
          f"ms/token, model-group collectives {sv['tp_s']:.2f} s "
          f"({sv['tp_bytes'] / 1e9:.3f} GB); peak {sv['peak_gb']:.2f} GB")


def multirank_serve_phase(torch, stage: str, step_dir: Path, prompt_len: int,
                          want_calls: list, want_heads: tuple, want_dims: tuple) -> dict:
    """Partitioned serving by heads on the one card, from a serve phase's
    checkpoint (``step_dir``, saved under data=2,model=2 and kept for this
    stage): 2 spawned ranks under ``CROSS_MESH`` restore it (RESHARD_STREAM,
    each its own shards) and serve 4 x ``prompt_len`` prompts (and the
    serve CLI's source embeds) through :func:`rank_serve`: a counted
    prefill whose flash launches must be ``want_calls`` at ``want_heads``
    and (D, Dv) ``want_dims`` a rank, 16 decode steps; a MoE config's ranks
    route alike; then one process serves the same step through the plain
    attention, fed the ranks' tokens (:func:`hold_serve`).  The parent's
    trees are freed before the ranks start."""
    cfg = cross_stage_cfg(stage)
    label = f"multirank-{stage}"
    out_dir = ROOT / "build" / f"chip_smoke_multirank_{stage}"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    (out_dir / "spec.json").write_text(json.dumps({"stage": stage, "step_dir": str(step_dir),
                                                   "prompt_len": prompt_len}))
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    try:
        ranks, wall = run_multirank_world(torch, stage, out_dir, join_s=CROSS_JOIN_S)
        ranked = torch.load(out_dir / f"multirank_{stage}_serve.pt")
        one = one_process_serve(torch, cfg, step_dir, ranked["seq"], prompt_len=prompt_len)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for r in ranks:
        sv = r["serve"]
        check_rank_serve(label, sv, r["rank"], "reshard_stream", want_calls, want_heads, want_dims)
        check(sv["block_quant_launches"] == {"quantize": 0, "dequantize": 0},
              f"{label} rank {r['rank']}: block-quant launches {sv['block_quant_launches']}")
    if cfg.moe is not None:
        check(ranks[0]["serve"]["routes"] == ranks[1]["serve"]["routes"],
              f"{label} serve: the ranks routed apart")
    held = hold_serve(torch, f"{label} serve", ranked, one)
    out = {"model": f"{cfg.name}, full width, {cfg.num_layers} layers", "mesh": CROSS_MESH,
           "prompts": [SERVE_BATCH[0], prompt_len],
           "serve": [{"rank": r["rank"], **r["serve"]} for r in ranks],
           "held": held, "one_process_serve_mode": one["mode"],
           "setup_s": [r["setup_s"] for r in ranks], "world_s": wall,
           "flash_launches_by_rank": [r["serve"]["flash_launches"] for r in ranks],
           "peak_gb": [r["serve"]["peak_gb"] for r in ranks],
           "phase_s": time.perf_counter() - t_phase}
    print(f"{label} {cfg.name} ({cfg.num_layers} layers, full width): {MULTIRANK_WORLD} ranks "
          f"under {CROSS_MESH} by heads, {want_heads[0]}:{want_heads[1]} a rank; phase "
          f"{out['phase_s']:.1f} s (world {wall:.1f} s)")
    for r in ranks:
        print_rank_serve(label, r, r["serve"], f"{SERVE_BATCH[0]}x{prompt_len}")
    return out


def multirank_encdec_phase(torch, bq_ops, baseline: list[float]) -> dict:
    """The partitioned encoder-decoder on the one card: whisper-tiny at full
    width and depth (3:3 of 6:6 heads of 64 a rank, the vocab 51,865 padded
    to 51,866 and split), ``ENCDEC_BATCH`` a step with 1500 frames; 2
    spawned ranks train steps 1-2 under ``CROSS_MESH`` (the encoder's and
    the decoder's streams each seq-sharded), each saving its own
    ``int8:b256`` shards at step 2, resume step 2 under
    ``ENCDEC_RESUME_MESH`` (RESHARD_STREAM) for steps 3-4, then serve step
    2 (DIRECT) by heads: 4 x ``ENCDEC_PROMPT`` prompts, exactly 12 flash
    launches a rank (4 encoder 1500 x 1500, then 4 x (432 x 432 causal, 432
    x 1500)), 16 decode steps, held against one process (:func:`hold_serve`).
    The one-process losses are train-encdec's ``baseline`` (steps 1-4 of
    the same config, seed and batches): this phase shows the ranks' init
    shards and batches equal that run's (its init redrawn here and cut by
    the 2-rank plan)."""
    from repro_torch.configs import ParallelismConfig, ShapeSpec
    from repro_torch.core.layout import slice_shard
    from repro_torch.core.patterns import StateKind
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.dist.sharding import make_plan, vocab_multiple
    from repro_torch.launch.mesh import mesh_spec_from_string
    from repro_torch.models import build_model
    from repro_torch.train.data import batch_for_step

    cfg = cross_stage_cfg("encdec")
    b, s = ENCDEC_BATCH
    mesh = mesh_spec_from_string(CROSS_MESH)
    par = ParallelismConfig()
    out_dir = ROOT / "build" / "chip_smoke_multirank_encdec"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t_phase = time.perf_counter()
    fns = {"quantize": bq_ops.block_quantize, "dequantize": bq_ops.block_dequantize}
    lm = build_model(cfg, vocab_multiple=vocab_multiple(par, mesh))
    plan = make_plan(cfg, lm.registry, par, mesh)
    full = flatten_with_paths(lm.init(torch.Generator(device="cuda").manual_seed(0)))
    want_bits = [{n: bits_sum(torch, slice_shard(x, plan.param_specs[n].layout_for(
        StateKind.FP32, mesh), r)) for n, x in full.items()} for r in range(MULTIRANK_WORLD)]
    del full, lm
    torch.cuda.empty_cache()
    want_batches = [batch_digest(torch, {k: torch.as_tensor(v) for k, v in batch_for_step(
        cfg, ShapeSpec("train", s, b, "train"), i, seed=0, batch_override=b,
        seq_override=s).items() if k in ("tokens", "source_embeds")}) for i in range(4)]
    try:
        ranks, wall = run_multirank_world(torch, "encdec", out_dir, join_s=CROSS_JOIN_S,
                                          warm_next=0)  # the last world
        ranked = torch.load(out_dir / "multirank_encdec_serve.pt")
        one = one_process_serve(torch, cfg, out_dir / "ckpt" / "step_00000002", ranked["seq"],
                                prompt_len=ENCDEC_PROMPT)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for r in ranks:
        check(r["init_bits"] == want_bits[r["rank"]] and r["batches"] == want_batches,
              f"multirank-encdec rank {r['rank']}: init or batches differ from train-encdec's")
    losses = [h["loss"] for h in ranks[0]["tp"]["hist"] + ranks[0]["dp"]["hist"]]
    check(all(h["loss"] == x for r in ranks for h, x in zip(r["tp"]["hist"] + r["dp"]["hist"],
                                                          losses)),
          "multirank-encdec: the ranks report different losses")
    gap = max(abs(x - y) for x, y in zip(losses, baseline[:4]))
    check(all(map(math.isfinite, losses)) and gap <= MULTIRANK_TOL,
          f"multirank-encdec: steps 1-4 {losses} left one process's {baseline[:4]}")
    want_calls = ([("bfloat16", 1500, 1500, False)] * 4
                  + [("bfloat16", ENCDEC_PROMPT, ENCDEC_PROMPT, True),
                     ("bfloat16", ENCDEC_PROMPT, 1500, False)] * 4)
    for r in ranks:
        rs, sv = r["restore"], r["serve"]
        check(r["tp"]["sp"] and r["tp"]["enc_sp"],
              f"multirank-encdec rank {r['rank']}: streams seq-sharded {r['tp']['sp']}, "
              f"{r['tp']['enc_sp']}")
        check(rs["mode"] == "reshard_stream" and rs["step"] == 2 and rs["bits_differing"] == 0,
              f"multirank-encdec resume rank {r['rank']}: {rs['mode']} step {rs['step']}, "
              f"{rs['bits_differing']} bits differing from a one-process restore")
        check(r["save_launches"]["quantize"] > 0 and rs["launches"]["dequantize"] > 0
              and r["dp"]["launches"] == {"quantize": 0, "dequantize": 0},
              f"multirank-encdec rank {r['rank']}: block-quant launches {r['save_launches']}, "
              f"{rs['launches']}, {r['dp']['launches']}")
        check_rank_serve("multirank-encdec", sv, r["rank"], "direct", want_calls, (3, 3), (64, 64))
        check(sv["block_quant_launches"] == {"quantize": 0, "dequantize": 0},
              f"multirank-encdec serve rank {r['rank']}: {sv['block_quant_launches']}")
    held = hold_serve(torch, "multirank-encdec serve", ranked, one)
    launches = {k: sum(r["save_launches"][k] + r["restore"]["launches"][k] for r in ranks)
                for k in fns}
    out = {"model": "whisper-tiny, full width and depth", "mesh": CROSS_MESH,
           "resume_mesh": ENCDEC_RESUME_MESH, "batch": list(ENCDEC_BATCH),
           "baseline": baseline[:4], "losses": losses, "gap": gap,
           "init_and_batches_equal_train_encdec": True,
           "steps": [{"rank": r["rank"], "mode": key, **h} for r in ranks
                     for key in ("tp", "dp") for h in r[key]["hist"]],
           "save": [{"rank": r["rank"], **r["save"]} for r in ranks],
           "restore": [{"rank": r["rank"], **r["restore"]} for r in ranks],
           "serve": [{"rank": r["rank"], **r["serve"]} for r in ranks],
           "held": held, "one_process_serve_mode": one["mode"],
           "peak_gb": {key: [r[key]["peak_gb"] for r in ranks] for key in ("tp", "dp", "serve")},
           "setup_s": [r["setup_s"] for r in ranks], "world_s": wall, "launches": launches,
           "flash_launches_by_rank": [r["serve"]["flash_launches"] for r in ranks],
           "phase_s": time.perf_counter() - t_phase}
    print(f"multirank-encdec whisper-tiny: {MULTIRANK_WORLD} ranks under {CROSS_MESH} (3:3 heads "
          f"a rank), {b} x {s} with 1500 frames; steps 1-2 partitioned then steps 3-4 under "
          f"{ENCDEC_RESUME_MESH}: {[round(v, 4) for v in losses]} against one process's "
          f"{[round(v, 4) for v in baseline[:4]]} (gap {gap:.2e}); init and batches equal "
          f"train-encdec's; phase {out['phase_s']:.1f} s (world {wall:.1f} s)")
    for r in ranks:
        for key in ("tp", "dp"):
            for h in r[key]["hist"]:
                sp = h["split"]
                tp_part = (f" + model-group collectives {sp['tp_s']:.3f} "
                           f"({sp['tp_bytes'] / 1e9:.3f} GB)" if "tp_s" in sp else "")
                print(f"  {key} rank {r['rank']} step {h['step']}: loss {h['loss']:.4f}, wall "
                      f"{h['dt']:.3f} s = gather {sp['gather_s']:.3f} + forward/backward "
                      f"{sp['grad_s']:.3f}{tp_part} + all-reduce {sp['all_reduce_s']:.3f} + "
                      f"update {sp['update_s']:.3f}; peak {r[key]['peak_gb']:.2f} GB")
        rs = r["restore"]
        print(f"  rank {r['rank']}: save {r['save']['bytes'] / 1e9:.3f} GB in "
              f"{r['save']['s']:.2f} s ({r['save_launches']}); resume {rs['mode']} {rs['s']:.2f} s "
              f"({rs['bytes_read'] / 1e9:.3f} GB read; {rs['launches']}; "
              f"{rs['bits_differing']} bits differing)")
        print_rank_serve("multirank-encdec", r, r["serve"], f"{SERVE_BATCH[0]}x{ENCDEC_PROMPT}")
    return out


# The dry run's production cells (arch, shape, flags), each in a process
# that sees no card, and the seconds they may take
DRYRUN_CELLS = (("smollm-360m", "train_4k", ("--grad-accum", "2")),
                ("smollm-360m", "prefill_32k", ()),
                ("smollm-360m", "decode_32k", ("--shard-cache-seq",)))
DRYRUN_JOIN_S = 300
DRYRUN_PEAK_TOL = (0.10, 256 << 20)  # the larger of 10% and 256 MiB
DRYRUN_FLOPS_TOL = 0.01
MM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
# One rank's cells of the train phase's config, traced on meta in a process
# that sees no card: a train step of 8 x 512 and a 4 x 512 prefill
DRYRUN_ONE_RANK = """
import argparse, dataclasses, json, torch
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.core.layout import MeshSpec
from repro_torch.launch import dryrun
cfg = dataclasses.replace(get_config("smollm-360m"), num_layers={layers})
args = argparse.Namespace(remat="full", grad_accum=1, moment_dtype=None, param_dtype=None,
                          no_fsdp=False, cast_params=False, shard_cache_seq=False)
for kind, rows in (("train", 8), ("prefill", 4)):
    rec = dryrun.run_cell("smollm-360m", kind, False, args,
                          mesh=MeshSpec((("data", 1), ("model", 1))),
                          shape=ShapeSpec(kind, 512, rows, kind), cfg=cfg)
    print(json.dumps(rec))
assert not torch.cuda.is_initialized(), "the dry run initialized CUDA"
"""


def no_card_process(args: list[str]) -> subprocess.Popen:
    """A process of this checkout's Python that sees no card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(SRC))
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def finish_process(proc: subprocess.Popen, label: str, timeout: float) -> list[dict]:
    """Wait for ``proc`` (killed after ``timeout``); the JSON records it
    printed, one a line; it must exit 0."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeError(f"dryrun: {label} still running after {timeout} s: killed")
    check(proc.returncode == 0, f"dryrun: {label} exited {proc.returncode}: {err[-2000:]}")
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def cache_bytes_by_length(arch: str, batch: int, cache_len: int) -> tuple[int, int]:
    """A rank's decode-cache bytes on the production mesh from the cache's
    ``cache_pspecs``: (the rings sharded over their length, not sharded);
    meta tensors only."""
    from repro_torch.configs import ParallelismConfig, get_config
    from repro_torch.core.pytree import flatten_with_paths
    from repro_torch.dist.sharding import cache_pspecs, local_shape, vocab_multiple
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.models.decode import init_cache

    mesh = make_production_mesh()
    out = []
    for seq in (True, False):
        par = ParallelismConfig(shard_cache_seq=seq)
        lm = build_model(get_config(arch), vocab_multiple=vocab_multiple(par, mesh))
        cache = init_cache(lm, batch, cache_len, device="meta")
        flat, specs = flatten_with_paths(cache), flatten_with_paths(cache_pspecs(cache, par, mesh))
        out.append(sum(math.prod(local_shape(tuple(t.shape), specs[n], mesh)) * t.element_size()
                       for n, t in flat.items()))
    return out[0], out[1]


def dryrun_phase(torch, ops) -> dict:
    """The dry run's production cells with no card, and its one-rank
    prediction held against the same step and prefill on the card."""
    procs = [(f"{arch} x {shape}", no_card_process(
        ["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, *flags]))
        for arch, shape, flags in DRYRUN_CELLS]
    procs.append(("one rank", no_card_process(
        ["-c", DRYRUN_ONE_RANK.format(layers=CUT_LAYERS)])))
    t0 = time.perf_counter()
    try:
        real = dryrun_real(torch, ops)
        recs = {label: finish_process(p, label, max(1.0, DRYRUN_JOIN_S - (time.perf_counter() - t0)))
                for label, p in procs}
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"dryrun: the card's total_memory {total} bytes (the dry run's HBM_BYTES)")
    out = {"real": real, "cells": {}, "total_memory": total}
    for (arch, shape, flags), label in zip(DRYRUN_CELLS, recs):
        rec = recs[label][-1]
        check(rec.get("ok") is True and rec["mesh"] == "16x16",
              f"dryrun: {label} {' '.join(flags)}: {rec.get('error', rec)}")
        keep = {k: rec.get(k) for k in ("memory", "roofline", "dominant", "wall_s", "per_device",
                                        "kernels", "roofline_fraction", "op_count")}
        print(f"dryrun {label} {' '.join(flags)}: memory {rec['memory']}; roofline "
              f"{rec['roofline']}; dominant {rec['dominant']}; wall {rec['wall_s']} s "
              "(estimates from datasheet constants)")
        out["cells"][f"{shape}{''.join(' ' + f for f in flags)}"] = keep
    flash = recs["smollm-360m x prefill_32k"][-1]["kernels"]
    check(set(flash) == {"flash_attention_fwd"}
          and flash["flash_attention_fwd"]["launches"] == 32
          and all("heads of (64, 64)" in k for k in flash["flash_attention_fwd"]["shapes"]),
          f"dryrun prefill_32k: the flash stand-ins {flash} are not 32 at (64, 64)")
    sharded, whole = cache_bytes_by_length("smollm-360m", 128, 32_768)
    got = recs["smollm-360m x decode_32k"][-1]["memory"]["cache_bytes_per_device"]
    print(f"dryrun decode_32k --shard-cache-seq: cache {got} bytes a rank; the length-sharded "
          f"specs' {sharded}, the unsharded length's {whole}")
    check(got == sharded < whole, f"dryrun decode_32k: cache {got} bytes a rank, not the "
          f"length-sharded specs' {sharded}")

    train, prefill = recs["one rank"]
    check(train["ok"] and prefill["ok"], f"dryrun one rank: {train}, {prefill}")
    mem = train["memory"]
    predicted = mem["argument_bytes_per_device"] + mem["temp_bytes_per_device"]
    tol = max(DRYRUN_PEAK_TOL[0] * real["peak_bytes"], DRYRUN_PEAK_TOL[1])
    flops = train["per_device"]["dot_flops"]
    stand_ins = prefill["kernels"].get("flash_attention_fwd", {}).get("launches", 0)
    pmem = prefill["memory"]
    out["one_rank"] = {
        "argument_bytes": [mem["argument_bytes_per_device"], real["argument_bytes"]],
        "peak_bytes": [predicted, real["peak_bytes"]],
        "dot_flops": [flops, real["profiler_flops"]],
        "flash_launches": [stand_ins, real["flash_launches"]],
        "prefill_peak_bytes": [pmem["argument_bytes_per_device"] + pmem["temp_bytes_per_device"],
                               real["prefill_peak_bytes"]],
        "train_roofline_s": train["roofline"], "train_dominant": train["dominant"],
        "prefill_roofline_s": prefill["roofline"], "prefill_dominant": prefill["dominant"],
    }
    print(f"dryrun one rank (data=1,model=1, smollm-360m {CUT_LAYERS} layers, 8x512): argument "
          f"bytes predicted {mem['argument_bytes_per_device']}, on the card "
          f"{real['argument_bytes']}; peak predicted {predicted} (arguments + temporaries), on "
          f"the card {real['peak_bytes']} (max_memory_allocated less the memory before the "
          f"state; limit ±{tol:.0f}); dot_flops {flops:.6e}, the profiler's mm-family "
          f"{real['profiler_flops']:.6e} (ops {real['profiler_mm_ops']}); roofline "
          f"{train['roofline']} ({train['dominant']}) "
          f"beside the measured step: wall {real['step_wall_ms']:.2f} ms, device busy "
          f"{real['step_busy_ms']:.2f} ms (profiler on)")
    print(f"dryrun one rank prefill 4x512: flash stand-ins {stand_ins}, real launches "
          f"{real['flash_launches']}; peak predicted {out['one_rank']['prefill_peak_bytes'][0]}, "
          f"on the card {real['prefill_peak_bytes']}; roofline {prefill['roofline']} beside "
          f"the measured prefill: wall {real['prefill_wall_ms']:.2f} ms, device busy "
          f"{real['prefill_busy_ms']:.2f} ms (profiler on)")
    check(mem["argument_bytes_per_device"] == real["argument_bytes"],
          "dryrun: the predicted argument bytes are not the state's and batch's on the card")
    check(abs(predicted - real["peak_bytes"]) <= tol,
          f"dryrun: predicted peak {predicted} vs {real['peak_bytes']} on the card")
    check(abs(flops - real["profiler_flops"]) <= DRYRUN_FLOPS_TOL * real["profiler_flops"],
          f"dryrun: dot_flops {flops} vs the profiler's {real['profiler_flops']}")
    check(stand_ins == real["flash_launches"] == CUT_LAYERS,
          f"dryrun: flash stand-ins {stand_ins} vs {real['flash_launches']} real launches")
    return out


def launched_mm_flops(prof) -> tuple[float, dict]:
    """The profiler's FLOPs over the mm-family ops that launched work on the
    card (a device record, or a kernel launch under it where the device
    record was lost), and how many ops each way.  The profiler also records
    the op that non-reentrant checkpoint's early stop aborts in the
    recompute before it launches anything: its FLOPs were never computed."""

    def launches(e) -> bool:
        return any("Launch" in c.name or launches(c) for c in e.cpu_children)

    total, ops = 0.0, {"device": 0, "launch": 0, "aborted": 0}
    for e in prof.events():
        if e.name not in MM_OPS or not e.flops:
            continue
        way = "device" if e.device_time_total > 0 else "launch" if launches(e) else "aborted"
        ops[way] += 1
        total += e.flops if way != "aborted" else 0
    return total, ops


def dryrun_real(torch, ops) -> dict:
    """The one-rank cells' step and prefill on the card, from fresh random
    weights: the state's bytes, the step's peak and its mm-family FLOPs,
    the prefill's flash launches."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.configs import ParallelismConfig, TrainConfig, get_config
    from repro_torch.core.layout import MeshSpec
    from repro_torch.launch.hlo_analysis import tensors_of
    from repro_torch.models import build_model
    from repro_torch.models import decode as D
    from repro_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=CUT_LAYERS)
    mesh = MeshSpec((("data", 1), ("model", 1)))
    nbytes = lambda tree: sum(t.numel() * t.element_size() for t in tensors_of(tree))  # noqa: E731
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t = Trainer.create(cfg, ParallelismConfig(), TrainConfig(seed=0), mesh, batch_size=8,
                       seq_len=512, device=dev)
    # the dry run's inputs: the host int32 step counter, int32 tokens
    state = dataclasses.replace(t.init_state(), step=torch.zeros((), dtype=torch.int32))
    batch = {"tokens": t.batch(0)["tokens"].int()}
    out = {"argument_bytes": nbytes((state.params, state.exp_avg, state.exp_avg_sq, batch))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    new = t.step_fn(state, batch)
    torch.cuda.synchronize()
    out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    del new
    # one warm-up step whose records are dropped, as device_profile's: a trace
    # that starts cold loses a device record now and then
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], with_flops=True,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        new = t.step_fn(state, batch)
        torch.cuda.synchronize()
        prof.step()
    del new
    out["profiler_flops"], out["profiler_mm_ops"] = launched_mm_flops(prof)
    out["step_wall_ms"], out["step_busy_ms"], _ = device_profile(
        torch, lambda: t.step_fn(state, batch))
    del state, batch, t
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    lm = build_model(cfg)
    params = lm.registry.cast(lm.init(torch.Generator(device=dev).manual_seed(0)), lm.compute_dtype)
    prompts = torch.randint(0, cfg.vocab_size, (4, 512), generator=torch.Generator(device=dev)
                            .manual_seed(1), device=dev, dtype=torch.int32)
    cache = D.init_cache(lm, 4, 512, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n0 = ops.flash_attention.launches
    with torch.inference_mode():
        logits, cache = D.prefill(lm, params, cache, prompts)
    torch.cuda.synchronize()
    out["flash_launches"] = ops.flash_attention.launches - n0
    out["prefill_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    check(bool(torch.isfinite(logits).all()), "dryrun: the real prefill's logits are not finite")
    del logits

    def again():
        with torch.inference_mode():
            D.prefill(lm, params, D.init_cache(lm, 4, 512, device=dev), prompts)

    out["prefill_wall_ms"], out["prefill_busy_ms"], _ = device_profile(torch, again)
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


class PhaseClock:
    """Each phase's wall seconds since the previous mark, printed as the
    phase ends and kept for the ``phase_seconds`` line (the smoke's time
    budget)."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.seconds: dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now
        print(f"phase {name}: {self.seconds[name]:.1f} s (the smoke at {now - self.start:.1f} s)",
              flush=True)


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        raise SmokeError(f"{SRC / 'repro_torch'} is missing: run from a checkout of the repo")
    bytecode_cache()
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("CUDA is not available: this smoke runs on a card, never the CPU")
    sys.path.insert(0, str(SRC))
    try:
        return run(torch)
    finally:
        WARM.close()


def run(torch) -> int:
    """Every phase in turn (``main``: the checks before them, and the warm
    ranks' end after them)."""
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
    clock = PhaseClock()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")

    with ThreadPoolExecutor(1) as pool:
        built = pool.submit(build_all, {"flash_attention": kernel, "block_quant": bq_kernel,
                                        "ssd_scan": ssd_kernel})
        # while the kernels build: each module's bytecode written once,
        # before any rank reads it, then the first world's ranks start up
        warm_imports()
        WARM.fill()
        usage = built.result()
    clock.mark("build")
    check_no_spills(usage["flash_attention"], (
        "fwd_kernel_wgmma<64, 64, 128>", "fwd_kernel_wgmma<128, 128, 128>",
        "fwd_kernel_wgmma<256, 256, 64>", "fwd_kernel_wgmma<192, 128, 128>",
        "fwd_kernel<float, 256, 256>", "fwd_kernel<float, 192, 128>"))
    k = kernel_phase(torch, F, kernel, ops, ref)
    clock.mark("kernel flash_attention")
    bq = block_quant_phase(torch, bq_ops, bq_ref)
    clock.mark("kernel block_quant")
    coll = collectives_phase(torch)
    clock.mark("collectives")
    multi = multirank_phase(torch, bq_ops)
    multi_pipe = multi.pop("pipe_record")
    clock.mark("multirank")
    multi_surv = multirank_survivors_phase(torch, bq_ops, multi["baseline"])
    clock.mark("multirank-survivors")
    multi_tp = multirank_tp_phase(torch, bq_ops)
    clock.mark("multirank-tp")
    multi_hot = multirank_hot_phase(torch, bq_ops)
    clock.mark("multirank-hot")
    multi_ssm = multirank_ssm_phase(torch, bq_ops)
    clock.mark("multirank-ssm")
    ssd = ssd_phase(torch, F, ssd_ops, ssd_ref)
    ssd_jamba = ssd_layout(torch, F, ssd_ops, ssd_ref, (4, 512, 128, 128, 1, 128), 256,
                           "jamba-1.5-large-398b")
    ssd_rank = ssd_layout(torch, F, ssd_ops, ssd_ref, (4, 512, 12, 64, 1, 128), 256,
                          "mamba2-130m rank of model=2")
    clock.mark("kernel ssd_scan")
    counters = {"flash_attention": ops.flash_attention, "ssd_scan": ssd_ops.ssd_scan}
    runs = serve_phase(torch, "smollm-360m", counters,
                       {"flash_attention": CUT_LAYERS, "ssd_scan": 0}, cpu_len=48, via_ucp=True,
                       layers=CUT_LAYERS)
    clock.mark("serve smollm-360m")
    ssm_runs = serve_phase(torch, "mamba2-130m", counters,
                           {"flash_attention": 0, "ssd_scan": 24}, cpu_len=512)
    clock.mark("serve mamba2-130m")
    gemma = gemma_phase(torch, counters)
    clock.mark("gemma3")
    train = train_phase(torch, ops, bq_ops)
    clock.mark("train")
    dry = dryrun_phase(torch, ops)
    clock.mark("dryrun")
    bq_counters = {"quantize": bq_ops.block_quantize, "dequantize": bq_ops.block_dequantize}
    reset_launches(bq_counters)
    hot = hot_phase(torch, bq_ops)
    clock.mark("hot")
    hot_bq = launch_counts(bq_counters)  # the drain's encode and digest, the fall-through's decode
    check(hot_bq == {"quantize": hot["quantize"],
                     "dequantize": hot["dequantize"] + hot["fall_through_dequantize"]},
          f"hot: block-quant launches {hot_bq} outside the counted sub-phases")
    reset_launches(bq_counters)
    fanout = fanout_phase(torch, bq_ops, counters)
    clock.mark("fanout")
    fanout_bq = launch_counts(bq_counters)  # the publisher's saves; the fleet's syncs make none
    check(fanout_bq == {k: sum(v[k] for v in fanout["launches_by_phase"].values())
                        for k in fanout_bq},
          f"fanout: block-quant launches {fanout_bq} outside the counted sub-phases")
    moe_serve = moe_serve_phase(torch, counters, bq_ops, kernel)
    clock.mark("serve-moe")
    moe_train = moe_train_phase(torch, bq_ops, bq_ref, counters)
    clock.mark("train-moe")
    multi_moe = multirank_moe_phase(torch, bq_ops, moe_train["baseline"])
    clock.mark("multirank-moe")
    reset_launches(bq_counters)
    mla = mla_serve_phase(torch, counters, kernel)
    clock.mark("serve-mla")
    mla_bq = launch_counts(bq_counters)  # the phase saves its weights uncoded: none
    check(mla_bq == {"quantize": 0, "dequantize": 0}, f"serve-mla: block-quant launches {mla_bq}")
    # deepseek-v2 by heads from serve-mla's checkpoint: 2 flash launches a rank
    step_dir = mla.pop("step_dir")
    try:
        multi_mla = multirank_serve_phase(torch, "mla", step_dir, 512,
                                          [("bfloat16", 512, 512, True)] * 2, (64, 64), (192, 128))
    finally:
        shutil.rmtree(step_dir.parent, ignore_errors=True)
    clock.mark("multirank-mla")
    reset_launches(bq_counters)
    hybrid = hybrid_serve_phase(torch, counters, kernel)
    clock.mark("serve-hybrid")
    hybrid_bq = launch_counts(bq_counters)  # bf16 weights saved uncoded: none
    check(hybrid_bq == {"quantize": 0, "dequantize": 0},
          f"serve-hybrid: block-quant launches {hybrid_bq}")
    reset_launches(counters)
    train_ssm = ssm_train_phase(torch, bq_ops, bq_ref, counters)
    clock.mark("train-ssm")
    train_ssm_kernels = launch_counts(counters)  # training goes through the plain versions
    # llama-vision: 4 causal self layers, then the gated cross layer at 512 x 1600
    reset_launches(bq_counters)
    vlm_want = [("bfloat16", 512, 512, True)] * 4 + [("bfloat16", 512, 1600, False)]
    vlm = cross_serve_phase(torch, counters, kernel, arch="llama-3.2-vision-11b", layers=5,
                            prompt_len=512, n_params=VLM_PARAMS, label="vlm", want=vlm_want)
    clock.mark("serve-vlm")
    # llama-vision by heads from serve-vlm's checkpoint: 5 flash launches a rank
    step_dir = vlm.pop("step_dir")
    try:
        multi_vlm = multirank_serve_phase(torch, "vlm", step_dir, 512, vlm_want, (16, 4),
                                          (128, 128))
    finally:
        shutil.rmtree(step_dir.parent, ignore_errors=True)
    clock.mark("multirank-vlm")
    # whisper: 4 encoder layers over 1500 frames, then each decoder layer's
    # causal self-attention and its cross-attention to the encoder's output
    encdec = cross_serve_phase(torch, counters, kernel, arch="whisper-tiny", layers=None,
                               prompt_len=432, n_params=WHISPER_PARAMS, label="encdec",
                               want=[("bfloat16", 1500, 1500, False)] * 4
                               + [("bfloat16", 432, 432, True), ("bfloat16", 432, 1500, False)] * 4)
    shutil.rmtree(encdec.pop("step_dir").parent, ignore_errors=True)
    clock.mark("serve-encdec")
    cross_bq = launch_counts(bq_counters)  # both serve phases save their weights uncoded: none
    check(cross_bq == {"quantize": 0, "dequantize": 0},
          f"serve-vlm and serve-encdec: block-quant launches {cross_bq}")
    reset_launches(counters)
    train_encdec = encdec_train_phase(torch, bq_ops, counters)
    clock.mark("train-encdec")
    train_encdec_kernels = launch_counts(counters)
    multi_encdec = multirank_encdec_phase(torch, bq_ops, train_encdec["baseline"])
    clock.mark("multirank-encdec")

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
        "collectives_launches": coll["flash_launches"],
        **{f"qoff_{key}": k["qoff"][key] for key in (
            "ms", "event_ms", "library_ms", "library_backend", "fp32_ms", "plain_ms", "bound_ms",
            "bound_by", "max_abs_err")},
        "qoff_shape": "bf16 B=4 Sq=256 Skv=512 15:5 heads of 64, causal, q_offset 256 "
                      "(smollm-360m's rank 1 of model=2 under sequence parallelism); library: "
                      "scaled_dot_product_attention with causal_lower_right(256, 512)",
        "multirank_launches": multi["flash_launches_by_rank"],
        "multirank_pipe_launches": multi_pipe["flash_launches_by_rank"],
        "multirank_tp_launches": multi_tp["flash_launches_by_rank"],
        "multirank_hot_launches": multi_hot["flash_launches"],
        "multirank_moe_launches": multi_moe["flash_launches_by_rank"],
        "multirank_ssm_launches": multi_ssm["serve"][0]["flash_launches"]
        + multi_ssm["serve"][1]["flash_launches"],
        **{f"mixtral_rank_{key}": k["mixtral_rank"][key] for key in (
            "ms", "event_ms", "library_ms", "fp32_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err")},
        "mixtral_rank_shape": "bf16 B=4 S=512 24:4 heads of 128, causal (mixtral-8x22b: a "
                              "rank's heads at model=2)",
        **{f"{tag}_{key}": k[tag][key] for tag in ("deepseek_rank", "vlm_rank", "whisper_rank")
           for key in ("ms", "event_ms", "library_ms", "fp32_ms", "plain_ms", "bound_ms",
                       "bound_by", "max_abs_err")},
        "deepseek_rank_library_backend": k["deepseek_rank"]["library_backend"],
        "deepseek_rank_shape": "bf16 B=4 S=512 64:64 heads, q and k of 192, v of 128, causal "
                               "(deepseek-v2-236b MLA: a rank's heads at model=2)",
        "vlm_rank_shape": "bf16 B=4 Sq=512 Skv=1600 16:4 heads of 128, no mask "
                          "(llama-3.2-vision-11b's cross layer: a rank's heads at model=2)",
        "whisper_rank_shape": "bf16 B=4 S=1500 3:3 heads of 64, no mask (whisper-tiny's "
                              "encoder: a rank's heads at model=2)",
        "multirank_mla_launches": multi_mla["flash_launches_by_rank"],
        "multirank_vlm_launches": multi_vlm["flash_launches_by_rank"],
        "multirank_encdec_launches": multi_encdec["flash_launches_by_rank"],
        "dryrun_launches": dry["real"]["flash_launches"],
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
        rows[-1]["collectives_launches"] = coll["launches"][which]
        rows[-1]["collectives_launches_by_variant"] = coll["launches_by_variant"][which]
        rows[-1]["multirank_launches"] = multi["launches"][which]
        rows[-1]["multirank_tp_launches"] = multi_tp["launches"][which]
        rows[-1]["multirank_hot_launches"] = multi_hot["launches"][which]
        rows[-1]["multirank_survivors_launches"] = multi_surv["launches"][which]
        rows[-1]["multirank_moe_launches"] = multi_moe["launches"][which]
        rows[-1]["multirank_moe_launches_by_rank"] = multi_moe["launches_by_rank"][which]
        rows[-1]["multirank_ssm_launches"] = multi_ssm["launches"][which]
        rows[-1]["multirank_encdec_launches"] = multi_encdec["launches"][which]
        rows[-1]["multirank_hot_launches_by_drain"] = {
            k: v[which] for k, v in multi_hot["launches_by_drain"].items()}
        rows[-1]["multirank_launches_by_phase"] = {k: v[which]
                                                   for k, v in multi["launches_by_phase"].items()}
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
        "multirank_ssm_launches": multi_ssm["ssd_launches_by_rank"],
        "multirank_moe_launches": sum(r["ssd_launches"] for r in multi_moe["serve"]),
        **{f"mamba2_rank_{key}": ssd_rank[key] for key in (
            "ms", "event_ms", "fp32_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")},
        "mamba2_rank_shape": "bf16 B=4 S=512 H=12 P=64 G=1 N=128 chunk 256 (mamba2-130m: a "
                             "rank's heads at model=2)",
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
    print(json.dumps({"collectives": coll}))
    print(json.dumps({"dryrun": dry}))
    print(json.dumps({"multirank_pipe": multi_pipe}))
    print(json.dumps({"multirank": multi}))
    print(json.dumps({"multirank_tp": multi_tp}))
    print(json.dumps({"multirank_hot": multi_hot}))
    print(json.dumps({"multirank_survivors": multi_surv}))
    print(json.dumps({"multirank_moe": multi_moe}))
    print(json.dumps({"multirank_ssm": multi_ssm}))
    print(json.dumps({"multirank_mla": multi_mla}))
    print(json.dumps({"multirank_vlm": multi_vlm}))
    print(json.dumps({"multirank_encdec": multi_encdec}))
    print(json.dumps({"phase_seconds": clock.seconds,
                      "total_s": time.perf_counter() - clock.start}))
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
