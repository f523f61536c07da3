"""Tensor- and sequence-parallel compute over the model subgroup of a
multi-rank run: every family of the configs (dense, MoE with or without
MLA, SSM, hybrid, vlm and encdec).

The reference installs ``make_sharder`` as ``LM.shard`` and constrains a few
activations (``repro/models/lm.py:430,438,508,542,613,635``); GSPMD then
partitions every product from the weights' and the activations' shardings.
Eager PyTorch has no partitioner, so the port's layer code computes its part
itself, by the same decisions (:func:`~repro_torch.dist.sharding.make_sharder`
of the logical shapes, the plan's ``moe_mode`` and its split of each
weight), with Megatron's patterns written out here as
``torch.autograd.Function``s on the model subgroup: each one's backward is
the transpose of its forward (all-gather ↔ reduce-scatter, identity ↔
all-reduce).

A rank computes from its *model-local* weights, the full data replica of its
model shard: in a train step gathered over the data subgroup where a layer
reads them (``LM.fsdp``, :class:`~.sharding.WeightGather`), for serving
before the model runs (:meth:`TensorParallel.gathered_weights`).  With ``m`` ranks
over the model axis and a prompt or batch of ``S`` positions:

* **sequence parallelism** — where the sharder puts the residual stream's
  ``seq`` over the model axis (``S`` divides by ``m``), a rank holds rows
  ``[c·S/m, (c+1)·S/m)`` of the stream (``c`` its model coordinate); the
  normed input of each block is all-gathered over seq and its output
  reduce-scattered; otherwise the stream is replicated, the normed input
  enters a block through an identity whose backward all-reduces, and the
  block's output is all-reduced.  Each stream decides for itself: whisper's
  encoder ([B, 1500, d]) and its decoder ([B, S, d]) may decide apart
  (:attr:`TensorParallel.enc_sp`, :attr:`TensorParallel.sp`);
* **attention, heads divide** (``hq`` and ``hkv`` by ``m``): the rank's
  ``wqkv`` shard is its heads' q, k and v columns (the plan splits each
  sub-fragment evenly), so it computes its heads and the row-parallel
  ``wo``; the cache keeps its KV heads;
* **attention, heads do not divide**: ``wqkv`` and ``wo`` are gathered over
  the model subgroup (:attr:`TensorParallel.gathered`).  Under sequence
  parallelism every rank computes K and V for all rows and q for its own
  rows only, against keys ``[0, (c+1)·S/m)`` at ``q_offset = c·S/m``; its
  output stays its rows.  Without it attention is replicated;
* **MLA (DeepSeek-V2), heads divide** (``hq`` by ``m``): the rank's
  ``wq_b`` and ``wkv_b`` shards are its heads' columns and its ``wo`` shard
  their rows; ``wq_a``, ``q_norm``, ``wkv_a`` and ``kv_norm`` are
  replicated and computed whole on every rank (from the gathered rows under
  sequence parallelism), so the latent cache (``c_kv``, ``k_rope``) is whole
  on every rank, as ``cache_pspecs`` leaves it; a decode step absorbs the
  rank's slice of ``wkv_b``.  Else ``wq_b``, ``wkv_b`` and ``wo`` are
  gathered and the block runs as the dense family's gathered attention (K/V
  for every row, q for the rank's rows at its ``q_offset``);
* **cross-attention** (vlm's gated layers, encdec's ungated ones), where the
  heads divide: ``cross_wq`` by q heads, ``cross_wkv`` by its k and v
  sub-fragments (the rank's KV heads), ``cross_wo`` by rows; the source is
  whole on every rank and each rank projects its own KV heads from it (the
  cache's ``ck``/``cv`` are those heads); a gated layer applies
  tanh(``cross_gate``) after the row-parallel reduction, so the gate's
  gradient is whole.  Else the three are gathered and the block runs on the
  rank's rows (no mask: every row reads the whole source) or replicated;
* **the encoder's output** (encdec) is all-gathered over seq once where the
  encoder's stream was sharded; every cross layer then reads it.  In the
  backward the ranks' gradients into it are summed over the model subgroup
  once (the gather's reduce-scatter, or an identity whose backward
  all-reduces) where each rank's use of it is partial (by heads, or by the
  decoder's rows), and taken as they are where every rank computes the
  cross layers whole (:meth:`TensorParallel.whole`);
* **the MLP**: column-parallel on the rank's ``mlp`` columns, row-parallel
  down-projection (also a MoE layer's shared experts);
* **MoE**: every model rank routes all of its data replica's tokens, so
  its slots and drops are one process's.  Under ``moe_mode == "ep"`` the
  rank holds experts ``[c·E/m, (c+1)·E/m)`` and dispatches only their
  slots; under ``"tp"`` it holds every expert's ``expert_mlp`` slice (the
  columns of ``we_gate``/``we_up``, the rows of ``we_down``).  Either way its
  combined output is partial and the row-parallel reduce sums it (no
  all-to-all: the tokens are replicated over model).  The load-balancing
  loss is computed whole on every rank, so its gradient is divided by ``m``
  there (:meth:`TensorParallel.shared`): the sums over the model subgroup
  that complete the combine path's partial gradients then count it once;
* **Mamba-2, SSM heads divide** (:attr:`TensorParallel.ssm_heads`): the rank
  computes heads ``[c·nh/m, (c+1)·nh/m)``.  Its ``in_proj`` shard is
  ``z_c | x_c | B_c | C_c | dt_c`` (each sub-fragment split evenly, so
  ``B_c`` and ``C_c`` are slices of the state dim, one group); the depthwise conv runs
  on those channels with the gathered ``conv_w`` (``[conv_dim, K]``, a few
  kB a layer), then B and C are all-gathered (every head reads all of
  them); the SSD scan runs on the rank's heads; ``ssm_norm``, an RMS norm
  over the whole ``d_inner``, all-reduces its sum of squares; ``out_proj``
  is row-parallel.  The decode cache holds the rank's ``cache_pspecs``
  shard: ``h`` its heads, ``conv`` an even slice of the concatenated
  ``[x|B|C]`` channels, which is not the rank's sub-fragments, so prefill
  and decode all-gather those K-1 rows and cut the rank's slice;
* **Mamba-2, SSM heads do not divide**: ``in_proj``, ``conv_w`` and
  ``out_proj`` are gathered and the block is computed whole (over the
  gathered rows under sequence parallelism, each rank keeping its own), its
  decode state whole on every rank;
* **the vocabulary**: a masked lookup in the rank's rows of ``embed``,
  vocab-sharded logits, and a vocab-parallel cross-entropy (max and
  sum-of-exp all-reduced, each label's logit from its owner, padding
  masked), so every model rank gets the same loss.

Gradients: a weight split over the model axis and computed locally needs no
exchange; a gathered weight's and a replicated weight's (the norms') are
complete on every rank without sequence parallelism and partial with it
(by the weight's own stream: ``encoder.*`` weights by the encoder's
decision, the rest by the decoder's), and are then summed over the model
subgroup (:meth:`TensorParallel.reduce_grads`; a gathered weight's in the
backward of its read, :meth:`TensorParallel.gather_weight`).
Some are partial even without it (:attr:`TensorParallel.partial`): the
router's (each rank's combine path reaches it through its own experts'
outputs); where the MLA heads divide, ``wq_a``, ``q_norm``, ``wkv_a`` and
``kv_norm`` (each rank reaches them through its own heads, the shared
``k_rope`` columns of ``wkv_a`` too); and, where the SSM heads divide,
Mamba's per-head ``a_log``, ``d_skip`` and ``dt_bias``, ``ssm_norm``,
``conv_b`` and the gathered ``conv_w`` (each rank reads its heads' or
channels' part).  The seconds and bytes of every model-subgroup collective
accumulate in :attr:`TensorParallel.seconds` and :attr:`TensorParallel.bytes`.

Every collective is a gloo or NCCL ``all_reduce`` or ``all_gather``: a
reduce-scatter is an all-reduce and a slice (gloo has no reduce-scatter).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, ParallelismConfig
from repro_torch.core.layout import MeshSpec
from repro_torch.core.patterns import StateKind

from .sharding import (
    Exchange, RankGroups, _moe_mode, gather_full, gather_shard, make_sharder, model_layout,
    relocal,
)

__all__ = ["TensorParallel", "partitions"]

# the attention weights (GQA, MLA and cross-attention), gathered where heads do not divide
_ATTN = ("wqkv", "wo", "wq_b", "wkv_b", "cross_wq", "cross_wkv", "cross_wo")
# MLA's replicated weights, which a rank reaches only through its own heads
# where they divide: their gradients are partial on every rank
_MLA_PARTIAL = ("wq_a", "q_norm", "wkv_a", "kv_norm")
_MAMBA = ("in_proj", "conv_w", "out_proj")  # Mamba's split weights, gathered where heads do not
# replicated weights a rank reads in part where the SSM heads divide (and
# conv_w, gathered there): their gradients are partial on every rank
_SSM_PARTIAL = ("a_log", "d_skip", "dt_bias", "ssm_norm", "conv_b", "conv_w")


def partitions(cfg: ModelConfig, parallel: ParallelismConfig, mesh: MeshSpec) -> bool:
    """Whether a rank computes its part over the model axis (a model axis
    of size > 1; a pipe axis may lie beside it, :mod:`.pipeline`):

    * under tensor parallelism every family (dense, MoE with or without
      MLA, SSM, hybrid, vlm, encdec) by the weights' split, where a MoE
      layer's experts split (expert parallelism, or each expert's width
      divides the model size; shared experts' width too);
    * with tensor parallelism off and sequence parallelism on, every family
      by the rows of each stream that the sharder puts over the model axis,
      from weights replicated over it (a MoE layer's experts split under
      expert parallelism).

    Otherwise (no model axis, a MoE layer whose experts would not split, or
    tensor and sequence parallelism both off) every rank gathers the whole
    model over the model axis."""
    m = mesh.axis_size(parallel.model_axis) if mesh.has_axis(parallel.model_axis) else 1
    if m <= 1:
        return False
    if not parallel.tensor_parallel:
        return parallel.sequence_parallel
    moe = cfg.moe
    if moe is None:
        return True
    ep = _moe_mode(cfg, parallel, mesh) == "ep"
    return (ep or moe.d_ff_expert % m == 0) and moe.num_shared * moe.d_ff_expert % m == 0


def _ssm_split(cfg: ModelConfig, m: int) -> bool:
    """Whether a rank computes whole SSM heads of its own: the heads and the
    state dim divide ``m``, with one B/C group that every head reads (as in
    every config; more groups take the gathered path)."""
    s = cfg.ssm
    return (s is not None and s.n_groups == 1 and s.n_heads(cfg.d_model) % m == 0
            and s.d_state % m == 0)


class TensorParallel:
    """A rank's context of partitioned compute: its :class:`RankGroups`, the
    sharder, and the collectives of the model subgroup.  Install it as
    ``LM.tp``; the model then computes by it (:mod:`repro_torch.models.lm`,
    :mod:`repro_torch.models.decode`)."""

    def __init__(self, ranks: RankGroups, cfg: ModelConfig):
        par, mesh = ranks.parallel, ranks.mesh
        if not partitions(cfg, par, mesh):
            raise ValueError(f"{cfg.name} under {dict(mesh.axes)} does not compute partitioned")
        self.ranks = ranks
        self.parallel = par
        self.mesh = mesh
        self.sharder = make_sharder(par, mesh)
        self.axis = par.model_axis
        self.size = mesh.axis_size(self.axis)
        self.coord = mesh.coords(ranks.rank)[self.axis]
        self.group = ranks.model
        self.members = ranks.members["model"]
        if [mesh.coords(r)[self.axis] for r in self.members] != list(range(self.size)):
            raise ValueError(f"model subgroup {self.members} is not in model-coordinate order")
        # tensor parallelism splits the weights over the model axis; with it
        # off the rank computes its rows from replicated weights
        self.tensor = par.tensor_parallel
        # q heads go over the model axis where the sharder says so; a rank
        # computes them from its own wqkv (cross_wq, cross_wkv) shard only
        # when its GQA groups are whole (the kv heads divide too), MLA's from
        # its wq_b and wkv_b shards when the heads divide; else it computes
        # by rows
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        self.heads = self.tensor and hq % self.size == 0 and (cfg.mla is not None
                                                              or hkv % self.size == 0)
        # Mamba-2 by heads (cfg.num_heads is not the SSM's: mamba2's is 1)
        self.ssm_heads = self.tensor and _ssm_split(cfg, self.size)
        self.moe_mode = ranks.plan.moe_mode  # "ep": experts over model; "tp": their width
        # a MoE layer's experts split over the model axis (whole ones, or slices)
        self.experts_split = self.moe_mode == "ep" or (self.moe_mode == "tp" and self.tensor)
        specs = ranks.plan.param_specs
        # a pipe axis keeps its stage of the stacked dim (dist.pipeline)
        pipe = par.pipe_axis if par.pipe_axis and mesh.has_axis(par.pipe_axis) else None
        self.pipe_axis = pipe if pipe and mesh.axis_size(pipe) > 1 else None
        self.layouts = {n: model_layout(s, StateKind.FP32, mesh, self.axis, self.pipe_axis)
                        for n, s in specs.items()}
        # what a gathered weight is whole as: the runtime tensor, or its stage's
        self.stage_layouts = {n: model_layout(s, StateKind.FP32, mesh, None, self.pipe_axis)
                              for n, s in specs.items()}
        self.split = {n: any(self.axis in d.axes for d in s.states[StateKind.FP32].dims)
                      for n, s in specs.items()}
        leaf = {n: n.split(".")[-1] for n in specs}
        gather = ((() if self.heads else _ATTN) + (("conv_w",) if self.ssm_heads else _MAMBA))
        self.gathered = frozenset(n for n in specs if self.split[n] and leaf[n] in gather)
        partial = ((("router",) if self.experts_split else ())
                   + (_SSM_PARTIAL if self.ssm_heads else ())
                   + (_MLA_PARTIAL if self.heads and cfg.mla is not None else ()))
        self.partial = frozenset(n for n in specs if leaf[n] in partial)
        self.sp = False      # the last forward's decision for the decoder's stream (decide_sp)
        self.enc_sp = False  # and for the encoder's (encdec)
        self.seconds = 0.0
        self.bytes = 0

    # -- decisions ----------------------------------------------------------

    def decide_sp(self, b: int, s: int, d: int, *, encoder: bool = False) -> bool:
        """Whether the residual stream [b, s, d] is seq-sharded (the sharder's
        entry for ``(batch, seq, embed)``), kept as :attr:`sp` (the
        encoder's as :attr:`enc_sp`).  The forward decides once a stream
        (``LM.forward``, ``LM.encode``, ``decode.prefill``) and hands the
        decision to its layers; :meth:`reduce_grads` reads both."""
        sp = self.sharder((b, s, d), ("batch", "seq", "embed"))[1] == self.axis
        if encoder:
            self.enc_sp = sp
        else:
            self.sp = sp
        return sp

    def rows(self, s: int) -> tuple[int, int]:
        """This rank's rows of a seq-sharded stream of ``s`` positions."""
        n = s // self.size
        return self.coord * n, (self.coord + 1) * n

    def vocab_start(self, local_vocab: int) -> int:
        return self.coord * local_vocab

    def experts(self, e: int) -> tuple[int, int] | None:
        """The experts ``[lo, hi)`` whose weights this rank holds under
        expert parallelism; None where it holds a slice of every expert."""
        if self.moe_mode != "ep":
            return None
        n = e // self.size
        return self.coord * n, (self.coord + 1) * n

    # -- the collectives (timed) ---------------------------------------------

    def _clock(self, t: torch.Tensor) -> float:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        return time.perf_counter()

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In place over the model subgroup."""
        t0 = self._clock(t)
        dist.all_reduce(t, op=op, group=self.group)
        self.seconds += self._clock(t) - t0
        self.bytes += t.numel() * t.element_size()
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The model subgroup's tensors concatenated along ``dim`` in
        model-coordinate order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        t0 = self._clock(t)
        dist.all_gather(parts, t, group=self.group)
        self.seconds += self._clock(t) - t0
        self.bytes += t.numel() * t.element_size() * self.size
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over the model subgroup, this rank's chunk along ``dim``."""
        t = self.all_reduce(t.clone())
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.coord * n, n).contiguous()

    def combine(self, o: torch.Tensor, m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
        """Flash-decoding's combine over the model group, without autograd:
        each rank's attention over its own slots of a cache sharded over
        its length, unnormalized (``decode_attention_partial``: ``o
        [..., D]``, its max ``m [...]`` and sum ``l [...]``, float32), to the
        attention over every slot, the same on every rank.  The group's max
        M, each part rescaled by ``exp(m - M)``, the packed ``(l, o)``
        summed, divided: two all-reduces."""
        top = self.all_reduce(m.clone(), op=dist.ReduceOp.MAX)
        w = torch.exp(m - top)
        packed = self.all_reduce(torch.cat([(l * w)[..., None], o * w[..., None]], dim=-1))
        return packed[..., 1:] / packed[..., :1]

    # -- the autograd patterns ----------------------------------------------

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' tensors concatenated along ``dim``; backward
        reduce-scatters (each rank's use of the whole is partial)."""
        return _Gather.apply(x, self, dim)

    def gather_seq(self, x: torch.Tensor) -> torch.Tensor:
        """[b, s/m, ...] → [b, s, ...]; backward reduce-scatters."""
        return self.gather(x, 1)

    def scatter_seq(self, x: torch.Tensor) -> torch.Tensor:
        """Partial [b, s, ...] → the sum's rows of this rank; backward gathers."""
        return _ScatterSeq.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Partial → the sum over the model subgroup; backward is the identity."""
        return _Reduce.apply(x, self)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """The identity; backward all-reduces (the input of a column-parallel
        product under a replicated stream)."""
        return _Copy.apply(x, self)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Partial → the sum, which each rank reads for its own part;
        backward sums too."""
        return _PSum.apply(x, self)

    def shared(self, x: torch.Tensor) -> torch.Tensor:
        """The identity on a value every model rank computes whole from
        replicated inputs; backward divides by ``m``, because the gradients
        it reaches are summed over the model subgroup (the MoE aux loss)."""
        return _Shared.apply(x, self)

    def regroup(self, t: torch.Tensor, widths: tuple[int, ...]) -> list[torch.Tensor]:
        """A last dim all-gathered from per-rank ``[p0_c | p1_c | ...]`` (of
        ``widths``) → the parts whole, ``[p0_0 … p0_{m-1}]``, ``[p1_0 …]``, …"""
        per = t.unflatten(-1, (self.size, sum(widths)))
        return [q.flatten(-2) for q in per.split(list(widths), -1)]

    def rms_norm(self, y: torch.Tensor, scale: torch.Tensor, eps: float,
                 width: int) -> torch.Tensor:
        """``models.common.rms_norm`` over a last dim of ``width`` whose
        ``y.shape[-1]`` channels this rank holds (``scale`` its slice): the
        sum of squares all-reduced, the reference's cast order."""
        dt = y.dtype
        yf = y.float()
        var = self.psum(yf.square().sum(-1, keepdim=True)) / width
        return (yf * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)

    def whole(self, x: torch.Tensor, sp: bool, partial: bool) -> torch.Tensor:
        """A stream's output that every rank reads whole (the encoder's,
        read by every cross layer): all-gathered over seq where ``sp``
        sharded it.  Backward: the ranks' gradients summed over the model
        subgroup where each rank's use of it is ``partial``; else each
        rank's gradient is complete, and it keeps its own (rows)."""
        if sp:
            return self.gather_seq(x) if partial else _GatherOwn.apply(x, self, 1)
        return self.copy(x) if partial else x

    def enter(self, h: torch.Tensor, sp: bool) -> torch.Tensor:
        """A block's normed input as its partitioned products read it."""
        return self.gather_seq(h) if sp else self.copy(h)

    def leave(self, out: torch.Tensor, sp: bool) -> torch.Tensor:
        """A block's partial output as the residual stream holds it."""
        return self.scatter_seq(out) if sp else self.reduce(out)

    # -- the vocabulary ------------------------------------------------------

    def embed(self, table: torch.Tensor, tokens: torch.Tensor, sp: bool) -> torch.Tensor:
        """Vocab-parallel lookup in this rank's rows of ``embed``: masked,
        then reduce-scattered over seq (``sp``) or all-reduced.  With tensor
        parallelism off (``embed`` whole): the lookup of the rank's rows."""
        if not self.tensor:
            return F.embedding(tokens[:, slice(*self.rows(tokens.shape[1]))] if sp else tokens,
                               table)
        vl = table.shape[0]
        ids = tokens - self.vocab_start(vl)
        own = (ids >= 0) & (ids < vl)
        x = F.embedding(ids.clamp(0, vl - 1), table) * own[..., None].to(table.dtype)
        return self.leave(x, sp)

    def cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor,
                      vocab: int) -> torch.Tensor:
        """Per-token NLL from vocab-sharded fp32 logits [..., Vl] over the
        logical ``vocab`` (the padding columns masked), equal on every rank."""
        shape = labels.shape
        nll = _VocabCrossEntropy.apply(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                                       self, vocab)
        return nll.reshape(shape)

    def _masked(self, logits: torch.Tensor, vocab: int) -> torch.Tensor:
        vl = logits.shape[-1]
        col = self.vocab_start(vl) + torch.arange(vl, device=logits.device)
        return logits.masked_fill(col >= vocab, float("-inf"))

    def greedy(self, logits: torch.Tensor, vocab: int) -> torch.Tensor:
        """Argmax over the vocab shards of ``logits`` [..., Vl]: each rank's
        (max, index) all-gathered, ties to the lower index as ``argmax``; the
        same token on every rank."""
        lg = self._masked(logits.float(), vocab)
        mx, idx = lg.max(-1)
        idx = idx + self.vocab_start(lg.shape[-1])
        mxs = self.all_gather(mx[None], 0)
        ids = self.all_gather(idx[None], 0)
        best = mxs.argmax(0)  # the first (lowest-index) shard of the maximum
        return ids.gather(0, best[None])[0]

    def gather_vocab(self, logits: torch.Tensor, vocab: int) -> torch.Tensor:
        """The whole logits [..., vocab] from the vocab shards."""
        return self.all_gather(logits, logits.dim() - 1)[..., :vocab]

    # -- weights and gradients ----------------------------------------------

    def weights(self, local: dict) -> tuple[dict, dict]:
        """From the rank's checkpoint shards (flat), the tensors the update
        reads and the tree the model computes from in a train step: both the
        shards themselves.  The model gathers each weight where a layer
        reads it (``LM.fsdp``, a :class:`~.sharding.WeightGather`): over the
        data subgroup into the model-local tensor, and the
        :attr:`gathered` ones over the model subgroup too
        (:meth:`gather_weight`)."""
        return local, dict(local)

    def gathered_weights(self, local: dict) -> dict:
        """From the rank's checkpoint shards (flat), every weight it computes
        from, gathered before the model runs (the serving path): its
        model-local weights (gathered over the data subgroup; under a pipe
        axis its stage's layers of them), the :attr:`gathered` ones whole
        (gathered over the model subgroup: the runtime tensor, or its
        stage's layers of it)."""
        rg, specs = self.ranks, self.ranks.plan.param_specs
        comp = {}
        for n, t in local.items():
            t = gather_shard(t, specs[n].layout_for(StateKind.FP32, self.mesh), self.layouts[n],
                             rg.rank, rg.data, rg.members["data"])
            if n not in self.gathered:
                comp[n] = t
            elif self.pipe_axis is None:
                comp[n] = gather_full(t, self.layouts[n], self.group, self.members)
            else:
                comp[n] = gather_shard(t, self.layouts[n], self.stage_layouts[n], rg.rank,
                                       self.group, self.members)
        return comp

    def gather_weight(self, name: str, t: torch.Tensor, sink) -> torch.Tensor:
        """One of :attr:`gathered` (or one layer of it) whole over the model
        subgroup from the rank's model-local tensor, its seconds and bytes
        added to ``sink.gather_s`` and ``sink.gather_bytes``.  Backward: the
        gradient summed over the model subgroup where it is partial (the
        weight in :attr:`partial`, or its stream seq-sharded: :attr:`enc_sp`
        for ``encoder.*``, :attr:`sp` for the rest), then cut to the rank's
        part."""
        sp = self.enc_sp if name.startswith("encoder.") else self.sp
        partial = name in self.partial or sp
        src, dst, rank = self.layouts[name], self.stage_layouts[name], self.ranks.rank

        def gather(x):
            t0 = self._clock(x)
            if self.pipe_axis is None:
                y = gather_full(x, src, self.group, self.members)
            else:
                y = gather_shard(x, src, dst, rank, self.group, self.members)
            sink.gather_s += self._clock(x) - t0
            sink.gather_bytes += x.numel() * x.element_size() * self.size
            return y

        def scatter(g):
            if partial:
                g = self.all_reduce(g.clone(memory_format=torch.contiguous_format))
            return relocal(g, dst, src, rank)

        return Exchange.apply(t, gather, scatter)

    def reduce_grads(self, grads: dict) -> dict:
        """The rank's gradients of its shards (a train step's; those of
        :attr:`gathered` summed and cut in :meth:`gather_weight`'s backward)
        with a replicated weight's summed over the model subgroup where it
        is partial: every one where the forward sharded the weight's stream
        (:attr:`enc_sp` for ``encoder.*`` and :attr:`sp` for the rest), and
        those of :attr:`partial` always."""
        for n, g in grads.items():
            sp = self.enc_sp if n.startswith("encoder.") else self.sp
            if n not in self.gathered and (n in self.partial or (sp and not self.split[n])):
                self.all_reduce(g)
        return grads

    def local_heads(self, cfg: ModelConfig) -> tuple[int, int]:
        """(q heads, kv heads) this rank computes from its own wqkv (or
        cross_wq and cross_wkv) shard."""
        if self.heads:
            return cfg.num_heads // self.size, cfg.num_kv_heads // self.size
        return cfg.num_heads, cfg.num_kv_heads


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.reduce_scatter(g, ctx.dim), None, None


class _GatherOwn(torch.autograd.Function):
    """All-gather whose every rank's use is complete: backward keeps the
    rank's own chunk of its gradient."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.tp.size
        return g.narrow(ctx.dim, ctx.tp.coord * n, n).contiguous(), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.reduce_scatter(x, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_gather(g, 1), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.clone()), None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.clone()), None


class _Shared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.size = tp.size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


class _VocabCrossEntropy(torch.autograd.Function):
    """Megatron's vocab-parallel cross-entropy: nll = log Σexp(l - max) +
    max - l[label], the sums and the label's logit all-reduced; the backward
    is softmax - onehot on the rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, tp, vocab):
        lg = tp._masked(logits, vocab)
        mx = tp.all_reduce(lg.max(-1).values, dist.ReduceOp.MAX)
        e = torch.exp(lg - mx[:, None])
        s = tp.all_reduce(e.sum(-1))
        vl = lg.shape[-1]
        idx = labels - tp.vocab_start(vl)
        own = (idx >= 0) & (idx < vl)
        at = idx.clamp(0, vl - 1)
        pick = torch.where(own, lg.gather(-1, at[:, None])[:, 0], torch.zeros_like(mx))
        pick = tp.all_reduce(pick)
        ctx.save_for_backward(e / s[:, None], at, own)
        return torch.log(s) + mx - pick

    @staticmethod
    def backward(ctx, g):
        p, at, own = ctx.saved_tensors
        grad = p.clone()
        rows = torch.arange(grad.shape[0], device=grad.device)
        grad[rows, at] -= own.to(grad.dtype)
        return grad * g[:, None], None, None, None
