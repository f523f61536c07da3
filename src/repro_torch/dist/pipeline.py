"""Compute by pipeline stages over the mesh's pipe axis (the reference's
stage layout, computed where it lives).

The reference shards the leading ``layers`` dim of every scan-stacked
parameter over the pipe axis by ceil division
(``repro/dist/sharding.py:199-200``, ``repro/core/layout.py``), and GSPMD
then computes each layer where its weights lie.  Eager PyTorch has no
partitioner, so a rank here computes exactly the layers of its checkpoint
shard of each stack (:attr:`Pipeline.chunks`, read from the layout's
:class:`~repro_torch.core.layout.IndexEntry` maps: possibly uneven,
possibly none), and the ranks of one (data, model) coordinate hand the residual
stream along:

* **segments** — a segment is (stack, pipe coordinate), in model order: the
  encoder's ``encoder.blk`` (encdec) and then each scan stage of
  ``plan_stages`` over coordinates 0…P-1, so a model with several stacks
  goes 0→…→P-1 and back to 0 (deepseek-v2's ``head`` then ``layers``).
  Coordinate 0 embeds the tokens (and feeds the encoder the source); the
  last coordinate takes ``final_norm``, the logits and the loss.  A rank's
  empty chunk passes the stream on unchanged; a padded layer is never
  computed (a zero-weight MoE layer is not the identity: its uniform
  router adds aux loss);
* **the weights** — a rank computes from its *stage-local* weights: the
  stacked dim its pipe shard (cut to the layers it holds), the data axes
  gathered layer by layer where the model reads them
  (:class:`~.sharding.WeightGather`); over a model axis as
  :class:`~.tensor_parallel.TensorParallel` computes (each stage's model
  ranks partitioned, each handing its own slice of the stream to the rank
  of the same (data, model) coordinate in the next stage), else gathered.
  Unstacked weights (``embed``,
  ``final_norm``, ``unembed``, ``encoder.norm``) are replicated over pipe,
  as in the plan;
* **the encoder's output** (encdec) is made whole on every pipe rank (a
  broadcast from the last coordinate), since each decoder stage's cross
  layers read it; the pipe ranks' gradients into it are summed before they
  go back through the encoder's segments;
* **the backward** runs the segments in reverse: each rank backpropagates
  its segment's output with the gradient it receives (and the last one its
  loss), with ``router_aux_weight`` × its own segment's aux loss (so the
  total is ce + w·Σ aux over the stages), then hands its input's gradient
  to the previous segment.  Unstacked weights' gradients are summed over
  the pipe group (a rank that did not use one adds zeros: the tied
  embedding gets its lookup's gradient from coordinate 0 and its logits'
  from the last); the global norm counts the stacked gradients on their
  own stage and the unstacked ones once;
* **schedule** — the simplest correct one: a microbatch's forward through
  every segment, then its backward; with gradient accumulation the
  microbatches go through one after another in the one-process order.

Transport: gloo takes CUDA tensors for collectives but not point to point
(on torch 2.11 its TCP transport writes from the device pointer, the
sending process aborts on ``Bad address`` and the receiver sees the
connection closed; the smoke's probe records it), so a hand-off is a
``broadcast`` over a two-member subgroup of each adjacent pair of pipe
coordinates in a (data, model) line, created by every rank in one order.  The seconds and bytes of every pipe-group exchange accumulate
in :attr:`Pipeline.seconds` and :attr:`Pipeline.bytes` (the step's
``pipe_s`` and ``pipe_bytes``).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.core.patterns import StateKind

from .sharding import RankGroups, axis_groups, model_layout, new_subgroup

__all__ = ["Pipeline", "pipelines"]


def pipelines(parallel, mesh) -> bool:
    """Whether a run computes by pipeline stages: a pipe axis over 1."""
    return bool(parallel.pipe_axis and mesh.has_axis(parallel.pipe_axis)
                and mesh.axis_size(parallel.pipe_axis) > 1)


class Pipeline:
    """A rank's pipeline stage: its chunk of every stack, its stage-local
    weights, the schedule of a microbatch (:meth:`forward_backward`) and the
    pipe group's exchanges.  Install it as ``LM.pipe`` (after ``LM.tp``,
    whose layouts then keep the pipe axis); every rank of the group must
    construct it in the same order as its other subgroups."""

    def __init__(self, ranks: RankGroups, lm):
        par, mesh = ranks.parallel, ranks.mesh
        if not pipelines(par, mesh):
            raise ValueError(f"{dict(mesh.axes)} has no pipe axis over 1")
        self.ranks, self.lm, self.mesh = ranks, lm, mesh
        self.axis = par.pipe_axis
        self.size = mesh.axis_size(self.axis)
        self.coord = mesh.coords(ranks.rank)[self.axis]
        self.group = ranks.pipe
        self.members = ranks.members["pipe"]
        if [mesh.coords(r)[self.axis] for r in self.members] != list(range(self.size)):
            raise ValueError(f"pipe subgroup {self.members} is not in pipe-coordinate order")
        specs = ranks.plan.param_specs
        self.stacked = {n: self.axis in s.states[StateKind.FP32].dims[0].axes
                        for n, s in specs.items()}
        # each stack's chunk [lo, hi) of this rank, from its stage-local layout's entries
        self.chunks: dict[str, tuple[int, int]] = {}
        for n, s in specs.items():
            stack = n.split(".")[0]
            if self.stacked[n] and stack not in self.chunks:
                entries = model_layout(s, StateKind.FP32, mesh, None, self.axis).entries[ranks.rank]
                count = s.runtime_shape[0]
                self.chunks[stack] = entries[0].atom_slice[0] if entries else (count, count)
        # one two-member group a pair of adjacent coordinates of a line
        # (the wrap P-1 -> 0 too), every rank creating every group in one order
        glob = [dist.get_global_rank(ranks.group, r) for r in range(ranks.group.size())]
        self._glob = glob
        self._pairs: dict[tuple[int, int], object] = {}
        pairs = sorted({tuple(sorted((p, (p + 1) % self.size))) for p in range(self.size)})
        for line in axis_groups(mesh, (self.axis,)):
            for a, b in pairs:
                g = new_subgroup(ranks.group, [glob[line[a]], glob[line[b]]])
                if ranks.rank in line:
                    self._pairs[a, b] = g
        self.seconds = 0.0
        self.bytes = 0
        self.computed: list[tuple[str, int, int]] = []  # the last microbatch's (stack, lo, hi)

    # -- the pipe group's exchanges (timed) ---------------------------------

    def _clock(self, t: torch.Tensor) -> float:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        return time.perf_counter()

    def _count(self, t: torch.Tensor, t0: float) -> None:
        self.seconds += self._clock(t) - t0
        self.bytes += t.numel() * t.element_size()

    def send(self, t: torch.Tensor, coord: int) -> None:
        """Hand ``t`` to the rank of this line at pipe coordinate ``coord``."""
        t = t.detach().contiguous()
        t0 = self._clock(t)
        dist.broadcast(t, src=self._glob[self.members[self.coord]],
                       group=self._pairs[tuple(sorted((self.coord, coord)))])
        self._count(t, t0)

    def recv(self, shape, dtype, device, coord: int) -> torch.Tensor:
        """What the rank of this line at pipe coordinate ``coord`` hands over."""
        t = torch.empty(shape, dtype=dtype, device=device)
        t0 = self._clock(t)
        dist.broadcast(t, src=self._glob[self.members[coord]],
                       group=self._pairs[tuple(sorted((self.coord, coord)))])
        self._count(t, t0)
        return t

    def broadcast(self, t: torch.Tensor, coord: int) -> torch.Tensor:
        """``t`` of the line's rank at ``coord``, on every rank of the line."""
        t = t.detach().contiguous()
        t0 = self._clock(t)
        dist.broadcast(t, src=self._glob[self.members[coord]], group=self.group)
        self._count(t, t0)
        return t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """In place, summed over the line."""
        t0 = self._clock(t)
        dist.all_reduce(t, group=self.group)
        self._count(t, t0)
        return t

    # -- weights and gradients ----------------------------------------------

    def weights(self, local: dict) -> tuple[dict, dict]:
        """From the rank's checkpoint shards (flat), the tensors the update
        reads (those shards) and the tree the model computes from: the
        shards, a stack's cut to the layers of the rank's chunk.  The model
        gathers each layer's weights where it reads them (``LM.fsdp``, a
        :class:`~.sharding.WeightGather`): over the data axes, and over the
        model axis as ``LM.tp`` computes, or gathered over it."""
        return local, {n: t[: self._held(n)] if self.stacked[n] else t for n, t in local.items()}

    def _held(self, name: str) -> int:
        lo, hi = self.chunks[name.split(".")[0]]
        return hi - lo

    def reduce_grads(self, grads: dict) -> dict:
        """Gradients of :meth:`weights`' compute tree → those of the rank's
        shards: a stack's padded back to its shard's shape, the model
        group's sums (``LM.tp``), and the unstacked weights' summed over the
        pipe group."""
        tp, specs, out = self.lm.tp, self.ranks.plan.param_specs, {}
        for n, g in grads.items():
            if self.stacked[n]:
                shape = specs[n].layout_for(StateKind.FP32, self.mesh).local_shape
                if g.shape[0] < shape[0]:
                    g = torch.cat([g, g.new_zeros((shape[0] - g.shape[0],) + tuple(g.shape[1:]))])
            out[n] = g
        if tp is not None:
            out = tp.reduce_grads(out)
        for n, g in out.items():
            if not self.stacked[n]:
                self.all_reduce(g)
        return out

    # -- the schedule ---------------------------------------------------------

    def forward_backward(self, params: dict, batch: dict) -> dict:
        """One microbatch through every segment, forward then backward, on
        the compute tree ``params`` (the leaves' ``.grad`` accumulate the
        rank's gradients): the metrics every pipe rank reports, ``loss``
        (the cross-entropy of the last coordinate) and ``aux`` (summed over
        the stages)."""
        lm, cfg, tp = self.lm, self.lm.cfg, self.lm.tp
        tokens = batch["tokens"]
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        b, s = inputs.shape
        sp = lm.stream_sp(inputs)
        dev, dtype = tokens.device, lm.compute_dtype
        w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
        positions = torch.arange(s, device=dev)
        self.computed = []
        enc, source = None, batch.get("source_embeds")
        if cfg.encoder is not None:
            enc = self._encoder_forward(params, source, sp)
            source = enc["leaf"]
        rows = s // tp.size if sp else s
        stream = (b, rows, cfg.d_model)
        segs = [(st, p) for st in lm.stages for p in range(self.size)]
        last = len(segs) - 1
        run, aux_sum, ce = [], torch.zeros((), device=dev), None
        for i, (st, p) in enumerate(segs):
            if p != self.coord:
                continue
            if i == 0:
                x_in = lm.embed_tokens(params, inputs, sp)
            else:
                x_in = self.recv(stream, dtype, dev, segs[i - 1][1]).requires_grad_(True)
            lo, hi = self.chunks[st.name]
            self.computed.append((st.name, lo, hi))
            x, aux = lm._stage_forward(st, params[st.name], x_in, positions=positions,
                                       source=source, sp=sp, first=lo)
            aux_sum = aux_sum + aux.detach()
            out = [x, w * aux]
            if i == last:
                ce = lm.cross_entropy(lm.logits(params, x, sp), labels)
                out = [ce + w * aux]
            else:
                self.send(x, segs[i + 1][1])
            run.append((i, x_in, out))
        for i, x_in, out in reversed(run):
            grads = [torch.ones_like(out[-1])]
            if i != last:
                grads.insert(0, self.recv(stream, dtype, dev, segs[i + 1][1]))
            _backward(out, grads)
            if i != 0:
                g = x_in.grad if x_in.grad is not None else torch.zeros_like(x_in)
                self.send(g, segs[i - 1][1])
        if enc is not None:
            self._encoder_backward(enc)
        la = torch.stack([ce.detach().float() if ce is not None else aux_sum.new_zeros(()),
                          aux_sum.float()])
        self.all_reduce(la)
        return {"loss": la[0], "aux": la[1]}

    def _encoder_forward(self, params: dict, source_embeds: torch.Tensor, sp: bool) -> dict:
        """The encoder's segments (``encoder.blk`` over coordinates 0…P-1),
        ``encoder.norm`` on the last, and its output broadcast to every pipe
        rank, where the decoder's cross layers read it as a leaf (whose
        gradient :meth:`_encoder_backward` sums)."""
        lm, tp, dev = self.lm, self.lm.tp, source_embeds.device
        b, n = source_embeds.shape[:2]
        enc_sp = tp is not None and tp.decide_sp(b, n, lm.cfg.d_model, encoder=True)
        rows = (b, n // tp.size if enc_sp else n, lm.cfg.d_model)
        lo, hi = self.chunks["encoder"]
        x_in = out = None
        if self.coord == 0:
            x_in, _ = lm.encoder_input(source_embeds)
        else:
            x_in = self.recv(rows, lm.compute_dtype, dev, self.coord - 1).requires_grad_(True)
        self.computed.append(("encoder", lo, hi))
        x = lm.encoder_layers(params["encoder"]["blk"], x_in, enc_sp)
        if self.coord < self.size - 1:
            self.send(x, self.coord + 1)
        else:
            out = lm.encoder_output(params, x, enc_sp, sp)
        whole = (b, n, lm.cfg.d_model)
        got = out if out is not None else torch.empty(whole, dtype=lm.compute_dtype, device=dev)
        leaf = self.broadcast(got, self.size - 1).requires_grad_(True)
        return {"x_in": x_in, "x": x, "out": out, "leaf": leaf}

    def _encoder_backward(self, enc: dict) -> None:
        """The pipe ranks' gradients into the encoder's output summed, then
        back through ``encoder.norm`` and the encoder's segments in
        reverse."""
        leaf = enc["leaf"]
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        self.all_reduce(g)
        if self.coord == self.size - 1:
            _backward([enc["out"]], [g])
        else:
            _backward([enc["x"]], [self.recv(enc["x"].shape, enc["x"].dtype, enc["x"].device,
                                             self.coord + 1)])
        if self.coord > 0:
            x_in = enc["x_in"]
            self.send(x_in.grad if x_in.grad is not None else torch.zeros_like(x_in),
                      self.coord - 1)


def _backward(tensors: list, grads: list) -> None:
    """``torch.autograd.backward`` of the tensors that record a gradient
    (an empty segment's aux does not; its output is its input)."""
    pairs = [(t, g) for t, g in zip(tensors, grads) if t.requires_grad]
    if pairs:
        torch.autograd.backward([t for t, _ in pairs], [g for _, g in pairs])
