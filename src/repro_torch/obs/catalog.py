"""Authoritative name catalogs for the obs layer (port of
``repro.obs.catalog``: the reference's four tables, entry for entry).

One entry per span/timed/event/counter name of the reference's tree,
mirroring the DESIGN.md §9 taxonomy.  The tables are plain dict literals
on purpose: a static check parses this file with ``ast`` (never imports
it).  ``tests/test_torch_obs.py`` holds them equal to the reference's and
every literal name a ported file emits equal to its reference file's.
Names of modules the port does not have yet (``serve.*``, ``dryrun.*``)
stay registered, so the tables never drift from the reference's.

Counters are membership-only: dynamic families (listed at the bottom of
``COUNTERS``) are emitted through precomputed names, so a literal-string
scan cannot prove coverage for them.
"""

from __future__ import annotations

__all__ = ["SPANS", "TIMED", "EVENTS", "COUNTERS"]

# obs.span(name) — scoped regions with containment in the exported trace.
SPANS: dict[str, str] = {
    "ckpt.commit": "DistCheckpoint.commit: manifest rewrite + COMMIT marker",
    "ckpt.gc": "CheckpointManager.gc: one full collection pass",
    "convert.param": "convert.to_ucp, one parameter re-atomized",
    "drain.shard": "persist_snapshot, one hot fragment promoted to disk",
    "engine.index_build": "CheckpointEngine, shard index built for one checkpoint",
    "hot.capture": "HotTier.capture: staging one step into the ring",
    "hot.drain_job": "HotDrainer worker: one queued promotion end-to-end",
    "manager.save": "CheckpointManager.save: policy + write + commit + gc",
    "restore.consolidate": "restore, cross-shard regions consolidated",
    "restore.materialize": "restore, planned reads executed into arrays",
    "restore.plan": "restore, read plan computed from manifests",
    "restore.prefetch": "restore, handle cache warmed for planned shards",
    "restore.tier": "one recovery-ladder attempt (hot / local / peer / disk)",
    "save.async_job": "AsyncSaver worker: one queued save end-to-end",
    "save.fsync": "save path, directory+file fsync barrier",
    "save.manifest": "save path, digest manifest rewrite",
    "save.resolve_base": "delta save, base checkpoint resolved (and pinned)",
    "save.shard": "save path, one shard persisted",
    "save.stage": "save path, arrays staged out of device buffers",
    "serve.fetch": "PeerFragmentSource.read_fragment: one fetch-ladder walk",
    "serve.publish": "PublicationRegistry.publish: store + deliver to subscribers",
    "serve.sync": "fleet reader syncing one publication into its engine",
}

# obs.timed(name) — always-measuring stopwatches at operation granularity.
TIMED: dict[str, str] = {
    "ckpt.restore": "one restore() call, any tier",
    "ckpt.save": "one write_distributed() call",
    "convert.to_ucp": "one DistCheckpoint -> UCP atom-store conversion",
    "dryrun.analyze": "dryrun, HLO text rendered + trip-count analysis",
    "dryrun.cell": "dryrun, one (arch x shape x mesh) cell end-to-end",
    "dryrun.compile": "dryrun, lowered module compiled",
    "dryrun.lower": "dryrun, jitted step lowered with abstract inputs",
    "hot.drain": "one snapshot promotion (persist_snapshot)",
    "serve.decode": "serving benchmark decode step",
    "serve.prefill": "serving benchmark prefill step",
    "train.step": "one training step (forward+backward+update)",
}

# obs.event(name) — instantaneous markers.
EVENTS: dict[str, str] = {
    "chaos.fault": "chaos controller fired an armed fault",
    "chaos.invariant_check": "chaos ladder ran the invariant checker",
    "chaos.point": "a fault_point hook was crossed (controller active)",
    "codec.ef_fallback": "error-feedback codec fell back to raw encoding",
    "restore.fallback": "recovery ladder moved to the next tier",
    "restore.hot_skip": "hot tier skipped: snapshot generation unusable",
    "restore.hot_unservable": "hot tier skipped: failed ranks made it unservable",
    "save.rebase": "delta save rebased onto a full save (chain cap / lost base)",
    "serve.digest_mismatch": "fetched fragment failed digest check, refetching",
}

# obs.add(name, n) — monotonic counters.  Exact names first, then the
# dynamic families (emitted through precomputed strings, kept here so the
# family members are still registered names).
COUNTERS: dict[str, str] = {
    "codec.decode_bytes": "bytes decoded on the read path",
    "codec.decode_shards": "shards decoded on the read path",
    "codec.encode_bytes_coded": "encoded output bytes written by the codec",
    "codec.encode_bytes_raw": "raw input bytes seen by the codec",
    "codec.encode_shards": "shards encoded on the save path",
    "convert.atoms_written": "UCP atoms written by conversion",
    "convert.bytes_read": "bytes read by conversion",
    "convert.bytes_written": "bytes written by conversion",
    "convert.params": "parameters converted",
    "engine.arena.alloc": "buffer arena: fresh allocations",
    "engine.arena.reuse": "buffer arena: pooled-buffer reuses",
    "engine.index.build": "shard indexes built",
    "engine.index.hit": "shard index cache hits",
    "gc.collected_bytes": "bytes reclaimed by GC",
    "gc.collected_steps": "step directories reclaimed by GC",
    "gc.pinned_steps": "deletions skipped because a chain pin held the step",
    "gc.wreckage_removed": "uncommitted wreckage directories removed",
    "hot.captures": "hot-tier captures",
    "hot.evictions": "hot-tier ring evictions",
    "hot.fragments": "fragments currently resident (bumped per capture)",
    "hot.mirrored_bytes": "bytes mirrored to replica ranks",
    "hot.resident_bytes": "bytes resident in the hot ring",
    "hot.stored_bytes": "bytes stored per capture",
    "restore.arrays": "arrays materialized by restore",
    "restore.bytes_read": "bytes read by restore",
    "restore.count": "restore() calls",
    "restore.region_fragments": "fragments feeding consolidated regions",
    "restore.region_reads": "consolidated region reads",
    "save.bytes_written": "bytes written by one save",
    "save.shards_inherited": "delta save: shards inherited from the base",
    "save.shards_written": "shards physically written",
    "serve.changed_shards": "shards that changed across a publication",
    "serve.publications": "publications delivered",
    "serve.syncs": "fleet reader syncs completed",
    # -- dynamic families --------------------------------------------------
    # save.<mode> (saver/drain: f"save.{result.mode}")
    "save.delta": "saves that took the delta path",
    "save.full": "saves that took the full path",
    # serve.<FanoutStats field> (peer._OBS_COUNTERS)
    "serve.digest_failures": "fetch ladder: digest verification failures",
    "serve.disk_bytes_read": "fetch ladder: bytes read from disk tier",
    "serve.disk_fetches": "fetch ladder: disk-tier fetches",
    "serve.local_hits": "fetch ladder: local-store hits",
    "serve.peer_bytes_read": "fetch ladder: bytes read from peers",
    "serve.peer_fetches": "fetch ladder: peer-tier fetches",
    "serve.refetches": "fetch ladder: refetches after digest failure",
    # <HandleCache.metric>.{hit,miss,eviction} (engine caches)
    "engine.atom.eviction": "atom handle cache evictions",
    "engine.atom.hit": "atom handle cache hits",
    "engine.atom.miss": "atom handle cache misses",
    "engine.handle.eviction": "shard handle cache evictions",
    "engine.handle.hit": "shard handle cache hits",
    "engine.handle.miss": "shard handle cache misses",
}
