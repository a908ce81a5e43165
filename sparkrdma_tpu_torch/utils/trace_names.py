"""The trace-name registry: every span/instant/counter name the
codebase may emit, in one place.

Trace names are load-bearing: dashboards, the chaos assertions, and the
bench harness all select events by exact name, so a typo'd emission
(``plan.coalese``) silently forks a series instead of failing anything.
The drift pass (``sparkrdma_tpu_torch/analysis/drift.py``) AST-scans every
``tracer.span/complete_span/instant/counter`` call site and requires
the emitted literal to resolve HERE — and, symmetrically, every name
here to still be emitted somewhere, so the registry can't rot into a
wishlist.

Adding an event = one line here + the emission. Names are
``<subsystem>.<event>``; keep new ones consistent.
"""

from __future__ import annotations

# Duration spans: ``tracer.span(...)`` context managers and the
# explicit-boundary ``complete_span`` emissions of the async fetcher.
SPANS = frozenset({
    "engine.dist_reduce",
    "engine.stage",
    "engine.task",
    "exchange.round",
    "fetch.blocks",
    "fetch.complete",
    "fetch.driver_table",
    "fetch.issue",
    "fetch.locations",
    "fetch.merged",
    "fetch.refetch_range",
    "fetch.vectored",
    "push.map",
    "push.planned",
    "write.merge",
    "write.scatter",
    "write.spill",
    "writer.commit",
    "writer.publish",
    # emitted only by the port: its host drivers' round phases
    # (parallel/device_plane.py) and its mesh service's host work
    # (shuffle/mesh_service.py)
    "exchange.collect",
    "exchange.merge",
    "exchange.stage",
    "mesh.decode",
    "mesh.pack",
    "mesh.partition",
    "mesh.unpack",
    # and its step spans (utils/trace.span): the device plane's
    # layers, the row gather, the exchange's phases and each
    # model's rounds, which the benchmark's readers select on
    "als.group",
    "als.solve",
    "chunked.land",
    "chunked.pack",
    "chunked.slot_fill",
    "chunked.transport",
    "exchange.arena_copy",
    "exchange.group",
    "exchange.pack",
    "exchange.receive_fill",
    "exchange.slot_fill",
    "exchange.transport",
    "fused.counts",
    "fused.local_sort",
    "fused.receive_sort",
    "join.exchange",
    "join.merge",
    "lookup.unique",
    "mesh.take_rows",
    "pagerank.contrib",
    "pagerank.exchange",
    "pagerank.sum",
    "q64.by_item",
    "q64.catalog_group",
    "q64.catalog_join",
    "q64.date_join",
    "q64.pair_lookup",
    "q64.store_join",
    "q95.addr",
    "q95.aggregate",
    "q95.aggregate.sort",
    "q95.by_order",
    "q95.date",
    "q95.site",
    "tpcds.aggregate",
    "tpcds.join1",
    "tpcds.join2",
})

# Point-in-time instants (fault/decision markers).
INSTANTS = frozenset({
    "admit.accept",
    "admit.expire",
    "admit.queue",
    "admit.reject",
    "autoscale.resize",
    "cold.upload",
    "commit.fenced",
    "driver.takeover",
    "exchange.degrade",
    "exchange.hierarchical",
    "exchange.overlap",
    "exchange.select",
    "fetch.coalesce_fallback",
    "fetch.merged_fallback",
    "fetch.pushed",
    "fetch.retry",
    "fetch.tiered",
    "member.drain",
    "member.drain_fallback",
    "member.join",
    "member.retire",
    "merge.finalize",
    "meta.epoch_bump",
    "meta.shard_fallback",
    "meta.shard_handoff",
    "peer.suspect",
    "push.drop",
    "push.planned_native",
    "push.superseded",
    "recovery.repoint",
    "recovery.repoint_cold",
    "plan.coalesce",
    "plan.replan",
    "plan.split",
    "serve.corrupt",
    "serve.pin",
    "serve.remap",
    "serve.zero_copy",
    "tenant.serve",
    "write.cleanup_error",
    "write.spill_remote",
    "write.spill_retry",
    "write.spill_shrink",
})

# Chrome "C"-phase counter series.
COUNTERS = frozenset({
    "ha_failovers",
    "oplog_lag_entries",
    "peer.suspects",
})

ALL = SPANS | INSTANTS | COUNTERS
