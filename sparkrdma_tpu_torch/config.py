"""Typed, range-validated configuration.

TPU-native re-design of the reference's ``RdmaShuffleConf``
(scala/RdmaShuffleConf.scala:36-142): every key lives under one prefix,
values are parsed with type + range validation and fall back to defaults on
any invalid input rather than raising (scala/RdmaShuffleConf.scala:36-47).

Keys that only make sense for verbs hardware (queue-pair depths, ODP, CPU
vectors) are re-interpreted for their TPU-native analogue where one exists
and dropped where none does; TPU-specific knobs (mesh axis, exchange chunk
bytes, staging concurrency) are added.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

PREFIX = "spark.shuffle.tpu."

_SIZE_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([kmgtp]?)b?\s*$", re.IGNORECASE)
_SIZE_MULT = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40, "p": 1 << 50}


def parse_bytes(value: Any) -> int:
    """Parse a byte-size string like ``'8m'``/``'256k'``/``'10g'`` to bytes.

    Mirrors the JVM-style size strings the reference accepts via
    ``getSizeAsBytes`` (scala/RdmaShuffleConf.scala:44-47).
    """
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return int(value)
    m = _SIZE_RE.match(str(value))
    if not m:
        raise ValueError(f"cannot parse byte size: {value!r}")
    return int(float(m.group(1)) * _SIZE_MULT[m.group(2).lower()])


def format_bytes(n: int) -> str:
    for unit, shift in (("t", 40), ("g", 30), ("m", 20), ("k", 10)):
        if n >= (1 << shift) and n % (1 << shift) == 0:
            return f"{n >> shift}{unit}"
    return str(n)


@dataclass
class _Key:
    name: str
    default: Any
    kind: str  # "int" | "bytes" | "bool" | "str" | "float"
    min: Optional[float] = None
    max: Optional[float] = None
    doc: str = ""


# Full key set. Reference key-for-key parity is documented per entry
# (scala/RdmaShuffleConf.scala:61-142); TPU-only keys say so.
_KEYS = [
    # --- exchange / data-plane sizing (reference: write/read block sizes, 107-111)
    _Key("shuffle_write_block_size", "8m", "bytes", 4096, 1 << 34,
         doc="Partition-aligned staging chunk size (ref shuffleWriteBlockSize=8m)."),
    # --- streaming map-side write dataplane (TPU-only: the reference
    # inherits Spark's sort/spill writer; we own it)
    _Key("spill_threshold_bytes", "64m", "bytes", 0, 1 << 44,
         doc="Map-side write budget: when a writer's accumulated "
             "partition-scattered run bytes exceed this, they spill to a "
             "per-map spill file on the background spill thread, "
             "overlapping the map task's next batches; close() becomes a "
             "sequential merge of partition-contiguous runs instead of a "
             "monolithic sort-and-write. 0 = spill after every batch "
             "(minimum memory, fully synchronous). Peak accumulation is "
             "bounded by this plus one batch."),
    _Key("write_spill_threads", 1, "int", 1, 64,
         doc="Background spill threads per writer — also the cap on "
             "spills in flight before write_batch backpressures, so "
             "write-path memory is bounded by (1 + this) x "
             "(spill_threshold_bytes + one batch)."),
    _Key("native_write_scatter", True, "bool",
         doc="Use the native O(n) counting-sort scatter kernel "
             "(csrc/writer.cpp) for write_batch partitioning when the "
             ".so provides it; off = the numpy fallback (identical run "
             "layout, lockstep-tested)."),
    _Key("shuffle_read_block_size", "256k", "bytes", 1024, 1 << 34,
         doc="Max bytes fetched by one grouped read (ref shuffleReadBlockSize=256k)."),
    _Key("max_bytes_in_flight", "48m", "bytes", 1 << 16, 1 << 40,
         doc="Bound on outstanding fetched-but-unconsumed bytes (ref maxBytesInFlight=48m)."),
    _Key("exchange_chunk_bytes", "64m", "bytes", 1 << 16, 1 << 34,
         doc="TPU-only: max per-device payload bytes per ragged all-to-all round."),
    _Key("exchange_row_bytes", 16, "int", 1, 4096,
         doc="TPU-only: record row stride in bytes for on-device exchange buffers."),
    # --- buffer pool (reference: RdmaBufferManager, maxBufferAllocationSize 97-99)
    _Key("max_buffer_allocation_size", "10g", "bytes", 1 << 20, 1 << 44,
         doc="Pool high-water mark before LRU trim (ref maxBufferAllocationSize=10g)."),
    _Key("prealloc_buffers", "", "str",
         doc="'size:count,size:count' eager pool carve-up (ref preAllocateBuffers)."),
    _Key("min_block_size", "16k", "bytes", 256, 1 << 30,
         doc="Smallest pool bin; sizes round up to pow2 of at least this "
             "(ref RdmaBufferManager.java:93 MIN_BLOCK_SIZE=16k)."),
    # --- flow control (reference: recv/send queue depths, swFlowControl 61-68)
    _Key("send_queue_depth", 4096, "int", 16, 1 << 20,
         doc="Outstanding async fetch budget per peer (ref sendQueueDepth=4096)."),
    _Key("read_ahead_depth", 0, "int", 0, 1 << 20,
         doc="Grouped fetches kept in flight per peer connection; 0 = auto "
             "(send_queue_depth // cores, the reference's division, "
             "RdmaShuffleFetcherIterator.scala:82-83); 1 = fully sequential "
             "fetch (pre-pipelining behavior, the regression escape hatch)."),
    _Key("coalesce_reads", True, "bool",
         doc="Per-peer batching at both fetch levels: ONE batched "
             "location RPC per (shuffle, peer) covering every map the "
             "reducer needs there (FetchOutputsReq — O(peers) instead of "
             "O(maps) metadata round trips), and VECTORED data reads "
             "merging block ranges across maps bound for the same peer "
             "into single request frames. Off = the per-map dataplane "
             "(one location RPC per map, data groups never span maps) — "
             "today's exact wire traffic, kept as the regression escape "
             "hatch and the mixed-version fallback."),
    _Key("max_vectored_bytes", "1m", "bytes", 1024, 1 << 34,
         doc="Max payload bytes of one coalesced (cross-map) vectored "
             "read; floored at shuffle_read_block_size. Per-map grouping "
             "still caps at shuffle_read_block_size — this bounds how "
             "many such groups one request frame may carry."),
    _Key("max_fetch_blocks", 0, "int", 0, 1 << 20,
         doc="Max (buf, offset, length) ranges in one data request frame; "
             "0 = auto-derive from the native block server's inbound "
             "frame cap (csrc/blockserver.cpp kMaxReqFrame, mirrored as "
             "messages.NATIVE_MAX_REQ_FRAME) with an 8x safety margin so "
             "a wide, mostly-empty partition range can never build a "
             "frame the C++ server rejects."),
    _Key("pre_warm_connections", True, "bool",
         doc="Dial peer control connections the moment an announce names "
             "them (ref pre-connects requestor channels on announce, "
             "RdmaShuffleManager.scala:117-126) so a shuffle's first fetch "
             "pays no handshake latency."),
    _Key("recv_queue_depth", 256, "int", 4, 1 << 16,
         doc="Control-plane inflight message budget (ref recvQueueDepth=256)."),
    _Key("rpc_msg_size", "4k", "bytes", 256, 1 << 24,
         doc="Control RPC segment size (ref recvWrSize=4k)."),
    _Key("sw_flow_control", True, "bool",
         doc="Enable credit-based backpressure on the control plane (ref swFlowControl)."),
    _Key("serve_credit_bytes", "32m", "bytes", 1 << 16, 1 << 40,
         doc="TPU-only shape of ref swFlowControl credits: per-connection "
             "window of logical response bytes a block server will hold "
             "built-but-unconsumed; serving parks past it until the "
             "reader's CreditReport replenishes."),
    _Key("serve_threads", 4, "int", 1, 256,
         doc="TPU-only: block-serving worker threads per executor "
             "endpoint (responses build/send off the connection reader "
             "thread so credit reports are never blocked behind data)."),
    # --- control plane endpooints (reference: driverHost/Port, executorPort 124-131)
    _Key("driver_host", "", "str", doc="Control-plane driver bind host."),
    _Key("driver_port", 0, "int", 0, 65535, doc="Control-plane driver port (0=ephemeral)."),
    _Key("executor_port", 0, "int", 0, 65535, doc="Executor control port (0=ephemeral)."),
    _Key("port_max_retries", 16, "int", 1, 1024, doc="Bind retry budget (ref portMaxRetries=16)."),
    _Key("connect_timeout_ms", 20000, "int", 1, 3600_000,
         doc="Per-attempt connect/event timeout (ref rdmaCmEventTimeout=20000)."),
    _Key("max_connection_attempts", 5, "int", 1, 100,
         doc="Connection retry budget (ref maxConnectionAttempts=5)."),
    _Key("teardown_timeout_ms", 50, "int", 1, 60000,
         doc="Listener join timeout at stop (ref teardownListenTimeout=50)."),
    _Key("partition_location_fetch_timeout_ms", 120000, "int", 1, 3600_000,
         doc="Timeout awaiting map-output locations (ref partitionLocationFetchTimeout)."),
    # --- observability (reference: stats keys 114-123, 133-141)
    _Key("wire_compress", False, "bool",
         doc="Compress DCN block-fetch payloads (zlib) — the analogue of the "
             "engine-level shuffle block compression the reference inherits."),
    _Key("wire_compress_min", "8k", "bytes", 0, 1 << 30,
         doc="Minimum payload size worth compressing."),
    _Key("wire_codec", "", "str",
         doc="Wire codec for fetch payloads ('hmac-sha256', 'aes-gcm', or "
             "engine-registered) — the encryption half of the reference's "
             "stream wrapping (scala/RdmaShuffleReader.scala:118-128)."),
    _Key("wire_codec_key", "", "str",
         doc="Hex key material for wire_codec (aes-gcm: 16/24/32 bytes)."),
    _Key("trace_file", "", "str",
         doc="Write a chrome://tracing JSON of shuffle spans here at stop."),
    _Key("collect_shuffle_reader_stats", False, "bool",
         doc="Collect per-remote fetch-latency histograms (ref collectShuffleReaderStats)."),
    _Key("fetch_time_bucket_size_ms", 300, "int", 1, 60000,
         doc="Histogram bucket width (ref fetchTimeBucketSizeInMs=300)."),
    _Key("fetch_time_num_buckets", 5, "int", 1, 1000,
         doc="Histogram bucket count (ref fetchTimeNumBuckets=5)."),
    # --- TPU-only: mesh / staging
    _Key("mesh_axis_name", "shuffle", "str", doc="TPU-only: mesh axis for the exchange."),
    _Key("staging_threads", 4, "int", 1, 256,
         doc="TPU-only: host threads for spill-file gather into staging buffers."),
    _Key("use_cpp_runtime", True, "bool",
         doc="TPU-only: use the C++ arena/staging shim when built; else pure-Python."),
    _Key("block_server_threads", 1, "int", 1, 256,
         doc="Native block server epoll worker count; connections shard "
             "round-robin (ref java/RdmaNode.java:222-279 cpu vector)."),
    _Key("block_server_cpus", "", "str",
         doc="Comma-separated cores to pin block-server workers to; empty = "
             "no pinning (ref cpuList + java/RdmaThread.java:46-48)."),
    _Key("registered_region_budget", 0, "bytes", 0, 1 << 44,
         doc="Mapped-bytes budget of the native block server's "
             "registered-region pool. Committed outputs, merged segments "
             "and external tokens register by path (one open/fstat) and "
             "mmap on FIRST SERVE — registration-on-demand instead of "
             "eager mmap-at-commit; past the budget the least-recently-"
             "served unpinned mappings unmap (LRU) and remap on demand "
             "(serve.remap instants, bs stats 'remaps'). In-flight serves "
             "hold refcount pins, so eviction and unregister never unmap "
             "under a live read. 0 = unbounded (every registered file may "
             "stay mapped, the pre-pool behavior minus the eager map)."),
    _Key("serve_zero_copy", True, "bool",
         doc="Native serve fast path: responses frame as a small header "
             "plus sendmsg/writev windows STRAIGHT from the registered "
             "mapping — constant server CPU per request regardless of "
             "bytes served. With CRC trailers on, a block whose range "
             "tiles the at-rest sidecar / merge-ledger attested ranges "
             "reuses the committed CRC32s (crc32_combine across ranges) "
             "and stays zero-copy; unaligned ranges fall back to "
             "copy-and-recompute per block. Off = always copy (the "
             "regression escape hatch and the serve bench's memcpy "
             "baseline; responses byte-identical either way)."),
    _Key("native_fetch", True, "bool",
         doc="Native client fetch engine (csrc/fetchclient.cpp): the "
             "coalesced dataplane's vectored reads submit doorbell-"
             "batched through a C epoll loop and their response payloads "
             "land DIRECTLY in BufferPool lease memory — no Python bytes "
             "object, no intermediate copy, CRC trailers verified in C. "
             "Engages only where the wire bytes are already exactly the "
             "lease bytes: coalesce_reads on, a pool present, the peer "
             "advertising a native block port, and no wire_compress/"
             "wire_codec. Any anomaly (bad status, CRC mismatch, torn "
             "connection) re-runs that request through the Python "
             "fetcher's retry/suspect/checksum envelope, so results are "
             "byte-identical by construction. Off (or a pre-client .so) "
             "= today's pure-Python receive path, bit-identical."),
    _Key("fetch_doorbell_batch", 16, "int", 1, 4096,
         doc="Vectored read requests queued per native-fetch doorbell: "
             "the engine submits up to this many frames per peer, then "
             "rings once (ONE writev carries the whole batch) and "
             "scatters completions as they land. 1 = a flush per "
             "request (no batching, the latency-first setting); larger "
             "values amortize syscalls on wide reduce fan-ins. Also "
             "bounds the planned-push sender's raw-frame batches when "
             "it rides the same engine."),
    _Key("task_threads", 4, "int", 1, 1024,
         doc="Worker threads for shipped engine tasks per executor "
             "(Spark's executor task slots analogue)."),
    _Key("task_timeout_ms", 600_000, "int", 1000, 86_400_000,
         doc="Driver-side wait budget for one shipped task."),
    # --- fault tolerance (TPU-only: the reference's whole failure story is
    # "surface FetchFailedException and recompute"; these keys harden the
    # path that gets there — see docs/FAULT_TOLERANCE.md)
    _Key("heartbeat_interval_ms", 2000, "int", 0, 3600_000,
         doc="Peer-health heartbeat period for peers with fetches in "
             "flight; 0 disables the monitor. A peer missing "
             "heartbeat_misses consecutive beats is declared suspect and "
             "its outstanding fetches fail immediately instead of waiting "
             "out a TCP timeout."),
    _Key("heartbeat_misses", 3, "int", 1, 100,
         doc="Consecutive missed heartbeats before a peer is declared "
             "suspect (worst-case detection ~ 2 x interval x misses)."),
    _Key("fetch_retry_budget", 2, "int", 0, 100,
         doc="Refetch attempts per remote call beyond the first for "
             "TRANSIENT failures (connect refusal, request deadline, "
             "checksum mismatch, transient server error). Fatal outcomes "
             "(suspect/tombstoned peer, authoritative unknown-map/shuffle) "
             "escalate to FetchFailed immediately."),
    _Key("retry_backoff_base_ms", 50, "int", 1, 60_000,
         doc="Exponential-backoff base between retries (connect re-dials "
             "and fetch retries); attempt k sleeps in [s/2, s] with "
             "s = min(cap, base * 2^k) — equal jitter, so the retry "
             "budget provably spans wall-clock time."),
    _Key("retry_backoff_cap_ms", 2000, "int", 1, 3600_000,
         doc="Exponential-backoff ceiling between retries."),
    _Key("fetch_checksum", True, "bool",
         doc="CRC32 per block on control-path fetch responses (FLAG_CRC32 "
             "trailer, computed before compression/codec). Mismatches "
             "refetch within fetch_retry_budget before escalating to "
             "FetchFailed. Native block-server responses are unchecksummed "
             "and verified only when the flag is present."),
    _Key("spill_dirs", "", "str",
         doc="Comma-separated FALLBACK spill directories for the write "
             "path. A spill that fails with a transient disk error "
             "(ENOSPC, EIO, torn write) retries with backoff into the "
             "next healthy directory; a directory accumulating "
             "spill_dir_max_failures consecutive failures is quarantined "
             "for the executor's lifetime. Empty = primary spill dir "
             "only (a transient failure still retries in place)."),
    _Key("spill_dir_max_failures", 2, "int", 1, 1000,
         doc="Consecutive spill failures before a spill directory is "
             "quarantined (skipped by every later spill and recovery "
             "sweep ordering; a success resets the count)."),
    _Key("spill_retry_budget", 2, "int", 0, 100,
         doc="Spill write retries beyond the first attempt for TRANSIENT "
             "disk errors (ENOSPC/EIO/EAGAIN/torn write), with the same "
             "exponential backoff as fetch retries. ENOSPC additionally "
             "halves the writer's spill threshold so later spills are "
             "smaller. Fatal errors (EACCES, EROFS, ...) and an "
             "exhausted budget fail the attempt cleanly — every tmp and "
             "spill file reaped — as a WriteFailedError the map stage "
             "can re-place on another executor."),
    _Key("at_rest_checksum", False, "bool",
         doc="Write a CRC32 sidecar (<data>.crc: per-partition + whole-"
             "file CRCs + the commit's fencing token) at commit, verify "
             "it on mmap-open after a restart (recover() drops corrupt "
             "or unattested files so the map recomputes), and spot-check "
             "at serve time: first serve of each partition on the Python "
             "data path, first location serve of each output when a "
             "native block server carries the data bytes. A corrupt "
             "output serves STATUS_CORRUPT (retryable) and routes into "
             "blame -> re-execution. Off by default: commits pay one "
             "streaming CRC pass when enabled."),
    # --- metadata plane (TPU-only: epoch-versioned location tables,
    # sharded driver state, warm iterative reuse — shuffle/location_plane.py,
    # docs/CONFIG.md "Metadata plane")
    _Key("location_epoch_cache", True, "bool",
         doc="Epoch-validated local cache of location metadata (driver "
             "table + per-map block-location entries). Warm-path reads — "
             "superstep N over an unchanged shuffle — resolve every "
             "location locally and put ZERO metadata RPCs on the wire; "
             "invalidation arrives as a pushed epoch bump (executor "
             "loss, re-execution, unregister). Off = no location "
             "caching at all — every read re-pays the full metadata "
             "round trips (the regression escape hatch, and what the "
             "iterative bench's cold mode measures)."),
    _Key("metadata_shards", 0, "int", 0, 4096,
         doc="Shard the driver's per-shuffle location table by map-range "
             "across up to this many executors: reducers' cold-path "
             "table syncs long-poll the shard hosts instead of "
             "serializing on the driver endpoint. 0 = off (driver-hosted "
             "only). Without shard_ownership the shards are read "
             "REPLICAS (the driver applies every publish and forwards "
             "it); with it they are partitioned write OWNERS. Any "
             "shard-host failure falls back to the driver, which stays "
             "authoritative either way."),
    _Key("shard_ownership", False, "bool",
         doc="Promote metadata shards from read replicas to partitioned "
             "write OWNERS: executors publish map entries and merged-"
             "directory updates DIRECTLY to the shard host owning that "
             "map-range (one hop, no driver round-trip). Each owner "
             "runs the fence CAS for its range, streams a per-shard op "
             "log to a standby, and batch-converges applied writes into "
             "the driver table (shard_batch_entries), so the driver-"
             "visible table stays byte-identical to the unsharded path. "
             "Membership changes hand ownership off generation-forward "
             "(sealed logs fence stale owners). Requires "
             "metadata_shards > 0; off = PR-6 replica forwarding."),
    _Key("shard_batch_entries", 16, "int", 1, 4096,
         doc="Ownership-mode batching: a shard owner flushes its applied "
             "publishes to the driver once this many accumulate (a "
             "background flusher also drains partial batches every few "
             "milliseconds, so convergence lag is bounded). Higher = "
             "fewer driver wakeups per publish; lower = tighter driver "
             "freshness."),
    _Key("warm_read_cache", False, "bool",
         doc="Cross-stage shuffle-output reuse (shuffle/dist_cache.py): "
             "a reducer's materialized partition range is kept, keyed by "
             "location epoch, and iteration N+1 over the unchanged "
             "shuffle serves it locally instead of re-fetching — zero "
             "RPCs, zero bytes moved. Epoch bumps (re-execution, "
             "executor loss) invalidate; bounded by dist_cache_budget. "
             "Off by default: it trades executor memory for superstep "
             "latency, a profile only iterative jobs want."),
    _Key("dist_cache_budget", "256m", "bytes", 0, 1 << 44,
         doc="Byte budget for the worker-process shuffle cache "
             "(dist_cache: mesh-reduce results + warm read cache). Past "
             "it, whole-shuffle entries evict LRU (dist_cache.evicted "
             "counts them) so cross-stage reuse can't OOM a long "
             "iterative job. 0 disables caching entirely."),
    # --- adaptive reduce planning (TPU-only: shuffle/planner.py,
    # docs/CONFIG.md "Reduce planning")
    _Key("adaptive_plan", False, "bool",
         doc="Skew-aware reduce planning: map publishes carry their "
             "per-partition byte sizes to the driver, which aggregates "
             "them into a SizeHistogram and emits an epoch-stamped "
             "ReducePlan at map-stage completion — coalescing runs of "
             "tiny partitions into one reducer, splitting hot partitions "
             "across reducers by map-range (deterministic merge in map "
             "order), and placing each reducer for locality. The plan is "
             "pushed on the announce channel (ReducePlanMsg) and "
             "resolved cache-first; recovery re-plans mid-stage after an "
             "executor loss (orphaned tasks only, bumped plan epoch). "
             "Off by default: uniform workloads get the identity plan "
             "anyway, and the size vectors cost P*4 bytes per publish."),
    _Key("coalesce_target_bytes", "1m", "bytes", 0, 1 << 40,
         doc="Adaptive-plan coalescing target: contiguous runs of "
             "partitions whose total bytes stay at or under this merge "
             "into ONE reducer task (served as one wider vectored "
             "fetch). A partition larger than this always gets its own "
             "task; 0 disables coalescing."),
    _Key("split_threshold_bytes", "32m", "bytes", 1 << 10, 1 << 44,
         doc="Adaptive-plan split threshold: a partition carrying more "
             "bytes than this splits across ceil(bytes/threshold) "
             "reducer tasks by map-range (bounded by the map count and "
             "2x the live-executor count), boundaries on the size "
             "histogram's per-map prefix sums so slices are near-equal. "
             "The split tasks' outputs concatenate deterministically in "
             "map order."),
    _Key("locality_placement", True, "bool",
         doc="Adaptive-plan placement: each reducer task prefers the "
             "executor already holding the largest share of its input "
             "bytes, under a balance cap (no slot takes more than 1.5x "
             "the even share) so locality can't recreate the straggler "
             "it exists to remove. Off = tasks carry no placement "
             "preference (round-robin execution)."),
    # --- push-merge shuffle dataplane (TPU-only: shuffle/push_merge.py,
    # docs/CONFIG.md "Push-merge")
    _Key("push_merge", False, "bool",
         doc="Magnet-style background push-merge: committed map outputs "
             "are pushed (fence attached) to merge_replicas peer "
             "executors chosen by partition-range, each appending into a "
             "per-(shuffle, partition) merged segment with a per-block "
             "CRC+fence ledger. Segments finalize at map-stage "
             "completion (driver broadcast) and publish into the "
             "driver's merged directory; reducers resolve "
             "merged-segment-first — ONE sequential vectored read per "
             "partition instead of an M-way per-map fan-in — falling "
             "back per-map for unmerged stragglers or CRC-bad segments, "
             "and recovery re-points to a replica instead of "
             "re-executing maps a live replica covers. Off by default: "
             "pushes cost one extra copy of the shuffle's bytes on the "
             "wire and K copies on peer disks."),
    _Key("merge_replicas", 1, "int", 0, 16,
         doc="Merge replicas per reduce partition (the K of push-merge): "
             "each committed map's per-partition blocks are pushed to "
             "this many peer executors chosen by partition-range "
             "(pushers never target themselves, so a replica always "
             "survives its producer). 0 disables pushing even with "
             "push_merge on. K>=2 lets an executor loss re-point to a "
             "surviving replica with ZERO map re-executions."),
    _Key("push_deadline_ms", 10000, "int", 1, 3600_000,
         doc="Push staleness bound: a queued push older than this is "
             "dropped (the straggler map stays per-map-fetched, never "
             "blocks the stage); also bounds how long a merge target's "
             "finalize waits for the push channel to quiesce."),
    _Key("merge_segment_max_bytes", "256m", "bytes", 1 << 16, 1 << 44,
         doc="Cap on one per-(shuffle, partition) merged segment file: "
             "pushed blocks that would grow a segment past this are "
             "rejected (their maps stay per-map-fetched for that "
             "partition), bounding merge-target disk per partition."),
    # --- cold tier (TPU-only: shuffle/cold_tier.py,
    # docs/CONFIG.md "Cold tier")
    _Key("cold_tier", False, "bool",
         doc="Disaggregated cold shuffle tier (requires push_merge): "
             "finalized merged segments upload in the background to a "
             "blob store (whole files + their ledger CRCs; fence-"
             "superseded ranges already excluded at finalize) and "
             "publish into the driver's HA-replicated TieredDirectory. "
             "Reducers resolve the TIERED location class LAST — after "
             "pushed staging, merged replicas, and per-map, before "
             "re-execution — so merge segments outlive the fleet: a "
             "full-fleet restart reduces from the cold tier byte-"
             "identically with zero map re-executions. Upload failure "
             "degrades to hot-only serving; tiering never fails a job."),
    _Key("cold_tier_path", "", "str",
         doc="Root of the in-tree local-filesystem blob backend (the "
             "BlobStore contract is shaped so an object store slots in "
             "later). Empty = ~/.sparkrdma_cold. Must be shared "
             "(network FS) for a restarted fleet to restore from it."),
    _Key("tier_upload_budget", "64m", "bytes", 1 << 16, 1 << 44,
         doc="Bound on in-flight upload BYTES in the TieringService "
             "queue: a finalize submitted past it is SHED (the segment "
             "simply stays hot-only) — backpressure never propagates "
             "into the publish path."),
    _Key("tier_retry_budget", 2, "int", 0, 64,
         doc="Upload retries per blob PUT (restores ride "
             "fetch_retry_budget like every read). Retries back off "
             "exponentially from retry_backoff_base_ms up to "
             "retry_backoff_cap_ms. Exhaustion degrades the segment to "
             "hot-only serving."),
    # --- planned push (TPU-only: shuffle/pushed_store.py,
    # docs/CONFIG.md "Planned push")
    _Key("planned_push", False, "bool",
         doc="Sender-driven planned shuffle: once the ReducePlan lands "
             "(requires adaptive_plan), each committed map's bytes are "
             "pushed during the map stage to the PLANNED reducer slot "
             "for every unsplit partition (PushPlannedReq, double-"
             "fenced: attempt fence + plan epoch). The receiving "
             "PushedInputStore stages the ranges and the fetcher "
             "resolves them FIRST — a reducer whose inputs all arrived "
             "starts with zero metadata and zero data RPCs; any hole "
             "(dropped push, re-plan, over-budget shed) falls back to "
             "the merged/per-map dataplanes byte-identically. Off by "
             "default: pushes cost one extra copy of the shuffle's "
             "bytes on the wire."),
    _Key("push_staging_budget", "64m", "bytes", 0, 1 << 44,
         doc="Per-executor budget for planned-push staging held in "
             "BufferPool leases: pushed ranges past it spill to disk "
             "under <spill_dir>/pushed/, charged to the owning tenant's "
             "spill quota (tenant_spill_quota) — a range neither budget "
             "admits is shed, and its partitions stay pull-fetched. "
             "0 sends every pushed range straight to disk."),
    # --- device exchange dataplane (TPU-only: parallel/device_plane.py,
    # docs/CONFIG.md "Device exchange")
    _Key("device_plane", "auto", "str",
         doc="Which dataplane carries on-mesh stages: 'auto' asks the "
             "cost model (stage residency, estimated bytes vs the "
             "device_hbm_budget round sizing, topology support from "
             "resolve_impl), 'device' forces the fused ICI "
             "partition+exchange+sort plane, 'host' forces the "
             "writer->resolver->fetcher dataplane (the regression "
             "escape hatch). Regardless of selection, a stage whose "
             "exchange overflows its skew headroom or loses an "
             "executor mid-stage degrades itself to the host plane."),
    _Key("device_hbm_budget", "64m", "bytes", 1 << 16, 1 << 40,
         doc="Per-device HBM byte budget for one fused exchange round: "
             "rounds auto-size to rows_per_round = budget / "
             "(row_bytes * (2 + 2*out_factor)) — input + grouped copy "
             "+ receive + sorted copy — replacing the static "
             "mesh_rows_per_round knob (still honored when set, "
             "deprecated). Stages whose bytes fit one round run as a "
             "single fused step; larger stages stream double-buffered "
             "rounds (round k+1's collective dispatches while round "
             "k's on-device sort runs)."),
    _Key("request_deadline_ms", 0, "int", 0, 3600_000,
         doc="Per-request completion deadline on the control plane "
             "(request/AsyncFetch waits); 0 = fall back to "
             "connect_timeout_ms. A response landing after the deadline is "
             "routed to the orphan path so flow-control credits still "
             "heal."),
    _Key("mesh_rows_per_round", 0, "int", 0, 1 << 31,
         doc="DEPRECATED: static per-device rows per fused exchange "
             "round. 0 (the default) lets rounds auto-size from "
             "device_hbm_budget — the preferred sizing; a nonzero value "
             "still pins the round size (one deprecation warning per "
             "process) so mixed-version configs stay parseable."),
    # --- tenancy / multi-tenant service (TPU-only: shuffle/tenancy.py,
    # docs/CONFIG.md "Tenancy")
    _Key("fair_share_serving", True, "bool",
         doc="Deficit-round-robin fair-share scheduling on BOTH serve "
             "paths (the Python serve loop and the native block "
             "server's request queue): block requests queue per tenant "
             "of the shuffle being served and dispatch by byte-cost "
             "DRR, so one tenant's wide fan-in cannot starve another "
             "tenant's latency-sensitive fetch. The registered-region "
             "pool's LRU eviction also prefers regions of tenants over "
             "their even share of registered_region_budget. With one "
             "tenant (every pre-tenancy deployment) DRR degenerates to "
             "FIFO exactly. Off = plain FIFO serving (the regression "
             "escape hatch and the isolation bench's baseline)."),
    _Key("fair_share_quantum_bytes", "256k", "bytes", 1024, 1 << 30,
         doc="DRR quantum: bytes each tenant's serve queue may dispatch "
             "per scheduling round. Smaller = tighter latency isolation "
             "but more rounds; the default matches "
             "shuffle_read_block_size so one per-map read is one "
             "quantum."),
    _Key("admission_max_inflight", 0, "int", 0, 1 << 20,
         doc="Per-tenant cap on concurrently registered (in-flight) "
             "shuffles at the driver. Past it, registerShuffle parks in "
             "a bounded FIFO queue and — past admission_queue_depth or "
             "the park deadline — is rejected with an AdmissionRejected "
             "carrying a retry-after hint, shedding load cleanly "
             "instead of OOMing shared pools. 0 = no admission control "
             "(the pre-tenancy behavior)."),
    _Key("admission_queue_depth", 16, "int", 0, 1 << 20,
         doc="Queued registerShuffle calls allowed per tenant past its "
             "in-flight cap before queue-or-reject rejects outright."),
    _Key("admission_retry_after_ms", 1000, "int", 1, 3600_000,
         doc="How long a queued registerShuffle parks for a slot before "
             "rejection — and the retry-after hint an AdmissionRejected "
             "carries either way."),
    _Key("shuffle_ttl_ms", 0, "int", 0, 86_400_000,
         doc="Shuffle idle time-to-live: the driver's GC sweep "
             "unregisters shuffles UNTOUCHED (no publish, no driver "
             "table sync) for longer than this (terminal EPOCH_DEAD "
             "push; executors reap committed outputs, merged segments "
             "and overflow blobs from disk on receipt), so abandoned "
             "jobs can't leak spill-dir bytes forever. Warm iterative "
             "jobs issue zero driver RPCs by design — size the TTL "
             "above their run or leave it 0 = no TTL (explicit "
             "unregister only)."),
    _Key("tenant_pool_quota", 0, "bytes", 0, 1 << 44,
         doc="Per-tenant byte quota on BufferPool leases (the "
             "leased_bytes gauge, charged at bin size): a tenant's "
             "writers/readers/pushers leasing past it get a "
             "TenantQuotaError instead of dragging every co-hosted "
             "tenant into the pool's high-water trim. 0 = unbounded "
             "(single-tenant behavior)."),
    _Key("tenant_spill_quota", 0, "bytes", 0, 1 << 44,
         doc="Per-tenant byte quota on local shuffle disk: committed "
             "map outputs plus merged segments charge the owning "
             "tenant; a commit past the quota fails cleanly (tmp "
             "reaped, TenantQuotaError) and a merge push past it is "
             "rejected like a full segment (its maps stay per-map-"
             "fetched). 0 = unbounded."),
    _Key("tenant_cache_quota", 0, "bytes", 0, 1 << 44,
         doc="Per-tenant byte cap inside dist_cache_budget. 0 = an even "
             "share of the budget across tenants holding cached "
             "shuffles. Either way evictions are charged to the "
             "INSERTING tenant only — a cold bulk job can evict its own "
             "LRU shuffles, never another tenant's warm iterative "
             "ranges (cross-tenant eviction is regression-tested to "
             "zero)."),
    _Key("tenant_hbm_quota", 0, "bytes", 0, 1 << 40,
         doc="Per-tenant device-HBM budget for fused exchange round "
             "sizing. 0 = device_hbm_budget split evenly across tenants "
             "with registered shuffles (dynamic sizing, NP-RDMA-style, "
             "instead of static partitioning); nonzero pins each "
             "tenant's slice. Single-tenant stages see the full "
             "budget either way."),
    # --- elastic membership (TPU-only: parallel/membership.py,
    # docs/CONFIG.md "Membership")
    _Key("min_executors", 0, "int", 0, 1 << 20,
         doc="Autoscaler floor: the fleet never drains below this many "
             "live executors (0 = floor of 1 — a fleet cannot scale to "
             "zero while the driver holds registered shuffles)."),
    _Key("max_executors", 0, "int", 0, 1 << 20,
         doc="Autoscaler ceiling: scale-up never grows the fleet past "
             "this many live executors. 0 = unbounded (the current "
             "live count is its own ceiling until a backlog appears)."),
    _Key("drain_deadline_ms", 30000, "int", 1, 3600_000,
         doc="Graceful-drain budget per decommission: the drainee's "
             "replication pass plus the driver's coverage wait must "
             "finish within it, or the drain FALLS BACK to the "
             "ordinary tombstone path (recovery re-executes what no "
             "replica covers — byte-identical, just not free). Also "
             "the default deadline a DrainReq without one carries."),
    _Key("autoscale_interval_ms", 0, "int", 0, 3600_000,
         doc="Autoscaler evaluation period. 0 = the loop never starts "
             "(attach_autoscaler still works; call tick() manually). "
             "Scale-down needs two consecutive idle ticks, so the "
             "effective shrink latency is twice this."),
    # --- two-level topology (TPU-only: parallel/topology.py,
    # docs/CONFIG.md "Topology")
    _Key("slice_topology", "", "str",
         doc="Slice grouping of the mesh's devices along the exchange "
             "axis: '' = auto-derive from device slice_index / "
             "process_index (single-host CPU meshes collapse to one "
             "slice — the degenerate, pre-topology behavior); 'N' = N "
             "equal contiguous slices (virtual slicing for CI/benches); "
             "'a,b,c' = explicit per-slice device counts (must sum to "
             "the device count). Invalid specs fall back to auto. The "
             "same spec partitions executor SLOTS for the reduce "
             "planner's link-cost placement."),
    _Key("ici_gbps", 100.0, "float", 0.001, 1e6,
         doc="Intra-slice (ICI) link bandwidth coefficient in GB/s for "
             "the two-level cost model. Only the RATIO to dcn_gbps "
             "matters for plan ranking; seed from the platform's "
             "datasheet and refine from a probe/bench round "
             "(Topology.refine)."),
    _Key("dcn_gbps", 10.0, "float", 0.001, 1e6,
         doc="Inter-slice (DCN / host-link) bandwidth coefficient in "
             "GB/s for the two-level cost model — the first-class "
             "inter-host channel cost. Defaults model the order-of-"
             "magnitude ICI:DCN gap of production TPU pods."),
    _Key("hierarchical_exchange", True, "bool",
         doc="Let the cost model emit HIERARCHICAL plans on multi-slice "
             "topologies: fused ICI all-to-all within each slice, host/"
             "DCN channel only for the slice-crossing residue, composed "
             "as a factored two-phase redistribution. Off = the flat "
             "selector (device-or-host for the whole stage, the "
             "regression escape hatch); single-slice meshes are "
             "unaffected either way."),
    # --- driver HA (TPU-only: shuffle/ha.py, docs/CONFIG.md "Driver HA")
    _Key("ha_standbys", 0, "int", 0, 16,
         doc="Replicated-driver standby count the deployment intends to "
             "run (0 = HA off, the single-driver behavior — no op log "
             "kept, no lease taken). Nonzero arms the driver's OpLog "
             "and lets StandbyHello registrations stream it; the value "
             "itself is advisory (standbys register dynamically) but "
             "gates the whole subsystem so non-HA deployments pay "
             "nothing."),
    _Key("driver_lease_ms", 5000, "int", 100, 3600_000,
         doc="Driver leadership lease TTL. The primary renews at a "
             "quarter of this; a standby whose poll sees the lease "
             "expired CAS-takes the next term and promotes. This is "
             "the failover detection bound AND the zombie-primary "
             "window bound: a deposed primary can keep pushing for at "
             "most one lease after losing renewal, and every such push "
             "is fenced by its stale incarnation. Size it well under "
             "request_deadline_ms so executor retries ride through a "
             "failover."),
    _Key("oplog_snapshot_every", 256, "int", 1, 1 << 20,
         doc="Op-log compaction period: after this many appended ops "
             "the primary folds state into a fresh snapshot and "
             "truncates the tail, bounding both standby catch-up time "
             "and driver memory. Smaller = faster cold-standby "
             "catch-up, more snapshot encode work on the mutation "
             "path."),
]

_KEY_MAP: Dict[str, _Key] = {k.name: k for k in _KEYS}


class TpuShuffleConf:
    """Range-validated view over a flat string config map.

    Like the reference (scala/RdmaShuffleConf.scala:36-47), invalid values
    never raise at read time: they log-and-default. Unknown keys under the
    prefix are ignored.
    """

    def __init__(self, conf: Optional[Mapping[str, Any]] = None, **overrides: Any):
        self._raw: Dict[str, Any] = {}
        for src in (conf or {}), overrides:
            for key, value in src.items():
                name = key[len(PREFIX):] if key.startswith(PREFIX) else key
                name = name.replace(".", "_")
                self._raw[name] = value
        self._cache: Dict[str, Any] = {}

    def _get(self, name: str) -> Any:
        if name in self._cache:
            return self._cache[name]
        spec = _KEY_MAP[name]
        raw = self._raw.get(name, spec.default)
        try:
            if spec.kind == "bytes":
                val = parse_bytes(raw)
            elif spec.kind == "int":
                val = int(raw)
            elif spec.kind == "float":
                val = float(raw)
            elif spec.kind == "bool":
                val = raw if isinstance(raw, bool) else str(raw).strip().lower() in ("1", "true", "yes", "on")
            else:
                val = str(raw)
            if spec.kind in ("bytes", "int", "float"):
                if (spec.min is not None and val < spec.min) or (spec.max is not None and val > spec.max):
                    raise ValueError(f"{val} out of [{spec.min}, {spec.max}]")
        except (ValueError, TypeError):
            # Fall back to the validated default, reference behavior
            # (scala/RdmaShuffleConf.scala:36-47).
            val = parse_bytes(spec.default) if spec.kind == "bytes" else spec.default
        self._cache[name] = val
        return val

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        if name in _KEY_MAP:
            return self._get(name)
        raise AttributeError(f"unknown config key: {name}")

    def resolved_request_deadline_s(self) -> float:
        """Per-request completion deadline in seconds: the configured
        ``request_deadline_ms``, or (when 0) the connect timeout — the
        pre-deadline behavior, so existing deployments see no change."""
        ms = self.request_deadline_ms
        return (ms if ms > 0 else self.connect_timeout_ms) / 1000

    def resolved_read_ahead_depth(self) -> int:
        """The effective per-peer read-ahead window: the configured depth,
        or (when 0/auto) the reference's ``sendQueueDepth / cores`` split
        (RdmaShuffleFetcherIterator.scala:82-83), floored at 1."""
        import os

        depth = self.read_ahead_depth
        if depth <= 0:
            depth = self.send_queue_depth // max(1, os.cpu_count() or 1)
        return max(1, depth)

    def resolved_max_fetch_blocks(self) -> int:
        """Block-count bound for one data request frame: the configured
        value, or (when 0/auto) derived from the native server's inbound
        frame cap — ``(kMaxReqFrame / 8 - fixed) / block_size`` — so the
        Python planner can never build a request the C++ server rejects,
        with the same 8x margin the old hardcoded 8192 kept below the
        server's in-flight buffering high-water mark."""
        from sparkrdma_tpu_torch.parallel import messages as M

        explicit = self.max_fetch_blocks
        derived = ((M.NATIVE_MAX_REQ_FRAME // 8 - M.BLOCKS_REQ_FIXED_BYTES)
                   // M.BLOCK_WIRE_BYTES)
        # even an explicit value is clamped to what ONE native frame can
        # physically carry: past it the C++ server drops the connection
        # as a protocol error, which no retry heals
        hard = ((M.NATIVE_MAX_REQ_FRAME - M.BLOCKS_REQ_FIXED_BYTES)
                // M.BLOCK_WIRE_BYTES)
        return max(1, min(explicit if explicit > 0 else derived, hard))

    def resolved_spill_dirs(self) -> list:
        """The parsed ``spill_dirs`` fallback list (may be empty)."""
        return [d.strip() for d in str(self.spill_dirs).split(",")
                if d.strip()]

    def prealloc_spec(self) -> Dict[int, int]:
        """Parse 'size:count,size:count' into {bytes: count}.

        Reference: preAllocateBuffers parsing (scala/RdmaShuffleConf.scala:100-106,
        consumed at scala/RdmaShuffleManager.scala:227-231).
        """
        spec: Dict[int, int] = {}
        text = self.prealloc_buffers.strip()
        if not text:
            return spec
        for part in text.split(","):
            try:
                size_s, count_s = part.split(":")
                size, count = parse_bytes(size_s), int(count_s)
                if size > 0 and count > 0:
                    spec[size] = spec.get(size, 0) + count
            except ValueError:
                continue
        return spec

    def to_dict(self) -> Dict[str, Any]:
        return {k.name: self._get(k.name) for k in _KEYS}

    @staticmethod
    def keys() -> Dict[str, str]:
        """name -> one-line doc, for help output."""
        return {k.name: k.doc for k in _KEYS}

    def __repr__(self) -> str:
        shown = {k: v for k, v in self.to_dict().items() if k in self._raw}
        return f"TpuShuffleConf({shown})"
