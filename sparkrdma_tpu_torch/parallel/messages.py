"""Control-plane message set beyond hello/announce.

The reference needs only two RPC types because everything else is one-sided
RDMA (scala/RdmaRpcMsg.scala:29-32). Without a NIC to do one-sided reads,
the TPU control plane carries those flows as explicit messages — but they
remain exactly the reference's three-level scheme:

* ``PublishMsg``      — the 12-byte driver-table entry WRITE at
                        ``map_id * MAP_ENTRY_SIZE``
                        (scala/RdmaShuffleManager.scala:384-418).
* ``FetchTableReq/Resp`` — the whole-driver-table READ, once per
                        (shuffle, executor) (scala/RdmaShuffleManager.scala:341-376).
* ``FetchOutputReq/Resp`` — the per-(map, reduce-range) block-location READ
                        of 16-byte entries out of the owning executor
                        (scala/RdmaShuffleFetcherIterator.scala:293-315).
* ``FetchOutputsReq/Resp`` — the batched form: ONE request returns the
                        16-byte location entries of MANY maps' output
                        tables for one reduce range — O(peers) instead of
                        O(maps) metadata round trips, the role the
                        reference's fetch-a-peer's-whole-address-table-once
                        plays (scala/RdmaShuffleManager.scala:341-376).
                        The per-map form stays as the mixed-version
                        fallback.
* ``FetchBlocksReq/Resp`` — the scatter data READ (DCN fallback path; on-mesh
                        traffic rides the ICI ragged all-to-all instead)
                        (scala/RdmaShuffleFetcherIterator.scala:119-180).
                        The block list may span different maps and buffer
                        tokens — one VECTORED request per coalesced window
                        of cross-map ranges; both the Python and native
                        servers gather the ranges in request order into a
                        single response with a per-sub-block CRC32 trailer.

The METADATA PLANE (shuffle/location_plane.py) adds the one-sided
publication frames that remove the request/reply cycle from warm-path
location resolution ("RPC Considered Harmful", PAPERS.md):

* ``EpochBumpMsg``     — driver -> executors push: shuffle S's location
                        state is now version E (or gone, E = EPOCH_DEAD).
                        Rides the same broadcast channel as announces, so
                        invalidation is pushed, never polled.
* ``ShardMapMsg``      — driver -> executors push at registerShuffle: the
                        map-range -> shard-host assignment, so a reducer
                        knows whom to ask without a driver round trip.
* ``ShardEntryMsg``    — driver -> shard host: one applied driver-table
                        entry forwarded into the host's shard replica (the
                        positional WRITE of the reference, re-aimed at a
                        shard host instead of the one driver table).
* ``FetchShardReq/Resp`` — reducer -> shard host: long-poll read of one
                        driver-table map-range out of the shard replica —
                        thousand-reducer fan-in spreads over shard hosts
                        instead of serializing on the driver endpoint.

All carry a ``req_id`` echo so clients can pipeline requests per connection
the way the reference pipelines work requests on a QP.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

from sparkrdma_tpu_torch.parallel.rpc_msg import RpcMsg, register

_QIII = struct.Struct("<qiii")
_QI = struct.Struct("<qi")
_Q = struct.Struct("<q")
_BLOCK = struct.Struct("<IQI")  # (buf token, offset, length)

# Native block-server request-frame geometry, mirrored from
# csrc/blockserver.cpp so Python-side request planning can be DERIVED from
# the C++ limit instead of hardcoding a constant that silently drifts
# (tests/test_fetch_coalesced.py greps the .cpp to keep them in lockstep):
#   kMaxReqFrame — hard cap on one inbound frame on the data port;
#   frame layout — [total:4][type:4][req_id:8][shuffle:4][count:4][blocks].
NATIVE_MAX_REQ_FRAME = 1 << 20          # csrc/blockserver.cpp kMaxReqFrame
BLOCKS_REQ_FIXED_BYTES = 8 + _QI.size + 4   # header + req_id/shuffle + count
BLOCK_WIRE_BYTES = _BLOCK.size          # one (buf, offset, length) range
# Response-frame fixed prefix (csrc/fetchclient.cpp kRespFixedBytes): the
# native CLIENT parses [total:4][type:4][req_id:8][status:4][flags:4]
# before scattering the payload into lease memory.
BLOCKS_RESP_FIXED_BYTES = 8 + _QI.size + 4  # header + req_id/status + flags


@register()
class PublishMsg(RpcMsg):
    """Executor -> driver: positional driver-table entry write.

    ``fence`` is the committing attempt's fencing token: the driver
    rejects a publish whose fence is older than the one already applied
    for the same (map, executor), so a zombie speculative attempt that
    commits late cannot clobber the winner's location entry. Appended
    after the fixed 12-byte entry; a fence-less (pre-fencing) payload
    decodes with fence 0, which never out-fences anything.

    ``lengths`` (adaptive reduce planning, shuffle/planner.py) is the
    map output's per-partition byte sizes — the u32 "length" column of
    its MapTaskOutput table, which the writer already has in hand at
    commit. Appended after the fence as ``count:u32 + u32[count]`` so
    the driver can aggregate a SizeHistogram without any extra round
    trip; omitted (count absent) when ``adaptive_plan`` is off, and a
    pre-planning payload decodes with ``lengths=None``."""

    ENTRY_BYTES = 12

    def __init__(self, shuffle_id: int, map_id: int, entry: bytes,
                 fence: int = 0, lengths=None):
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.entry = entry
        self.fence = fence
        self.lengths = list(lengths) if lengths is not None else None

    def payload(self) -> bytes:
        out = (struct.pack("<ii", self.shuffle_id, self.map_id)
               + self.entry + struct.pack("<q", self.fence))
        if self.lengths is not None:
            out += struct.pack(f"<I{len(self.lengths)}I",
                               len(self.lengths), *self.lengths)
        return out

    @classmethod
    def from_payload(cls, payload: bytes) -> "PublishMsg":
        shuffle_id, map_id = struct.unpack_from("<ii", payload, 0)
        entry = payload[8:8 + cls.ENTRY_BYTES]
        fence = 0
        lengths = None
        off = 8 + cls.ENTRY_BYTES
        if len(payload) >= off + 8:
            (fence,) = struct.unpack_from("<q", payload, off)
            off += 8
        if len(payload) >= off + 4:
            (n,) = struct.unpack_from("<I", payload, off)
            if len(payload) >= off + 4 + 4 * n:
                lengths = list(struct.unpack_from(f"<{n}I", payload,
                                                  off + 4))
        return cls(shuffle_id, map_id, entry, fence, lengths)


# Wire type 4 reserved — see rpc_msg.RESERVED_WIRE_IDS (was an ack;
# publish is one-sided like the reference's RDMA WRITE, so nothing acks).


@register()
class FetchTableReq(RpcMsg):
    """``min_published > 0`` turns the fetch into a long-poll: the driver
    holds the response until that many maps have published (or
    ``timeout_ms`` passes, answering with the partial table) — one
    request per reducer instead of a poll loop against the driver, the
    role the reference's known-complete one-sided READ plays
    (scala/RdmaShuffleManager.scala:341-376)."""

    def __init__(self, req_id: int, shuffle_id: int,
                 min_published: int = 0, timeout_ms: int = 0):
        self.req_id = req_id
        self.shuffle_id = shuffle_id
        self.min_published = min_published
        self.timeout_ms = timeout_ms

    def payload(self) -> bytes:
        return (_QI.pack(self.req_id, self.shuffle_id)
                + struct.pack("<ii", self.min_published, self.timeout_ms))

    @classmethod
    def from_payload(cls, payload: bytes) -> "FetchTableReq":
        req_id, shuffle_id = _QI.unpack_from(payload, 0)
        min_published, timeout_ms = struct.unpack_from("<ii", payload,
                                                       _QI.size)
        return cls(req_id, shuffle_id, min_published, timeout_ms)


@register()
class FetchTableResp(RpcMsg):
    """num_published lets clients poll until the maps they need have
    committed (client-side analogue of the reference's wait on
    partitionLocationFetchTimeout). ``epoch`` stamps the table bytes with
    the shuffle's location-state version (location_plane): a reducer
    caches the table under this epoch and serves later supersteps from
    the cache until an ``EpochBumpMsg`` invalidates it."""

    def __init__(self, req_id: int, num_published: int, table: bytes,
                 epoch: int = 0):
        self.req_id = req_id
        self.num_published = num_published
        self.table = table
        self.epoch = epoch

    def payload(self) -> bytes:
        return (_QI.pack(self.req_id, self.num_published)
                + _Q.pack(self.epoch) + self.table)

    @classmethod
    def from_payload(cls, payload: bytes) -> "FetchTableResp":
        req_id, num_published = _QI.unpack_from(payload, 0)
        rest = payload[_QI.size:]
        # Mixed-version tolerance: a pre-metadata-plane peer sends no
        # epoch field. The table is whole MAP_ENTRY_SIZE (12-byte)
        # driver-table entries, so the i64 epoch's presence is decidable
        # from the length residue: 8 mod 12 when it leads, 0 mod 12 when
        # it does not. A legacy payload decodes with epoch 0, which
        # never validates a cache entry — staleness costs a re-sync,
        # never correctness.
        epoch = 0
        if len(rest) % PublishMsg.ENTRY_BYTES == _Q.size:
            (epoch,) = _Q.unpack_from(rest, 0)
            rest = rest[_Q.size:]
        return cls(req_id, num_published, bytes(rest), epoch)


@register()
class FetchOutputReq(RpcMsg):
    """Read 16B location entries [start, end) of one map's output table."""

    def __init__(self, req_id: int, shuffle_id: int, map_id: int,
                 start_partition: int, end_partition: int):
        self.req_id = req_id
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.start_partition = start_partition
        self.end_partition = end_partition

    def payload(self) -> bytes:
        return _QIII.pack(self.req_id, self.shuffle_id, self.map_id,
                          self.start_partition) + struct.pack("<i", self.end_partition)

    @classmethod
    def from_payload(cls, payload: bytes) -> "FetchOutputReq":
        req_id, shuffle_id, map_id, start = _QIII.unpack_from(payload, 0)
        (end,) = struct.unpack_from("<i", payload, _QIII.size)
        return cls(req_id, shuffle_id, map_id, start, end)


@register()
class FetchOutputResp(RpcMsg):
    def __init__(self, req_id: int, status: int, entries: bytes):
        self.req_id = req_id
        self.status = status
        self.entries = entries

    def payload(self) -> bytes:
        return _QI.pack(self.req_id, self.status) + self.entries

    @classmethod
    def from_payload(cls, payload: bytes) -> "FetchOutputResp":
        req_id, status = _QI.unpack_from(payload, 0)
        return cls(req_id, status, payload[_QI.size:])


@register()
class FetchBlocksReq(RpcMsg):
    """Scatter-read: list of (buf token, offset, length) to pack in order."""

    def __init__(self, req_id: int, shuffle_id: int,
                 blocks: List[Tuple[int, int, int]]):
        self.req_id = req_id
        self.shuffle_id = shuffle_id
        self.blocks = list(blocks)

    def payload(self) -> bytes:
        head = _QI.pack(self.req_id, self.shuffle_id)
        body = b"".join(_BLOCK.pack(t, o, ln) for t, o, ln in self.blocks)
        return head + struct.pack("<I", len(self.blocks)) + body

    @classmethod
    def from_payload(cls, payload: bytes) -> "FetchBlocksReq":
        req_id, shuffle_id = _QI.unpack_from(payload, 0)
        off = _QI.size
        (n,) = struct.unpack_from("<I", payload, off)
        off += 4
        blocks = []
        for _ in range(n):
            t, o, ln = _BLOCK.unpack_from(payload, off)
            off += _BLOCK.size
            blocks.append((t, o, ln))
        return cls(req_id, shuffle_id, blocks)


FLAG_ZLIB = 1     # FetchBlocksResp.flags: payload is zlib-compressed
FLAG_WRAPPED = 2  # payload passed through the configured wire codec
                  # (utils/codecs.py; applied after compression, so
                  # readers unwrap first)
FLAG_CRC32 = 4    # the logical payload carries a trailer of one
                  # little-endian u32 CRC32 per requested block, appended
                  # BEFORE compression/codec so the check is end-to-end
                  # (server read -> client consume). Readers verify and
                  # strip; both the Python responder and the native block
                  # server (bs_set_checksum) set it, and a responder that
                  # can't checksum simply doesn't set the flag. Per-BLOCK
                  # granularity is what lets a vectored (cross-map) read
                  # isolate a corrupt sub-range to one map and refetch
                  # only the affected ranges.

_QII = struct.Struct("<qii")


@register()
class FetchBlocksResp(RpcMsg):
    def __init__(self, req_id: int, status: int, data: bytes, flags: int = 0):
        self.req_id = req_id
        self.status = status
        self.data = data
        self.flags = flags

    def payload(self) -> bytes:
        return _QII.pack(self.req_id, self.status, self.flags) + self.data

    @classmethod
    def from_payload(cls, payload: bytes) -> "FetchBlocksResp":
        req_id, status, flags = _QII.unpack_from(payload, 0)
        return cls(req_id, status, payload[_QII.size:], flags)


@register()
class RunTaskReq(RpcMsg):
    """Ship one serialized task to an executor (the role Spark's task
    scheduler plays for the reference: tasks arrive at executors with the
    shuffle handle in their closure, scala/RdmaUtils.scala:145-159).
    Payload is an opaque serialized descriptor (engine-defined)."""

    def __init__(self, req_id: int, payload: bytes):
        self.req_id = req_id
        self.data = payload

    def payload(self) -> bytes:
        return struct.pack("<q", self.req_id) + self.data

    @classmethod
    def from_payload(cls, payload: bytes) -> "RunTaskReq":
        (req_id,) = struct.unpack_from("<q", payload, 0)
        return cls(req_id, payload[8:])


@register()
class RunTaskResp(RpcMsg):
    """status: TASK_OK / TASK_ERROR / TASK_FETCH_FAILED; payload is the
    serialized result or error detail."""

    def __init__(self, req_id: int, status: int, payload: bytes):
        self.req_id = req_id
        self.status = status
        self.data = payload

    def payload(self) -> bytes:
        return struct.pack("<qi", self.req_id, self.status) + self.data

    @classmethod
    def from_payload(cls, payload: bytes) -> "RunTaskResp":
        req_id, status = struct.unpack_from("<qi", payload, 0)
        return cls(req_id, status, payload[12:])


@register()
class CreditReport(RpcMsg):
    """Reader -> server: ``consumed`` logical response bytes were drained
    by the consumer — replenish that much of this connection's serving
    credit window. The receiver-driven half of flow control: the server
    reserves a response's logical size from the window before building it
    and PARKS when the window is exhausted, so a stalled consumer bounds
    the server's queued response bytes instead of growing them
    (java/RdmaChannel.java:61-64, 744-787 — credits granted by recv queue
    depth, replenished by credit reports every recvDepth/8 reclaims)."""

    def __init__(self, consumed: int):
        self.consumed = consumed

    def payload(self) -> bytes:
        return _Q.pack(self.consumed)

    @classmethod
    def from_payload(cls, payload: bytes) -> "CreditReport":
        (consumed,) = _Q.unpack_from(payload, 0)
        return cls(consumed)


@register()
class GetBroadcastReq(RpcMsg):
    """Executor -> driver: fetch a broadcast blob by id (the delivery
    half of shared_vars.Broadcast — once per executor PROCESS, cached
    there, so N tasks cost one transfer like Spark's TorrentBroadcast
    costs one fetch per executor)."""

    def __init__(self, req_id: int, bcast_id: int):
        self.req_id = req_id
        self.bcast_id = bcast_id

    def payload(self) -> bytes:
        return struct.pack("<qq", self.req_id, self.bcast_id)

    @classmethod
    def from_payload(cls, payload: bytes) -> "GetBroadcastReq":
        req_id, bcast_id = struct.unpack_from("<qq", payload, 0)
        return cls(req_id, bcast_id)


@register()
class GetBroadcastResp(RpcMsg):
    """status STATUS_OK with the pickled blob, or STATUS_ERROR when the
    id is unknown (unpersisted or never registered)."""

    def __init__(self, req_id: int, status: int, data: bytes):
        self.req_id = req_id
        self.status = status
        self.data = data

    def payload(self) -> bytes:
        return struct.pack("<qi", self.req_id, self.status) + self.data

    @classmethod
    def from_payload(cls, payload: bytes) -> "GetBroadcastResp":
        req_id, status = struct.unpack_from("<qi", payload, 0)
        return cls(req_id, status, payload[12:])


@register()
class PingMsg(RpcMsg):
    """Peer-health probe (endpoint heartbeat monitor): carries a
    ``req_id`` so it rides the same ``request_async`` pipelining as
    fetches — a pong is just the echoed completion. Deliberately tiny:
    the monitor's cost must stay negligible next to data traffic."""

    def __init__(self, req_id: int):
        self.req_id = req_id

    def payload(self) -> bytes:
        return _Q.pack(self.req_id)

    @classmethod
    def from_payload(cls, payload: bytes) -> "PingMsg":
        (req_id,) = _Q.unpack_from(payload, 0)
        return cls(req_id)


@register()
class PongMsg(RpcMsg):
    """Echoed heartbeat completion."""

    def __init__(self, req_id: int):
        self.req_id = req_id

    def payload(self) -> bytes:
        return _Q.pack(self.req_id)

    @classmethod
    def from_payload(cls, payload: bytes) -> "PongMsg":
        (req_id,) = _Q.unpack_from(payload, 0)
        return cls(req_id)


@register()
class FetchOutputsReq(RpcMsg):
    """Batched block-location read: the 16B entries [start, end) of MANY
    maps' output tables in one round trip (one per (shuffle, peer) for
    reducers with coalesced reads on — the metadata half of the RPC-count
    reduction). ``map_ids`` is explicit rather than a range: a reducer
    only asks for the maps the driver table routed to this peer."""

    def __init__(self, req_id: int, shuffle_id: int, map_ids: List[int],
                 start_partition: int, end_partition: int):
        self.req_id = req_id
        self.shuffle_id = shuffle_id
        self.map_ids = list(map_ids)
        self.start_partition = start_partition
        self.end_partition = end_partition

    def payload(self) -> bytes:
        head = (_QIII.pack(self.req_id, self.shuffle_id,
                           self.start_partition, self.end_partition)
                + struct.pack("<I", len(self.map_ids)))
        return head + struct.pack(f"<{len(self.map_ids)}i", *self.map_ids)

    @classmethod
    def from_payload(cls, payload: bytes) -> "FetchOutputsReq":
        req_id, shuffle_id, start, end = _QIII.unpack_from(payload, 0)
        (n,) = struct.unpack_from("<I", payload, _QIII.size)
        map_ids = list(struct.unpack_from(f"<{n}i", payload, _QIII.size + 4))
        return cls(req_id, shuffle_id, map_ids, start, end)


@register()
class FetchOutputsResp(RpcMsg):
    """Per-map records ``(map_id, status, entries)`` in request order.
    ``status`` is the overall verdict (a non-OK overall status carries no
    records); per-map statuses let one unknown map answer authoritatively
    without hiding the other maps' entries."""

    def __init__(self, req_id: int, status: int,
                 records: List[Tuple[int, int, bytes]]):
        self.req_id = req_id
        self.status = status
        self.records = list(records)

    def payload(self) -> bytes:
        out = [_QI.pack(self.req_id, self.status),
               struct.pack("<I", len(self.records))]
        for map_id, status, entries in self.records:
            out.append(struct.pack("<iiI", map_id, status, len(entries)))
            out.append(entries)
        return b"".join(out)

    @classmethod
    def from_payload(cls, payload: bytes) -> "FetchOutputsResp":
        req_id, status = _QI.unpack_from(payload, 0)
        off = _QI.size
        (n,) = struct.unpack_from("<I", payload, off)
        off += 4
        records = []
        for _ in range(n):
            map_id, mstatus, nbytes = struct.unpack_from("<iiI", payload, off)
            off += 12
            records.append((map_id, mstatus, payload[off:off + nbytes]))
            off += nbytes
        return cls(req_id, status, records)


# Epoch sentinel: the shuffle is unregistered — caches drop their state
# entirely instead of re-validating against a version that will never
# exist again.
EPOCH_DEAD = -1


@register()
class EpochBumpMsg(RpcMsg):
    """Driver -> executors push: shuffle ``shuffle_id``'s location state
    is now version ``epoch`` (monotone per shuffle; ``EPOCH_DEAD`` =
    unregistered). Sent on the announce/broadcast channel whenever the
    driver table is REPAIRED (re-execution overwrote an entry), an
    executor is tombstoned, or the shuffle unregisters — the push that
    replaces cache-TTL polling (invalidation is an event, not a timer).
    One-sided like a publish: no reply, problems observable driver-side
    only; a lost push is backstopped by the fetch-failure path (a stale
    location fails its fetch, which invalidates the cache the hard
    way)."""

    def __init__(self, shuffle_id: int, epoch: int):
        self.shuffle_id = shuffle_id
        self.epoch = epoch

    def payload(self) -> bytes:
        return struct.pack("<iq", self.shuffle_id, self.epoch)

    @classmethod
    def from_payload(cls, payload: bytes) -> "EpochBumpMsg":
        shuffle_id, epoch = struct.unpack_from("<iq", payload, 0)
        return cls(shuffle_id, epoch)


@register()
class ShardMapMsg(RpcMsg):
    """Driver -> executors push at registerShuffle time: the map-range ->
    shard-host assignment for one shuffle (location_plane.ShardMap wire
    form). Reducers use it to aim cold-path table reads at shard hosts
    instead of the driver; executors that never receive it (late
    joiners) simply stay on the driver path — the shard plane is an
    optimization, the driver remains authoritative."""

    def __init__(self, shuffle_id: int, epoch: int, num_maps: int,
                 shard_slots: List[int]):
        self.shuffle_id = shuffle_id
        self.epoch = epoch
        self.num_maps = num_maps
        self.shard_slots = list(shard_slots)

    def payload(self) -> bytes:
        head = struct.pack("<iqiI", self.shuffle_id, self.epoch,
                           self.num_maps, len(self.shard_slots))
        return head + struct.pack(f"<{len(self.shard_slots)}i",
                                  *self.shard_slots)

    @classmethod
    def from_payload(cls, payload: bytes) -> "ShardMapMsg":
        shuffle_id, epoch, num_maps, n = struct.unpack_from("<iqiI",
                                                            payload, 0)
        slots = list(struct.unpack_from(f"<{n}i", payload, 20))
        return cls(shuffle_id, epoch, num_maps, slots)


@register()
class ShardEntryMsg(RpcMsg):
    """Driver -> shard host: one APPLIED driver-table entry forwarded
    into the host's shard replica (the driver stays the fencing
    authority — only publishes that survived the fence CAS are
    forwarded, so replicas can never serve a zombie attempt's
    location). One-sided, no reply; ``num_maps`` lets the replica answer
    shard completeness without ever having seen the ShardMapMsg."""

    def __init__(self, shuffle_id: int, epoch: int, map_id: int,
                 num_maps: int, entry: bytes):
        self.shuffle_id = shuffle_id
        self.epoch = epoch
        self.map_id = map_id
        self.num_maps = num_maps
        self.entry = entry

    def payload(self) -> bytes:
        return struct.pack("<iqii", self.shuffle_id, self.epoch,
                           self.map_id, self.num_maps) + self.entry

    @classmethod
    def from_payload(cls, payload: bytes) -> "ShardEntryMsg":
        shuffle_id, epoch, map_id, num_maps = struct.unpack_from(
            "<iqii", payload, 0)
        return cls(shuffle_id, epoch, map_id, num_maps, payload[20:])


@register()
class FetchShardReq(RpcMsg):
    """Reducer -> shard host: long-poll read of driver-table entries
    [map_lo, map_hi) out of the host's shard replica. Same long-poll
    contract as ``FetchTableReq`` (``min_published`` counts published
    maps WITHIN the range; ``timeout_ms`` bounds the hold) so a reducer
    syncs each shard with one request instead of polling — and the
    thousand-reducer fan-in lands on shard hosts, not the driver."""

    def __init__(self, req_id: int, shuffle_id: int, map_lo: int,
                 map_hi: int, min_published: int = 0, timeout_ms: int = 0):
        self.req_id = req_id
        self.shuffle_id = shuffle_id
        self.map_lo = map_lo
        self.map_hi = map_hi
        self.min_published = min_published
        self.timeout_ms = timeout_ms

    def payload(self) -> bytes:
        return (_QI.pack(self.req_id, self.shuffle_id)
                + struct.pack("<iiii", self.map_lo, self.map_hi,
                              self.min_published, self.timeout_ms))

    @classmethod
    def from_payload(cls, payload: bytes) -> "FetchShardReq":
        req_id, shuffle_id = _QI.unpack_from(payload, 0)
        map_lo, map_hi, min_published, timeout_ms = struct.unpack_from(
            "<iiii", payload, _QI.size)
        return cls(req_id, shuffle_id, map_lo, map_hi, min_published,
                   timeout_ms)


@register()
class FetchShardResp(RpcMsg):
    """``num_published`` counts published maps within the requested
    range (-1 = the host holds no replica for the shuffle — the client
    falls back to the driver); ``table`` is the range's MAP_ENTRY_SIZE
    entries in map order, UNPUBLISHED-filled where nothing has been
    forwarded yet; ``epoch`` stamps the replica's version."""

    def __init__(self, req_id: int, num_published: int, epoch: int,
                 table: bytes):
        self.req_id = req_id
        self.num_published = num_published
        self.epoch = epoch
        self.table = table

    def payload(self) -> bytes:
        return (_QI.pack(self.req_id, self.num_published)
                + _Q.pack(self.epoch) + self.table)

    @classmethod
    def from_payload(cls, payload: bytes) -> "FetchShardResp":
        req_id, num_published = _QI.unpack_from(payload, 0)
        (epoch,) = _Q.unpack_from(payload, _QI.size)
        return cls(req_id, num_published, epoch,
                   payload[_QI.size + _Q.size:])


@register()
class ReducePlanMsg(RpcMsg):
    """Driver -> executors push: the shuffle's reduce plan (adaptive
    skew-aware planning, shuffle/planner.py) — an epoch-stamped,
    one-sided, driver-published artifact like the location tables it
    rides beside. Pushed at plan build and on every mid-stage re-plan
    (bumped ``plan_epoch``); reducers cache it in their LocationPlane
    and resolve cache-first. A lost push is backstopped by the pull
    path (``FetchPlanReq``). ``payload`` is ``ReducePlan.to_bytes()``."""

    def __init__(self, plan_bytes: bytes):
        self.plan_bytes = plan_bytes

    def payload(self) -> bytes:
        return self.plan_bytes

    @classmethod
    def from_payload(cls, payload: bytes) -> "ReducePlanMsg":
        return cls(payload)


@register()
class FetchPlanReq(RpcMsg):
    """Reducer -> driver: pull one shuffle's current reduce plan (the
    cold path / lost-push backstop of ``ReducePlanMsg``)."""

    def __init__(self, req_id: int, shuffle_id: int):
        self.req_id = req_id
        self.shuffle_id = shuffle_id

    def payload(self) -> bytes:
        return _QI.pack(self.req_id, self.shuffle_id)

    @classmethod
    def from_payload(cls, payload: bytes) -> "FetchPlanReq":
        req_id, shuffle_id = _QI.unpack_from(payload, 0)
        return cls(req_id, shuffle_id)


@register()
class FetchPlanResp(RpcMsg):
    """``STATUS_OK`` with the plan bytes; ``STATUS_ERROR`` when the
    driver holds no plan (adaptive planning off, or the map stage has
    not completed) — the reducer falls back to the identity plan;
    ``STATUS_UNKNOWN_SHUFFLE`` when the shuffle is unregistered."""

    def __init__(self, req_id: int, status: int, plan_bytes: bytes):
        self.req_id = req_id
        self.status = status
        self.plan_bytes = plan_bytes

    def payload(self) -> bytes:
        return _QI.pack(self.req_id, self.status) + self.plan_bytes

    @classmethod
    def from_payload(cls, payload: bytes) -> "FetchPlanResp":
        req_id, status = _QI.unpack_from(payload, 0)
        return cls(req_id, status, payload[_QI.size:])


# -- push-merge dataplane (shuffle/push_merge.py) -------------------------
#
# Magnet-style background merge: committed map outputs are PUSHED to K
# peer executors chosen by partition-range, each appending into a
# per-(shuffle, partition) segment file with a per-block CRC+fence
# ledger; finalized segments publish one-sided into the driver's merged
# directory and are served by the EXISTING block server (one vectored
# read per partition, no extra server CPU in the read path — the
# one-sided discipline of "RPC Considered Harmful"), with pushes riding
# the same line-rate framing as every other data frame (Tiara,
# PAPERS.md). Reducers resolve merged-segment-first and fall back
# per-map; recovery re-points to a replica instead of re-executing.

PUSH_KIND_MERGE = 0     # per-partition blocks into merged segments
PUSH_KIND_OVERFLOW = 1  # tiered-spill overflow blob (fetched back at merge)
PUSH_KIND_DRAIN = 2     # drain re-push: like MERGE, but may REOPEN an
#                         already-finalized segment (the driver
#                         re-finalizes after the drainee's DrainResp)
PUSH_KIND_PLANNED = 3   # planned push: reduce inputs to their PLANNED
#                         reducer slot (PushPlannedReq, plan-epoch
#                         fenced), not to a merge-range peer


@register()
class PushBlocksReq(RpcMsg):
    """Executor -> merge target: one committed map's per-partition blocks
    for a contiguous partition range (``kind=PUSH_KIND_MERGE``), or one
    opaque spill-overflow blob (``kind=PUSH_KIND_OVERFLOW`` — tiered
    spill overflowing to a peer on ENOSPC; ``sizes`` then carries the
    blob's per-partition layout so the writer can fetch ranges back).
    ``fence`` is the committing attempt's fencing token: the target's
    ledger rejects a push whose fence is older than one already applied
    for the same map, and a newer fence supersedes the stale blocks
    (excluded from the finalized ranges). ``data`` is the concatenation
    of the ``sizes`` segments in partition order."""

    def __init__(self, req_id: int, shuffle_id: int, map_id: int,
                 fence: int, kind: int, start_partition: int,
                 sizes: List[int], data: bytes):
        self.req_id = req_id
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.fence = fence
        self.kind = kind
        self.start_partition = start_partition
        self.sizes = list(sizes)
        self.data = data

    def payload(self) -> bytes:
        head = (struct.pack("<qiiq", self.req_id, self.shuffle_id,
                            self.map_id, self.fence)
                + struct.pack("<iiI", self.kind, self.start_partition,
                              len(self.sizes))
                + struct.pack(f"<{len(self.sizes)}I", *self.sizes))
        return head + self.data

    @classmethod
    def from_payload(cls, payload: bytes) -> "PushBlocksReq":
        req_id, shuffle_id, map_id, fence = struct.unpack_from("<qiiq",
                                                               payload, 0)
        kind, start, n = struct.unpack_from("<iiI", payload, 24)
        sizes = list(struct.unpack_from(f"<{n}I", payload, 36))
        return cls(req_id, shuffle_id, map_id, fence, kind, start, sizes,
                   payload[36 + 4 * n:])


@register()
class PushBlocksResp(RpcMsg):
    """Merge target's verdict: ``accepted`` is one byte per pushed
    partition (1 = appended into the segment ledger, 0 = rejected —
    stale fence, finalized shuffle, or a segment at
    ``merge_segment_max_bytes``). For overflow pushes ``token`` names
    the stored blob in the target's serving token space so the writer
    fetches it back over the ordinary data plane."""

    def __init__(self, req_id: int, status: int, token: int,
                 accepted: bytes):
        self.req_id = req_id
        self.status = status
        self.token = token
        self.accepted = accepted

    def payload(self) -> bytes:
        return (struct.pack("<qiq", self.req_id, self.status, self.token)
                + self.accepted)

    @classmethod
    def from_payload(cls, payload: bytes) -> "PushBlocksResp":
        req_id, status, token = struct.unpack_from("<qiq", payload, 0)
        return cls(req_id, status, token, payload[20:])


@register()
class PushPlannedReq(RpcMsg):
    """Executor -> PLANNED reducer slot: one committed map's bytes for
    the contiguous partition range the receiver's plan task owns, pushed
    during the map stage so the reduce stage starts with the inputs
    already local. Double-fenced: ``fence`` is the committing attempt's
    fencing token (a newer attempt's push supersedes a stale one for the
    same ``(partition, map)``, exactly the merge-ledger discipline) and
    ``plan_epoch`` stamps the ReducePlan the sender routed by — the
    receiving PushedInputStore rejects pushes older than its plan epoch
    and releases every staged range stamped older when a re-plan lands,
    so a mid-stage re-plan supersedes stale pushes and orphaned tasks
    re-pull. ``data`` is the concatenation of the ``sizes`` segments in
    partition order starting at ``start_partition``."""

    def __init__(self, req_id: int, shuffle_id: int, map_id: int,
                 fence: int, plan_epoch: int, start_partition: int,
                 sizes: List[int], data: bytes):
        self.req_id = req_id
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.fence = fence
        self.plan_epoch = plan_epoch
        self.start_partition = start_partition
        self.sizes = list(sizes)
        self.data = data

    def payload(self) -> bytes:
        head = (struct.pack("<qiiqq", self.req_id, self.shuffle_id,
                            self.map_id, self.fence, self.plan_epoch)
                + struct.pack("<iI", self.start_partition,
                              len(self.sizes))
                + struct.pack(f"<{len(self.sizes)}I", *self.sizes))
        return head + self.data

    @classmethod
    def from_payload(cls, payload: bytes) -> "PushPlannedReq":
        (req_id, shuffle_id, map_id, fence,
         plan_epoch) = struct.unpack_from("<qiiqq", payload, 0)
        start, n = struct.unpack_from("<iI", payload, 32)
        sizes = list(struct.unpack_from(f"<{n}I", payload, 40))
        return cls(req_id, shuffle_id, map_id, fence, plan_epoch, start,
                   sizes, payload[40 + 4 * n:])


@register()
class PushPlannedResp(RpcMsg):
    """Planned-push verdict: ``accepted`` is one byte per pushed
    partition (1 = staged in the PushedInputStore, 0 = rejected — stale
    plan epoch, stale attempt fence, over-budget shed, or dead/unknown
    shuffle). Rejection is never an error for the sender: the range
    simply stays a hole the reducer fills over the merged/per-map
    dataplanes."""

    def __init__(self, req_id: int, status: int, accepted: bytes):
        self.req_id = req_id
        self.status = status
        self.accepted = accepted

    def payload(self) -> bytes:
        return _QI.pack(self.req_id, self.status) + self.accepted

    @classmethod
    def from_payload(cls, payload: bytes) -> "PushPlannedResp":
        req_id, status = _QI.unpack_from(payload, 0)
        return cls(req_id, status, payload[_QI.size:])


@register()
class FinalizeSegmentsReq(RpcMsg):
    """Driver -> executors (broadcast on the announce channel at
    map-stage completion, ``req_id=0`` — one-sided, no reply) or an
    explicit request (``req_id>0``): stop accepting pushes for the
    shuffle once the push channel quiesces, seal every per-partition
    segment, and publish the results into the driver's merged
    directory."""

    def __init__(self, req_id: int, shuffle_id: int):
        self.req_id = req_id
        self.shuffle_id = shuffle_id

    def payload(self) -> bytes:
        return _QI.pack(self.req_id, self.shuffle_id)

    @classmethod
    def from_payload(cls, payload: bytes) -> "FinalizeSegmentsReq":
        req_id, shuffle_id = _QI.unpack_from(payload, 0)
        return cls(req_id, shuffle_id)


@register()
class FinalizeSegmentsResp(RpcMsg):
    """``finalized`` counts the segments this target sealed+published."""

    def __init__(self, req_id: int, status: int, finalized: int):
        self.req_id = req_id
        self.status = status
        self.finalized = finalized

    def payload(self) -> bytes:
        return struct.pack("<qii", self.req_id, self.status,
                           self.finalized)

    @classmethod
    def from_payload(cls, payload: bytes) -> "FinalizeSegmentsResp":
        req_id, status, finalized = struct.unpack_from("<qii", payload, 0)
        return cls(req_id, status, finalized)


@register()
class MergedPublishMsg(RpcMsg):
    """Merge target -> driver: one finalized merged segment, one-sided
    like ``PublishMsg`` (no ack — the driver's directory is repaired by
    later finalize rounds, and a lost publish only costs coverage).
    ``covered`` is a bitmap over the shuffle's map space (bit m set =
    the segment holds map m's bytes for this partition, under the
    newest fence the ledger saw); ``ranges`` the byte ranges of the
    segment file that survived fence supersession (usually one
    ``[0, nbytes)`` range); ``crc32`` the CRC32 of those ranges
    concatenated, verified REDUCER-side after the fetch so at-rest rot
    on the replica degrades to per-map fetch, never to wrong bytes."""

    def __init__(self, shuffle_id: int, partition_id: int,
                 exec_index: int, token: int, nbytes: int, crc32: int,
                 covered: bytes, ranges: List[Tuple[int, int]]):
        self.shuffle_id = shuffle_id
        self.partition_id = partition_id
        self.exec_index = exec_index
        self.token = token
        self.nbytes = nbytes
        self.crc32 = crc32
        self.covered = covered
        self.ranges = [(int(o), int(ln)) for o, ln in ranges]

    def payload(self) -> bytes:
        head = (struct.pack("<iii", self.shuffle_id, self.partition_id,
                            self.exec_index)
                + struct.pack("<qqI", self.token, self.nbytes, self.crc32)
                + struct.pack("<II", len(self.covered), len(self.ranges)))
        body = self.covered + b"".join(
            struct.pack("<QI", o, ln) for o, ln in self.ranges)
        return head + body

    @classmethod
    def from_payload(cls, payload: bytes) -> "MergedPublishMsg":
        shuffle_id, partition_id, exec_index = struct.unpack_from(
            "<iii", payload, 0)
        token, nbytes, crc = struct.unpack_from("<qqI", payload, 12)
        ncov, nranges = struct.unpack_from("<II", payload, 32)
        off = 40
        covered = payload[off:off + ncov]
        off += ncov
        ranges = []
        for _ in range(nranges):
            o, ln = struct.unpack_from("<QI", payload, off)
            ranges.append((o, ln))
            off += 12
        return cls(shuffle_id, partition_id, exec_index, token, nbytes,
                   crc, covered, ranges)


@register()
class FetchMergedReq(RpcMsg):
    """Reducer -> driver: pull one shuffle's merged-segment directory
    (cache-first in the location plane under the location epoch; this
    is the cold path / lost-coverage backstop)."""

    def __init__(self, req_id: int, shuffle_id: int):
        self.req_id = req_id
        self.shuffle_id = shuffle_id

    def payload(self) -> bytes:
        return _QI.pack(self.req_id, self.shuffle_id)

    @classmethod
    def from_payload(cls, payload: bytes) -> "FetchMergedReq":
        req_id, shuffle_id = _QI.unpack_from(payload, 0)
        return cls(req_id, shuffle_id)


@register()
class FetchMergedResp(RpcMsg):
    """``data`` is ``MergedDirectory.to_bytes()`` (possibly empty —
    nothing finalized yet); ``epoch`` stamps it with the shuffle's
    location-state version so the plane's cache validity rule applies
    unchanged. ``STATUS_UNKNOWN_SHUFFLE`` when unregistered."""

    def __init__(self, req_id: int, status: int, epoch: int, data: bytes):
        self.req_id = req_id
        self.status = status
        self.epoch = epoch
        self.data = data

    def payload(self) -> bytes:
        return (_QI.pack(self.req_id, self.status) + _Q.pack(self.epoch)
                + self.data)

    @classmethod
    def from_payload(cls, payload: bytes) -> "FetchMergedResp":
        req_id, status = _QI.unpack_from(payload, 0)
        (epoch,) = _Q.unpack_from(payload, _QI.size)
        return cls(req_id, status, epoch, payload[_QI.size + _Q.size:])


@register()
class TieredPublishMsg(RpcMsg):
    """Tiering executor -> driver: one cold-tier blob, one-sided like
    ``MergedPublishMsg`` (no ack — a lost publish only costs cold
    coverage; the hot copy still serves). ``blob_key`` names the blob
    in the configured store, ``covered`` is the map-space bitmap the
    blob's bytes carry for ``partition_id``, ``crc32`` the CRC32 over
    the WHOLE blob, verified reducer-side on restore so at-rest rot in
    the cold store degrades to the next resolve rung, never to wrong
    bytes. ``nbytes`` is u64: object stores hold blobs bigger than any
    one segment file. The directory it lands in is HA-replicated
    through the op log (shuffle/ha.py), so cold locations survive
    driver failover too."""

    def __init__(self, shuffle_id: int, partition_id: int, blob_key: str,
                 nbytes: int, crc32: int, covered: bytes):
        self.shuffle_id = shuffle_id
        self.partition_id = partition_id
        self.blob_key = blob_key
        self.nbytes = nbytes
        self.crc32 = crc32
        self.covered = covered

    def payload(self) -> bytes:
        key = self.blob_key.encode("utf-8")
        return (struct.pack("<ii", self.shuffle_id, self.partition_id)
                + struct.pack("<QI", self.nbytes, self.crc32)
                + struct.pack("<II", len(key), len(self.covered))
                + key + self.covered)

    @classmethod
    def from_payload(cls, payload: bytes) -> "TieredPublishMsg":
        shuffle_id, partition_id = struct.unpack_from("<ii", payload, 0)
        nbytes, crc = struct.unpack_from("<QI", payload, 8)
        nkey, ncov = struct.unpack_from("<II", payload, 20)
        off = 28
        key = payload[off:off + nkey].decode("utf-8")
        off += nkey
        covered = payload[off:off + ncov]
        return cls(shuffle_id, partition_id, key, nbytes, crc, covered)


@register()
class FetchTieredReq(RpcMsg):
    """Reducer -> driver: pull one shuffle's cold-tier directory (the
    LAST resolve rung — consulted only when pushed staging, merged
    replicas, and per-map owners have all degraded)."""

    def __init__(self, req_id: int, shuffle_id: int):
        self.req_id = req_id
        self.shuffle_id = shuffle_id

    def payload(self) -> bytes:
        return _QI.pack(self.req_id, self.shuffle_id)

    @classmethod
    def from_payload(cls, payload: bytes) -> "FetchTieredReq":
        req_id, shuffle_id = _QI.unpack_from(payload, 0)
        return cls(req_id, shuffle_id)


@register()
class FetchTieredResp(RpcMsg):
    """``data`` is ``TieredDirectory.to_bytes()`` (possibly empty —
    nothing tiered yet); ``epoch`` stamps it with the shuffle's
    location-state version. ``STATUS_UNKNOWN_SHUFFLE`` + ``EPOCH_DEAD``
    when unregistered."""

    def __init__(self, req_id: int, status: int, epoch: int, data: bytes):
        self.req_id = req_id
        self.status = status
        self.epoch = epoch
        self.data = data

    def payload(self) -> bytes:
        return (_QI.pack(self.req_id, self.status) + _Q.pack(self.epoch)
                + self.data)

    @classmethod
    def from_payload(cls, payload: bytes) -> "FetchTieredResp":
        req_id, status = _QI.unpack_from(payload, 0)
        (epoch,) = _Q.unpack_from(payload, _QI.size)
        return cls(req_id, status, epoch, payload[_QI.size + _Q.size:])


@register()
class TenantMapMsg(RpcMsg):
    """Driver -> executors push at registerShuffle time: shuffle
    ``shuffle_id`` belongs to tenant ``tenant`` (and expires
    ``ttl_ms`` after registration; 0 = no TTL). Executors key their
    serve-path fair-share queues, cache charging, and quota ledgers by
    it. One-sided like every push on the announce channel: a lost push
    (or a late-joining executor) degrades that executor's view of the
    shuffle to DEFAULT_TENANT — a fairness approximation, never a
    correctness problem, and the local writer/reader path re-teaches
    the mapping from the handle on first use."""

    def __init__(self, shuffle_id: int, tenant: int, ttl_ms: int):
        self.shuffle_id = shuffle_id
        self.tenant = tenant
        self.ttl_ms = ttl_ms

    def payload(self) -> bytes:
        return struct.pack("<iiq", self.shuffle_id, self.tenant,
                           self.ttl_ms)

    @classmethod
    def from_payload(cls, payload: bytes) -> "TenantMapMsg":
        shuffle_id, tenant, ttl_ms = struct.unpack_from("<iiq", payload, 0)
        return cls(shuffle_id, tenant, ttl_ms)


# -- elastic membership (parallel/membership.py) ---------------------------
#
# The membership plane's wire half: explicit mid-job joins, the pushed
# slot-state vector, and the graceful-drain request/response. All four
# frames are ADDITIVE — a pre-elastic peer that never sends or receives
# them sees exactly the static-membership protocol (announce-only), which
# is the documented mixed-version degrade.

@register()
class JoinMsg(RpcMsg):
    """Executor -> driver: an explicit mid-job JOIN. Same membership
    append as a HelloMsg (which remains the startup greeting and the
    legacy join), but names the intent so the driver traces the elastic
    event and bumps capacity hints immediately. ``flags`` is reserved
    (0); a pre-elastic payload without it decodes to 0."""

    FLAGS_NONE = 0

    def __init__(self, manager_id, flags: int = 0):
        self.manager_id = manager_id
        self.flags = flags

    def payload(self) -> bytes:
        return self.manager_id.serialize() + struct.pack("<I", self.flags)

    @classmethod
    def from_payload(cls, payload: bytes) -> "JoinMsg":
        from sparkrdma_tpu_torch.utils.ids import ShuffleManagerId
        mid, off = ShuffleManagerId.deserialize(payload)
        flags = 0
        if len(payload) >= off + 4:
            (flags,) = struct.unpack_from("<I", payload, off)
        return cls(mid, flags)


@register()
class MembershipBumpMsg(RpcMsg):
    """Driver -> all executors: the membership plane moved — epoch
    ``epoch`` with per-slot states ``slot_states`` (``SLOT_LIVE`` /
    ``SLOT_DRAINING`` / ``SLOT_DEAD``, one byte per announce slot).
    Rides the same broadcast channel as announces; receivers keep the
    highest epoch. Pushers stop choosing DRAINING slots as merge
    targets, fetch planners stop placing work there, and the health
    monitor registers newly-LIVE joiners. An epoch-only legacy payload
    (or a peer that drops the frame entirely) decodes to an empty state
    vector = every announced slot treated LIVE — the static-membership
    behavior."""

    def __init__(self, epoch: int, slot_states: List[int]):
        self.epoch = epoch
        self.slot_states = [int(s) for s in slot_states]

    def payload(self) -> bytes:
        return (_Q.pack(self.epoch)
                + struct.pack("<I", len(self.slot_states))
                + bytes(s & 0xFF for s in self.slot_states))

    @classmethod
    def from_payload(cls, payload: bytes) -> "MembershipBumpMsg":
        (epoch,) = _Q.unpack_from(payload, 0)
        states: List[int] = []
        if len(payload) >= _Q.size + 4:
            (n,) = struct.unpack_from("<I", payload, _Q.size)
            states = list(payload[_Q.size + 4:_Q.size + 4 + n])
        return cls(epoch, states)


@register()
class DrainReq(RpcMsg):
    """Driver -> drainee: replicate everything you own, you are being
    decommissioned. The drainee re-pushes its committed map outputs
    (``PUSH_KIND_DRAIN`` — ledger fences dedupe whatever background
    push-merge already delivered) and hands off the merged-segment rows
    it hosts for OTHER executors' maps, then answers ``DrainResp``.
    ``deadline_ms`` bounds the drainee-side work; a pre-elastic payload
    without it decodes to 0 = the receiver's configured
    ``drain_deadline_ms``."""

    def __init__(self, req_id: int, slot: int, deadline_ms: int = 0):
        self.req_id = req_id
        self.slot = slot
        self.deadline_ms = deadline_ms

    def payload(self) -> bytes:
        return _QI.pack(self.req_id, self.slot) + struct.pack(
            "<q", self.deadline_ms)

    @classmethod
    def from_payload(cls, payload: bytes) -> "DrainReq":
        req_id, slot = _QI.unpack_from(payload, 0)
        deadline_ms = 0
        if len(payload) >= _QI.size + 8:
            (deadline_ms,) = struct.unpack_from("<q", payload, _QI.size)
        return cls(req_id, slot, deadline_ms)


@register()
class DrainResp(RpcMsg):
    """Drainee -> driver: the replication pass finished. ``STATUS_OK``
    means every committed output was (re-)pushed and hosted segments
    handed off within the deadline; ``STATUS_ERROR`` means a partial or
    impossible drain (push-merge off, pusher dead) — the driver's
    coverage check decides whether existing replicas suffice or the
    drain falls back to tombstone recovery either way. ``maps_pushed``
    and ``bytes_pushed`` are the audit counters the drain result
    reports."""

    def __init__(self, req_id: int, status: int, maps_pushed: int,
                 bytes_pushed: int):
        self.req_id = req_id
        self.status = status
        self.maps_pushed = maps_pushed
        self.bytes_pushed = bytes_pushed

    def payload(self) -> bytes:
        return _QI.pack(self.req_id, self.status) + struct.pack(
            "<qq", self.maps_pushed, self.bytes_pushed)

    @classmethod
    def from_payload(cls, payload: bytes) -> "DrainResp":
        req_id, status = _QI.unpack_from(payload, 0)
        maps_pushed, bytes_pushed = struct.unpack_from(
            "<qq", payload, _QI.size)
        return cls(req_id, status, maps_pushed, bytes_pushed)


# Status codes shared by responses.
STATUS_OK = 0
STATUS_UNKNOWN_SHUFFLE = 1
STATUS_UNKNOWN_MAP = 2
STATUS_BAD_RANGE = 3
STATUS_ERROR = 4
# the committed output failed its at-rest CRC verification: retryable on
# the wire (the retry envelope escalates it to FetchFailed with a
# corrupt_output verdict, and recovery re-executes the producing map)
STATUS_CORRUPT = 5
# push-merge: the shuffle's segments are sealed on this target — the
# pusher stops pushing it (authoritative, not retryable; the map simply
# stays per-map-fetched)
STATUS_FINALIZED = 6

# RunTaskResp statuses.
TASK_OK = 0
TASK_ERROR = 1
TASK_FETCH_FAILED = 2
TASK_NO_RUNNER = 3


# ---------------------------------------------------------------------------
#                         driver HA: op-log replication + lease takeover
#                         (shuffle/ha.py; one-sided pushes on the
#                         announce channel, never request/reply)

def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return struct.pack("<H", len(raw)) + raw


def _unpack_str(payload: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<H", payload, off)
    off += 2
    return payload[off:off + n].decode("utf-8"), off + n


@register()
class OpLogAppendMsg(RpcMsg):
    """Primary -> standbys: one replicated op-log record, stamped
    ``(incarnation, seq)`` (monotone; receivers accept only strictly
    forward stamps, which fences a zombie primary's appends). ``kind``
    is the ha.OP_* discriminator; ``blob`` is the op payload — for
    OP_WIRE, the encoded driver-bound frame itself, replayed through
    the same handler whose fence floors make the second application a
    no-op."""

    def __init__(self, incarnation: int, seq: int, kind: int,
                 blob: bytes):
        self.incarnation = incarnation
        self.seq = seq
        self.kind = kind
        self.blob = blob

    def payload(self) -> bytes:
        return struct.pack("<IQI", self.incarnation, self.seq,
                           self.kind) + self.blob

    @classmethod
    def from_payload(cls, payload: bytes) -> "OpLogAppendMsg":
        incarnation, seq, kind = struct.unpack_from("<IQI", payload, 0)
        return cls(incarnation, seq, kind, bytes(payload[16:]))


@register()
class SnapshotMsg(RpcMsg):
    """Primary -> standby: the full control-plane snapshot taken at
    ``(incarnation, seq)`` (ha.encode_snapshot envelope). Sent once at
    subscribe time (and after compactions) so a cold standby catches up
    from the snapshot plus the op tail instead of an unbounded log."""

    def __init__(self, incarnation: int, seq: int, blob: bytes):
        self.incarnation = incarnation
        self.seq = seq
        self.blob = blob

    def payload(self) -> bytes:
        return struct.pack("<IQ", self.incarnation, self.seq) + self.blob

    @classmethod
    def from_payload(cls, payload: bytes) -> "SnapshotMsg":
        incarnation, seq = struct.unpack_from("<IQ", payload, 0)
        return cls(incarnation, seq, bytes(payload[12:]))


@register()
class StandbyHelloMsg(RpcMsg):
    """Standby -> primary: subscribe to the replication stream. ``name``
    is the standby's lease-holder identity, ``host``/``port`` the
    address its catch-up server listens on (the primary pushes
    SnapshotMsg + OpLogAppendMsg there), ``last_seq`` the newest seq it
    already holds so a resubscribe after a blip replays only the gap."""

    def __init__(self, name: str, host: str, port: int, last_seq: int):
        self.name = name
        self.host = host
        self.port = port
        self.last_seq = last_seq

    def payload(self) -> bytes:
        return (_pack_str(self.name) + _pack_str(self.host)
                + struct.pack("<IQ", self.port, self.last_seq))

    @classmethod
    def from_payload(cls, payload: bytes) -> "StandbyHelloMsg":
        name, off = _unpack_str(payload, 0)
        host, off = _unpack_str(payload, off)
        port, last_seq = struct.unpack_from("<IQ", payload, off)
        return cls(name, host, port, last_seq)


@register()
class TakeoverMsg(RpcMsg):
    """New primary -> executors: the driver lease moved — incarnation
    ``incarnation`` now answers at ``host:port``. Executors observe a
    failover as one more membership-style bump: re-point the
    DriverClient (forward-only on incarnation, so a late replay of an
    older takeover cannot re-point backwards) and let the in-flight
    retry envelopes re-send against the new address. The authoritative
    state re-broadcast (announce + epoch bumps + plans) rides the same
    channel right behind this frame."""

    def __init__(self, incarnation: int, host: str, port: int):
        self.incarnation = incarnation
        self.host = host
        self.port = port

    def payload(self) -> bytes:
        return struct.pack("<I", self.incarnation) + _pack_str(
            self.host) + struct.pack("<I", self.port)

    @classmethod
    def from_payload(cls, payload: bytes) -> "TakeoverMsg":
        (incarnation,) = struct.unpack_from("<I", payload, 0)
        host, off = _unpack_str(payload, 4)
        (port,) = struct.unpack_from("<I", payload, off)
        return cls(incarnation, host, port)


@register()
class ShardPublishMsg(RpcMsg):
    """Executor -> shard OWNER: direct positional table write for a map
    in the owner's range (shard_ownership mode). Same body as
    PublishMsg — 12-byte entry, attempt fence, optional per-partition
    lengths — plus ``owner_gen``, the composed ownership generation
    (driver incarnation in the high 32 bits, per-incarnation handoff
    seq below) the sender believes holds the range. An owner that has
    sealed the shard, moved to a newer generation, or never owned the
    range forwards the publish to the driver instead of applying it,
    so a stale sender costs one extra hop, never a lost entry."""

    ENTRY_BYTES = 12

    def __init__(self, shuffle_id: int, map_id: int, entry: bytes,
                 fence: int = 0, owner_gen: int = 0, lengths=None):
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.entry = entry
        self.fence = fence
        self.owner_gen = owner_gen
        self.lengths = list(lengths) if lengths is not None else None

    def payload(self) -> bytes:
        out = (struct.pack("<ii", self.shuffle_id, self.map_id)
               + self.entry
               + struct.pack("<qq", self.fence, self.owner_gen))
        if self.lengths is not None:
            out += struct.pack(f"<I{len(self.lengths)}I",
                               len(self.lengths), *self.lengths)
        return out

    @classmethod
    def from_payload(cls, payload: bytes) -> "ShardPublishMsg":
        shuffle_id, map_id = struct.unpack_from("<ii", payload, 0)
        entry = payload[8:8 + cls.ENTRY_BYTES]
        off = 8 + cls.ENTRY_BYTES
        fence, owner_gen = struct.unpack_from("<qq", payload, off)
        off += 16
        lengths = None
        if len(payload) >= off + 4:
            (n,) = struct.unpack_from("<I", payload, off)
            if len(payload) >= off + 4 + 4 * n:
                lengths = list(struct.unpack_from(f"<{n}I", payload,
                                                  off + 4))
        return cls(shuffle_id, map_id, entry, fence, owner_gen, lengths)


@register()
class ShardMergedPublishMsg(RpcMsg):
    """Executor -> shard OWNER: a merged-directory publish routed to
    the owner of shard ``partition % num_shards`` instead of the
    driver. ``blob`` is the inner MergedPublishMsg payload verbatim —
    the owner logs it opaquely and batch-forwards it, so the driver's
    zombie/fence checks still run exactly once, on the same bytes."""

    def __init__(self, shuffle_id: int, shard: int, owner_gen: int,
                 blob: bytes):
        self.shuffle_id = shuffle_id
        self.shard = shard
        self.owner_gen = owner_gen
        self.blob = blob

    def payload(self) -> bytes:
        return struct.pack("<iiq", self.shuffle_id, self.shard,
                           self.owner_gen) + self.blob

    @classmethod
    def from_payload(cls, payload: bytes) -> "ShardMergedPublishMsg":
        shuffle_id, shard, owner_gen = struct.unpack_from(
            "<iiq", payload, 0)
        return cls(shuffle_id, shard, owner_gen, bytes(payload[16:]))


@register()
class ShardBatchMsg(RpcMsg):
    """Shard owner -> driver: batch convergence of writes the owner
    already applied and logged. ``records`` are
    ``(map_id, fence, entry[, lengths])`` publishes (3-tuples
    normalize to ``lengths=None``); ``blobs`` are opaque
    MergedPublishMsg payloads. The driver replays each through its
    normal publish path — the fence CAS makes the echo idempotent —
    which is what keeps the driver table byte-identical to the
    unsharded path."""

    def __init__(self, shuffle_id: int, shard: int, owner_gen: int,
                 records, blobs=None):
        self.shuffle_id = shuffle_id
        self.shard = shard
        self.owner_gen = owner_gen
        self.records = [
            (r[0], r[1], bytes(r[2]),
             list(r[3]) if len(r) > 3 and r[3] is not None else None)
            for r in records
        ]
        self.blobs = [bytes(b) for b in (blobs or [])]

    def payload(self) -> bytes:
        out = [struct.pack("<iiqI", self.shuffle_id, self.shard,
                           self.owner_gen, len(self.records))]
        for map_id, fence, entry, lengths in self.records:
            out.append(struct.pack("<iqI", map_id, fence, len(entry)))
            out.append(entry)
            if lengths is None:
                out.append(struct.pack("<i", -1))
            else:
                out.append(struct.pack(f"<i{len(lengths)}I",
                                       len(lengths), *lengths))
        out.append(struct.pack("<I", len(self.blobs)))
        for b in self.blobs:
            out.append(struct.pack("<I", len(b)))
            out.append(b)
        return b"".join(out)

    @classmethod
    def from_payload(cls, payload: bytes) -> "ShardBatchMsg":
        shuffle_id, shard, owner_gen, nrec = struct.unpack_from(
            "<iiqI", payload, 0)
        off = 20
        records = []
        for _ in range(nrec):
            map_id, fence, elen = struct.unpack_from("<iqI", payload,
                                                     off)
            off += 16
            entry = bytes(payload[off:off + elen])
            off += elen
            (nlen,) = struct.unpack_from("<i", payload, off)
            off += 4
            lengths = None
            if nlen >= 0:
                lengths = list(struct.unpack_from(f"<{nlen}I", payload,
                                                  off))
                off += 4 * nlen
            records.append((map_id, fence, entry, lengths))
        (nblob,) = struct.unpack_from("<I", payload, off)
        off += 4
        blobs = []
        for _ in range(nblob):
            (blen,) = struct.unpack_from("<I", payload, off)
            off += 4
            blobs.append(bytes(payload[off:off + blen]))
            off += blen
        return cls(shuffle_id, shard, owner_gen, records, blobs)


@register()
class ShardOpMsg(RpcMsg):
    """Shard owner -> its standby: one per-shard op-log record, stamped
    ``(owner_gen, seq)`` — the sharded twin of OpLogAppendMsg, with
    the ownership generation where the driver stream has its
    incarnation. Forward-only on ``(owner_gen, seq)`` at the receiver,
    so a sealed owner's stragglers cannot land behind a handoff."""

    def __init__(self, shuffle_id: int, shard: int, owner_gen: int,
                 seq: int, kind: int, blob: bytes):
        self.shuffle_id = shuffle_id
        self.shard = shard
        self.owner_gen = owner_gen
        self.seq = seq
        self.kind = kind
        self.blob = blob

    def payload(self) -> bytes:
        return struct.pack("<iiqQI", self.shuffle_id, self.shard,
                           self.owner_gen, self.seq,
                           self.kind) + self.blob

    @classmethod
    def from_payload(cls, payload: bytes) -> "ShardOpMsg":
        shuffle_id, shard, owner_gen, seq, kind = struct.unpack_from(
            "<iiqQI", payload, 0)
        return cls(shuffle_id, shard, owner_gen, seq, kind,
                   bytes(payload[28:]))


@register()
class ShardHandoffMsg(RpcMsg):
    """Driver -> executors: ownership of ``(shuffle_id, shard)`` moved
    to ``new_slot`` at generation ``owner_gen``. The outgoing owner (if
    alive — the drain case) seals its log segment and flushes; the
    incoming owner replays its standby buffer for the shard; everyone
    else re-aims buffered republishes. Rides the announce channel right
    behind the refreshed ShardMapMsg, so FIFO ordering gives the new
    owner its assignment before the replay trigger."""

    def __init__(self, shuffle_id: int, shard: int, owner_gen: int,
                 new_slot: int, old_slot: int):
        self.shuffle_id = shuffle_id
        self.shard = shard
        self.owner_gen = owner_gen
        self.new_slot = new_slot
        self.old_slot = old_slot

    def payload(self) -> bytes:
        return struct.pack("<iiqii", self.shuffle_id, self.shard,
                           self.owner_gen, self.new_slot, self.old_slot)

    @classmethod
    def from_payload(cls, payload: bytes) -> "ShardHandoffMsg":
        shuffle_id, shard, owner_gen, new_slot, old_slot = \
            struct.unpack_from("<iiqii", payload, 0)
        return cls(shuffle_id, shard, owner_gen, new_slot, old_slot)
