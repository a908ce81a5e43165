"""Control-plane RPC message framing.

Re-design of the reference's ``RdmaRpcMsg`` (scala/RdmaRpcMsg.scala): a tiny
self-describing frame — ``[total_length:4][msg_type:4][payload]`` — chopped
into fixed-size segments so each segment fits one pre-posted receive buffer
(scala/RdmaRpcMsg.scala:40-58: segments of ``recvWrSize``). The reference
needs segmentation because RDMA RECV buffers are fixed-size; we keep it as
the flow-control accounting unit (credits are per segment) and as the wire
format for datagram-ish transports, while the TCP transport can also write a
frame contiguously.

The reference defines exactly two message types — Hello (executor→driver,
scala/RdmaRpcMsg.scala:81-112) and Announce (driver→all, 114-173). The TPU
control plane adds table/location/publish messages in
``sparkrdma_tpu_torch.parallel.rpc`` via the same registry.
"""

from __future__ import annotations

import struct
from typing import ClassVar, Dict, Iterator, List, Optional, Type

from sparkrdma_tpu_torch.utils.ids import ShuffleManagerId

HEADER = struct.Struct("<II")  # (total_length incl. header, msg_type)

_REGISTRY: Dict[int, Type["RpcMsg"]] = {}

# THE authoritative wire-number table: every message class's type id, in
# one place, keyed by class name. ``@register()`` call sites look their
# id up here, so a new message means one new row — the id can never be
# assigned twice or drift between the class and a doc. The analyzer
# suite (sparkrdma_tpu_torch/analysis/wire.py) asserts the live registry
# matches this table exactly (unique, dense over the reserved gaps) and
# regenerates the message-ID table in docs/CONFIG.md from it.
WIRE_IDS: Dict[str, int] = {
    "HelloMsg": 1,
    "AnnounceMsg": 2,
    "PublishMsg": 3,
    # 4 reserved: was the publish ack (publish is one-sided now)
    "FetchTableReq": 5,
    "FetchTableResp": 6,
    "FetchOutputReq": 7,
    "FetchOutputResp": 8,
    "FetchBlocksReq": 9,
    "FetchBlocksResp": 10,
    "RunTaskReq": 11,
    "RunTaskResp": 12,
    "CreditReport": 13,
    "GetBroadcastReq": 14,
    "GetBroadcastResp": 15,
    "PingMsg": 16,
    "PongMsg": 17,
    "FetchOutputsReq": 18,
    "FetchOutputsResp": 19,
    "EpochBumpMsg": 20,
    "ShardMapMsg": 21,
    "ShardEntryMsg": 22,
    "FetchShardReq": 23,
    "FetchShardResp": 24,
    "ReducePlanMsg": 25,
    "FetchPlanReq": 26,
    "FetchPlanResp": 27,
    "PushBlocksReq": 28,
    "PushBlocksResp": 29,
    "FinalizeSegmentsReq": 30,
    "FinalizeSegmentsResp": 31,
    "MergedPublishMsg": 32,
    "FetchMergedReq": 33,
    "FetchMergedResp": 34,
    "TenantMapMsg": 35,
    "JoinMsg": 36,
    "MembershipBumpMsg": 37,
    "DrainReq": 38,
    "DrainResp": 39,
    "PushPlannedReq": 40,
    "PushPlannedResp": 41,
    # driver HA (shuffle/ha.py): the op-log replication stream and the
    # lease takeover announcement — one-sided pushes like everything
    # else on the announce channel
    "OpLogAppendMsg": 42,
    "SnapshotMsg": 43,
    "StandbyHelloMsg": 44,
    "TakeoverMsg": 45,
    # partitioned metadata ownership (shuffle/shard_plane.py): the
    # direct-to-owner write path, the owner->driver convergence batch,
    # the per-shard op-log stream, and the handoff announcement
    "ShardPublishMsg": 46,
    "ShardMergedPublishMsg": 47,
    "ShardBatchMsg": 48,
    "ShardOpMsg": 49,
    "ShardHandoffMsg": 50,
    # disaggregated cold tier (shuffle/cold_tier.py): the one-sided
    # blob publish and the reducer's directory pull — the TIERED
    # location class resolved last, before re-execution
    "TieredPublishMsg": 51,
    "FetchTieredReq": 52,
    "FetchTieredResp": 53,
}

# Ids deliberately absent from the dense 1..max range, with the reason
# pinned here so the density check can never be silenced by accident.
RESERVED_WIRE_IDS: Dict[int, str] = {
    4: "was the publish ack; publish is one-sided like the reference's "
       "RDMA WRITE, nothing acks",
}


def register(msg_type: Optional[int] = None):
    """Class decorator registering an ``RpcMsg`` subclass for decode.

    With no argument (every production call site) the wire number comes
    from ``WIRE_IDS[cls.__name__]`` — the one table above. An explicit
    id remains accepted for test/fixture message types outside it.
    """
    def deco(cls: Type["RpcMsg"]):
        mt = msg_type
        if mt is None:
            if cls.__name__ not in WIRE_IDS:
                raise ValueError(f"{cls.__name__} has no WIRE_IDS row")
            mt = WIRE_IDS[cls.__name__]
        if mt in _REGISTRY:
            raise ValueError(f"duplicate msg_type {mt}")
        cls.MSG_TYPE = mt
        _REGISTRY[mt] = cls
        return cls
    return deco


def registry() -> Dict[int, Type["RpcMsg"]]:
    """Snapshot of the live decode registry (analyzer + doc generation)."""
    return dict(_REGISTRY)


class RpcMsg:
    """Base frame. Subclasses implement payload (de)serialization."""

    MSG_TYPE: ClassVar[int] = -1

    def payload(self) -> bytes:
        raise NotImplementedError

    @classmethod
    def from_payload(cls, payload: bytes) -> "RpcMsg":
        raise NotImplementedError

    def encode(self) -> bytes:
        body = self.payload()
        return HEADER.pack(HEADER.size + len(body), self.MSG_TYPE) + body


def decode_message(frame: bytes) -> RpcMsg:
    """Decode one complete frame (scala/RdmaRpcMsg.scala:64-78)."""
    total, msg_type = HEADER.unpack_from(frame, 0)
    if total != len(frame):
        raise ValueError(f"frame length mismatch: header={total} actual={len(frame)}")
    cls = _REGISTRY.get(msg_type)
    if cls is None:
        raise ValueError(f"unknown msg_type {msg_type}")
    return cls.from_payload(frame[HEADER.size:total])


def segments(frame: bytes, seg_size: int) -> List[bytes]:
    """Chop an encoded frame into ≤seg_size chunks
    (scala/RdmaRpcMsg.scala:42-58)."""
    if seg_size < HEADER.size + 1:
        raise ValueError("segment size too small")
    return [frame[i:i + seg_size] for i in range(0, len(frame), seg_size)]


class Reassembler:
    """Streaming decoder: feed arbitrary chunks, yields complete messages.

    Covers both the segmented path and a TCP byte stream.
    """

    def __init__(self, max_frame: int = 1 << 30):
        self._buf = bytearray()
        self._max_frame = max_frame

    def feed(self, chunk: bytes) -> Iterator[RpcMsg]:
        self._buf.extend(chunk)
        while len(self._buf) >= HEADER.size:
            total, _ = HEADER.unpack_from(self._buf, 0)
            if total < HEADER.size or total > self._max_frame:
                raise ValueError(f"bad frame length {total}")
            if len(self._buf) < total:
                return
            frame = bytes(self._buf[:total])
            del self._buf[:total]
            yield decode_message(frame)


@register()
class HelloMsg(RpcMsg):
    """Executor → driver introduction (scala/RdmaRpcMsg.scala:81-112)."""

    def __init__(self, manager_id: ShuffleManagerId):
        self.manager_id = manager_id

    def payload(self) -> bytes:
        return self.manager_id.serialize()

    @classmethod
    def from_payload(cls, payload: bytes) -> "HelloMsg":
        mid, _ = ShuffleManagerId.deserialize(payload)
        return cls(mid)

    def __eq__(self, other):
        return isinstance(other, HelloMsg) and self.manager_id == other.manager_id


@register()
class AnnounceMsg(RpcMsg):
    """Driver → all executors membership broadcast
    (scala/RdmaRpcMsg.scala:114-173).

    ``epoch`` totally orders broadcasts: concurrent announce threads can
    deliver out of order, and tombstoning changes list *content* without
    changing length, so receivers keep the highest epoch, not the longest
    list."""

    def __init__(self, manager_ids: List[ShuffleManagerId], epoch: int = 0):
        self.manager_ids = list(manager_ids)
        self.epoch = epoch

    def payload(self) -> bytes:
        out = [struct.pack("<QI", self.epoch, len(self.manager_ids))]
        out += [m.serialize() for m in self.manager_ids]
        return b"".join(out)

    @classmethod
    def from_payload(cls, payload: bytes) -> "AnnounceMsg":
        epoch, n = struct.unpack_from("<QI", payload, 0)
        off = 12
        ids = []
        for _ in range(n):
            mid, off = ShuffleManagerId.deserialize(payload, off)
            ids.append(mid)
        return cls(ids, epoch)

    def __eq__(self, other):
        return (isinstance(other, AnnounceMsg)
                and self.manager_ids == other.manager_ids
                and self.epoch == other.epoch)
