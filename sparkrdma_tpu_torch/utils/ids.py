"""Compact identifier types + custom binary serialization.

Re-design of the reference's ``RdmaUtils.scala`` id machinery: the reference
hand-rolls a compact binary codec for ``BlockManagerId`` /
``RdmaShuffleManagerId`` (scala/RdmaUtils.scala:33-124) with an interning
cache (scala/RdmaUtils.scala:136-142) because these ids ride in every control
message and every task closure. We keep that discipline: fixed-layout
little-endian structs, length-prefixed UTF-8 strings, and an intern table so
repeated decodes share one object.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, Tuple

_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")


def _pack_str(s: str) -> bytes:
    raw = s.encode("utf-8")
    if len(raw) > 0xFFFF:
        raise ValueError("string too long for u16 length prefix")
    return _U16.pack(len(raw)) + raw


def _unpack_str(buf: memoryview, off: int) -> Tuple[str, int]:
    (n,) = _U16.unpack_from(buf, off)
    off += 2
    return bytes(buf[off:off + n]).decode("utf-8"), off + n


@dataclass(frozen=True)
class ExecutorId:
    """Engine-level executor identity (the reference's BlockManagerId analogue,
    scala/RdmaUtils.scala:33-86): (executorId, host, port)."""

    executor: str
    host: str
    port: int

    def serialize(self) -> bytes:
        return _pack_str(self.executor) + _pack_str(self.host) + _U32.pack(self.port)

    @staticmethod
    def deserialize(buf: bytes, off: int = 0) -> Tuple["ExecutorId", int]:
        mv = memoryview(buf)
        executor, off = _unpack_str(mv, off)
        host, off = _unpack_str(mv, off)
        (port,) = _U32.unpack_from(mv, off)
        return _intern(ExecutorId(executor, host, port)), off + 4


@dataclass(frozen=True)
class ShuffleManagerId:
    """Control-plane endpoint identity (the reference's RdmaShuffleManagerId,
    scala/RdmaUtils.scala:88-134): where a peer's control server listens, its
    engine identity, and (when the native runtime is built) the C++ block
    server port peers fetch data bytes from."""

    executor_id: ExecutorId
    rpc_host: str
    rpc_port: int
    block_port: int = 0  # 0 = serve blocks over the control connection

    def serialize(self) -> bytes:
        return (self.executor_id.serialize() + _pack_str(self.rpc_host)
                + _U32.pack(self.rpc_port) + _U32.pack(self.block_port))

    @staticmethod
    def deserialize(buf: bytes, off: int = 0) -> Tuple["ShuffleManagerId", int]:
        executor_id, off = ExecutorId.deserialize(buf, off)
        mv = memoryview(buf)
        rpc_host, off = _unpack_str(mv, off)
        (rpc_port,) = _U32.unpack_from(mv, off)
        (block_port,) = _U32.unpack_from(mv, off + 4)
        return (_intern(ShuffleManagerId(executor_id, rpc_host, rpc_port,
                                         block_port)), off + 8)


@dataclass(frozen=True)
class BlockId:
    """(shuffleId, mapId, reduceId) shuffle block coordinate."""

    shuffle_id: int
    map_id: int
    reduce_id: int

    _S = struct.Struct("<iii")

    def serialize(self) -> bytes:
        return self._S.pack(self.shuffle_id, self.map_id, self.reduce_id)

    @staticmethod
    def deserialize(buf: bytes, off: int = 0) -> Tuple["BlockId", int]:
        s, m, r = BlockId._S.unpack_from(buf, off)
        return BlockId(s, m, r), off + BlockId._S.size


# Interning cache, reference precedent scala/RdmaUtils.scala:136-142.
_INTERN: Dict[object, object] = {}


def _intern(obj):
    return _INTERN.setdefault(obj, obj)
