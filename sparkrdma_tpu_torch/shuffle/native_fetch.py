"""Python face of the native client fetch engine (csrc/fetchclient.cpp).

The engine is the receive half of the one-sided dataplane: vectored
block-read requests are doorbell-batched (``submit`` queues frames,
``flush`` rings — ONE writev per connection carries the whole batch) and
response payloads land **directly in BufferPool lease memory** — the
caller passes the lease's base address and the C epoll loop scatters the
wire bytes there, verifying CRC trailers in C. No Python bytes object
exists anywhere on the happy path; the fetcher slices ``(token, offset,
length)`` views off the filled lease and ``decode_rows``/
``read_to_device`` consume them zero-copy.

The same submission/completion loop carries pre-framed control RPCs
(``submit_raw``): the planned-push sender batches its PushPlannedReq
frames through a raw-mode connection, and the hierarchical exchange's
cross-slice (DCN) movers ride the identical path — all three bulk
movers, one engine.

Threading contract: ONE engine per thread. The C side holds no locks;
the fetcher creates an engine inside each peer thread, a pusher inside
its push thread. Completions for a connection that dies arrive as
negative ``status`` codes and the caller re-runs those requests through
the ordinary Python retry/suspect/checksum envelope — the native engine
only ever completes the happy path, so anomalies stay byte-identical
with the pure-Python fetcher by construction.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

from sparkrdma_tpu_torch.parallel import messages as M
from sparkrdma_tpu_torch.parallel import rpc_msg
from sparkrdma_tpu_torch.runtime import native

# Local completion statuses — csrc/fetchclient.cpp kErr* lockstep
# (negative: disjoint from every server status by construction). Any of
# them means the connection died under the request.
FC_ERR_CONN = -100    # EOF / reset / connect failure
FC_ERR_PROTO = -101   # malformed frame or unmatched req_id
FC_ERR_TRUNC = -102   # payload length != requested length

_POLL_BATCH = 64


class _FcCompletion(ctypes.Structure):
    # csrc/fetchclient.cpp struct FcCompletion, field for field
    _fields_ = [
        ("conn_id", ctypes.c_int64),
        ("req_id", ctypes.c_uint64),
        ("nbytes", ctypes.c_int64),
        ("status", ctypes.c_int32),
        ("flags", ctypes.c_uint32),
        ("crc_state", ctypes.c_int32),
        ("frame_type", ctypes.c_uint32),
    ]


class Completion(NamedTuple):
    """One finished request. ``status``: the server's status for
    well-formed responses, a negative ``FC_ERR_*`` when the connection
    died. ``crc_state``: 0 = response carried no trailer, 1 = every
    block verified in C, -1 = mismatch (discard and refetch through the
    Python envelope, which re-raises ChecksumError with per-block
    blame)."""

    conn: int
    req_id: int
    nbytes: int
    status: int
    flags: int
    crc_state: int
    frame_type: int

    @property
    def ok(self) -> bool:
        return self.status == M.STATUS_OK and self.crc_state >= 0


def pack_blocks(blocks: List[Tuple[int, int, int]]) -> bytes:
    """Wire-pack (buf, offset, length) ranges — the exact byte layout
    messages.FetchBlocksReq carries and fc_submit splices into its
    request frame."""
    return b"".join(M._BLOCK.pack(int(b), int(o), int(ln))
                    for b, o, ln in blocks)


class NativeFetchEngine:
    """One thread's doorbell-batched submission/completion loop."""

    @staticmethod
    def available() -> bool:
        return native.has_fetch_client()

    def __init__(self):
        if not self.available():
            raise RuntimeError("native fetch client not built "
                               "(rebuild with `make -C csrc`)")
        self._lib = native.LIB
        self._eng = self._lib.fc_create()
        if not self._eng:
            raise RuntimeError("fc_create failed")
        self._carr = (_FcCompletion * _POLL_BATCH)()

    # -- connections -----------------------------------------------------

    def connect(self, host: str, port: int, raw: bool = False,
                timeout_ms: int = 20000) -> int:
        """Dial a peer. Returns a conn id > 0, or 0 on failure. ``raw``
        connections carry pre-framed RPCs (FIFO reply matching); plain
        connections speak the typed block-fetch protocol."""
        if self._eng is None:
            return 0
        return self._lib.fc_connect(self._eng, host.encode(), port,
                                    1 if raw else 0, int(timeout_ms))

    def alive(self, conn: int) -> bool:
        return (self._eng is not None
                and bool(self._lib.fc_conn_alive(self._eng, conn)))

    def pending(self, conn: int) -> int:
        return int(self._lib.fc_pending(self._eng, conn))

    def close_conn(self, conn: int) -> None:
        if self._eng is not None:
            self._lib.fc_close(self._eng, conn)

    # -- submission (queued until flush — the doorbell) ------------------

    def submit(self, conn: int, req_id: int, shuffle_id: int,
               blocks: List[Tuple[int, int, int]], dst_addr: Optional[int],
               dst_cap: int) -> int:
        """Queue one vectored block read whose payload lands at
        ``dst_addr`` (lease memory; must hold the sum of the block
        lengths). 0 = queued; negative = rejected (dead conn, frame too
        big, pending cap, duplicate req_id, capacity short)."""
        wire = pack_blocks(blocks)
        return self._lib.fc_submit(self._eng, conn, req_id, shuffle_id,
                                   wire, len(blocks), dst_addr, dst_cap)

    def submit_raw(self, conn: int, req_id: int, frame: bytes,
                   resp_buf) -> int:
        """Queue one pre-framed request (e.g. ``msg.encode()``); the
        reply frame's payload is written into ``resp_buf`` (a writable
        buffer — replies match FIFO per connection)."""
        buf = (ctypes.c_uint8 * len(resp_buf)).from_buffer(resp_buf)
        return self._lib.fc_submit_raw(self._eng, conn, req_id, frame,
                                       len(frame), buf, len(resp_buf))

    def flush(self) -> None:
        """The doorbell: one writev per connection pushes every queued
        frame."""
        self._lib.fc_flush(self._eng)

    # -- completion ------------------------------------------------------

    def poll(self, timeout_ms: int = 0) -> List[Completion]:
        """Collect up to a batch of completions, waiting at most
        ``timeout_ms`` when none are already queued."""
        n = self._lib.fc_poll(self._eng, int(timeout_ms), self._carr,
                              _POLL_BATCH)
        return [Completion(c.conn_id, c.req_id, c.nbytes, c.status,
                           c.flags, c.crc_state, c.frame_type)
                for c in self._carr[:n]]

    @staticmethod
    def decode_reply(frame_type: int, payload: bytes) -> rpc_msg.RpcMsg:
        """Decode a raw-mode reply payload by its frame type."""
        cls = rpc_msg.registry().get(frame_type)
        if cls is None:
            raise ValueError(f"unknown reply frame type {frame_type}")
        return cls.from_payload(payload)

    # -- stats / teardown ------------------------------------------------

    @property
    def io_uring(self) -> bool:
        return bool(self._lib.fc_io_uring(self._eng))

    @property
    def flush_count(self) -> int:
        return int(self._lib.fc_flush_count(self._eng))

    @property
    def writev_count(self) -> int:
        return int(self._lib.fc_writev_count(self._eng))

    @property
    def frames_sent(self) -> int:
        return int(self._lib.fc_frames_sent(self._eng))

    @property
    def conns_killed(self) -> int:
        return int(self._lib.fc_conns_killed(self._eng))

    def close(self) -> None:
        eng, self._eng = self._eng, None
        if eng:
            self._lib.fc_destroy(eng)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best-effort: the engine owns an epoll fd
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
