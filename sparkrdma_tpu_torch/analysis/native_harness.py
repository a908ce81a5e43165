"""Pass 4 — sanitizer exercises for the native runtime (csrc/).

Loads a sanitizer-instrumented build of ``libtpushuffle.so`` (ASan or
UBSan, ``make -C csrc asan ubsan``) and drives the two native components
with real memory on the line through their edge cases:

* ``writer_scatter`` — the streaming write path's counting-sort kernel:
  empty batches, zero-byte payloads, single partition, multi-threaded
  stability split, and the out-of-range-dest error path. A one-byte
  cursor slip here is silent data corruption in production; under ASan
  it aborts this harness.
* the native block server — over a real socket: vectored scatter reads,
  zero-length blocks, CRC32 trailer verification against zlib,
  unknown-token and bad-range statuses, a request frame at EXACTLY
  ``kMaxReqFrame`` (65534 blocks — the biggest parse the server must
  survive), and the over-max protocol error that must CLOSE the
  connection rather than wander off the frame.

Run via ``scripts/run_analysis.sh --sanitize`` (which builds the
instrumented .so and sets LD_PRELOAD for ASan), or directly::

    python -m sparkrdma_tpu_torch.analysis.native_harness <path/to/.so>

Exit 0 = every exercise passed and no sanitizer report fired (sanitizer
failures abort the process with their own diagnostics). The harness is
self-checking beyond the sanitizers: responses are verified
byte-for-byte, so it doubles as a native-server protocol test.
"""

from __future__ import annotations

import ctypes
import os
import socket
import struct
import sys
import tempfile
import zlib

from sparkrdma_tpu_torch.parallel import messages as M
from sparkrdma_tpu_torch.parallel.rpc_msg import HEADER


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    u64, i64, vp, cp = (ctypes.c_uint64, ctypes.c_int64, ctypes.c_void_p,
                        ctypes.c_char_p)
    lib.writer_scatter.argtypes = [ctypes.POINTER(u64), cp, u64, u64,
                                   ctypes.POINTER(i64), ctypes.c_uint32,
                                   cp, ctypes.POINTER(u64), ctypes.c_int]
    lib.writer_scatter.restype = i64
    lib.bs_create.argtypes = [cp, ctypes.c_uint16, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.bs_create.restype = vp
    lib.bs_port.argtypes = [vp]
    lib.bs_port.restype = ctypes.c_uint16
    lib.bs_set_checksum.argtypes = [vp, ctypes.c_int]
    lib.bs_set_checksum.restype = None
    lib.bs_register_file.argtypes = [vp, ctypes.c_uint32, cp]
    lib.bs_register_file.restype = ctypes.c_int
    lib.bs_unregister_file.argtypes = [vp, ctypes.c_uint32]
    lib.bs_unregister_file.restype = ctypes.c_int
    lib.bs_stop.argtypes = [vp]
    lib.bs_stop.restype = None
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.bs_set_zero_copy.argtypes = [vp, ctypes.c_int]
    lib.bs_set_zero_copy.restype = None
    lib.bs_set_region_budget.argtypes = [vp, u64]
    lib.bs_set_region_budget.restype = None
    lib.bs_set_file_crcs.argtypes = [vp, ctypes.c_uint32,
                                     ctypes.POINTER(u64), u32p, u32p,
                                     ctypes.c_uint32]
    lib.bs_set_file_crcs.restype = ctypes.c_int
    for fn in ("bs_mapped_bytes", "bs_remaps", "bs_zero_copy_blocks",
               "bs_crc_reused", "bs_pin_events"):
        getattr(lib, fn).argtypes = [vp]
        getattr(lib, fn).restype = u64
    if hasattr(lib, "bs_set_fair"):  # tenancy build
        lib.bs_register_file2.argtypes = [vp, ctypes.c_uint32, cp,
                                          ctypes.c_uint32]
        lib.bs_register_file2.restype = ctypes.c_int
        lib.bs_set_fair.argtypes = [vp, ctypes.c_int, u64]
        lib.bs_set_fair.restype = None
        lib.bs_fair_queued.argtypes = [vp]
        lib.bs_fair_queued.restype = u64
    if hasattr(lib, "fc_create"):  # client fetch engine build
        lib.fc_create.argtypes = []
        lib.fc_create.restype = vp
        lib.fc_connect.argtypes = [vp, cp, ctypes.c_uint16, ctypes.c_int,
                                   ctypes.c_int]
        lib.fc_connect.restype = i64
        lib.fc_submit.argtypes = [vp, i64, u64, ctypes.c_uint32, cp,
                                  ctypes.c_uint32, vp, u64]
        lib.fc_submit.restype = ctypes.c_int
        lib.fc_submit_raw.argtypes = [vp, i64, u64, cp, u64, vp, u64]
        lib.fc_submit_raw.restype = ctypes.c_int
        lib.fc_flush.argtypes = [vp]
        lib.fc_flush.restype = ctypes.c_int
        lib.fc_poll.argtypes = [vp, ctypes.c_int, vp, ctypes.c_int]
        lib.fc_poll.restype = ctypes.c_int
        lib.fc_conn_alive.argtypes = [vp, i64]
        lib.fc_conn_alive.restype = ctypes.c_int
        for fn in ("fc_flush_count", "fc_writev_count", "fc_frames_sent",
                   "fc_conns_killed"):
            getattr(lib, fn).argtypes = [vp]
            getattr(lib, fn).restype = u64
        lib.fc_close.argtypes = [vp, i64]
        lib.fc_close.restype = None
        lib.fc_destroy.argtypes = [vp]
        lib.fc_destroy.restype = None
    return lib


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"native harness: {what}")
    print(f"  ok: {what}")


# ------------------------------------------------------------- scatter

def _scatter(lib, keys, payload_bytes, payload, dests, num_partitions,
             nthreads):
    n = len(keys)
    u64 = ctypes.c_uint64
    keys_a = (u64 * max(1, n))(*keys)
    dest_a = (ctypes.c_int64 * max(1, n))(*dests)
    out = ctypes.create_string_buffer(max(1, n * (8 + payload_bytes)))
    counts = (u64 * num_partitions)()
    total = lib.writer_scatter(
        keys_a, payload if payload else b"", n, payload_bytes, dest_a,
        num_partitions, out, counts, nthreads)
    return total, bytes(out.raw[:max(0, total)]), list(counts)


def exercise_writer_scatter(lib) -> None:
    print("writer_scatter:")
    import random
    rng = random.Random(7)

    # multi-threaded scatter with payload: verify totals, counts, and
    # per-partition stable content against a reference scatter
    n, pb, parts = 4096, 8, 16
    keys = [rng.randrange(1 << 62) for _ in range(n)]
    payload = bytes(rng.randrange(256) for _ in range(n * pb))
    dests = [rng.randrange(parts) for _ in range(n)]
    total, out, counts = _scatter(lib, keys, pb, payload, dests, parts, 4)
    _check(total == n * (8 + pb), "scatter total bytes")
    _check(sum(counts) == n, "scatter per-partition counts sum")
    want = {p: b"" for p in range(parts)}
    for i in range(n):
        want[dests[i]] += (struct.pack("<Q", keys[i])
                           + payload[i * pb:(i + 1) * pb])
    got, off = [], 0
    for p in range(parts):
        seg = out[off:off + counts[p] * (8 + pb)]
        off += len(seg)
        got.append(seg)
    _check(all(got[p] == want[p] for p in range(parts)),
           "scatter stability: per-partition rows in arrival order")

    total, _, _ = _scatter(lib, [], 8, b"", [], 4, 2)
    _check(total == 0, "empty batch")
    total, out, counts = _scatter(lib, [5, 6], 0, b"", [0, 0], 1, 8)
    _check(total == 16 and counts == [2],
           "zero payload_bytes, single partition, threads > rows")
    total, _, _ = _scatter(lib, [1], 8, b"\x00" * 8, [9], 4, 1)
    _check(total == -1, "out-of-range dest returns -1")


# --------------------------------------------------------- block server

def _recv_frame(sock: socket.socket) -> bytes:
    head = b""
    while len(head) < HEADER.size:
        chunk = sock.recv(HEADER.size - len(head))
        if not chunk:
            return b""
        head += chunk
    total, _ = HEADER.unpack_from(head, 0)
    buf = head
    while len(buf) < total:
        chunk = sock.recv(min(1 << 20, total - len(buf)))
        if not chunk:
            return b""
        buf += chunk
    return buf


def _fetch(sock, req_id, shuffle_id, blocks) -> M.FetchBlocksResp:
    sock.sendall(M.FetchBlocksReq(req_id, shuffle_id, blocks).encode())
    frame = _recv_frame(sock)
    assert frame, "server closed connection unexpectedly"
    _, msg_type = HEADER.unpack_from(frame, 0)
    assert msg_type == M.FetchBlocksResp.MSG_TYPE
    return M.FetchBlocksResp.from_payload(frame[HEADER.size:])


def exercise_block_server(lib) -> None:
    print("block server:")
    data = bytes((i * 131 + 17) % 256 for i in range(1 << 16))
    with tempfile.NamedTemporaryFile(suffix=".data", delete=False) as f:
        f.write(data)
        path = f.name
    server = lib.bs_create(b"127.0.0.1", 0, 2, None, 0)
    try:
        _check(bool(server), "bs_create")
        lib.bs_set_checksum(server, 1)
        port = lib.bs_port(server)
        _check(lib.bs_register_file(server, 42, path.encode()) == 0,
               "bs_register_file")

        sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        try:
            # vectored read incl. zero-length block + CRC trailer check
            blocks = [(42, 0, 100), (42, 500, 0), (42, 4096, 1024),
                      (42, len(data) - 7, 7)]
            resp = _fetch(sock, 1, 0, blocks)
            _check(resp.status == M.STATUS_OK and resp.flags & M.FLAG_CRC32,
                   "vectored read: OK + FLAG_CRC32")
            body_len = sum(ln for _, _, ln in blocks)
            body, trailer = resp.data[:body_len], resp.data[body_len:]
            want = b"".join(data[o:o + ln] for _, o, ln in blocks)
            _check(body == want, "vectored read: payload bytes")
            crcs = struct.unpack(f"<{len(blocks)}I", trailer)
            pos = 0
            ok = True
            for (_, _, ln), crc in zip(blocks, crcs):
                ok = ok and crc == zlib.crc32(body[pos:pos + ln])
                pos += ln
            _check(ok, "vectored read: per-block CRC32 trailer == zlib")

            resp = _fetch(sock, 2, 0, [(7, 0, 16)])
            _check(resp.status == M.STATUS_UNKNOWN_SHUFFLE,
                   "unknown buffer token -> STATUS_UNKNOWN")
            resp = _fetch(sock, 3, 0, [(42, len(data), 64)])
            _check(resp.status == M.STATUS_BAD_RANGE,
                   "offset past EOF -> STATUS_BAD_RANGE")
            resp = _fetch(sock, 4, 0, [])
            _check(resp.status == M.STATUS_OK and len(resp.data) == 0,
                   "zero-block request")

            # the biggest frame the server must parse: exactly under
            # kMaxReqFrame (65534 zero-length blocks = 1048568 bytes)
            nmax = (M.NATIVE_MAX_REQ_FRAME - M.BLOCKS_REQ_FIXED_BYTES
                    - HEADER.size) // M.BLOCK_WIRE_BYTES
            resp = _fetch(sock, 5, 0, [(42, 0, 0)] * nmax)
            _check(resp.status == M.STATUS_OK
                   and len(resp.data) == 4 * nmax,
                   f"max-frame request ({nmax} blocks) parses clean")
        finally:
            sock.close()

        # over-max frame: a protocol error must CLOSE the connection
        sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        try:
            huge = M.NATIVE_MAX_REQ_FRAME + 8
            sock.sendall(HEADER.pack(huge, M.FetchBlocksReq.MSG_TYPE))
            sock.sendall(b"\x00" * 64)
            _check(_recv_frame(sock) == b"",
                   "over-kMaxReqFrame frame closes the connection")
        finally:
            sock.close()

        _check(lib.bs_unregister_file(server, 42) == 0,
               "bs_unregister_file")
    finally:
        lib.bs_stop(server)
        os.unlink(path)


def exercise_zero_copy_serve(lib) -> None:
    """The one-sided serve path under sanitizers: zero-copy vectored
    responses (bytes must still be exact), CRC-trailer reuse from an
    attested-range table (incl. the crc32_combine matrix math, checked
    against zlib), LRU eviction + remap under a registered-region
    budget, and the register/unregister-during-in-flight-vectored-serve
    race that refcount pinning exists for (a munmap under a draining
    response is a guaranteed ASan use-after-poison)."""
    print("zero-copy serve path:")
    import threading

    datas = {t: bytes(((i * (t + 3) + 7) % 256)
                      for i in range(1 << 16)) for t in (1, 2, 3)}
    paths = {}
    for t, data in datas.items():
        with tempfile.NamedTemporaryFile(suffix=f".zc{t}", delete=False) as f:
            f.write(data)
            paths[t] = f.name
    server = lib.bs_create(b"127.0.0.1", 0, 2, None, 0)
    try:
        _check(bool(server), "bs_create")
        port = lib.bs_port(server)
        for t in datas:
            _check(lib.bs_register_file(server, t, paths[t].encode()) == 0,
                   f"register token {t}")

        sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        try:
            # zero-copy vectored read spanning tokens, no checksum
            blocks = [(1, 0, 4096), (2, 100, 0), (3, 1024, 2048),
                      (1, len(datas[1]) - 9, 9)]
            want = b"".join(datas[t][o:o + ln] for t, o, ln in blocks)
            resp = _fetch(sock, 1, 0, blocks)
            _check(resp.status == M.STATUS_OK and resp.data == want,
                   "zero-copy vectored read: payload bytes exact")
            _check(lib.bs_zero_copy_blocks(server) >= 3,
                   "zero-copy blocks counted")

            # CRC reuse: attest token 1 as four 16 KiB ranges; aligned
            # reads must reuse (combine included), unaligned recompute —
            # trailers verify against zlib either way
            n_ranges, rlen = 4, 1 << 14
            offs = (ctypes.c_uint64 * n_ranges)(*(i * rlen
                                                  for i in range(n_ranges)))
            lens = (ctypes.c_uint32 * n_ranges)(*([rlen] * n_ranges))
            crcs = (ctypes.c_uint32 * n_ranges)(
                *(zlib.crc32(datas[1][i * rlen:(i + 1) * rlen])
                  for i in range(n_ranges)))
            _check(lib.bs_set_file_crcs(server, 1, offs, lens, crcs,
                                        n_ranges) == 0, "bs_set_file_crcs")
            lib.bs_set_checksum(server, 1)
            blocks = [(1, 0, rlen),            # exact range -> reuse
                      (1, 0, 2 * rlen),        # two ranges -> combine
                      (1, 0, 4 * rlen),        # whole file -> combine
                      (1, 7, 100),             # unaligned -> recompute
                      (2, 0, 512)]             # unattested -> recompute
            reused_before = lib.bs_crc_reused(server)
            resp = _fetch(sock, 2, 0, blocks)
            _check(resp.status == M.STATUS_OK
                   and resp.flags & M.FLAG_CRC32, "CRC serve: OK + flag")
            body_len = sum(ln for _, _, ln in blocks)
            body, trailer = resp.data[:body_len], resp.data[body_len:]
            want = b"".join(datas[t][o:o + ln] for t, o, ln in blocks)
            _check(body == want, "CRC serve: payload bytes exact")
            got = struct.unpack(f"<{len(blocks)}I", trailer)
            pos, ok = 0, True
            for (_, _, ln), crc in zip(blocks, got):
                ok = ok and crc == zlib.crc32(body[pos:pos + ln])
                pos += ln
            _check(ok, "CRC trailers (reused + combined + recomputed) "
                       "all match zlib")
            _check(lib.bs_crc_reused(server) == reused_before + 3,
                   "exactly the aligned blocks reused attested CRCs")
            lib.bs_set_checksum(server, 0)

            # budget pressure: with room for ~one file, alternating
            # tokens must evict + remap, bytes staying exact
            lib.bs_set_region_budget(server, len(datas[1]) + 1024)
            for r in range(6):
                t = (r % 3) + 1
                resp = _fetch(sock, 10 + r, 0, [(t, 128, 4096)])
                _check(resp.status == M.STATUS_OK
                       and resp.data == datas[t][128:128 + 4096],
                       f"over-budget serve {r} (token {t}) byte-exact")
            _check(lib.bs_remaps(server) >= 2, "LRU evictions remapped")
            _check(lib.bs_mapped_bytes(server) <= len(datas[1]) + 1024,
                   "mapped bytes within budget after serves")
            lib.bs_set_region_budget(server, 0)
        finally:
            sock.close()

        # register/unregister storm during in-flight vectored serves:
        # pins must keep every draining response's mapping alive
        stop = threading.Event()

        def churn():
            import time
            while not stop.is_set():
                lib.bs_unregister_file(server, 3)
                lib.bs_register_file(server, 3, paths[3].encode())
                # let serves land mid-registration so the unregister
                # races DRAINING zero-copy windows, not just lookups
                time.sleep(0.0002)
            lib.bs_register_file(server, 3, paths[3].encode())

        th = threading.Thread(target=churn)
        th.start()
        try:
            sock = socket.create_connection(("127.0.0.1", port), timeout=10)
            try:
                okc = unkc = 0
                for r in range(300):
                    blocks = [(3, 0, 8192), (1, 0, 64), (3, 4096, 8192)]
                    resp = _fetch(sock, 100 + r, 0, blocks)
                    if resp.status == M.STATUS_OK:
                        want = b"".join(datas[t][o:o + ln]
                                        for t, o, ln in blocks)
                        assert resp.data == want, "served bytes diverged"
                        okc += 1
                    else:
                        assert resp.status == M.STATUS_UNKNOWN_SHUFFLE
                        unkc += 1
                _check(okc > 0,
                       f"serves landed through the churn ({okc} ok, "
                       f"{unkc} unknown)")
            finally:
                sock.close()
        finally:
            stop.set()
            th.join()
        _check(lib.bs_pin_events(server) > 0, "region pins counted")
    finally:
        lib.bs_stop(server)
        for p in paths.values():
            os.unlink(p)


def exercise_fair_serving(lib) -> None:
    """The multi-tenant DRR request queue under sanitizers: tenant-
    tagged registration (bs_register_file2), interleaved wide/narrow
    requests from two connections deferring through the worker-local
    tenant queues (bytes must stay exact, per-connection order
    preserved), a connection CLOSED while its requests sit deferred
    (the close-time purge a dangling Conn* would turn into a
    use-after-free), and the runtime fair->FIFO flip."""
    if not hasattr(lib, "bs_set_fair"):
        print("fair serving: .so predates bs_set_fair, skipped")
        return
    print("fair-share serving:")
    datas = {t: bytes(((i * (t + 5) + 11) % 256)
                      for i in range(1 << 16)) for t in (1, 2)}
    paths = {}
    for t, data in datas.items():
        with tempfile.NamedTemporaryFile(suffix=f".fr{t}",
                                         delete=False) as f:
            f.write(data)
            paths[t] = f.name
    server = lib.bs_create(b"127.0.0.1", 0, 1, None, 0)
    try:
        _check(bool(server), "bs_create")
        port = lib.bs_port(server)
        for t in datas:
            _check(lib.bs_register_file2(server, t, paths[t].encode(),
                                         t) == 0,
                   f"bs_register_file2 token {t} tenant {t}")
        lib.bs_set_fair(server, 1, 4096)  # small quantum: real deferral

        # two tenants' requests interleave on one worker; every
        # response must be byte-exact and per-connection in order
        socks = {t: socket.create_connection(("127.0.0.1", port),
                                             timeout=10) for t in datas}
        try:
            for r in range(50):
                for t, sock in socks.items():
                    blocks = [(t, (r * 977) % 32768, 8192 if t == 1
                               else 64)]
                    resp = _fetch(sock, r, 0, blocks)
                    want = b"".join(datas[tt][o:o + ln]
                                    for tt, o, ln in blocks)
                    _check(resp.status == M.STATUS_OK
                           and resp.data == want,
                           f"fair serve r{r} tenant {t} byte-exact")
            _check(lib.bs_fair_queued(server) >= 100,
                   "requests deferred through the DRR queues")
        finally:
            for sock in socks.values():
                sock.close()

        # close-with-deferred-requests: fire a burst and slam the
        # socket — the worker must purge the dangling Conn*'s queue
        # entries instead of serving into freed memory
        for _ in range(3):
            sock = socket.create_connection(("127.0.0.1", port),
                                            timeout=10)
            for r in range(64):
                frame = struct.pack("<IIqiI", 8 + 16 + 16, 9, r, 0, 1)
                frame += struct.pack("<IqI", 1, 0, 16384)
                sock.sendall(frame)
            sock.close()  # many requests still deferred/unsent

        # back to FIFO: the legacy inline path still serves exactly
        lib.bs_set_fair(server, 0, 0)
        sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        try:
            resp = _fetch(sock, 999, 0, [(2, 5, 777)])
            _check(resp.status == M.STATUS_OK
                   and resp.data == datas[2][5:5 + 777],
                   "post-flip FIFO serve byte-exact")
        finally:
            sock.close()
    finally:
        lib.bs_stop(server)
        for p in paths.values():
            os.unlink(p)


# ------------------------------------------------------ client fetch engine

class _FcComp(ctypes.Structure):
    # csrc/fetchclient.cpp struct FcCompletion, field for field
    _fields_ = [("conn_id", ctypes.c_int64), ("req_id", ctypes.c_uint64),
                ("nbytes", ctypes.c_int64), ("status", ctypes.c_int32),
                ("flags", ctypes.c_uint32), ("crc_state", ctypes.c_int32),
                ("frame_type", ctypes.c_uint32)]


def _fc_wait(lib, eng, want: int, deadline_s: float = 10.0):
    """Poll the engine until ``want`` completions arrive."""
    import time
    comps = (_FcComp * 16)()
    out = []
    end = time.monotonic() + deadline_s
    while len(out) < want and time.monotonic() < end:
        n = lib.fc_poll(eng, 50, comps, 16)
        out.extend(comps[i] for i in range(n))
    if len(out) < want:
        raise AssertionError("native harness: fc completion deadline")
    return out


def _fake_peer(handler):
    """One-shot listener: accept a single connection, run ``handler``
    (which receives the socket), close. Returns (thread, port)."""
    import threading
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(1)
    port = ls.getsockname()[1]

    def run():
        try:
            conn, _ = ls.accept()
        except OSError:
            return
        try:
            handler(conn)
        finally:
            try:
                conn.close()
            except OSError:
                pass
            ls.close()

    th = threading.Thread(target=run)
    th.start()
    return th, port


def _fc_recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        try:
            chunk = conn.recv(n - len(buf))
        except OSError:  # the client under test dropped the conn: fine
            break
        if not chunk:
            break
        buf += chunk
    return buf


def exercise_fetch_client(lib) -> None:
    """The native CLIENT under sanitizers: the wire-anomaly paths a
    misbehaving (or dying) server drives it through. A fake Python peer
    plays the server so the malformed frames are exact: a length-lying
    truncated response (kErrTrunc, conn dropped — resync after a length
    lie is not trusted), a peer close mid-vectored-payload (kErrConn
    with the scatter half-landed — the use-after-scope ASan exists for),
    a CRC-bad trailer (completion with crc_state=-1, conn SURVIVES),
    and, against the real block server, the largest request frame
    fc_submit may emit plus the first one past it (rejected client-side,
    never on the wire)."""
    if not hasattr(lib, "fc_create"):
        print("fetch client: .so predates fc_create, skipped")
        return
    print("fetch client:")
    resp_t = M.FetchBlocksResp.MSG_TYPE

    def run_one(handler, blocks, dst_len):
        """Connect a fresh engine to a one-shot fake peer, submit one
        vectored read, return (completion, dst bytes, engine stats)."""
        th, port = _fake_peer(handler)
        eng = lib.fc_create()
        assert eng, "fc_create"
        try:
            conn = lib.fc_connect(eng, b"127.0.0.1", port, 0, 5000)
            _check(conn > 0, "fc_connect to fake peer")
            dst = ctypes.create_string_buffer(max(1, dst_len))
            wire = b"".join(struct.pack("<IQI", b, o, ln)
                            for b, o, ln in blocks)
            rc = lib.fc_submit(eng, conn, 1, 0, wire, len(blocks),
                               ctypes.addressof(dst), dst_len)
            _check(rc == 0, "fc_submit queues")
            lib.fc_flush(eng)
            comp = _fc_wait(lib, eng, 1)[0]
            alive = bool(lib.fc_conn_alive(eng, conn))
            return comp, bytes(dst.raw[:dst_len]), alive
        finally:
            lib.fc_destroy(eng)
            th.join()

    data = bytes((i * 37 + 5) % 256 for i in range(4096))

    # length lie: response claims OK but carries 300 of 1000 bytes in a
    # COMPLETE frame — precise kErrTrunc for the request, conn dropped
    def lie(conn):
        req = _fc_recv_exact(conn, M.BLOCKS_REQ_FIXED_BYTES
                             + M.BLOCK_WIRE_BYTES)
        assert len(req) == M.BLOCKS_REQ_FIXED_BYTES + M.BLOCK_WIRE_BYTES
        body = struct.pack("<qii", 1, M.STATUS_OK, 0) + data[:300]
        conn.sendall(HEADER.pack(8 + len(body), resp_t) + body)
        _fc_recv_exact(conn, 1)  # hold open until the client drops us

    comp, _, alive = run_one(lie, [(1, 0, 1000)], 1000)
    _check(comp.status == -102 and not alive,
           "length-lying response -> kErrTrunc, conn dropped")

    # peer close mid-vectored-payload: header promises 1000, socket dies
    # after 300 — the half-landed scatter must complete as kErrConn
    def die_mid(conn):
        _fc_recv_exact(conn, M.BLOCKS_REQ_FIXED_BYTES + M.BLOCK_WIRE_BYTES)
        body = struct.pack("<qii", 1, M.STATUS_OK, 0) + data[:300]
        conn.sendall(HEADER.pack(8 + 12 + 4 + 1000, resp_t) + body)

    comp, _, alive = run_one(die_mid, [(1, 0, 1000)], 1000)
    _check(comp.status == -100 and not alive,
           "peer close mid-payload -> kErrConn, conn dropped")

    # CRC-bad trailer: well-formed frame, wrong checksum — the request
    # fails softly (crc_state=-1) and the CONNECTION must survive
    def bad_crc(conn):
        _fc_recv_exact(conn, M.BLOCKS_REQ_FIXED_BYTES + M.BLOCK_WIRE_BYTES)
        payload = data[:256]
        bad = (zlib.crc32(payload) ^ 0xFFFF) & 0xFFFFFFFF
        body = (struct.pack("<qii", 1, M.STATUS_OK, M.FLAG_CRC32)
                + payload + struct.pack("<I", bad))
        conn.sendall(HEADER.pack(8 + len(body), resp_t) + body)
        _fc_recv_exact(conn, 1)

    comp, dst, alive = run_one(bad_crc, [(1, 0, 256)], 256)
    _check(comp.status == M.STATUS_OK and comp.crc_state == -1 and alive,
           "CRC-bad trailer -> crc_state=-1, conn survives")
    _check(dst == data[:256],
           "CRC-bad payload still scattered byte-exact (caller discards)")

    # against the REAL server: the biggest request frame fc_submit may
    # emit (65534 zero-length blocks -> a 65534-entry CRC trailer of
    # empty-string checksums verified in C), then one block past it
    with tempfile.NamedTemporaryFile(suffix=".fc", delete=False) as f:
        f.write(data)
        path = f.name
    server = lib.bs_create(b"127.0.0.1", 0, 1, None, 0)
    try:
        _check(bool(server), "bs_create")
        lib.bs_set_checksum(server, 1)
        port = lib.bs_port(server)
        _check(lib.bs_register_file(server, 9, path.encode()) == 0,
               "bs_register_file")
        eng = lib.fc_create()
        assert eng, "fc_create"
        try:
            conn = lib.fc_connect(eng, b"127.0.0.1", port, 0, 5000)
            _check(conn > 0, "fc_connect to real server")
            nmax = ((M.NATIVE_MAX_REQ_FRAME - M.BLOCKS_REQ_FIXED_BYTES)
                    // M.BLOCK_WIRE_BYTES)
            wire = struct.pack("<IQI", 9, 0, 0) * nmax
            rc = lib.fc_submit(eng, conn, 7, 0, wire, nmax, None, 0)
            _check(rc == 0, f"max-frame submit ({nmax} blocks) accepted")
            over = wire + struct.pack("<IQI", 9, 0, 0)
            rc = lib.fc_submit(eng, conn, 8, 0, over, nmax + 1, None, 0)
            _check(rc == -2, "one block past kMaxReqFrame rejected "
                             "client-side (-2), never sent")
            lib.fc_flush(eng)
            comp = _fc_wait(lib, eng, 1)[0]
            _check(comp.status == M.STATUS_OK and comp.crc_state == 1
                   and comp.nbytes == 0,
                   "max-frame response: OK, 65534 empty CRCs verified")
            # sanity: a real payload round-trips through lease-style
            # memory with its trailer verified in C
            dst = ctypes.create_string_buffer(4096)
            rc = lib.fc_submit(eng, conn, 9, 0,
                               struct.pack("<IQI", 9, 0, 4096), 1,
                               ctypes.addressof(dst), 4096)
            _check(rc == 0, "payload submit")
            lib.fc_flush(eng)
            comp = _fc_wait(lib, eng, 1)[0]
            _check(comp.status == M.STATUS_OK and comp.crc_state == 1
                   and comp.nbytes == 4096 and dst.raw[:4096] == data,
                   "payload scattered byte-exact, CRC verified in C")
            _check(lib.fc_frames_sent(eng) == 2
                   and lib.fc_writev_count(eng) >= 1,
                   "doorbell counters: only the accepted frames sent")
        finally:
            lib.fc_destroy(eng)
    finally:
        lib.bs_stop(server)
        os.unlink(path)


def main(argv) -> int:
    so = (argv[0] if argv else
          os.environ.get("TPU_SHUFFLE_SANITIZER_SO", ""))
    if not so or not os.path.exists(so):
        print("usage: python -m sparkrdma_tpu_torch.analysis.native_harness "
              "<instrumented libtpushuffle .so>", file=sys.stderr)
        return 2
    print(f"native harness: {so}")
    lib = _load(so)
    exercise_writer_scatter(lib)
    exercise_block_server(lib)
    exercise_zero_copy_serve(lib)
    exercise_fair_serving(lib)
    exercise_fetch_client(lib)
    print("native harness: all exercises passed")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
