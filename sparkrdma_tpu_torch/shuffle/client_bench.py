"""Client-side CPU-per-GB microbench: the native fetch engine, measured.

Port of ``sparkrdma_tpu/shuffle/client_bench.py``, name for name; the
device it uploads to is a ``torch.device`` (``cuda`` unless the caller
asks for another; without a card it raises).

The receive-side mirror of ``serve_bench.py``: the paper's zero-copy
claim cuts BOTH ends of the wire, and this harness measures the
client's half — **client-side CPU per GB fetched** (``getrusage`` of
the fetching process) alongside throughput and the wire-to-device
latency of one request's payload.

Methodology (the serve bench's, mirrored):

* the SERVER runs in a subprocess (its epoll workers burn none of this
  process's rusage); the CLIENT runs IN THIS PROCESS, so
  ``RUSAGE_SELF`` deltas isolate the fetching side's CPU;
* the A/B baseline is the pure-Python receive path doing exactly the
  per-byte work today's fetcher does: frame reassembly from the socket,
  the response-payload copy the message decode makes, per-block CRC32
  verification in Python zlib, and the per-block slicing that feeds
  per-map results. The native mode drives ``NativeFetchEngine``:
  doorbell-batched submits whose payloads scatter straight into
  BufferPool lease memory with trailers verified in C — no Python bytes
  object on the path;
* both modes fetch the same block schedule from the same server; a
  separate UNMEASURED parity pass digests every payload byte per
  request, so byte-identity is gated without polluting the CPU window;
* the wire-to-device probe times one request's payload from issue to a
  device tensor on ``device``, synchronised: the Python mode uploads a
  host bytes object, the native mode stages the filled lease view
  through ``device_plane.stage_to_device`` over a one-shard mesh.
"""

from __future__ import annotations

import json
import os
import resource
import socket
import struct
import subprocess
import sys
import time
import zlib
from typing import Dict, List, Optional, Tuple

# Block server in a subprocess: register the bench file (attested at the
# client's block geometry) and serve until stdin closes. The port goes
# to stdout as JSON; the parent owns the file's lifetime.
_SERVER = r"""
import json, os, sys, zlib
from sparkrdma_tpu_torch.runtime.blockserver import BlockServer
path, checksum, block_len = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
crc_ranges, off = [], 0
with open(path, "rb") as f:
    while True:
        seg = f.read(block_len)
        if not seg:
            break
        crc_ranges.append((off, len(seg), zlib.crc32(seg)))
        off += len(seg)
srv = BlockServer(threads=2, checksum=bool(checksum))
srv.register_file(1, path, crc_ranges=crc_ranges)
print(json.dumps({"port": srv.port}), flush=True)
sys.stdin.read()
srv.stop()
"""

_WINDOW = 4  # in-flight requests per mode, both modes


def _cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def _schedule(file_size: int, block_len: int, per_req: int,
              total_bytes: int) -> List[List[Tuple[int, int, int]]]:
    """The shared block schedule: rotating offsets over the file, the
    same requests in the same order for both modes."""
    nblocks = max(1, file_size // block_len)
    reqs, pos, sent = [], 0, total_bytes
    while sent > 0:
        blocks = []
        for _ in range(per_req):
            blocks.append((1, (pos % nblocks) * block_len, block_len))
            pos += 1
        reqs.append(blocks)
        sent -= per_req * block_len
    return reqs


# -- the pure-Python receive path (today's fetcher, distilled) -----------


class _PyClient:
    """Frame reassembly + decode copy + Python CRC verify + per-block
    slicing: the per-byte work ``endpoint.fetch_blocks`` and the
    fetcher's per-map emission do, without the control-plane scaffolding
    (which costs per REQUEST, not per byte)."""

    def __init__(self, host: str, port: int):
        self.sock = socket.create_connection((host, port), timeout=30)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _recv_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(min(1 << 20, n - len(buf)))
            if not chunk:
                raise RuntimeError("server closed connection")
            buf += chunk
        return bytes(buf)

    def _read_resp(self, blocks) -> bytes:
        head = self._recv_exact(8)
        total, _ = struct.unpack("<II", head)
        body = self._recv_exact(total - 8)
        _, status = struct.unpack_from("<qi", body, 0)
        (flags,) = struct.unpack_from("<i", body, 12)
        if status != 0:
            raise RuntimeError(f"fetch failed: status {status}")
        payload = body[16:]  # the decode's payload copy
        if flags & 4:  # FLAG_CRC32: verify every block, strip trailer
            n = len(blocks)
            payload, trailer = payload[:-4 * n], payload[-4 * n:]
            crcs = struct.unpack(f"<{n}I", trailer)
            pos = 0
            for (_, _, ln), crc in zip(blocks, crcs):
                if zlib.crc32(payload[pos:pos + ln]) != crc:
                    raise RuntimeError("CRC trailer mismatch")
                pos += ln
        return payload

    def run(self, reqs, digest: bool) -> Dict[int, int]:
        """Pipeline the schedule ``_WINDOW`` deep; returns per-request
        CRC digests when ``digest`` (the parity pass), else {}."""
        digests: Dict[int, int] = {}
        i, inflight = 0, []
        while i < len(reqs) or inflight:
            while i < len(reqs) and len(inflight) < _WINDOW:
                blocks = reqs[i]
                payload = struct.pack("<qiI", i, 0, len(blocks))
                payload += b"".join(struct.pack("<IQI", *b) for b in blocks)
                self.sock.sendall(struct.pack("<II", 8 + len(payload), 9)
                                  + payload)
                inflight.append(i)
                i += 1
            rid = inflight.pop(0)
            payload = self._read_resp(reqs[rid])
            # the per-map emission: one slice per block
            pos, segs = 0, []
            for (_, _, ln) in reqs[rid]:
                segs.append(payload[pos:pos + ln])
                pos += ln
            if digest:
                digests[rid] = zlib.crc32(payload)
        return digests

    def close(self) -> None:
        self.sock.close()


# -- the native engine path ----------------------------------------------


class _NativeClient:
    """NativeFetchEngine into BufferPool leases: submits doorbell-batch,
    payloads scatter into lease memory, CRC verified in C, per-map
    emission is refcounted view slicing."""

    def __init__(self, host: str, port: int, pool, batch: int):
        from sparkrdma_tpu_torch.shuffle.native_fetch import NativeFetchEngine

        self.eng = NativeFetchEngine()
        self.conn = self.eng.connect(host, port, timeout_ms=20000)
        if self.conn <= 0:
            self.eng.close()
            raise RuntimeError("native engine connect failed")
        self.pool = pool
        self.batch = max(1, batch)

    def run(self, reqs, digest: bool) -> Dict[int, int]:
        digests: Dict[int, int] = {}
        leases: Dict[int, object] = {}
        i, queued = 0, 0
        while i < len(reqs) or leases:
            while i < len(reqs) and len(leases) < 2 * _WINDOW:
                blocks = reqs[i]
                nbytes = sum(ln for _, _, ln in blocks)
                lease = self.pool.get_registered(nbytes)
                rc = self.eng.submit(self.conn, i, 0, blocks,
                                     lease._buf.view.ctypes.data, nbytes)
                if rc != 0:
                    lease.release()
                    raise RuntimeError(f"fc_submit failed rc={rc}")
                leases[i] = (lease, nbytes, blocks)
                i += 1
                queued += 1
                if queued >= self.batch:
                    self.eng.flush()
                    queued = 0
            if queued:
                self.eng.flush()
                queued = 0
            for c in self.eng.poll(timeout_ms=100):
                lease, nbytes, blocks = leases.pop(c.req_id)
                try:
                    if not c.ok or c.nbytes != nbytes:
                        raise RuntimeError(f"native fetch failed: {c}")
                    # the per-map emission: one refcounted view per block
                    views = [lease.slice(ln) for (_, _, ln) in blocks]
                    if digest:
                        digests[c.req_id] = zlib.crc32(
                            lease._buf.view[:nbytes])
                    for _ in views:  # each slice holds a lease ref
                        lease.release()
                finally:
                    lease.release()  # creator's reference
        return digests

    def stats(self) -> Dict[str, int]:
        return {"flushes": self.eng.flush_count,
                "writevs": self.eng.writev_count,
                "frames": self.eng.frames_sent}

    def close(self) -> None:
        self.eng.close()


# -- wire -> device ------------------------------------------------------


def _device_probe(make_fetch, blocks, reps: int = 5) -> float:
    """Median seconds from request issue to a ready device tensor holding
    the payload. ``make_fetch`` returns a fresh one-shot closure per rep
    (connection setup happens outside the timed window); the closure
    itself returns the device tensor, so each mode's host staging, or
    its absence, is inside the measurement, and so is the upload: a
    tensor on ``cuda`` is waited for with ``torch.cuda.synchronize``."""
    import torch

    times = []
    for _ in range(reps):
        fetch = make_fetch()
        t0 = time.perf_counter()
        dev = fetch(blocks)
        if dev.is_cuda:
            torch.cuda.synchronize(dev.device)
        times.append(time.perf_counter() - t0)
        del dev
    times.sort()
    return times[len(times) // 2]


def run_client_microbench(spill_root: str, file_mb: int = 64,
                          total_mb: int = 256, block_kb: int = 256,
                          blocks_per_req: int = 8, checksum: bool = True,
                          doorbell_batch: int = 8, device=None) -> Dict:
    """Returns (``device``: where the wire-to-device probe uploads,
    ``cuda`` unless given)::

        {"cpu_s_per_gb": {"python": c, "native": c},
         "cpu_speedup": python/native,
         "throughput_gb_s": {"python": t, "native": t},
         "identical": bool, "checksum": bool,
         "wire_to_device_ms": {"python": m, "native": m},
         "doorbell": {"flushes": n, "writevs": n, "frames": n},
         "bytes_per_mode": n, "file_mb": n, "block_kb": n}
    """
    import numpy as np

    from sparkrdma_tpu_torch.config import TpuShuffleConf
    from sparkrdma_tpu_torch.parallel.mesh import resolve_device
    from sparkrdma_tpu_torch.runtime import native
    from sparkrdma_tpu_torch.runtime.pool import BufferPool

    # resolved first: without a card this raises before the server starts
    device = resolve_device(device)
    if not native.available() or not native.has_fetch_client():
        raise RuntimeError("native fetch client not built (the shim "
                           "runtime/shim_build.py builds from csrc/)")
    os.makedirs(spill_root, exist_ok=True)
    path = os.path.join(spill_root, "client_bench.data")
    file_size = file_mb << 20
    block_len = block_kb << 10
    rng = os.urandom(1 << 20)
    with open(path, "wb") as f:
        for _ in range(file_mb):
            f.write(rng)

    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    srv = subprocess.Popen(
        [sys.executable, "-c", _SERVER, path, str(int(checksum)),
         str(block_len)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env)
    pool: Optional[BufferPool] = None
    try:
        port = json.loads(srv.stdout.readline())["port"]
        pool = BufferPool(TpuShuffleConf())
        reqs = _schedule(file_size, block_len, blocks_per_req,
                         total_mb << 20)

        def py_client():
            return _PyClient("127.0.0.1", port)

        def nat_client():
            return _NativeClient("127.0.0.1", port, pool, doorbell_batch)

        # parity pass (unmeasured; doubles as the warm pass): every
        # payload byte digested per request, modes must agree exactly
        parity = _schedule(file_size, block_len, blocks_per_req, file_size)
        c = py_client()
        py_digests = c.run(parity, digest=True)
        c.close()
        n = nat_client()
        nat_digests = n.run(parity, digest=True)
        n.close()
        identical = py_digests == nat_digests and len(py_digests) > 0

        res: Dict[str, Dict] = {}
        doorbell = {}
        for mode, make in (("python", py_client), ("native", nat_client)):
            client = make()
            cpu0 = _cpu_s()
            t0 = time.perf_counter()
            client.run(reqs, digest=False)
            wall = time.perf_counter() - t0
            cpu = _cpu_s() - cpu0
            if mode == "native":
                doorbell = client.stats()
            client.close()
            gb = len(reqs) * blocks_per_req * block_len / (1 << 30)
            res[mode] = {"cpu_s_per_gb": cpu / gb if gb else 0.0,
                         "throughput_gb_s": gb / wall if wall else 0.0}

        # wire -> device: one request's payload to a ready device tensor
        import torch

        from sparkrdma_tpu_torch.parallel.device_plane import stage_to_device
        from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

        probe_blocks = reqs[0]
        nbytes = sum(ln for _, _, ln in probe_blocks)
        one_shard = VirtualMesh(1, device)

        def _py_frame(rid, blocks):
            payload = struct.pack("<qiI", rid, 0, len(blocks))
            payload += b"".join(struct.pack("<IQI", *b) for b in blocks)
            return struct.pack("<II", 8 + len(payload), 9) + payload

        def py_probe():
            c = py_client()

            def fetch(blocks):
                c.sock.sendall(_py_frame(0, blocks))
                payload = c._read_resp(blocks)
                c.close()
                # host bytes -> host ndarray -> device copy
                return torch.from_numpy(
                    np.frombuffer(payload, np.uint8)).to(device)

            return fetch

        def nat_probe():
            n = nat_client()

            def fetch(blocks):
                lease = pool.get_registered(nbytes)
                rc = n.eng.submit(n.conn, 1, 0, blocks,
                                  lease._buf.view.ctypes.data, nbytes)
                assert rc == 0, rc
                n.eng.flush()
                done = []
                while not done:
                    done = n.eng.poll(timeout_ms=100)
                assert done[0].ok, done[0]
                view = lease.slice(nbytes)  # wire bytes already in place
                dev = stage_to_device(view, one_shard)
                lease.release()  # slice ref — buffer reused after ready
                lease.release()  # creator ref
                n.close()
                return dev

            return fetch

        w2d = {"python": _device_probe(py_probe, probe_blocks),
               "native": _device_probe(nat_probe, probe_blocks)}

        nat_cpu = res["native"]["cpu_s_per_gb"]
        return {
            "cpu_s_per_gb": {m: round(r["cpu_s_per_gb"], 4)
                             for m, r in res.items()},
            "cpu_speedup": (round(res["python"]["cpu_s_per_gb"] / nat_cpu, 2)
                            if nat_cpu > 0 else float("inf")),
            "throughput_gb_s": {m: round(r["throughput_gb_s"], 2)
                                for m, r in res.items()},
            "identical": identical,
            "checksum": checksum,
            "wire_to_device_ms": {m: round(v * 1e3, 2)
                                  for m, v in w2d.items()},
            "doorbell": doorbell,
            "bytes_per_mode": len(reqs) * blocks_per_req * block_len,
            "file_mb": file_mb,
            "block_kb": block_kb,
        }
    finally:
        if pool is not None:
            pool.stop()
        try:
            srv.stdin.close()
            srv.wait(timeout=20)
        except Exception:  # noqa: BLE001 — teardown best-effort
            srv.kill()
        os.unlink(path)


def main() -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--total-mb", type=int, default=512)
    ap.add_argument("--file-mb", type=int, default=64)
    ap.add_argument("--block-kb", type=int, default=256)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(prefix="clientbench_") as td:
        for checksum in (False, True):
            res = run_client_microbench(td, file_mb=args.file_mb,
                                        total_mb=args.total_mb,
                                        block_kb=args.block_kb,
                                        checksum=checksum)
            print(json.dumps(res, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
