"""Serve-side CPU-per-GB microbench: the zero-copy serve path, measured.

The paper's serving claim is a CPU claim, not (only) a latency claim: the
remote CPU does constant work per READ regardless of bytes served. The
host fallback can't reach zero, but the zero-copy serve path
(csrc/blockserver.cpp) should cut the per-byte server cost to the one
unavoidable kernel copy (mapping -> socket buffer) — no userspace memcpy
into a response buffer, no CRC recompute where the at-rest sidecar
already attests the range. This harness measures exactly that, the way
the ROADMAP asks: **serve-side CPU per GB served** (``getrusage`` of the
serving process) alongside throughput.

Methodology:

* the server runs IN THIS PROCESS (the native epoll workers are its only
  active threads during the window); the client is a SUBPROCESS — a
  self-contained socket script with no sparkrdma imports — so
  ``RUSAGE_SELF`` deltas isolate the serving side's CPU;
* one data file registers under two tokens: the A/B baseline serves the
  un-attested token with ``bs_set_zero_copy(0)`` — byte-for-byte the old
  copy-and-recompute path — the fast mode serves the attested token
  zero-copy;
* each mode warms its mapping (one full pass) before the measured reps,
  so both pay only soft faults; CPU ratios are host-contention-robust
  (rusage counts cycles, not wall time);
* the client returns a CRC32 digest over every payload byte — the
  byte-identity gate across modes — and verifies CRC trailers against
  its own zlib when checksums are on (the reuse-parity gate).

Shared by ``bench.py`` (``serve_cpu_per_gb`` / ``serve_throughput``
secondaries) and the tier-1 acceptance test in
``tests/test_serve_path.py`` (>= 1.5x less serve CPU per GB, equal-or-
better throughput, byte-identical responses with CRC on and off).
"""

from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import zlib
from typing import Dict, List, Tuple

# Self-contained fetch client (run as ``python -c`` in a subprocess): no
# package imports, so a fresh interpreter costs ~50 ms and none of the
# serving process's CPU. Speaks the FetchBlocks wire protocol directly.
_CLIENT = r"""
import json, socket, struct, sys, time, zlib
host, port, token, file_size, block_len, per_req, total_bytes, verify = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
    int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7]), int(sys.argv[8]))
sock = socket.create_connection((host, port))
sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

def req_frame(req_id, blocks):
    payload = struct.pack("<qiI", req_id, 0, len(blocks))
    for (t, o, ln) in blocks:
        payload += struct.pack("<IQI", t, o, ln)
    return struct.pack("<II", 8 + len(payload), 9) + payload

def recv_exact(n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise SystemExit("server closed connection")
        buf += chunk
    return bytes(buf)

def read_resp():
    head = recv_exact(8)
    total, _type = struct.unpack("<II", head)
    body = recv_exact(total - 8)
    req_id, status = struct.unpack_from("<qi", body, 0)
    flags, = struct.unpack_from("<i", body, 12)
    return status, flags, body[16:]

nblocks = max(1, file_size // block_len)
reqs = []
pos = 0
sent = total_bytes
req_id = 0
while sent > 0:
    blocks = []
    for _ in range(per_req):
        off = (pos % nblocks) * block_len
        pos += 1
        blocks.append((token, off, block_len))
    reqs.append(req_frame(req_id, blocks))
    req_id += 1
    sent -= per_req * block_len

digest = 0
trailer_ok = True
got_bytes = 0
window = 4
inflight = 0
i = 0
t0 = time.perf_counter()
while i < len(reqs) or inflight:
    while i < len(reqs) and inflight < window:
        sock.sendall(reqs[i])
        i += 1
        inflight += 1
    status, flags, data = read_resp()
    inflight -= 1
    if status != 0:
        raise SystemExit(f"serve failed: status {status}")
    if flags & 4:  # FLAG_CRC32 trailer: one u32 per requested block
        body, trailer = data[:-4 * per_req], data[-4 * per_req:]
        if verify:
            crcs = struct.unpack(f"<{per_req}I", trailer)
            p = 0
            for c in crcs:
                seg = body[p:p + block_len]
                p += block_len
                if zlib.crc32(seg) != c:
                    trailer_ok = False
    else:
        body = data
    digest = zlib.crc32(body, digest)
    got_bytes += len(body)
wall = time.perf_counter() - t0
print(json.dumps({"digest": digest, "bytes": got_bytes, "wall_s": wall,
                  "trailer_ok": trailer_ok}))
"""


def _run_client(port: int, token: int, file_size: int, block_len: int,
                per_req: int, total_bytes: int, verify: bool) -> Dict:
    out = subprocess.run(
        [sys.executable, "-c", _CLIENT, "127.0.0.1", str(port), str(token),
         str(file_size), str(block_len), str(per_req), str(total_bytes),
         str(int(verify))],
        capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"serve-bench client failed: {out.stderr[-500:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def run_serve_microbench(spill_root: str, file_mb: int = 64,
                         total_mb: int = 256, block_kb: int = 1024,
                         blocks_per_req: int = 8, checksum: bool = False,
                         threads: int = 2) -> Dict:
    """Returns::

        {"cpu_s_per_gb": {"memcpy": c, "zero_copy": c},
         "cpu_speedup": memcpy/zero_copy,
         "throughput_gb_s": {"memcpy": t, "zero_copy": t},
         "identical": bool, "trailer_ok": bool, "checksum": bool,
         "zero_copy_blocks": n, "crc_reused": n, "bytes_per_mode": n}
    """
    from sparkrdma_tpu_torch.runtime import native
    from sparkrdma_tpu_torch.runtime.blockserver import BlockServer

    if not native.available() or not native.has_serve_path():
        raise RuntimeError("native serve path not built (make -C csrc)")
    os.makedirs(spill_root, exist_ok=True)
    path = os.path.join(spill_root, "serve_bench.data")
    file_size = file_mb << 20
    block_len = block_kb << 10
    rng = os.urandom(1 << 20)
    with open(path, "wb") as f:
        for _ in range(file_mb):
            f.write(rng)  # content repetition is fine; CRCs don't care
    # attested ranges at exactly the client's block geometry, so the
    # fast mode's CRC trailers reuse committed CRCs (the sidecar shape)
    crc_ranges: List[Tuple[int, int, int]] = []
    with open(path, "rb") as f:
        off = 0
        while off < file_size:
            seg = f.read(block_len)
            crc_ranges.append((off, len(seg), zlib.crc32(seg)))
            off += len(seg)

    srv = BlockServer(threads=threads, checksum=checksum)
    try:
        srv.register_file(1, path)                        # un-attested
        srv.register_file(2, path, crc_ranges=crc_ranges)  # attested
        total_bytes = total_mb << 20
        res: Dict[str, Dict] = {}
        for mode, token, zc in (("memcpy", 1, False), ("zero_copy", 2, True)):
            srv.set_zero_copy(zc)
            # warm the mode's mapping + page cache: one full pass
            _run_client(srv.port, token, file_size, block_len,
                        blocks_per_req, file_size, False)
            cpu0 = _cpu_s()
            out = _run_client(srv.port, token, file_size, block_len,
                              blocks_per_req, total_bytes, checksum)
            cpu = _cpu_s() - cpu0
            gb = out["bytes"] / (1 << 30)
            res[mode] = {
                "digest": out["digest"],
                "bytes": out["bytes"],
                "trailer_ok": out["trailer_ok"],
                "cpu_s_per_gb": cpu / gb if gb else 0.0,
                "throughput_gb_s": (gb / out["wall_s"]
                                    if out["wall_s"] else 0.0),
            }
        stats = srv.stats()
        zc_cpu = res["zero_copy"]["cpu_s_per_gb"]
        return {
            "cpu_s_per_gb": {m: round(r["cpu_s_per_gb"], 4)
                             for m, r in res.items()},
            "cpu_speedup": (round(res["memcpy"]["cpu_s_per_gb"] / zc_cpu, 2)
                            if zc_cpu > 0 else float("inf")),
            "throughput_gb_s": {m: round(r["throughput_gb_s"], 2)
                                for m, r in res.items()},
            "identical": (res["memcpy"]["digest"]
                          == res["zero_copy"]["digest"]
                          and res["memcpy"]["bytes"]
                          == res["zero_copy"]["bytes"]),
            "trailer_ok": all(r["trailer_ok"] for r in res.values()),
            "checksum": checksum,
            "zero_copy_blocks": stats["zero_copy_blocks"],
            "crc_reused": stats["crc_reused"],
            "bytes_per_mode": total_bytes,
            "file_mb": file_mb,
            "block_kb": block_kb,
        }
    finally:
        srv.stop()
        os.unlink(path)


def main() -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--total-mb", type=int, default=512)
    ap.add_argument("--file-mb", type=int, default=64)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(prefix="servebench_") as td:
        for checksum in (False, True):
            res = run_serve_microbench(td, file_mb=args.file_mb,
                                       total_mb=args.total_mb,
                                       checksum=checksum,
                                       threads=args.threads)
            print(json.dumps(res, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
