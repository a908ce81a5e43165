"""At-rest integrity: CRC32 sidecars for committed shuffle files.

The serving path has no server CPU in the loop — a committed shuffle
file is mmap'd and served one-sided (PAPER §0), so a torn commit or
bit-rot is served silently unless integrity lives in the data itself
("RPC Considered Harmful"'s point, applied to disk). At commit the
writer's per-partition CRC32s (computed while the bytes stream through
the merge — no extra read) are written to a ``<data>.crc`` sidecar next
to the ``.index``; the resolver verifies them on mmap-open after a
restart and spot-checks at serve time (see
``shuffle/resolver.py``). Gated by the ``at_rest_checksum`` conf key.

Sidecar format (little-endian)::

    u32 magic ("CRC1")  u32 version  u64 fence  u32 file_crc
    u32 reserved        u64 nparts   u32[nparts] partition CRCs

``fence`` is the committing attempt's fencing token, so a restarted
executor re-publishes recovered outputs under the epoch they committed
with (commit fencing, ``shuffle/resolver.py``). ``file_crc`` is the
CRC32 of the whole data file — always equal to the in-order
:func:`crc32_combine` of the partition CRCs, recorded redundantly so a
whole-file check needs no combine pass.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import List, Optional, Sequence, Tuple

MAGIC = 0x31435243  # "CRC1" little-endian
VERSION = 1
_HEADER = struct.Struct("<IIQIIQ")


class CorruptOutputError(Exception):
    """A committed map output failed its at-rest CRC verification. The
    serving side demotes this to a retryable ``STATUS_CORRUPT`` fetch
    status; the reducer's retry envelope escalates it to FetchFailed
    with a ``corrupt_output`` verdict and the recovery loop re-executes
    the producing map task (not only on peer loss)."""

    def __init__(self, path: str, detail: str):
        super().__init__(f"{path}: {detail}")
        self.path = path


def sidecar_path(data_path: str) -> str:
    return data_path + ".crc"


# -- CRC32 combination ----------------------------------------------------
# crc32(A || B) from crc32(A), crc32(B) and len(B) — zlib's crc32_combine,
# which CPython does not expose. Lets the merge CRC a partition assembled
# from sendfile'd spill segments WITHOUT reading the bytes back into
# userspace: each segment's CRC was computed when it was written.

def _gf2_matrix_times(mat: List[int], vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_matrix_square(square: List[int], mat: List[int]) -> None:
    for n in range(32):
        square[n] = _gf2_matrix_times(mat, mat[n])


# _ZERO_OPS[i] = the GF(2) operator matrix for appending 2^i zero BYTES,
# built lazily and cached: the matrices depend only on the length bit,
# and the merge calls crc32_combine once per (spill, partition) pair —
# rebuilding ~40 matrix squarings per call would put thousands of pure-
# Python matrix constructions on the write hot path.
_ZERO_OPS: List[List[int]] = []
_ZERO_OPS_LOCK = threading.Lock()


def _zero_ops(bits: int) -> List[List[int]]:
    """Operator matrices for 2^0 .. 2^(bits-1) zero bytes."""
    if len(_ZERO_OPS) >= bits:
        return _ZERO_OPS
    with _ZERO_OPS_LOCK:
        if not _ZERO_OPS:
            # operator for one zero bit: reflected polynomial, then shifts
            odd = [0xEDB88320] + [1 << (n - 1) for n in range(1, 32)]
            even = [0] * 32
            _gf2_matrix_square(even, odd)      # two zero bits
            _gf2_matrix_square(odd, even)      # four zero bits
            byte_op = [0] * 32
            _gf2_matrix_square(byte_op, odd)   # eight = one zero byte
            _ZERO_OPS.append(byte_op)
        while len(_ZERO_OPS) < bits:
            nxt = [0] * 32
            _gf2_matrix_square(nxt, _ZERO_OPS[-1])
            _ZERO_OPS.append(nxt)
    return _ZERO_OPS


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC32 of the concatenation of two byte ranges with known CRCs."""
    if len2 <= 0:
        return crc1
    ops = _zero_ops(len2.bit_length())
    i = 0
    while len2:
        if len2 & 1:
            crc1 = _gf2_matrix_times(ops[i], crc1)
        len2 >>= 1
        i += 1
    return crc1 ^ crc2


def combine_parts(crcs: Sequence[int], lengths: Sequence[int]) -> int:
    """Whole-file CRC from in-order partition (crc, length) pairs."""
    total = 0
    for crc, ln in zip(crcs, lengths):
        total = crc32_combine(total, int(crc), int(ln))
    return total


# -- range-aligned CRC reuse ----------------------------------------------
# The serve path recomputes nothing the commit already attested: a sidecar
# (or merge ledger) names per-range CRCs, and any served block whose
# [offset, offset+length) tiles those ranges end-to-end derives its
# trailer CRC by crc32_combine instead of re-hashing the bytes. Both
# serving dataplanes share this shape — the native server mirrors it in C
# (csrc/blockserver.cpp crc_from_table), the Python fallback calls
# :func:`ranges_crc` directly.

def partition_crc_ranges(partition_lengths: Sequence[int],
                         partition_crcs: Sequence[int]
                         ) -> List[Tuple[int, int, int]]:
    """Sidecar partition CRCs as sorted ``(offset, length, crc)`` ranges
    of the partition-contiguous data file (zero-length partitions
    dropped — they attest nothing and would stall range walks)."""
    out: List[Tuple[int, int, int]] = []
    off = 0
    for ln, crc in zip(partition_lengths, partition_crcs):
        ln = int(ln)
        if ln > 0:
            out.append((off, ln, int(crc) & 0xFFFFFFFF))
        off += ln
    return out


def ranges_crc(ranges: Sequence[Tuple[int, int, int]], offset: int,
               length: int) -> Optional[int]:
    """CRC32 of ``[offset, offset+length)`` when attested ranges tile it
    exactly (both endpoints aligned, no holes); None = not covered, the
    caller recomputes. ``ranges`` is sorted ``(offset, length, crc)``."""
    if length == 0:
        return 0
    import bisect
    i = bisect.bisect_left(ranges, offset, key=lambda r: r[0]) \
        if ranges else 0
    if i >= len(ranges) or ranges[i][0] != offset:
        return None
    end = offset + length
    cur = offset
    crc = 0
    while i < len(ranges):
        o, ln, c = ranges[i]
        if o != cur or cur + ln > end:
            return None
        crc = c if cur == offset else crc32_combine(crc, c, ln)
        cur += ln
        if cur == end:
            return crc
        i += 1
    return None


# -- sidecar I/O ----------------------------------------------------------

def write_sidecar(data_path: str, fence: int,
                  partition_crcs: Sequence[int],
                  partition_lengths: Sequence[int]) -> str:
    """Atomically write the sidecar (tmp + rename — a crash leaves either
    the old sidecar or none, never a torn one). Returns the path."""
    path = sidecar_path(data_path)
    file_crc = combine_parts(partition_crcs, partition_lengths)
    blob = _HEADER.pack(MAGIC, VERSION, max(0, int(fence)), file_crc, 0,
                        len(partition_crcs))
    blob += struct.pack(f"<{len(partition_crcs)}I",
                        *(int(c) & 0xFFFFFFFF for c in partition_crcs))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return path


def read_sidecar(data_path: str) -> Optional[Tuple[int, List[int], int]]:
    """(fence, partition_crcs, file_crc), or None when absent/unreadable
    (pre-sidecar commits, or at_rest_checksum was off)."""
    path = sidecar_path(data_path)
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return None
    if len(blob) < _HEADER.size:
        return None
    magic, version, fence, file_crc, _, nparts = _HEADER.unpack_from(blob, 0)
    if magic != MAGIC or version != VERSION:
        return None
    if len(blob) < _HEADER.size + 4 * nparts:
        return None
    crcs = list(struct.unpack_from(f"<{nparts}I", blob, _HEADER.size))
    return int(fence), crcs, int(file_crc)


def file_crc32(path: str, chunk: int = 1 << 20) -> int:
    """CRC32 of a whole file, streamed."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def partition_crcs_of_file(path: str,
                           partition_lengths: Sequence[int],
                           chunk: int = 1 << 20) -> List[int]:
    """Per-partition CRC32s of a partition-contiguous data file (used by
    commits whose writer didn't stream them — the monolithic baseline)."""
    crcs: List[int] = []
    with open(path, "rb") as f:
        for ln in partition_lengths:
            remaining = int(ln)
            crc = 0
            while remaining > 0:
                block = f.read(min(chunk, remaining))
                if not block:
                    raise CorruptOutputError(
                        path, "file shorter than declared partitions")
                crc = zlib.crc32(block, crc)
                remaining -= len(block)
            crcs.append(crc)
    return crcs
