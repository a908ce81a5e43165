"""The writer's row format, decoded: ``key (8 bytes LE) | payload (W
bytes)`` rows, partition-contiguous.

A partial copy of ``sparkrdma_tpu/shuffle/writer.py`` holding only what
the mesh service reads committed map outputs with: ``decode_rows``
(``writer.py:1072-1089``) and ``_rows_keys`` (``writer.py:96-104``). The
full copy of the host plane replaces it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _rows_keys(rows: np.ndarray) -> np.ndarray:
    """u64 key column of a ``(n, row_bytes)`` u8 row matrix, zero-copy.

    numpy >= 1.23 allows the dtype view when the last axis is contiguous
    (the key slice's is); older numpy needs the copy."""
    try:
        return rows[:, :8].view(np.uint64)[:, 0]
    except ValueError:
        return rows[:, :8].copy().view(np.uint64).reshape(-1)


def decode_rows(data, row_payload_bytes: int,
                copy: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of the writer's row format: bytes -> (keys, payload).

    One materialization, not two: with ``copy=True`` (default) the row
    bytes are copied ONCE and both returned arrays are zero-copy views
    into that copy — use when ``data`` is transient (a pool lease about to
    be released). With ``copy=False`` both arrays view ``data`` directly
    (zero copies; read-only when ``data`` is an immutable bytes object) —
    use when the caller owns the bytes for the arrays' lifetime."""
    row_bytes = 8 + row_payload_bytes
    if len(data) % row_bytes:
        raise ValueError(f"byte length {len(data)} not a multiple of row size "
                         f"{row_bytes}")
    rows = np.frombuffer(data, dtype=np.uint8).reshape(-1, row_bytes)
    if copy:
        rows = rows.copy()
    return _rows_keys(rows), rows[:, 8:]
