"""The shuffle reader's host-to-device on-ramp.

Port of the staging in ``TpuShuffleReader.read_to_device``
(``sparkrdma_tpu/shuffle/reader.py:153-222``) as a function over the
fetched byte chunks, so it needs neither the reader nor its fetcher
(both come with the copy of the host plane). The JAX method's other
branch, handing pool-lease memory to the device directly when the native
fetch engine landed every chunk there (``reader.py:184-201``), needs the
buffer pool and that engine, and waits for them.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple, Union

import numpy as np
import torch

from sparkrdma_tpu_torch.parallel.mesh import resolve_device


def _gather(chunks: Iterable, row_bytes: int, pin: bool) -> torch.Tensor:
    """Every chunk's bytes, in order, in one host buffer (page-locked when
    ``pin``): the staging's one materialization. Raises ``ValueError`` for
    a chunk that does not hold whole rows, as ``decode_rows`` does."""
    parts = [np.frombuffer(c, dtype=np.uint8) for c in chunks]
    for part in parts:
        if len(part) % row_bytes:
            raise ValueError(f"byte length {len(part)} not a multiple of "
                             f"row size {row_bytes}")
    host = torch.empty(sum(len(p) for p in parts), dtype=torch.uint8,
                       pin_memory=pin)
    buf = host.numpy()
    pos = 0
    for part in parts:
        buf[pos:pos + len(part)] = part
        pos += len(part)
    return host


def read_to_device(chunks: Iterable, row_payload_bytes: int,
                   device: Optional[Union[str, torch.device]] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage fetched ``key | payload`` row bytes on ``device`` (``cuda``
    unless the caller asks for another; with no card and no request this
    raises).

    ``chunks`` are bytes-like blocks of whole rows (``bytes``,
    ``bytearray``, ``memoryview`` or a u8 array), for example a
    resolver's ``local_blocks``. They are gathered into one pinned host
    buffer, which goes up in ONE ``non_blocking`` copy; keys and payload
    are split on the card, and the copy is waited for before returning,
    so the caller may free or reuse the chunks at once.

    Returns ``(keys int32[N, 2], payload uint8[N, W])`` on the device:
    each key as its (lo, hi) u32 words in int32 bits (``utils.u32``), the
    JAX method's ``u32[N, 2]``. Empty input gives ``[0, 2]`` and
    ``[0, W]``."""
    device = resolve_device(device)
    row_bytes = 8 + row_payload_bytes
    host = _gather(chunks, row_bytes, pin=device.type == "cuda")
    if host.numel() == 0:
        return (torch.zeros((0, 2), dtype=torch.int32, device=device),
                torch.zeros((0, row_payload_bytes), dtype=torch.uint8,
                            device=device))
    rows = host.to(device, non_blocking=True).view(-1, row_bytes)
    keys = rows[:, :8].contiguous().view(torch.int32)
    payload = rows[:, 8:].contiguous()
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return keys, payload
