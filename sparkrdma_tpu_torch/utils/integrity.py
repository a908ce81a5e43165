"""At-rest integrity errors of committed map outputs.

A partial copy of ``sparkrdma_tpu/utils/integrity.py`` holding only
``CorruptOutputError`` (``integrity.py:39``), which the mesh service's
staging skips. The full copy of the host plane replaces it.
"""

from __future__ import annotations


class CorruptOutputError(Exception):
    """A committed map output failed its at-rest CRC verification. The
    serving side demotes this to a retryable ``STATUS_CORRUPT`` fetch
    status; the reducer's retry envelope escalates it to FetchFailed
    with a ``corrupt_output`` verdict and the recovery loop re-executes
    the producing map task (not only on peer loss)."""

    def __init__(self, path: str, detail: str):
        super().__init__(f"{path}: {detail}")
        self.path = path
