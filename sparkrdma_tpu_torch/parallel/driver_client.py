"""DriverClient: the executor's single, failover-aware driver channel.

Before driver HA, every executor-side component dialed the driver
through its own scattered ``ConnectionCache`` call sites (endpoints,
manager, fetcher, recovery), each with its own error story — a dead
driver connection surfaced as whatever the nearest caller did with a
``TransportError``: a burned fetch retry, a tombstoned live peer, or a
hung publish. This module centralizes the driver channel so failover is
ONE behavior everywhere:

* the driver's address is a mutable, forward-only pointer: a
  ``TakeoverMsg`` re-points it under a higher ``driver_incarnation``
  (stale re-points from a zombie's queued broadcast lose the comparison
  and are dropped, the same keep-highest rule every epoch receiver
  already applies);
* sends and requests retry ``TransportError`` against the CURRENT
  address under the existing backoff envelope
  (:class:`~sparkrdma_tpu_torch.parallel.transport.Backoff`), bounded by
  ``request_deadline_ms`` — sized to ride through a
  ``driver_lease_ms`` failover window;
* exhaustion raises :class:`DriverUnreachableError`, a RETRYABLE
  verdict the fetch/recovery layers classify as "driver down", which
  must never tombstone a live peer or burn the per-peer fetch budget
  (the peers are fine; only the control plane is electing).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional, Tuple

from sparkrdma_tpu_torch.parallel.transport import (Backoff, Connection,
                                              ConnectionCache,
                                              TransportError)
from sparkrdma_tpu_torch.parallel.rpc_msg import RpcMsg

log = logging.getLogger("sparkrdma_tpu_torch.driver_client")


class DriverUnreachableError(TransportError):
    """The driver did not answer within the deadline envelope — distinct
    from a PEER failure by construction: peers are reached directly, the
    driver only through :class:`DriverClient`. Retryable: a standby may
    be mid-takeover, and the next attempt may land on the re-pointed
    primary."""

    retryable = True


class DriverClient:
    """The one channel to the (current) driver.

    ``note_takeover`` is called from the executor's message handler when
    a ``TakeoverMsg`` lands; in-flight retry loops re-read the address
    every attempt, so a failover mid-retry converges without any caller
    cooperation.
    """

    def __init__(self, conf, clients: ConnectionCache,
                 addr: Tuple[str, int]):
        self._conf = conf
        self._clients = clients
        self._lock = threading.Lock()
        self._addr: Tuple[str, int] = (addr[0], int(addr[1]))
        self._incarnation = 0
        self.failovers_observed = 0  # audit: accepted re-points
        self.retried_sends = 0       # audit: attempts past the first

    @property
    def addr(self) -> Tuple[str, int]:
        with self._lock:
            return self._addr

    @property
    def incarnation(self) -> int:
        with self._lock:
            return self._incarnation

    def note_takeover(self, incarnation: int, host: str,
                      port: int) -> bool:
        """Re-point the driver address, forward-only: only a strictly
        higher incarnation wins, so a zombie primary's stale broadcast
        (or a reordered duplicate) can never re-point executors at a
        deposed driver. Returns True iff the pointer moved."""
        with self._lock:
            if incarnation <= self._incarnation:
                return False
            self._incarnation = incarnation
            self._addr = (host, int(port))
            self.failovers_observed += 1
            return True

    def conn(self) -> Connection:
        """The raw cached connection to the current address (compat for
        call sites that manage their own retries)."""
        return self._clients.get(*self.addr)

    # -- deadline-bounded retry envelope ---------------------------------

    def send(self, msg: RpcMsg,
             deadline_s: Optional[float] = None) -> None:
        """Fire-and-forget with the retry envelope: a publish/hello/sync
        racing a failover re-dials the re-pointed primary instead of
        dying with the old connection."""
        self._with_retry(lambda conn: conn.send(msg), deadline_s)

    def request(self, build: Callable[[Connection], RpcMsg],
                timeout: Optional[float] = None,
                deadline_s: Optional[float] = None) -> RpcMsg:
        """Request/response with the retry envelope. ``build`` mints the
        message against the attempt's connection so every attempt
        carries a FRESH req_id — re-sending a stale id against a new
        primary could orphan-match another waiter's response. Only
        ``TransportError`` is retried; a ``TimeoutError`` means the
        driver is reachable but slow, which the caller's own long-poll
        logic owns."""
        return self._with_retry(
            lambda conn: conn.request(build(conn), timeout=timeout),
            deadline_s)

    def _with_retry(self, fn: Callable[[Connection], object],
                    deadline_s: Optional[float]):
        budget = (deadline_s if deadline_s is not None
                  else self._conf.resolved_request_deadline_s())
        deadline = time.monotonic() + budget
        backoff = Backoff.from_conf(self._conf)
        attempt = 0
        last: Optional[TransportError] = None
        while True:
            addr = self.addr
            conn = None
            try:
                conn = self._clients.get(*addr)
                return fn(conn)
            except TransportError as e:
                last = e
                if conn is not None:
                    conn.close()  # force a re-dial (possibly re-pointed)
                log.debug("driver %s:%s attempt %d failed: %s", addr[0],
                          addr[1], attempt + 1, e)
            if time.monotonic() >= deadline:
                raise DriverUnreachableError(
                    f"driver {addr[0]}:{addr[1]} unreachable after "
                    f"{attempt + 1} attempts over {budget:.1f}s"
                ) from last
            self.retried_sends += 1
            backoff.sleep(attempt)
            attempt += 1
