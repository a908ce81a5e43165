"""Threaded TCP control-plane transport.

Plays the role of the reference's ``RdmaNode``/``RdmaChannel`` pair for
*control* traffic only (the data plane rides ICI collectives — see
``sparkrdma_tpu_torch.parallel.exchange``). Preserved semantics:

* listener with port-retry bind (java/RdmaNode.java:74-88),
* a per-process connection cache keyed by remote address, built lazily with
  a bounded retry/timeout loop (java/RdmaNode.java:283-353, connect budget
  ``maxConnectionAttempts`` x event timeout),
* request pipelining over one connection with completion callbacks — the
  QP work-request model (java/RdmaChannel.java:484-589) mapped to req_id
  correlation on a stream socket, with a bounded in-flight budget standing
  in for the send-queue-depth semaphore (java/RdmaChannel.java:66-67,
  422-482),
* parallel teardown that fails all outstanding requests
  (java/RdmaChannel.java:872-956).

Threading model mirrors the reference's one-CQ-thread-per-channel
(java/RdmaThread.java:26-64): one reader thread per connection dispatches
completions; senders never block on the network for replies.
"""

from __future__ import annotations

import itertools
import logging
import random
import socket
import threading
import time
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Callable, Dict, Optional, Tuple

from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.parallel.rpc_msg import Reassembler, RpcMsg

log = logging.getLogger(__name__)

Addr = Tuple[str, int]


class TransportError(RuntimeError):
    """Base transport failure. ``retryable`` classifies the outcome for
    the fetch retry envelope: connection loss / connect failure default to
    retryable (a re-dial or refetch usually heals); subclasses and raisers
    that know better override it (an authoritative unknown-map answer
    re-fails identically — retrying just doubles failure-path load)."""

    retryable = True


class ChecksumError(TransportError):
    """A fetch payload failed its CRC32 verification (bit-flip on the
    wire, or corruption at the server between read and send). Always
    retryable: the refetch re-reads the source bytes.

    When the verifier can tell WHICH blocks failed it attaches
    ``bad_blocks`` (request-order indices) and ``body`` (the full
    trailer-stripped payload): a vectored (cross-map) fetch then salvages
    every clean sub-range and refetches only the ranges that actually
    failed, attributing the retry to the map that owns them. Both stay
    ``None`` for failures with no per-block verdict (decompress/unwrap
    errors, size mismatches) — those retry whole-request."""

    def __init__(self, msg: str, bad_blocks=None, body=None):
        super().__init__(msg)
        self.bad_blocks = bad_blocks
        self.body = body


class FetchStatusError(TransportError):
    """A peer answered a fetch with a non-OK status. The raiser sets
    ``retryable`` from the status semantics it knows: transient
    server-side failures (credit-window expiry) heal on refetch,
    authoritative rejections (unknown map/shuffle, bad range) do not."""

    def __init__(self, what: str, status: int, retryable: bool = True):
        super().__init__(f"{what} status={status}")
        self.status = status
        self.retryable = retryable


class Backoff:
    """Exponential backoff with equal jitter: attempt ``k`` (0-based)
    sleeps in ``[s/2, s]`` where ``s = min(cap, base * 2^k)``. Equal
    jitter rather than full jitter so a retry budget provably spans
    wall-clock time (full jitter can draw ~0 on every attempt, turning
    the budget back into the hot-spin it exists to prevent) while still
    decorrelating the retry storms of many peers. A seeded ``rng`` makes
    chaos scenarios replay exactly."""

    def __init__(self, base_s: float, cap_s: float,
                 rng: Optional[random.Random] = None):
        self.base_s = max(0.0, base_s)
        self.cap_s = max(self.base_s, cap_s)
        self._rng = rng if rng is not None else random

    @classmethod
    def from_conf(cls, conf: TpuShuffleConf,
                  rng: Optional[random.Random] = None) -> "Backoff":
        return cls(conf.retry_backoff_base_ms / 1000,
                   conf.retry_backoff_cap_ms / 1000, rng)

    def delay(self, attempt: int) -> float:
        span = min(self.cap_s, self.base_s * (1 << max(0, min(attempt, 60))))
        return span / 2 + self._rng.uniform(0, span / 2)

    def sleep(self, attempt: int,
              interrupt: Optional[threading.Event] = None) -> bool:
        """Sleep out attempt ``attempt``'s delay; with ``interrupt``, an
        abort wakes the sleep early (returns True iff interrupted)."""
        d = self.delay(attempt)
        if interrupt is not None:
            return interrupt.wait(d)
        time.sleep(d)
        return False


def await_response(fut: Future, timeout: Optional[float]) -> RpcMsg:
    """Wait out a request future with the claim-back race handling every
    caller needs: on timeout, cancel() failing means the reader won the
    race and a response already landed — return it rather than dropping a
    consumed message on the floor (a credited fetch would otherwise leak
    the server's window forever: the response never reaches the orphan
    path AND the requester never reports). cancel() succeeding poisons
    the future, so a late set_result in _dispatch raises and the response
    is re-routed to the unsolicited-message path.

    Catches both timeout flavors — on this interpreter (3.10)
    ``concurrent.futures.TimeoutError`` is NOT the builtin — and always
    re-raises the BUILTIN ``TimeoutError`` so every caller can catch one
    class (pre-normalization, 3.10 callers writing ``except
    TimeoutError`` silently missed the futures flavor)."""
    try:
        return fut.result(timeout=timeout)
    except (TimeoutError, FutureTimeoutError) as e:
        if not fut.cancel():
            return fut.result(timeout=0)
        raise TimeoutError("request timed out") from e


class Connection:
    """One pipelined control connection.

    Requests carry a ``req_id``; the reader thread completes the matching
    Future when the response echoes it. Unsolicited messages (announce,
    publish) go to ``on_message``.
    """

    def __init__(self, sock: socket.socket, conf: TpuShuffleConf,
                 on_message: Optional[Callable[["Connection", RpcMsg], Optional[RpcMsg]]] = None,
                 name: str = "conn"):
        self._sock = sock
        self._conf = conf
        self._on_message = on_message
        self.name = name
        self._send_lock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        self._pending_lock = threading.Lock()
        self._req_ids = itertools.count(1)
        # Send-budget semaphore (java/RdmaChannel.java:66-67): bounds
        # outstanding requests on one connection.
        self._budget = threading.BoundedSemaphore(max(1, conf.send_queue_depth))
        self._closed = threading.Event()
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"ctl-reader-{name}")
        self._reader.start()

    # -- sending ---------------------------------------------------------

    def next_req_id(self) -> int:
        return next(self._req_ids)

    def send(self, msg: RpcMsg) -> None:
        """Fire-and-forget (SEND without completion interest)."""
        data = msg.encode()
        with self._send_lock:
            if self._closed.is_set():
                raise TransportError(f"{self.name}: connection closed")
            try:
                self._sock.sendall(data)
            except OSError as e:
                raise TransportError(f"{self.name}: send failed: {e}") from e

    def request_async(self, msg: RpcMsg) -> Future:
        """Send a req_id-bearing message; the returned Future completes
        with the echoed response (reader thread), a TransportError
        (teardown/lost connection), or cancellation (caller gave up).

        This is the req-id pipelining surface: many requests ride one
        connection concurrently, each holding a send-budget slot
        (java/RdmaChannel.java:66-67) from issue until its future is done
        — acquisition blocks when the queue-depth budget is exhausted,
        exactly like the reference's send-queue semaphore.
        """
        req_id = getattr(msg, "req_id", None)
        if req_id is None:
            raise ValueError("request_async() needs a msg with req_id")
        fut: Future = Future()
        self._budget.acquire()

        def _cleanup(f: Future, _req_id=req_id) -> None:
            with self._pending_lock:
                self._pending.pop(_req_id, None)
            self._budget.release()

        # done-callback cleanup fires exactly once per future, whether the
        # reader completed it, teardown failed it, or the caller cancelled
        fut.add_done_callback(_cleanup)
        with self._pending_lock:
            self._pending[req_id] = fut
        try:
            self.send(msg)
        except TransportError as e:
            if not fut.cancel():
                # the reader raced a (stale) completion in; surface that
                return fut
            # cancel() already triggered _cleanup; hand back a failed
            # future so callers see one error path
            failed: Future = Future()
            failed.set_exception(e)
            return failed
        except BaseException:
            # non-transport failure (encode bug, codec error): resolve
            # the future so _cleanup reclaims the budget slot + pending
            # entry, then let the bug propagate as itself — same contract
            # as the replaced blocking request()'s try/finally
            fut.cancel()
            raise
        return fut

    def request(self, msg: RpcMsg, timeout: Optional[float] = None) -> RpcMsg:
        """Send a req_id-bearing message and wait for the echoed response
        (default wait: the per-request deadline, ``request_deadline_ms``,
        falling back to the connect timeout)."""
        fut = self.request_async(msg)
        tmo = (timeout if timeout is not None
               else self._conf.resolved_request_deadline_s())
        return await_response(fut, tmo)

    # -- receiving -------------------------------------------------------

    def _read_loop(self) -> None:
        reasm = Reassembler()
        try:
            while not self._closed.is_set():
                chunk = self._sock.recv(1 << 16)
                if not chunk:
                    break
                for msg in reasm.feed(chunk):
                    self._dispatch(msg)
        except (OSError, ValueError) as e:
            if not self._closed.is_set():
                log.debug("%s: reader stopped: %s", self.name, e)
        finally:
            self._fail_pending(TransportError(f"{self.name}: connection lost"))
            self._closed.set()
            try:
                self._sock.close()
            except OSError:
                pass

    def _dispatch(self, msg: RpcMsg) -> None:
        req_id = getattr(msg, "req_id", None)
        if req_id is not None:
            with self._pending_lock:
                fut = self._pending.pop(req_id, None)
            if fut is not None:
                try:
                    fut.set_result(msg)
                    return
                except InvalidStateError:
                    # the requester timed out and cancelled the future in
                    # the race window — deliver as unsolicited instead
                    # (the endpoint's orphan path reports its credits)
                    pass
        if self._on_message is not None:
            try:
                reply = self._on_message(self, msg)
            except Exception as e:  # handler bug must not kill the reader
                log.exception("%s: handler error for %s: %s",
                              self.name, type(msg).__name__, e)
                return
            if reply is not None:
                try:
                    self.send(reply)
                except TransportError:
                    pass

    def _fail_pending(self, exc: Exception) -> None:
        # Fail-all-outstanding on teardown (java/RdmaChannel.java:872-956).
        with self._pending_lock:
            pending, self._pending = dict(self._pending), {}
        for fut in pending.values():
            try:
                if not fut.done():
                    fut.set_exception(exc)
            except InvalidStateError:
                # a caller's cancel() won the race between the done()
                # check and here (the pipelined fetcher cancels whole
                # windows at exactly this moment); cancelled is resolved
                pass

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._fail_pending(TransportError(f"{self.name}: closed"))

    @property
    def closed(self) -> bool:
        return self._closed.is_set()


class ControlServer:
    """Listening endpoint; one reader thread per accepted connection."""

    def __init__(self, host: str, port: int, conf: TpuShuffleConf,
                 handler: Callable[[Connection, RpcMsg], Optional[RpcMsg]],
                 name: str = "server"):
        self._conf = conf
        self._handler = handler
        self.name = name
        self._conns: list = []
        self._conns_lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # Port-retry bind (java/RdmaNode.java:74-88).
        bound = False
        for attempt in range(max(1, conf.port_max_retries)):
            try:
                self._sock.bind((host, port + attempt if port else 0))
                bound = True
                break
            except OSError:
                continue
        if not bound:
            raise TransportError(
                f"{name}: could not bind {host}:{port} after "
                f"{conf.port_max_retries} attempts")
        self._sock.listen(128)  # BACKLOG, java/RdmaNode.java:92
        self.host, self.port = self._sock.getsockname()[:2]
        self._stopped = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True, name=f"ctl-accept-{name}")
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                sock, addr = self._sock.accept()
            except OSError:
                break
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = Connection(sock, self._conf, on_message=self._handler,
                             name=f"{self.name}<-{addr[0]}:{addr[1]}")
            with self._conns_lock:
                # reap connections whose reader died (peer went away):
                # accepted conns are otherwise append-only and a
                # long-lived server accumulates one dead entry per client
                # lifetime, without bound
                self._conns = [c for c in self._conns if not c.closed]
                self._conns.append(conn)

    def live_connections(self) -> int:
        """Count of accepted connections whose reader is still alive
        (reaps dead entries as a side effect — the audit surface for the
        leak the accept-time reap closes)."""
        with self._conns_lock:
            self._conns = [c for c in self._conns if not c.closed]
            return len(self._conns)

    @property
    def stopped(self) -> bool:
        """Liveness signal for schedulers (engine task placement)."""
        return self._stopped.is_set()

    def stop(self) -> None:
        self._stopped.set()
        # shutdown() before close(): a close() alone does not tear down a
        # listening socket another thread is blocked accept()ing on — the
        # kernel keeps it in LISTEN and keeps completing handshakes into the
        # backlog, so peers never see the endpoint die. shutdown() interrupts
        # the blocked accept and kills the listen state immediately.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=self._conf.teardown_timeout_ms / 1000)
        with self._conns_lock:
            conns, self._conns = list(self._conns), []
        for c in conns:
            c.close()


class ConnectionCache:
    """Lazy per-peer client connections with bounded retry
    (java/RdmaNode.java:283-353)."""

    def __init__(self, conf: TpuShuffleConf,
                 on_message: Optional[Callable[[Connection, RpcMsg], Optional[RpcMsg]]] = None):
        self._conf = conf
        self._on_message = on_message
        self._conns: Dict[Addr, Connection] = {}
        self._lock = threading.Lock()

    def get(self, host: str, port: int) -> Connection:
        addr = (host, port)
        with self._lock:
            conn = self._conns.get(addr)
            if conn is not None and not conn.closed:
                return conn
        conn = self._connect(addr)
        with self._lock:
            existing = self._conns.get(addr)
            if existing is not None and not existing.closed:
                conn.close()  # lost the race (java/RdmaNode.java:303-305)
                return existing
            self._conns[addr] = conn
        return conn

    def _dial(self, addr: Addr, timeout: float) -> socket.socket:
        """One connect attempt, separated from the retry loop so the
        fault shim can refuse/delay individual dials."""
        sock = socket.create_connection(addr, timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)
        return sock

    def _connect(self, addr: Addr) -> Connection:
        timeout = self._conf.connect_timeout_ms / 1000
        backoff = Backoff.from_conf(self._conf)
        last: Optional[Exception] = None
        for attempt in range(max(1, self._conf.max_connection_attempts)):
            if attempt:
                # between attempts only — a refused dial re-tried with
                # zero sleep burns the whole budget in microseconds, so
                # the budget never spans the restart it exists to ride out
                backoff.sleep(attempt - 1)
            try:
                sock = self._dial(addr, timeout)
                return Connection(sock, self._conf, on_message=self._on_message,
                                  name=f"->{addr[0]}:{addr[1]}")
            except OSError as e:
                last = e
        raise TransportError(
            f"connect to {addr} failed after "
            f"{self._conf.max_connection_attempts} attempts: {last}")

    def peek(self, host: str, port: int) -> Optional[Connection]:
        """The cached live connection to ``(host, port)``, or None —
        never dials (the heartbeat monitor pings only over connections
        the fetch path already holds; a monitor that dialed would stall
        a whole beat on one unreachable peer's connect budget)."""
        with self._lock:
            conn = self._conns.get((host, port))
        return conn if conn is not None and not conn.closed else None

    def drop(self, host: str, port: int) -> bool:
        """Close and forget the cached connection to ``(host, port)``
        WITHOUT dialing (the peer-health monitor's suspect path: closing
        fails every outstanding request on it immediately instead of
        letting them wait out a TCP timeout). Returns True if a cached
        connection existed."""
        with self._lock:
            conn = self._conns.pop((host, port), None)
        if conn is None:
            return False
        conn.close()
        return True

    def close_all(self) -> None:
        with self._lock:
            conns, self._conns = list(self._conns.values()), {}
        for c in conns:
            c.close()
