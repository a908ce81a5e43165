"""Task shipping: run engine tasks in executor processes.

The reference never ships tasks — Spark does: closures (carrying the
shuffle handle, scala/RdmaUtils.scala:145-159) are serialized to
executors and run in task slots, and that is the only reason its
ShuffleManager works multi-node. This module is that half for the
in-tree engine: the driver serializes a task descriptor (cloudpickle, so
closures work like Spark's), ships it over the control plane
(``RunTaskReq``), and an executor-side runner executes it against the
LOCAL manager — writers/readers/publishes all happen in the executor
process, exactly as under Spark.

Trust model: descriptors are deserialized with cloudpickle, i.e. the
driver can execute arbitrary code on workers. This is Spark's own model
(closure serialization); the control plane must only span trusted
machines, like the reference's verbs endpoints.

* ``install_task_server(compat_mgr)`` — worker side: handle shipped
  tasks on the manager's executor endpoint.
* ``RemoteExecutor`` — driver side: an executor proxy the DAG engine
  schedules onto exactly like an in-process manager; FetchFailed raised
  by a remote task re-raises driver-side with its slot/map identity so
  stage retry works transparently across processes.
"""

from __future__ import annotations

import logging
import pickle
from typing import List, Optional, Tuple

from sparkrdma_tpu_torch.parallel import messages as M
from sparkrdma_tpu_torch.parallel.transport import ConnectionCache, TransportError
from sparkrdma_tpu_torch.shuffle import dist_cache
from sparkrdma_tpu_torch.shuffle.fetcher import FetchFailedError

log = logging.getLogger(__name__)


def _cloudpickle():
    # lazy: in-process DAG jobs (which import this module only for the
    # exception types) must not require cloudpickle to be installed
    import cloudpickle

    return cloudpickle


class TaskError(RuntimeError):
    """A shipped task failed for a non-FetchFailed reason."""


class ExecutorLostError(RuntimeError):
    """Task delivery failed: the executor process is unreachable."""


class _RemoteTaskContext:
    """Worker-side TaskContext: reads parents through the local manager —
    or straight from this process's distributed-mesh-reduce cache when
    the engine ran the collective here (the ICI-received rows ARE the
    partition; no TCP re-fetch). A partition another process owns falls
    back to the ordinary fetcher, so misplacement costs latency, never
    correctness."""

    def __init__(self, mgr, parent_handles, task_id: int):
        self.manager = mgr
        self._parents = parent_handles
        self.task_id = task_id

    def read(self, parent_index: int = 0, start=None, end=None,
             map_range=None):
        """Default: this task's own partition. A PLANNED reduce task
        (adaptive planner, shuffle/planner.py) passes an explicit
        coalesced partition range and/or a split map slice — those
        bypass the mesh cache (it holds whole single partitions) and go
        through the ordinary fetcher, which understands both."""
        handle = self._parents[parent_index]
        if start is not None or end is not None or map_range is not None:
            lo = self.task_id if start is None else start
            hi = lo + 1 if end is None else end
            return self.manager.getReader(handle, lo, hi,
                                          mapRange=map_range)
        cached = dist_cache.get(handle.shuffle_id, self.task_id)
        if cached is not None:
            from sparkrdma_tpu_torch.shuffle.mesh_service import CachedPartitionReader
            from sparkrdma_tpu_torch.shuffle.spark_compat import CompatReader

            return CompatReader(CachedPartitionReader(
                {self.task_id: cached}, self.task_id, self.task_id + 1,
                handle.row_payload_bytes))
        return self.manager.getReader(handle, self.task_id, self.task_id + 1)


def install_task_server(compat_mgr) -> None:
    """Serve shipped tasks on this executor (worker-side entry point)."""
    from sparkrdma_tpu_torch import shared_vars

    def fetch_broadcast(bcast_id: int) -> bytes:
        ep = compat_mgr.native.executor
        conn = ep.driver_conn()
        resp = conn.request(M.GetBroadcastReq(conn.next_req_id(), bcast_id))
        assert isinstance(resp, M.GetBroadcastResp)
        if resp.status != M.STATUS_OK:
            raise TaskError(f"broadcast {bcast_id} unknown to the driver "
                            "(unpersisted?)")
        return resp.data

    def run(payload: bytes) -> Tuple[int, bytes]:
        try:
            desc = _cloudpickle().loads(payload)
            kind = desc["kind"]
            with shared_vars.collecting() as acc_deltas, \
                    shared_vars.serving(fetch_broadcast):
                if kind == "map":
                    ctx = _RemoteTaskContext(compat_mgr, desc["parents"],
                                             desc["task_id"])
                    writer = compat_mgr.getWriter(desc["handle"],
                                                  desc["task_id"])
                    try:
                        desc["fn"](ctx, writer, desc["task_id"])
                    except BaseException:
                        writer.stop(False)
                        raise
                    writer.stop(True)
                    result = None
                elif kind == "result":
                    ctx = _RemoteTaskContext(compat_mgr, desc["parents"],
                                             desc["task_id"])
                    result = desc["fn"](ctx, desc["task_id"])
                elif kind == "invalidate":
                    # drops the memoized driver table AND the location
                    # plane's epoch-validated views in this process
                    # (superstep epoch propagation: the next read here
                    # re-syncs a fresh snapshot), plus the worker cache
                    compat_mgr.native.executor.invalidate_shuffle(
                        desc["shuffle_id"])
                    # recovery republishes maps: collective results and
                    # warm ranges built from the old table must not
                    # serve stale rows (invalidate_shuffle drops them
                    # too; kept explicit so a custom endpoint can't
                    # silently lose the contract)
                    dist_cache.drop(desc["shuffle_id"])
                    result = None
                elif kind == "unregister":
                    compat_mgr.unregisterShuffle(desc["shuffle_id"])
                    dist_cache.drop(desc["shuffle_id"])
                    result = None
                else:
                    return (M.TASK_ERROR,
                            f"unknown task kind {kind!r}".encode())
            # v2 envelope: accumulator deltas ride back with the result
            # (merged driver-side only for the first success per task)
            return M.TASK_OK, _cloudpickle().dumps(
                {"v": 2, "result": result, "acc": acc_deltas})
        except FetchFailedError as e:
            return M.TASK_FETCH_FAILED, pickle.dumps(
                (e.shuffle_id, e.map_id, e.exec_index, str(e)))
        except Exception as e:  # noqa: BLE001 — report, don't kill the slot
            log.exception("shipped task failed")
            return M.TASK_ERROR, repr(e).encode()

    compat_mgr.native.executor.set_task_runner(run)


class RemoteExecutor:
    """Driver-side proxy for one executor process.

    The DAG engine schedules tasks onto this exactly like an in-process
    manager; the descriptor travels by cloudpickle (closures allowed, as
    with Spark), the result or a typed failure comes back.
    """

    def __init__(self, manager_id, conf, clients: Optional[ConnectionCache] = None):
        self.manager_id = manager_id
        self.conf = conf
        self._clients = clients or ConnectionCache(conf)
        self._own_clients = clients is None
        self.alive = True

    # -- engine-facing ---------------------------------------------------

    def run_map_task(self, fn, handle, parent_handles, task_id: int):
        """Returns (None, accumulator deltas)."""
        return self._run({"kind": "map", "fn": fn, "handle": handle,
                          "parents": list(parent_handles),
                          "task_id": task_id})

    def run_result_task(self, fn, parent_handles, task_id: int):
        """Returns (task value, accumulator deltas)."""
        return self._run({"kind": "result", "fn": fn,
                          "parents": list(parent_handles),
                          "task_id": task_id})

    def invalidate_shuffle(self, shuffle_id: int) -> None:
        # admin ops are cheap: a wedged executor must stall recovery and
        # cleanup by a connect budget, not the 10-minute task budget
        self._run({"kind": "invalidate", "shuffle_id": shuffle_id},
                  timeout=self.conf.connect_timeout_ms / 1000)

    def unregister_shuffle(self, shuffle_id: int) -> None:
        self._run({"kind": "unregister", "shuffle_id": shuffle_id},
                  timeout=self.conf.connect_timeout_ms / 1000)

    def stop(self) -> None:
        if self._own_clients:
            self._clients.close_all()

    # -- plumbing --------------------------------------------------------

    def _run(self, desc: dict, timeout: Optional[float] = None):
        import time

        timeout = timeout or self.conf.task_timeout_ms / 1000
        payload = _cloudpickle().dumps(desc)
        # A worker hellos the driver DURING manager construction, before
        # its process gets to install_task_server — so a freshly-announced
        # executor can briefly answer NO_RUNNER. Retry through that
        # bootstrap window before declaring it misconfigured.
        deadline = time.monotonic() + 5.0
        while True:
            try:
                conn = self._clients.get(self.manager_id.rpc_host,
                                         self.manager_id.rpc_port)
                resp = conn.request(
                    M.RunTaskReq(conn.next_req_id(), payload),
                    timeout=timeout)
            except TransportError as e:
                self.alive = False
                raise ExecutorLostError(
                    f"executor {self.manager_id.executor_id.executor} "
                    f"unreachable: {e}") from e
            except TimeoutError as e:
                # the executor is reachable but the task outlived its
                # budget: re-place THIS task, don't write off a healthy
                # process (alive=False would also skip it at job cleanup,
                # leaking its shuffle data).
                # DUPLICATE-EXECUTION WINDOW: the abandoned copy keeps
                # running remotely and may publish after the re-placed
                # copy — safe only because publishes are idempotent
                # positional writes of deterministic output, and
                # _recover_shuffle_locked's failure.map_id fallback can
                # repair a table entry naming the wrong copy's executor.
                # Weakening either invariant breaks this branch.
                raise ExecutorLostError(
                    f"task on {self.manager_id.executor_id.executor} "
                    f"exceeded its {timeout:.0f}s wait budget: {e}") from e
            assert isinstance(resp, M.RunTaskResp)
            if resp.status != M.TASK_NO_RUNNER:
                break
            if time.monotonic() > deadline:
                raise TaskError(
                    f"executor {self.manager_id.executor_id.executor} has "
                    "no task server (call tasks.install_task_server there)")
            time.sleep(0.05)
        if resp.status == M.TASK_OK:
            obj = _cloudpickle().loads(resp.data) if resp.data else None
            if isinstance(obj, dict) and obj.get("v") == 2:
                return obj["result"], obj.get("acc") or {}
            return obj, {}
        if resp.status == M.TASK_FETCH_FAILED:
            shuffle_id, map_id, exec_index, cause = pickle.loads(resp.data)
            raise FetchFailedError(shuffle_id, map_id, exec_index,
                                   f"(remote) {cause}")
        raise TaskError(f"remote task failed: "
                        f"{resp.data.decode(errors='replace')[:500]}")


def remote_executors(driver_compat, conf,
                     expect: Optional[int] = None,
                     timeout: float = 30.0) -> List[RemoteExecutor]:
    """Proxies for every live member the driver currently knows (waits
    for ``expect`` members when given)."""
    import time

    from sparkrdma_tpu_torch.parallel.endpoints import TOMBSTONE

    deadline = time.monotonic() + timeout
    while True:
        members = driver_compat.native.driver.members()
        live = [m for m in members if m != TOMBSTONE]
        if expect is None or len(live) >= expect:
            return [RemoteExecutor(m, conf) for m in live]
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"only {len(live)}/{expect} executors joined")
        time.sleep(0.05)
