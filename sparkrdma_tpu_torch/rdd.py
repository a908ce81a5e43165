"""RDD-style high-level API compiled onto the DAG engine.

The reference is only ever driven through Spark's RDD API — a user types
``rdd.map(...).reduceByKey(...).collect()`` and Spark's DAGScheduler turns
that into the stage graph that calls the shuffle SPI
(scala/RdmaShuffleManager.scala:143-310). A standalone framework needs that
front half too: this module is a lazy RDD planner that fuses narrow
transformations (map/filter/flatMap run inside one task, Spark's stage
pipelining) and places one :class:`engine.MapStage` per wide dependency
(partitionBy / groupByKey / reduceByKey / sortByKey / cogroup), then runs
the plan with :meth:`engine.DAGEngine.run` — so every RDD job exercises the
exact register/getWriter/getReader/unregister sequence, stage retry,
speculation, and (with a mesh) the ICI collective data plane underneath.

Record model: this layer carries **arbitrary Python objects**. A shuffle
serializes each map task's per-partition record list into one pickled blob,
framed with a u64 length and chunked into fixed-width rows
(``row_payload_bytes``), routed with the ``modulo`` partitioner (row key =
destination partition). The vectorized (keys, payload-matrix) batch API of
``shuffle/spark_compat.py`` remains the performance surface — the in-tree
model drivers use it directly; this layer is the usability surface, like
pyspark's RDDs over Spark's JVM core.

Determinism contract: transformations must be deterministic (the engine
recomputes lost partitions from lineage, exactly Spark's rule), and keys
must hash stably across processes (``portable_hash`` below — ints, strs,
bytes, tuples are stable; other types hash via their pickle bytes).
"""

from __future__ import annotations

import pickle
import struct
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from sparkrdma_tpu_torch.engine import DAGEngine, MapStage, ResultStage
from sparkrdma_tpu_torch.shuffle.manager import PartitionerSpec
from sparkrdma_tpu_torch.shuffle.spark_compat import ShuffleDependency

_LEN = struct.Struct("<Q")


def portable_hash(key) -> int:
    """Process-stable hash (builtin ``hash`` is salted per process for
    strings — useless for routing records across executors; pyspark pins
    PYTHONHASHSEED for the same reason)."""
    import hashlib

    # numeric cross-type equality (True == 1 == 1.0) must mean same
    # partition, like builtin hash; bools and integral floats collapse to
    # the int path before mixing
    if isinstance(key, bool):
        key = int(key)
    elif isinstance(key, (float, np.floating)):
        if float(key).is_integer():
            key = int(key)
    if isinstance(key, (int, np.integer)):
        # splitmix-style mix so dense int keys spread over partitions
        h = int(key) & 0xFFFFFFFFFFFFFFFF
        h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        h = (h ^ (h >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
        return (h ^ (h >> 31)) & 0x7FFFFFFFFFFFFFFF
    if isinstance(key, (float, np.floating)):
        data = struct.pack("<d", float(key))
    elif isinstance(key, str):
        data = key.encode()
    elif isinstance(key, bytes):
        data = key
    elif isinstance(key, tuple):
        return portable_hash(tuple(portable_hash(k) for k in key)
                             .__repr__().encode())
    else:
        data = pickle.dumps(key, protocol=4)
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "little") & 0x7FFFFFFFFFFFFFFF


_TAG = 8  # per-row u64 tag: (map_id << 32) | row_seq


def _encode_blob(obj, part: int, width: int, map_id: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """One (map, partition) blob -> (row keys, fixed-width rows).

    Layout per row: ``[u64 (map_id << 32 | seq)] [width-8 chunk bytes]``;
    the chunk stream is ``u64 length + pickle bytes`` zero-padded to
    whole rows. The tag makes decoding ORDER-INDEPENDENT: rows may
    arrive interleaved across maps and rounds in any sequence (mesh
    collectives sort by key; bounded-round exchanges split a map's rows
    across rounds) and still reassemble exactly — no transport-ordering
    assumption anywhere. Costs 8 bytes per ``width``-byte row.
    """
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    chunk = width - _TAG
    total = _LEN.size + len(payload)
    n = -(-total // chunk)
    body = np.zeros(n * chunk, dtype=np.uint8)
    body[:_LEN.size] = np.frombuffer(_LEN.pack(len(payload)), dtype=np.uint8)
    body[_LEN.size:total] = np.frombuffer(payload, dtype=np.uint8)
    rows = np.empty((n, width), dtype=np.uint8)
    tags = ((np.uint64(map_id) << np.uint64(32))
            | np.arange(n, dtype=np.uint64))
    # explicit little-endian: the decoder reads "<u8" regardless of host
    rows[:, :_TAG] = tags.astype("<u8")[:, None].view(np.uint8)
    rows[:, _TAG:] = body.reshape(n, chunk)
    return np.full(n, part, dtype=np.uint64), rows


def _decode_blobs(batches) -> Iterator[object]:
    """Invert :func:`_encode_blob` over reader batches, in any row order:
    rows sort by their (map_id, seq) tag, then blobs parse sequentially
    (each map writes exactly one blob per partition).

    Order-independence inherently needs the partition's rows resident
    once (sorting is global); beyond that single buffer, only the tag
    argsort indices and one blob's gathered rows are materialized — no
    full reordered copy of the row matrix.
    """
    chunks = [rows for _keys, rows in batches if len(rows)]
    if not chunks:
        return
    rows = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
    chunks.clear()
    tags = np.ascontiguousarray(rows[:, :_TAG]).view("<u8").ravel()
    order = np.argsort(tags, kind="stable")
    chunk = rows.shape[1] - _TAG
    i = 0
    while i < len(order):
        (ln,) = _LEN.unpack_from(rows[order[i], _TAG:].tobytes(), 0)
        span = -(-(_LEN.size + ln) // chunk)
        if i + span > len(order):
            raise ValueError(
                f"blob at row {i} claims {span} rows but only "
                f"{len(order) - i} remain — corrupt or truncated stream")
        blob = rows[order[i:i + span], _TAG:].tobytes()
        yield pickle.loads(blob[_LEN.size:_LEN.size + ln])
        i += span


# -- plan nodes -----------------------------------------------------------
#
# An RDD is a lazy lineage DAG. Compilation walks it backwards: narrow
# nodes fuse into their consumer's task function; each _Shuffled /
# _CoGrouped node becomes one MapStage (memoized — shared lineage runs
# once per job, like Spark's stage dedup within a job).


@dataclass
class _Source:
    bcast: object           # Broadcast of the partition list
    n: int                  # partition count

    def num_partitions(self) -> int:
        return self.n


@dataclass
class _FileSource:
    """Byte-range splits over text files (Hadoop input-split rule: a
    split owns every line that STARTS inside [start, end); a reader
    seeks to start and skips the partial first line, which the previous
    split read past its own end). Splits are small metadata — they ride
    the task closure, not the broadcast plane. Executors must share the
    driver's filesystem (single-host clusters and the multi-process
    tests here do; a distributed deployment needs a shared mount, the
    same requirement Spark puts on file:// URIs)."""

    splits: List[Tuple[str, int, int]]   # (path, start, end)

    def num_partitions(self) -> int:
        return len(self.splits)


def _read_split(path: str, start: int, end: int) -> Iterator[str]:
    with open(path, "rb") as f:
        if start > 0:
            f.seek(start - 1)
            f.readline()  # the line straddling `start` belongs upstream
        pos = f.tell()
        while pos < end:
            line = f.readline()
            if not line:
                break
            pos = f.tell()
            # \r\n is a terminator too (Hadoop's LineRecordReader rule):
            # CRLF files must not yield keys with trailing \r
            yield line.decode().rstrip("\r\n")


@dataclass
class _Narrow:
    parent: object
    xform: Callable[[Iterator], Iterator]

    def num_partitions(self) -> int:
        return self.parent.num_partitions()


@dataclass
class _Shuffled:
    """One wide dependency. ``mode``:

    * ``records`` — reduce side replays the records (partitionBy)
    * ``group``   — reduce side yields (k, [v, ...])     (groupByKey)
    * ``reduce``  — map-side combine with ``merge``, reduce side merges
      partial aggregates: yields (k, merged)             (reduceByKey)
    * ``combine`` — generalized aggregation (combineByKey): map side
      seeds with ``create`` and folds values with ``merge_value``,
      reduce side merges partial combiners with ``merge``

    Routing: by key hash (default / ``part_fn``), or — for
    partition-level moves where records are arbitrary objects, not
    (k, v) pairs — ``route_task`` sends task t's whole output to
    partition ``route_task(t)`` (union/coalesce), and ``route_index``
    round-robins records by index (repartition; deterministic, so
    recomputes and speculative attempts write identical bytes).
    """

    parent: object
    parts: int
    mode: str = "records"
    merge: Optional[Callable] = None
    part_fn: Optional[Callable[[object], int]] = None  # default hash%P
    create: Optional[Callable] = None          # combine: createCombiner
    merge_value: Optional[Callable] = None     # combine: mergeValue
    route_task: Optional[Callable[[int], int]] = None
    route_index: bool = False

    def num_partitions(self) -> int:
        return self.parts

    def route(self, key) -> int:
        if self.part_fn is not None:
            return self.part_fn(key)
        return portable_hash(key) % self.parts


@dataclass
class _Union:
    """Concatenation of several lineages: partitions are the sides'
    partitions in order. Compiles narrow (task t delegates to one side's
    builder) when every side's chain is boundary-free; otherwise each
    side becomes one identity-routed shuffle into the union's partition
    space (Spark's union is narrow always, but its tasks can read any
    parent partition — this engine's co-partitioning contract trades
    that for one exchange, which under a mesh rides ICI anyway)."""

    sides: List[object]

    def num_partitions(self) -> int:
        return sum(s.num_partitions() for s in self.sides)


@dataclass
class _Coalesce:
    """Narrow partition-count reduction: new partition i reads parent
    partitions [i*P//n, (i+1)*P//n) — Spark's coalesce(shuffle=False)
    fan-in. Falls back to an identity-routed shuffle when a boundary
    sits upstream (task t can only read parent partition t here)."""

    parent: object
    n: int

    def num_partitions(self) -> int:
        return self.n


class _Cached:
    """persist()/cache(): materializes the parent lineage ONCE as a
    pinned identity shuffle — map task t writes parent partition t's
    records to partition t, and the engine keeps the shuffle registered
    past job teardown (engine.pin), so later actions SKIP the whole
    upstream DAG and read the retained outputs from any executor.

    This is Spark's actual cache-interaction machinery re-based on the
    shuffle layer: skipped stages + shuffle files that outlive the job,
    with recovery for free — an executor loss surfaces as FetchFailed
    and stage retry recomputes the lost maps from ``task_fn``'s captured
    lineage (true lineage recovery through a cached RDD, exercised in
    test_rdd.py)."""

    def __init__(self, parent):
        self.parent = parent
        self._stage = None  # built once, reused across actions

    def num_partitions(self) -> int:
        return self.parent.num_partitions()


@dataclass
class _CoGrouped:
    """Two co-partitioned wide parents; yields (k, (left_vals, right_vals))."""

    left: _Shuffled
    right: _Shuffled
    parts: int

    def num_partitions(self) -> int:
        return self.parts


class RDD:
    """Lazy distributed collection. Build lineage with transformations,
    evaluate with an action. Spark's camelCase names are aliased so code
    written against pyspark's RDD shapes ports mechanically."""

    def __init__(self, ctx: "EngineContext", node):
        self._ctx = ctx
        self._node = node

    # -- narrow transformations ------------------------------------------

    def map(self, f) -> "RDD":
        return self.map_partitions(lambda it, _f=f: (_f(x) for x in it))

    def filter(self, f) -> "RDD":
        return self.map_partitions(lambda it, _f=f: (x for x in it if _f(x)))

    def flat_map(self, f) -> "RDD":
        return self.map_partitions(
            lambda it, _f=f: (y for x in it for y in _f(x)))

    def map_partitions(self, f) -> "RDD":
        """f(iterator) -> iterator, once per partition (the fusion unit)."""
        return RDD(self._ctx, _Narrow(self._node, f))

    def map_values(self, f) -> "RDD":
        return self.map_partitions(
            lambda it, _f=f: ((k, _f(v)) for k, v in it))

    def keys(self) -> "RDD":
        return self.map_partitions(lambda it: (k for k, _ in it))

    def values(self) -> "RDD":
        return self.map_partitions(lambda it: (v for _, v in it))

    def glom(self) -> "RDD":
        return self.map_partitions(lambda it: iter([list(it)]))

    def distinct(self, num_partitions: Optional[int] = None) -> "RDD":
        return (self.map(lambda x: (x, None))
                .reduce_by_key(lambda a, b: None, num_partitions)
                .keys())

    # -- wide transformations --------------------------------------------

    def partition_by(self, num_partitions: Optional[int] = None) -> "RDD":
        """Hash-repartition (k, v) records (Spark's partitionBy)."""
        return RDD(self._ctx, _Shuffled(self._node,
                                        self._parts(num_partitions)))

    def group_by_key(self, num_partitions: Optional[int] = None) -> "RDD":
        return RDD(self._ctx, _Shuffled(self._node,
                                        self._parts(num_partitions),
                                        mode="group"))

    def reduce_by_key(self, f, num_partitions: Optional[int] = None,
                      salt: int = 0) -> "RDD":
        """Map-side combined aggregation — each map task pre-merges its
        records per key before the shuffle (the aggregator half Spark
        applies before spilling), so shuffle bytes scale with distinct
        keys, not records.

        ``salt > 1`` adds a two-stage tree: records first shuffle on
        (key, record_hash % salt) so one hot key's partial aggregates
        spread over up to ``salt`` reducers, then a second shuffle
        merges the partials per key — the standard skew cure (requires
        ``f`` associative+commutative, which reduceByKey already
        assumes). Use when one key dominates (ALS-style power-law
        data); the extra stage costs one pass over the aggregates."""
        parts = self._parts(num_partitions)
        if salt <= 1:
            return RDD(self._ctx, _Shuffled(self._node, parts,
                                            mode="reduce", merge=f))
        salted = (self
                  .map_partitions(lambda it, _s=salt: (
                      ((k, i % _s), v) for i, (k, v) in enumerate(it)))
                  .reduce_by_key(f, parts))
        # round-robin salt by record index: deterministic (recomputes and
        # speculative duplicates must yield identical bytes — the
        # engine's idempotent-publish contract), and a hot key's run of
        # records spreads evenly across its salt groups
        return (salted
                .map_partitions(lambda it: ((k, v) for (k, _r), v in it))
                .reduce_by_key(f, parts))

    def combine_by_key(self, create_combiner, merge_value, merge_combiners,
                       num_partitions: Optional[int] = None) -> "RDD":
        """The general aggregation primitive (Spark's combineByKey):
        ``create_combiner(v) -> C`` seeds a key's combiner map-side,
        ``merge_value(C, v) -> C`` folds further values map-side, and
        ``merge_combiners(C, C) -> C`` merges partial combiners
        reduce-side — shuffle bytes scale with distinct keys, and the
        value and combiner types may differ (the part reduceByKey can't
        express)."""
        return RDD(self._ctx, _Shuffled(
            self._node, self._parts(num_partitions), mode="combine",
            merge=merge_combiners, create=create_combiner,
            merge_value=merge_value))

    def aggregate_by_key(self, zero, seq_func, comb_func,
                         num_partitions: Optional[int] = None) -> "RDD":
        """Aggregate values per key starting from ``zero`` (Spark's
        aggregateByKey): ``seq_func(acc, v)`` folds map-side,
        ``comb_func(acc, acc)`` merges partials reduce-side. ``zero`` is
        deep-copied per key so a mutable zero ([], {}) is safe to mutate
        in ``seq_func`` — each key gets its own accumulator."""
        import copy
        return self.combine_by_key(
            lambda v, _z=zero, _s=seq_func: _s(copy.deepcopy(_z), v),
            seq_func, comb_func, num_partitions)

    def fold_by_key(self, zero, f,
                    num_partitions: Optional[int] = None) -> "RDD":
        return self.aggregate_by_key(zero, f, f, num_partitions)

    def union(self, *others: "RDD") -> "RDD":
        """Concatenate this RDD with ``others`` (partitions in argument
        order; nested unions flatten, so chained unions don't deepen the
        plan)."""
        nodes: list = []
        for r in (self, *others):
            if isinstance(r._node, _Union):
                nodes.extend(r._node.sides)
            else:
                nodes.append(r._node)
        return RDD(self._ctx, _Union(nodes))

    def coalesce(self, num_partitions: int, shuffle: bool = False) -> "RDD":
        """Reduce the partition count without a shuffle (new partition i
        absorbs a contiguous range of old ones); ``shuffle=True``
        redistributes records round-robin instead — the only way to
        GROW the count or rebalance skewed partitions."""
        n = self._parts(num_partitions)
        if shuffle:
            return RDD(self._ctx, _Shuffled(self._node, n,
                                            route_index=True))
        return RDD(self._ctx,
                   _Coalesce(self._node,
                             min(n, self._node.num_partitions())))

    def repartition(self, num_partitions: int) -> "RDD":
        return self.coalesce(num_partitions, shuffle=True)

    def persist(self) -> "RDD":
        """Materialize this lineage once and keep it: the first action
        runs the upstream DAG and pins its output shuffle (engine.pin);
        every later action skips the upstream stages and reads the
        retained partitions. Executor loss recomputes only the lost
        partitions from lineage via the ordinary FetchFailed stage
        retry. In-place like Spark's persist: marks THIS RDD object and
        returns it; RDDs derived afterwards read through the cache."""
        if not isinstance(self._node, _Cached):
            self._node = _Cached(self._node)
        return self

    cache = persist

    def unpersist(self) -> "RDD":
        """Release the pinned shuffle (and its pinned ancestors) now;
        later actions recompute from lineage."""
        if isinstance(self._node, _Cached):
            if self._node._stage is not None:
                self._ctx.engine.unpin(self._node._stage)
            self._node = self._node.parent
        return self

    @property
    def is_cached(self) -> bool:
        return isinstance(self._node, _Cached)

    def sort_by_key(self, num_partitions: Optional[int] = None,
                    ascending: bool = True, sample_size: int = 512) -> "RDD":
        """Global sort: a sampling pass picks P-1 range splitters (Spark's
        RangePartitioner runs the same extra sampling job over the
        lineage), records range-partition to ordered partitions, and each
        partition sorts locally — partition i's keys all precede
        partition i+1's (TeraSort's output contract)."""
        parts = self._parts(num_partitions)
        if parts > 1:
            # splitters stay ASCENDING either way (bisect requires it);
            # descending order flips the partition index instead
            sample = self._sample_keys(sample_size)
            idx = [round(len(sample) * i / parts) for i in range(1, parts)]
            splitters = [sample[min(i, len(sample) - 1)] for i in idx] \
                if sample else []
        else:
            splitters = []

        def route(key, _s=splitters, _asc=ascending):
            import bisect
            if not _s:
                return 0
            i = bisect.bisect_right(_s, key)
            return i if _asc else len(_s) - i

        shuffled = RDD(self._ctx, _Shuffled(self._node, parts,
                                            part_fn=route))
        return shuffled.map_partitions(
            lambda it, _asc=ascending: iter(
                sorted(it, key=lambda kv: kv[0], reverse=not _asc)))

    def cogroup(self, other: "RDD",
                num_partitions: Optional[int] = None) -> "RDD":
        parts = self._parts(num_partitions)
        left = _Shuffled(self._node, parts)
        right = _Shuffled(other._node, parts)
        return RDD(self._ctx, _CoGrouped(left, right, parts))

    def join(self, other: "RDD",
             num_partitions: Optional[int] = None) -> "RDD":
        """Inner equi-join -> (k, (v_left, v_right))."""
        return self.cogroup(other, num_partitions).map_partitions(
            lambda it: ((k, (a, b)) for k, (ls, rs) in it
                        for a in ls for b in rs))

    # -- actions ----------------------------------------------------------

    def collect(self) -> list:
        return [x for part in self._run(lambda it, _t: list(it))
                for x in part]

    def count(self) -> int:
        return sum(self._run(lambda it, _t: sum(1 for _ in it)))

    def first(self):
        got = self.take(1)
        if not got:
            raise ValueError("RDD is empty")
        return got[0]

    def take(self, n: int) -> list:
        """First ``n`` records (partition order). Runs the lineage as ONE
        full job — islice bounds per-partition materialization, not the
        scan itself (Spark's incremental partition scale-up is a
        possible future optimization)."""
        import itertools
        out: list = []
        for part in self._run(
                lambda it, _t, _n=n: list(itertools.islice(it, _n))):
            out.extend(part)
            if len(out) >= n:
                break
        return out[:n]

    def materialize(self) -> "RDD":
        """Evaluate once, return an RDD over the results, driver-held.
        Partition data collects to the driver and redistributes through
        the broadcast plane, so later actions skip the whole upstream
        lineage — recovery-safe (the driver owns the bytes; executor
        loss costs nothing) at the price of driver memory, like a
        collect + parallelize that keeps partitioning. Prefer
        :meth:`persist` for large data: it keeps partitions on the
        executors (pinned shuffle) and recovers via lineage instead of
        driver RAM."""
        parts = self._run(lambda it, _t: list(it))
        return RDD(self._ctx,
                   _Source(self._ctx.engine.broadcast(parts), len(parts)))

    def save_as_text_file(self, path: str) -> None:
        """One ``part-NNNNN`` file per partition + a ``_SUCCESS`` marker
        (the Hadoop output contract). Parts write to an attempt-unique
        temp name and rename-commit — the crash-safe discipline of the
        resolver's spill commit, which also makes concurrent speculative
        attempts of one task harmless (each writes its own temp; the
        rename is atomic, last commit wins with complete contents).

        A previous run's ``part-*``/``_SUCCESS`` files in ``path`` are
        removed first: a shrinking partition count must not leave stale
        parts under a fresh ``_SUCCESS`` (Spark refuses the directory
        outright; here re-runs are expected, so clear exactly the files
        this writer owns and never anything else).

        ``path`` must be on a filesystem shared by driver and executors
        (same requirement as ``_FileSource`` reads): tasks write parts on
        THEIR machine, and the driver verifies every expected part exists
        locally before committing ``_SUCCESS`` — with remote executors on
        unshared disks that verification fails loudly instead of leaving
        a ``_SUCCESS`` next to missing parts."""
        import glob as _glob
        import os
        os.makedirs(path, exist_ok=True)
        for stale in _glob.glob(os.path.join(path, "part-[0-9]*")) + \
                _glob.glob(os.path.join(path, ".tmp-part-*")) + \
                [os.path.join(path, "_SUCCESS")]:
            try:
                os.remove(stale)
            except FileNotFoundError:
                pass

        def save(it, task_id, _p=path):
            import os
            import threading
            tmp = os.path.join(
                _p, f".tmp-part-{task_id:05d}.{os.getpid()}."
                    f"{threading.get_ident()}")
            with open(tmp, "w") as f:
                for x in it:
                    f.write(str(x))
                    f.write("\n")
            os.replace(tmp, os.path.join(_p, f"part-{task_id:05d}"))

        n_parts = len(self._run(save))
        missing = [i for i in range(n_parts)
                   if not os.path.exists(os.path.join(path,
                                                      f"part-{i:05d}"))]
        if missing:
            raise IOError(
                f"save_as_text_file({path!r}): tasks reported success but "
                f"parts {missing} are absent on the driver's filesystem — "
                f"executors are writing to an unshared disk; point `path` "
                f"at a mount shared by driver and executors")
        with open(os.path.join(path, "_SUCCESS"), "w"):
            pass

    def reduce(self, f):
        import functools

        def fold(it, _task_id, _f=f):
            acc, found = None, False
            for x in it:
                acc = x if not found else _f(acc, x)
                found = True
            return found, acc

        vals = [v for found, v in self._run(fold) if found]
        if not vals:
            raise ValueError("reduce() of empty RDD")
        return functools.reduce(f, vals)

    # -- aliases (the pyspark-shaped surface) -----------------------------

    flatMap = flat_map
    mapPartitions = map_partitions
    mapValues = map_values
    partitionBy = partition_by
    groupByKey = group_by_key
    reduceByKey = reduce_by_key
    combineByKey = combine_by_key
    aggregateByKey = aggregate_by_key
    foldByKey = fold_by_key
    saveAsTextFile = save_as_text_file

    def sortByKey(self, ascending: bool = True,
                  numPartitions: Optional[int] = None) -> "RDD":
        """pyspark's argument order — (ascending, numPartitions) — NOT
        sort_by_key's (num_partitions, ascending); a plain alias would
        silently absorb ``sortByKey(False)`` as num_partitions=False and
        sort ascending."""
        return self.sort_by_key(num_partitions=numPartitions,
                                ascending=ascending)

    # -- internals --------------------------------------------------------

    @property
    def num_partitions(self) -> int:
        return self._node.num_partitions()

    def _parts(self, num_partitions: Optional[int]) -> int:
        if num_partitions is None:
            return self._node.num_partitions()
        import operator
        try:
            if isinstance(num_partitions, bool):
                # the classic misuse is pyspark's sortByKey(False); only
                # THAT hint fits a bool — other methods just got a bad arg
                raise ValueError(
                    f"num_partitions must be a positive int, got "
                    f"{num_partitions!r} (pyspark-style calls belong on "
                    f"sortByKey(ascending, numPartitions))")
            n = operator.index(num_partitions)  # int-likes incl. np.int64
        except TypeError:
            raise ValueError(
                f"num_partitions must be a positive int, got "
                f"{num_partitions!r}") from None
        if n < 1:
            raise ValueError(
                f"num_partitions must be >= 1, got {n}")
        return n

    def _sample_keys(self, sample_size: int) -> list:
        """Sampling job for sortByKey: up to ``sample_size`` keys per
        partition, random but seeded per task (recompute-deterministic)."""
        def sample(it, _task_id, _n=sample_size):
            import random
            rng = random.Random(0x5EED)
            seen: list = []
            for i, (k, _v) in enumerate(it):
                if len(seen) < _n:
                    seen.append(k)
                else:  # reservoir
                    j = rng.randint(0, i)
                    if j < _n:
                        seen[j] = k
            return seen

        return sorted(k for part in self._run(sample) for k in part)

    def _run(self, finalize: Callable[[Iterator, int], object]
             ) -> List[object]:
        """Compile the lineage into engine stages and run it;
        ``finalize(iterator, task_id)`` folds each partition."""
        memo: dict = {}
        builder, parents = _chain(self._node, memo, self._ctx)
        _wire_slots(builder)

        def task_fn(tc, task_id, _b=builder, _fin=finalize):
            return _fin(_b(tc, task_id), task_id)

        final = ResultStage(self._node.num_partitions(), task_fn,
                            parents=parents)
        return self._ctx.engine.run(final)


def _chain(node, memo: dict, ctx: "EngineContext"):
    """(iterator builder, direct parent MapStages) for ``node``.

    Narrow chains fuse; each wide node becomes a memoized MapStage and a
    reader slot (``tc.read(i)``) in the consuming stage."""
    if isinstance(node, _Source):
        bcast = node.bcast

        def build(tc, task_id, _b=bcast):
            return iter(_b.value[task_id])

        build._boundary = None
        return build, []

    if isinstance(node, _FileSource):
        def build(tc, task_id, _s=node.splits):
            return _read_split(*_s[task_id])

        build._boundary = None
        return build, []

    if isinstance(node, _Narrow):
        inner, parents = _chain(node.parent, memo, ctx)

        def build(tc, task_id, _inner=inner, _f=node.xform):
            return _f(_inner(tc, task_id))

        build._boundary = inner._boundary
        return build, parents

    if isinstance(node, _Shuffled):
        stage = _shuffle_stage(node, memo, ctx)
        # "combine" partial combiners merge reduce-side exactly like
        # "reduce" partial aggregates — with merge_combiners as the merge
        mode = "reduce" if node.mode == "combine" else node.mode

        def build(tc, task_id, _mode=mode, _merge=node.merge):
            return _reduce_side(tc.read(build._slot).readBatches(),
                                _mode, _merge)

        build._slot = None  # wired by _wire_slots before the job runs
        build._boundary = build
        return build, [stage]

    if isinstance(node, _Union):
        compiled = [_chain(s, memo, ctx) for s in node.sides]
        offs, off = [], 0
        for s in node.sides:
            offs.append(off)
            off += s.num_partitions()
        if all(b._boundary is None for b, _ in compiled):
            # narrow: every side is source/narrow-only, so union task t
            # just delegates to the owning side's builder
            builders = [b for b, _ in compiled]

            def build(tc, task_id, _bs=builders, _offs=offs):
                import bisect
                i = bisect.bisect_right(_offs, task_id) - 1
                return _bs[i](tc, task_id - _offs[i])

            build._boundary = None
            return build, []
        # some side has a shuffle upstream: each side becomes one
        # identity-routed map stage into the union's partition space;
        # slots are statically 0..k-1 (this build is the chain's only
        # boundary, so its parents head the consuming stage's list).
        # The wrappers are memoized on the node (like _Coalesce._shuffled):
        # the _shuffle_stage memo keys on node identity, so a union
        # consumed twice in one job must present the SAME _Shuffled nodes
        # both times or each side's data shuffles twice
        shs = getattr(node, "_shuffled_sides", None)
        if shs is None:
            shs = [_Shuffled(s, node.num_partitions(),
                             route_task=(lambda t, _o=o: _o + t))
                   for s, o in zip(node.sides, offs)]
            node._shuffled_sides = shs
        stages = [_shuffle_stage(sh, memo, ctx) for sh in shs]

        def build(tc, task_id, _k=len(stages)):
            def gen():
                for i in range(_k):
                    yield from _reduce_side(tc.read(i).readBatches(),
                                            "records", None)
            return gen()

        # this IS a boundary (it reads shuffle slots): downstream
        # narrow-vs-shuffle checks must see it as one. Slots are wired
        # statically (0..k-1 matching the returned parents order), so
        # _wire_slots has nothing to assign — the build carries no
        # _slot/_lslot attributes.
        build._boundary = build
        return build, stages

    if isinstance(node, _Coalesce):
        inner, parents = _chain(node.parent, memo, ctx)
        P, n = node.parent.num_partitions(), node.n
        if inner._boundary is None:
            def build(tc, task_id, _inner=inner, _P=P, _n=n):
                lo, hi = task_id * _P // _n, (task_id + 1) * _P // _n

                def gen():
                    for pid in range(lo, hi):
                        yield from _inner(tc, pid)
                return gen()

            build._boundary = None
            return build, parents  # boundary-free => parents is []
        # a shuffle upstream: this engine's tasks read only their own
        # partition of a parent shuffle, so fan-in compiles to one
        # identity-routed exchange instead. Memoized on the node: a
        # coalesced RDD consumed twice in one job must compile ONE
        # exchange stage (the _shuffle_stage memo keys on node identity).
        # Routing is the EXACT inverse of the narrow path's
        # [i*P//n, (i+1)*P//n) ranges — bisect over those boundaries —
        # so the two paths agree on which output partition holds which
        # parent even when P % n != 0 (t*n//P drifts there: P=5, n=2
        # sends parent 2 to output 0, the narrow ranges put it in 1)
        sh = getattr(node, "_shuffled", None)
        if sh is None:
            import bisect
            bounds = tuple(i * P // n for i in range(1, n))
            sh = _Shuffled(node.parent, n,
                           route_task=(lambda t, _b=bounds:
                                       bisect.bisect_right(_b, t)))
            node._shuffled = sh
        return _chain(sh, memo, ctx)

    if isinstance(node, _Cached):
        stage = node._stage
        if stage is None:
            inner, parents = _chain(node.parent, memo, ctx)
            _wire_slots(inner)
            width = ctx.row_bytes
            dep = ShuffleDependency(node.num_partitions(),
                                    PartitionerSpec("modulo"),
                                    row_payload_bytes=width)

            def task_fn(tc, writer, task_id, _inner=inner, _w=width):
                records = list(_inner(tc, task_id))
                writer.write(_encode_blob(records, task_id, _w, task_id))

            stage = MapStage(node.parent.num_partitions(), dep, task_fn,
                             parents=parents)
            node._stage = stage
            ctx.engine.pin(stage)

        def build(tc, task_id):
            return _reduce_side(tc.read(build._slot).readBatches(),
                                "records", None)

        build._slot = None
        build._boundary = build
        return build, [stage]

    if isinstance(node, _CoGrouped):
        lstage = _shuffle_stage(node.left, memo, ctx)
        rstage = _shuffle_stage(node.right, memo, ctx)

        def build(tc, task_id):
            groups: dict = {}
            for k, v in _reduce_side(
                    tc.read(build._lslot).readBatches(), "records", None):
                groups.setdefault(k, ([], []))[0].append(v)
            for k, v in _reduce_side(
                    tc.read(build._rslot).readBatches(), "records", None):
                groups.setdefault(k, ([], []))[1].append(v)
            return iter(groups.items())

        build._lslot = build._rslot = None
        build._boundary = build
        return build, [lstage, rstage]

    raise TypeError(f"unknown plan node {type(node).__name__}")


def _reduce_side(batches, mode: str, merge) -> Iterator:
    """Decode one partition's blobs and apply the wide op's semantics."""
    if mode == "records":
        for records in _decode_blobs(batches):
            yield from records
        return
    acc: dict = {}
    for records in _decode_blobs(batches):
        if mode == "group":
            for k, v in records:
                acc.setdefault(k, []).append(v)
        else:  # "reduce": records are map-side partial aggregates
            for k, v in records:
                acc[k] = merge(acc[k], v) if k in acc else v
    yield from acc.items()


def _shuffle_stage(node: _Shuffled, memo: dict, ctx: "EngineContext"):
    """Memoized MapStage for one wide dependency."""
    if id(node) in memo:
        return memo[id(node)]
    inner, parents = _chain(node.parent, memo, ctx)
    _wire_slots(inner)
    width = ctx.row_bytes
    dep = ShuffleDependency(node.parts, PartitionerSpec("modulo"),
                            row_payload_bytes=width)

    def task_fn(tc, writer, task_id, _inner=inner, _node=node, _w=width):
        if _node.route_task is not None:
            # partition-level move (union/coalesce): the whole task
            # output — arbitrary records, not (k, v) pairs — lands in
            # one destination partition
            records = list(_inner(tc, task_id))
            writer.write(_encode_blob(records, _node.route_task(task_id),
                                      _w, task_id))
            return
        buckets: dict = {}
        if _node.route_index:
            # round-robin by record index (repartition): deterministic,
            # so recomputes/speculative attempts write identical bytes
            for i, x in enumerate(_inner(tc, task_id)):
                buckets.setdefault(i % _node.parts, []).append(x)
            items = buckets.items()
        elif _node.mode == "reduce":
            for k, v in _inner(tc, task_id):
                b = buckets.setdefault(_node.route(k), {})
                b[k] = _node.merge(b[k], v) if k in b else v
            items = ((p, list(d.items())) for p, d in buckets.items())
        elif _node.mode == "combine":
            for k, v in _inner(tc, task_id):
                b = buckets.setdefault(_node.route(k), {})
                b[k] = _node.merge_value(b[k], v) if k in b \
                    else _node.create(v)
            items = ((p, list(d.items())) for p, d in buckets.items())
        else:
            for k, v in _inner(tc, task_id):
                buckets.setdefault(_node.route(k), []).append((k, v))
            items = buckets.items()
        for p, records in items:
            writer.write(_encode_blob(records, p, _w, task_id))

    stage = MapStage(node.parent.num_partitions(), dep, task_fn,
                     parents=parents)
    memo[id(node)] = stage
    return stage


def _wire_slots(builder) -> None:
    """Wire a consuming chain's boundary builder to its tc.read() slots.

    A fused chain reads at most one boundary node directly — a single
    _Shuffled (slot 0) or one _CoGrouped pair (slots 0, 1); anything
    further upstream is behind that boundary's own map stage. Narrow
    wrappers propagate ``_boundary`` so the attribute is reachable from
    the chain's outermost builder."""
    b = builder._boundary
    if b is None:
        return
    if hasattr(b, "_slot"):
        b._slot = 0
    if hasattr(b, "_lslot"):
        b._lslot, b._rslot = 0, 1


# -- vectorized batch RDD -------------------------------------------------


@dataclass
class _BSource:
    bcast: object               # Broadcast of per-partition (keys, payload)
    n: int
    payload_bytes: int

    def num_partitions(self) -> int:
        return self.n


@dataclass
class _BNarrow:
    parent: object
    fn: Callable                # fn(keys u64[N], payload u8[N, W]) -> same shape pair
    payload_bytes: int

    def num_partitions(self) -> int:
        return self.parent.num_partitions()


@dataclass
class _BShuffle:
    parent: object
    parts: int
    partitioner: PartitionerSpec
    combiner: Optional[Callable] = None   # the SPI dep.combiner contract

    def num_partitions(self) -> int:
        return self.parts

    @property
    def payload_bytes(self) -> int:
        return self.parent.payload_bytes


class BatchRDD:
    """Vectorized sibling of :class:`RDD`: partitions are
    ``(keys u64[N], payload u8[N, W])`` numpy batches and shuffles move
    them RAW — real hash/range partitioners on the keys, the writer's
    map-side combine, zero per-record Python and zero pickling. This is
    the RDD ergonomics wrapped around the same batch plane the in-tree
    workloads use; with a mesh on the engine the shuffles ride ICI and
    arrive key-sorted (the collective reduce sorts)."""

    def __init__(self, ctx: "EngineContext", node):
        self._ctx = ctx
        self._node = node

    @property
    def num_partitions(self) -> int:
        return self._node.num_partitions()

    def map_batches(self, f, payload_bytes: Optional[int] = None
                    ) -> "BatchRDD":
        """``f(keys, payload) -> (keys, payload)`` per partition. Pass
        ``payload_bytes`` when ``f`` changes the row width."""
        width = payload_bytes if payload_bytes is not None \
            else self._node.payload_bytes
        return BatchRDD(self._ctx, _BNarrow(self._node, f, width))

    def repartition(self, num_partitions: int,
                    partitioner: Optional[PartitionerSpec] = None
                    ) -> "BatchRDD":
        """Hash- (default) or range-repartition rows by key."""
        return BatchRDD(self._ctx, _BShuffle(
            self._node, num_partitions,
            partitioner or PartitionerSpec("hash")))

    def reduce_by_key(self, combiner, num_partitions: int) -> "BatchRDD":
        """``combiner(sorted_keys, sorted_payload) -> (keys, payload)``
        — the dependency-combiner contract: it runs map-side in every
        writer (shuffle bytes scale with distinct keys) and once more
        reduce-side over the fetched partition."""
        return BatchRDD(self._ctx, _BShuffle(
            self._node, num_partitions, PartitionerSpec("hash"),
            combiner=combiner))

    def sort_by_key(self, num_partitions: int,
                    sample_per_part: int = 4096) -> "BatchRDD":
        """Global key sort: sampled range splitters -> range shuffle ->
        local sort (TeraSort's shape, driven from the RDD surface).
        Under a mesh engine the local sort is a no-op check: the
        collective reduce already returns each partition key-sorted."""
        # splitters come straight from the sorted integer sample —
        # np.quantile would interpolate in float64, which rounds keys
        # near 2**64 past the uint64 range and overflows the partitioner
        sample = np.sort(self._sample_keys(sample_per_part))
        if len(sample):
            idx = [round(len(sample) * i / num_partitions)
                   for i in range(1, num_partitions)]
            splitters = tuple(int(sample[min(i, len(sample) - 1)])
                              for i in idx)
        else:
            splitters = ()
        shuffled = BatchRDD(self._ctx, _BShuffle(
            self._node, num_partitions,
            PartitionerSpec("range", splitters)))

        def local_sort(keys, payload):
            order = np.argsort(keys, kind="stable")
            return keys[order], payload[order]

        return shuffled.map_batches(local_sort)

    # -- actions ----------------------------------------------------------

    def collect_batches(self) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Per-partition (keys, payload) batches, in partition order."""
        return self._run(lambda keys, payload, _t: (keys, payload))

    def count(self) -> int:
        return sum(self._run(lambda keys, _p, _t: len(keys)))

    # -- internals --------------------------------------------------------

    def _sample_keys(self, per_part: int) -> np.ndarray:
        def sample(keys, _p, task_id, _n=per_part):
            if len(keys) <= _n:
                return keys.copy()
            rng = np.random.default_rng(0x5EED + task_id)
            return rng.choice(keys, size=_n, replace=False)

        got = self._run(sample)
        return np.concatenate(got) if got else np.zeros(0, np.uint64)

    def _run(self, finalize) -> list:
        memo: dict = {}
        builder, parents = _b_chain(self._node, memo)

        def task_fn(tc, task_id, _b=builder, _fin=finalize):
            keys, payload = _b(tc, task_id)
            return _fin(keys, payload, task_id)

        final = ResultStage(self._node.num_partitions(), task_fn,
                            parents=parents)
        return self._ctx.engine.run(final)


def _b_chain(node, memo: dict):
    """Batch analogue of :func:`_chain` (same fusion + boundary rules)."""
    if isinstance(node, _BSource):
        bcast = node.bcast

        def build(tc, task_id, _b=bcast):
            return _b.value[task_id]

        return build, []

    if isinstance(node, _BNarrow):
        inner, parents = _b_chain(node.parent, memo)

        def build(tc, task_id, _inner=inner, _f=node.fn):
            keys, payload = _inner(tc, task_id)
            return _f(keys, payload)

        return build, parents

    if isinstance(node, _BShuffle):
        if id(node) in memo:
            stage = memo[id(node)]
        else:
            inner, parents = _b_chain(node.parent, memo)
            dep = ShuffleDependency(node.parts, node.partitioner,
                                    row_payload_bytes=node.payload_bytes,
                                    combiner=node.combiner)

            def task_fn(tc, writer, task_id, _inner=inner):
                keys, payload = _inner(tc, task_id)
                if len(keys):
                    writer.write((np.ascontiguousarray(keys, np.uint64),
                                  _as_u8_rows(payload)))

            stage = MapStage(node.parent.num_partitions(), dep, task_fn,
                             parents=parents)
            memo[id(node)] = stage

        combiner = node.combiner

        def build(tc, task_id, _c=combiner):
            reader = tc.read(0)
            if _c is not None:
                # reduce-side final combine over the fetched partition
                # (map-side partials from different maps still need one
                # merge — the aggregator's merge half)
                return reader.readAggregated(_c)
            return reader.readAll()

        return build, [stage]

    raise TypeError(f"unknown batch plan node {type(node).__name__}")


def _as_u8_rows(payload: np.ndarray) -> np.ndarray:
    """View any fixed-width row payload as the u8 bytes the writer wants.

    Width comes from the dtype/shape, not the data — a 0-row batch keeps
    its row width (reshape(-1) can't infer one from zero elements)."""
    payload = np.ascontiguousarray(payload)
    width = payload.dtype.itemsize * (
        int(np.prod(payload.shape[1:])) if payload.ndim > 1 else 1)
    n = len(payload)  # BEFORE the u8 view: the view multiplies the
    # leading axis by itemsize for 1-D inputs
    if payload.dtype != np.uint8:
        payload = payload.view(np.uint8)
    return payload.reshape(n, width)


class EngineContext:
    """The SparkContext analogue: makes RDDs, owns defaults.

    ``engine`` is a :class:`sparkrdma_tpu_torch.engine.DAGEngine`; every action
    compiles to one ``engine.run`` job, so RDD jobs get stage retry,
    speculation, shared variables, task shipping to executor processes,
    and the mesh data plane exactly as hand-built stage graphs do.
    """

    def __init__(self, engine: DAGEngine, default_parallelism: int = 0,
                 row_bytes: int = 1024):
        self.engine = engine
        self.default_parallelism = (default_parallelism
                                    or max(2, len(engine.executors)))
        # fixed row width for object-blob shuffles: 8B u64 key + 8B
        # (map, seq) tag per row on the wire, zero-pad only in each
        # blob's last row
        if row_bytes < 64:
            raise ValueError("row_bytes must be >= 64 (8B row tag + "
                             "8B length header + payload)")
        self.row_bytes = row_bytes

    def parallelize(self, data: Iterable, num_slices: int = 0) -> RDD:
        """Distribute a local collection. The partition list rides the
        driver's broadcast plane (one fetch per executor process), not
        each task's closure."""
        items = list(data)
        n = max(1, min(num_slices or self.default_parallelism,
                       max(1, len(items))))
        step = -(-len(items) // n) or 1
        # n slices exactly; trailing ones come out empty via short slices
        parts = [items[i * step:(i + 1) * step] for i in range(n)]
        return RDD(self, _Source(self.engine.broadcast(parts), n))

    def text_file(self, path: str, num_slices: int = 0) -> RDD:
        """Lines of the file(s) at ``path`` (a path or glob), split into
        byte ranges at line granularity — the lazy, scan-parallel entry
        point (Spark's sc.textFile)."""
        import glob as _glob
        import os

        files = sorted(_glob.glob(path)) if _glob.has_magic(path) \
            else [path]
        sizes = [os.path.getsize(f) for f in files]  # missing file raises
        if not files:
            raise FileNotFoundError(f"no files match {path!r}")
        n = num_slices or self.default_parallelism
        target = max(1, -(-sum(sizes) // n))
        splits: List[Tuple[str, int, int]] = []
        for f, size in zip(files, sizes):
            k = max(1, -(-size // target))
            step = -(-size // k) or 1
            splits.extend((f, i * step, min((i + 1) * step, size))
                          for i in range(k))
        return RDD(self, _FileSource(splits))

    textFile = text_file

    def from_arrays(self, keys: np.ndarray, payload: np.ndarray,
                    num_slices: int = 0) -> BatchRDD:
        """Vectorized source: split (keys u64[N], payload rows) evenly
        into partitions. Entry point to :class:`BatchRDD` — the
        zero-pickling batch plane with RDD ergonomics."""
        keys = np.ascontiguousarray(keys, np.uint64)
        rows = _as_u8_rows(payload)
        if len(rows) != len(keys):
            raise ValueError(f"{len(keys)} keys vs {len(rows)} payload rows")
        n = max(1, min(num_slices or self.default_parallelism,
                       max(1, len(keys))))
        step = -(-len(keys) // n) or 1
        parts = [(keys[i * step:(i + 1) * step].copy(),
                  rows[i * step:(i + 1) * step].copy()) for i in range(n)]
        return self.batches(parts)

    def batches(self, per_partition: List[Tuple[np.ndarray, np.ndarray]]
                ) -> BatchRDD:
        """Vectorized source from explicit per-partition batches."""
        parts = [(np.ascontiguousarray(k, np.uint64), _as_u8_rows(p))
                 for k, p in per_partition]
        widths = {p.shape[1] for _k, p in parts}
        if len(widths) > 1:
            raise ValueError(f"inconsistent payload widths {sorted(widths)}")
        width = widths.pop() if widths else 0
        return BatchRDD(self, _BSource(self.engine.broadcast(parts),
                                       len(parts), width))

    def broadcast(self, value):
        return self.engine.broadcast(value)

    def accumulator(self, name: str, zero=0):
        return self.engine.accumulator(name, zero)
