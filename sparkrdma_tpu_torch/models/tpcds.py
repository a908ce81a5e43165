"""TPC-DS-shaped multi-join: the q64/q95-class shuffle-heavy SQL workload.

Port of the on-mesh half of ``sparkrdma_tpu/models/tpcds.py``
(BASELINE.md config #4). The canonical star shape

    fact  join(key1) dim1  join(key2) dim2  -> GROUP BY g -> (count, sum)

runs as five chained ``exchange.shuffle_into`` shuffles in one step over
every shard (on ``cuda`` each through the ragged all-to-all kernel, the
``native`` transport): fact and dim1 by hash(key1), the join-1 survivors
and dim2 by hash(key2), the joined rows by group owner (``g % D``). Fact
keys are Zipf-skewed; dimension keys are unique with partial coverage, so
both joins are selective inner joins done as sorted lookups
(``ops/sort.py::lookup_unique``; validity masks carry selectivity).

Arithmetic is the JAX package's u32 arithmetic: int64 values masked to
32 bits (``utils.u32``). Per-group sums are int32 there and wrap; the
port sums in int64 and wraps the result to int32, which is the same
modulo 2**32.

The same logical plan is also a DAG-engine job (``build_tpcds_job``):
source stages for the three tables, two join MapStages, one aggregating
ResultStage, in numpy on the host; with ``DAGEngine(mesh=...)`` its five
shuffles ride the device plane. Both forms answer to ``numpy_tpcds``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.ops.partition import hash_partition
from sparkrdma_tpu_torch.ops.sort import lookup_unique
from sparkrdma_tpu_torch.parallel.exchange import (
    resolve_transport,
    shuffle_into,
    spread_index,
)
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.utils import trace as trace_mod
from sparkrdma_tpu_torch.utils.u32 import (
    MASK,
    SENTINEL,
    rows_from_numpy,
    to_bits,
    to_u64,
)

PAD = np.uint32(0xFFFFFFFF)
_MOD = 10007


@dataclass(frozen=True)
class TpcdsConfig:
    fact_rows_per_device: int
    dim1_size: int              # global; keys in [0, dim1_size)
    dim2_size: int
    num_groups: int = 256
    zipf_a: float = 1.2         # fact key1 skew exponent
    out_factor: int = 3         # receive headroom for the skewed exchange
    dim_coverage_mod: int = 10  # dim keeps keys with k % mod != 0 (90%)


def _mix_group(key1, key2, num_groups):
    """Group key from both join keys with u32 wraparound, on zero-extended
    int64 tensors or uint64 numpy arrays."""
    return ((key1 * 31 + key2) & MASK) % num_groups


def generate_star(cfg: TpcdsConfig, num_devices: int, seed: int = 0,
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(fact u32[D*F, 3], dim1 u32[M1', 2], dim2 u32[M2', 2])``, the same
    arrays as the JAX package's generator for the same seed.

    fact columns: (key1 zipf-skewed, key2 uniform, measure). Dim tables
    have unique keys with ``(mod-1)/mod`` coverage."""
    rng = np.random.default_rng(seed)
    n = num_devices * cfg.fact_rows_per_device
    key1 = (rng.zipf(cfg.zipf_a, size=n) - 1) % cfg.dim1_size
    key2 = rng.integers(0, cfg.dim2_size, size=n)
    measure = rng.integers(0, 97, size=n)
    fact = np.stack([key1, key2, measure], axis=1).astype(np.uint32)

    def dim(size, attr_mod, salt):
        keys = np.arange(size, dtype=np.uint32)
        keys = keys[keys % cfg.dim_coverage_mod != 0]
        attr = ((keys * 2654435761 + salt) % attr_mod).astype(np.uint32)
        return np.stack([keys, attr], axis=1)

    return fact, dim(cfg.dim1_size, 89, 7), dim(cfg.dim2_size, 83, 13)


def pad_to_devices(rows: np.ndarray, num_devices: int) -> np.ndarray:
    """Pad (with PAD-key rows) so the leading axis splits evenly; at least
    one row per device so an empty table still exchanges and probes."""
    per = max(1, -(-len(rows) // num_devices))
    out = np.full((per * num_devices, rows.shape[1]), PAD, rows.dtype)
    out[:len(rows)] = rows
    return out


def make_tpcds_step(mesh: VirtualMesh, cfg: TpcdsConfig, impl: str = "auto"):
    """Star-join + aggregate over ``mesh``.

    ``step(fact, dim1, dim2)`` takes ``fact int32[D, F, 3]``, ``dim1
    int32[D, M1, 2]``, ``dim2 int32[D, M2, 2]`` u32 rows (PAD-key rows
    ignored). Returns ``(counts int32[D, G], sums int32[D, G], overflowed
    bool[D])``: shard d's rows hold the totals of the groups it owns
    (``g % D == d``) and zeros elsewhere, so a sum over shards is the full
    GROUP BY result."""
    n = mesh.num_shards
    impl = resolve_transport(mesh, impl)
    groups = cfg.num_groups

    def route(rows, key_col):
        keys = to_u64(rows[..., key_col])
        return torch.where(keys != SENTINEL, hash_partition(keys, n), -1)

    def step(fact: torch.Tensor, dim1: torch.Tensor, dim2: torch.Tensor):
        cap = fact.shape[1] * cfg.out_factor
        with trace_mod.span("tpcds.join1"):
            # shuffles 1+2: dim1 and fact to hash(key1) owners
            d1, d1_valid, of1 = shuffle_into(
                dim1, route(dim1, 0), dim1.shape[1] * cfg.out_factor, impl)
            f1, f1_valid, of2 = shuffle_into(fact, route(fact, 0), cap, impl)
            key1 = to_u64(f1[..., 0])
            attr1, found1 = lookup_unique(d1[..., 0], d1_valid, d1[..., 1],
                                          key1)
            live1 = f1_valid & found1
            value1 = ((to_u64(f1[..., 2]) * attr1) & MASK) % _MOD
            # join-1 survivors: (key2, key1, value1), PAD-keyed when dead
            mid = torch.stack([torch.where(live1, to_u64(f1[..., 1]),
                                           SENTINEL), key1, value1], dim=-1)
            mid = to_bits(mid)
        with trace_mod.span("tpcds.join2"):
            # shuffles 3+4: dim2 and the survivors to hash(key2) owners
            d2, d2_valid, of3 = shuffle_into(
                dim2, route(dim2, 0), dim2.shape[1] * cfg.out_factor, impl)
            m2, m2_valid, of4 = shuffle_into(mid, route(mid, 0), cap, impl)
            key2 = to_u64(m2[..., 0])
            attr2, found2 = lookup_unique(d2[..., 0], d2_valid, d2[..., 1],
                                          key2)
            live2 = m2_valid & found2
            value = ((to_u64(m2[..., 2]) + attr2) & MASK) % _MOD
            group = _mix_group(to_u64(m2[..., 1]), key2, groups)
        with trace_mod.span("tpcds.aggregate"):
            # shuffle 5: joined rows to their group's owner (g % D)
            rows3 = to_bits(torch.stack(
                [torch.where(live2, group, SENTINEL), value], dim=-1))
            dest3 = torch.where(live2, group % n, -1)
            recv3, v3, of5 = shuffle_into(rows3, dest3, cap, impl)
            g3 = to_u64(recv3[..., 0])
            live3 = v3 & (g3 != SENTINEL)
            # one flat [D*G] sum: shard d's group g at d*G + g. The JAX
            # bincount sends pads to a discarded bin G; here a pad adds
            # zero at a spread place
            flat = spread_index(live3, g3, groups)
            counts = torch.zeros(n * groups, dtype=torch.int64,
                                 device=g3.device)
            sums = torch.zeros_like(counts)
            counts.index_add_(0, flat.reshape(-1),
                              live3.to(torch.int64).reshape(-1))
            sums.index_add_(0, flat.reshape(-1), torch.where(
                live3, to_u64(recv3[..., 1]), 0).reshape(-1))
            counts = counts.reshape(n, groups)
            sums = sums.reshape(n, groups)
        overflowed = of1 | of2 | of3 | of4 | of5
        return counts.to(torch.int32), sums.to(torch.int32), overflowed

    return step


def run_tpcds(mesh: VirtualMesh, cfg: TpcdsConfig, seed: int = 0,
              impl: str = "auto",
              star: Optional[Tuple[np.ndarray, np.ndarray,
                                   np.ndarray]] = None,
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Host driver: returns the exact global ``(counts int64[G], sums
    int64[G])``. ``star`` is a ``generate_star`` result (made from
    ``seed`` when not given). Raises ``OverflowError`` when a shuffle
    overflowed its receive headroom."""
    n = mesh.num_shards
    fact, dim1, dim2 = (star if star is not None
                        else generate_star(cfg, n, seed))
    step = make_tpcds_step(mesh, cfg, impl)
    counts, sums, overflowed = step(
        rows_from_numpy(fact, mesh),
        rows_from_numpy(pad_to_devices(dim1, n), mesh),
        rows_from_numpy(pad_to_devices(dim2, n), mesh))
    if overflowed.any().item():
        raise OverflowError("tpcds shuffle overflowed receive headroom; "
                            "raise TpcdsConfig.out_factor")
    return (counts.cpu().numpy().sum(axis=0).astype(np.int64),
            sums.cpu().numpy().sum(axis=0).astype(np.int64))


def numpy_tpcds(fact: np.ndarray, dim1: np.ndarray, dim2: np.ndarray,
                num_groups: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host oracle: exact star-join + GROUP BY with the same u32
    arithmetic: the JAX package's per-row loop, vectorised. Dimension
    keys are unique."""

    def lookup(dim, keys):
        if not len(dim):
            return np.zeros(len(keys), np.uint64), np.zeros(len(keys), bool)
        order = np.argsort(dim[:, 0], kind="stable")
        dkeys, attr = dim[order, 0], dim[order, 1].astype(np.uint64)
        idx = np.clip(np.searchsorted(dkeys, keys), 0, len(dkeys) - 1)
        return attr[idx], dkeys[idx] == keys

    k1, k2 = fact[:, 0], fact[:, 1]
    v1, found1 = lookup(dim1, k1)
    v2, found2 = lookup(dim2, k2)
    live = found1 & found2
    mask = np.uint64(MASK)
    m = fact[:, 2].astype(np.uint64)
    value = ((((m * v1) & mask) % _MOD + v2) & mask) % _MOD
    group = _mix_group(k1.astype(np.uint64), k2.astype(np.uint64),
                       num_groups)[live].astype(np.int64)
    counts = np.bincount(group, minlength=num_groups).astype(np.int64)
    # float64 weights are exact: every group's sum is below 2**53
    sums = np.bincount(group, weights=value[live],
                       minlength=num_groups).astype(np.int64)
    return counts, sums


# -- the same plan through the DAG engine (drop-in SPI path) --------------

def build_tpcds_job(cfg: TpcdsConfig, num_maps: int, num_partitions: int,
                    seed: int = 0):
    """The star query as a stage DAG for ``engine.DAGEngine.run``.

    Returns ``(result_stage, finish)`` where ``finish(results)`` folds the
    per-partition dicts into global ``(counts[G], sums[G])``. Stage graph:
    three sources (fact/dim1/dim2, modulo-partitioned on their join key),
    join-1 (reads fact+dim1, writes by key2), join-2 (reads join-1+dim2,
    writes by group), aggregate ResultStage — five shuffles, the SPI
    sequence a TPC-DS stage graph drives through Spark.
    """
    from sparkrdma_tpu_torch.engine import MapStage, ResultStage
    from sparkrdma_tpu_torch.shuffle.manager import PartitionerSpec
    from sparkrdma_tpu_torch.shuffle.spark_compat import ShuffleDependency

    G = cfg.num_groups
    fact_all, dim1_all, dim2_all = generate_star(cfg, 1, seed)

    def dep(payload_bytes):
        return ShuffleDependency(num_partitions, PartitionerSpec("modulo"),
                                 row_payload_bytes=payload_bytes)

    def rows_of(table, task):  # deterministic striping across map tasks
        return table[task::num_maps]

    def src(table, key_col, payload_cols):
        width = 4 * len(payload_cols)

        def fn(ctx, writer, task):
            rows = rows_of(table, task)
            payload = np.ascontiguousarray(
                rows[:, payload_cols], dtype="<u4").view(np.uint8)
            writer.write((rows[:, key_col].astype(np.uint64),
                          payload.reshape(len(rows), width)))
        return fn

    fact_st = MapStage(num_maps, dep(8), src(fact_all, 0, [1, 2]))
    dim1_st = MapStage(num_maps, dep(4), src(dim1_all, 0, [1]))
    dim2_st = MapStage(num_maps, dep(4), src(dim2_all, 0, [1]))

    def read_u32(ctx, parent):  # -> (keys u64[N], cols u32[N, W])
        ks, vs = [], []
        for keys, payload in ctx.read(parent).readBatches():
            ks.append(keys)
            vs.append(np.ascontiguousarray(payload).view("<u4")
                      .reshape(len(keys), -1))
        if not ks:
            return np.zeros(0, np.uint64), np.zeros((0, 1), np.uint32)
        return np.concatenate(ks), np.concatenate(vs)

    def np_lookup(dkeys, dattr, probes):
        """Vectorized unique-key join: (attr[N] u32, found[N] bool)."""
        if len(dkeys) == 0:
            return (np.zeros(len(probes), np.uint32),
                    np.zeros(len(probes), bool))
        order = np.argsort(dkeys)
        ks, at = dkeys[order], dattr[order]
        idx = np.clip(np.searchsorted(ks, probes), 0, len(ks) - 1)
        return at[idx].astype(np.uint32), ks[idx] == probes

    def join1_fn(ctx, writer, task):
        fkeys, fcols = read_u32(ctx, 0)   # key1 -> (key2, measure)
        dkeys, dcols = read_u32(ctx, 1)   # key1 -> (attr1,)
        attr, found = np_lookup(dkeys, dcols[:, 0], fkeys)
        v1 = (fcols[:, 1].astype(np.uint32) * attr) % np.uint32(10007)
        keep = found
        payload = np.stack([fkeys.astype(np.uint32)[keep], v1[keep]],
                           axis=1)  # (key1, value1)
        writer.write((fcols[:, 0][keep].astype(np.uint64),
                      np.ascontiguousarray(payload, "<u4").view(np.uint8)
                      .reshape(int(keep.sum()), 8)))
        del task

    join1_st = MapStage(num_partitions, dep(8), join1_fn,
                        parents=[fact_st, dim1_st])

    def join2_fn(ctx, writer, task):
        mkeys, mcols = read_u32(ctx, 0)   # key2 -> (key1, value1)
        dkeys, dcols = read_u32(ctx, 1)   # key2 -> (attr2,)
        attr, found = np_lookup(dkeys, dcols[:, 0], mkeys)
        value = (mcols[:, 1].astype(np.uint32) + attr) % np.uint32(10007)
        group = _mix_group(mcols[:, 0].astype(np.uint32),
                           mkeys.astype(np.uint32), np.uint32(G))
        keep = found
        writer.write((group[keep].astype(np.uint64),
                      np.ascontiguousarray(value[keep], "<u4")
                      .view(np.uint8).reshape(int(keep.sum()), 4)))
        del task

    join2_st = MapStage(num_partitions, dep(4), join2_fn,
                        parents=[join1_st, dim2_st])

    def agg_fn(ctx, task):
        counts = np.zeros(G, np.int64)
        sums = np.zeros(G, np.int64)
        for keys, payload in ctx.read(0).readBatches():
            vals = np.ascontiguousarray(payload).view("<u4").ravel()
            np.add.at(counts, keys.astype(np.int64), 1)
            np.add.at(sums, keys.astype(np.int64), vals.astype(np.int64))
        del task
        return counts, sums

    result = ResultStage(num_partitions, agg_fn, parents=[join2_st])

    def finish(results):
        counts = sum(c for c, _ in results)
        sums = sum(s for _, s in results)
        return counts, sums

    return result, finish
