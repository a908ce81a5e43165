#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``sparkrdma_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; builds the port's kernels from the
sources in this checkout into ``build/`` on first use. Phases, each
printing one JSON line; any failure raises and the exit code is not 0:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel of the main path, one ``nvcc`` per source;
3. kernel: ``ring_all_to_all`` against its plain PyTorch version, bit
   for bit, at the TeraSort path's shape, at the kernel's tile edges (a
   block shorter than a scalar head plus tail, one warp tile, one tile +
   1 word, several tile groups; D = 1, 2, 3, 8) and at an odd shape
   whose blocks are not 16-byte aligned; CUDA-event medians of the
   kernel, the plain version and one library call computing the same
   function, cold (a shape whose blocks fit in the L2 is also timed
   warm, and cold by rotating through copies), and the host's time per
   launch; then the same at a fixed list of misaligned shapes that the
   paths below launch (``MISALIGNED_SHAPES``) and at the tiny aligned
   ones (``SMALL_SHAPES``), each with its ratio to the library call
   (``vs_library``), on a line each (``kernel_misaligned``,
   ``kernel_small``), and at the block shapes the paths launch it at
   under ``impl="ring"`` (``PATH_RING_SHAPES``, line ``kernel_paths``);
   then kernel_native: ``ragged_all_to_all`` (the ``native``
   transport) against its plain version and the ``gather`` transport,
   byte for byte, at the TeraSort path's shape (timed: ms, the byte
   bound of the rows the counts move, ``gather_ms``, host µs per
   launch), at row widths 1, 2, 3, 5 and 25 under random, skewed,
   empty, flooding (truncated) and holed counts, and replayed in a
   CUDA graph on new rows and counts; then kernel_gather: the row gather
   kernel ``row_gather`` (under every ``take_rows``) against its plain
   version, byte for byte and one launch a call, at q95's SF10 fact
   gathers (grouping and random-permutation indices), its
   customer_address and web_returns groupings, TeraSort's 25-word local
   and receive sorts and two odd shapes, each timed against its byte
   bound, the plain version and one flat ``index_select``
   (``library_ms``); from here on every CUDA ``take_rows`` call is
   counted with the launches it asks for (in the worker processes of the
   multihost and analysis phases too), each counted path's gather
   launches are held to its own calls, and the end holds the process's
   launches to all of them; then kernel_merge: the receive merge kernel
   ``run_merge`` (the ``range`` step's receive side) on the receive of a
   range step at the main path's 1 GiB and at HiBench large's 3.2 GB,
   byte for byte against ``sort_received`` (its plain version) and the
   step's output, timed against its byte bound and ``sort_received``;
   from here on every CUDA range step is counted (in the multihost
   phase's worker processes too), each counted path's merge launches
   are held to its own range steps, and the end holds the process's
   launches to all of them;
   then kernel_partition: the stable partition by destination
   ``dest_partition`` (under every grouping) against its plain version,
   byte for byte and one launch a call, at q95's SF10 groupings (the
   fact rows of round 1 and a padded receive buffer of rounds 2-4), timed
   against its byte bound, the plain version and ``torch.sort`` with
   ``searchsorted`` on int32 destinations (``library_ms``); every CUDA
   ``group_by_destination`` call with rows is counted (in the worker
   processes of the multihost and analysis phases too), each counted
   path's partition launches are held to its own groupings, the paths
   that group (q95, q64, the ``dest`` step, ALS, PageRank, the mesh
   reduce) must have launched it, and the end holds the process's
   launches to all of them;
   then kernel_lookup: the unique-key lookup ``hash_lookup`` (under the
   query plans' joins) at q64's SF10 shapes, the store join's two-word
   pairs and the date join's one-word dates, against its plain version
   (``found`` exact, ``attr`` exact where found and 0 elsewhere) and what
   the data must find, one launch a call, timed against the plain
   version's sort and search; every CUDA ``hash_lookup`` call is counted
   (in the worker processes too), each counted path's lookup launches are
   held to its own calls, the star join, q95 and q64 paths must have
   launched it, and the end holds the process's launches to all calls;
4. main path: TeraSort of 1 GiB of 100-byte rows over an 8-shard virtual
   mesh with ``impl="auto"`` (the ragged kernel) and again with
   ``impl="ring"`` (BASELINE.md config #1), counting each kernel's
   launches, then ``verify_terasort``; repeated warm steps of both
   timed on the host clock in turns and one traced step of each (device
   time per layer span, top kernels, idle share); a small run held bit
   for bit to
   ``numpy_terasort``; a streamed run of 3 rounds with a partial tail;
5. streamed: ``run_terasort_streamed`` over the main path's 1 GiB of rows
   in 4 rounds (a quarter of its rows a shard, the tail padded),
   pipelined and with ``pipeline_rounds=False``: byte-equal outputs, each
   holding ``verify_terasort``'s contract, their ``phase_times``, and
   the card's memory peak of each run within one round's peak + 10%
   unpipelined and two rounds' + 10% pipelined;
6. bench: ``python -m sparkrdma_tpu_torch.bench`` (secondaries skipped)
   as a process of its own, its JSON line checked (the headline metric,
   ``platform`` ``cuda``, the ``native`` transport, a ``vs_baseline``) and
   printed; then the bench's four device secondaries (PageRank, the
   join, the TPC-DS star, ALS) in this process through its own builders,
   none recording an error;
7. kernel_chunked: the ring kernel against its plain version at the ALS
   path's block shape, timed like phase 3;
8. the workloads of BASELINE.md configs #3-#5, each through its entry
   point with ``impl="auto"`` (the ragged kernel on the card), its kernel
   launches counted per shape, the kernel held to its plain
   version at every block shape the path gave it, its result held to its
   numpy oracle, then warm steps timed and one traced: ALS half-step over
   100M ratings (the normal equations kernel's launches held to the
   path's solves, one a shard a half-step; then the kernel checked
   against its plain version and float64 and timed at a block of the ALS
   cell, rank 10, each side), PageRank over 2**27 edges, the shuffle
   join, the TPC-DS star;
9. the TPC-DS q95 and q64 plans (BASELINE.md config #4), the same way:
   q95 over SF10's 7,197,568 web_sales rows, q64 at the largest size its
   16-bit keys admit, each per-shard partial held to a numpy oracle;
10. the device plane's host drivers over 1 GiB of 100-byte rows (BASELINE.md
   config #1's size) in rounds sized from a 64 MiB device memory budget:
   ``run_fused_exchange`` pipelined and sequential (byte-equal, each shard
   equal to a numpy stable sort of its rows), with the host's time per
   round in staging, dispatch, collect and merge; then
   ``run_hierarchical_exchange`` over two slices of 4 shards, byte-equal
   to the flat driver, with its cross-slice bytes;
11. the mesh shuffle service (``shuffle/mesh_service.py``) over an engine
   shuffle stage: 1 GiB of 100-byte records written as 8 map outputs of
   128 MiB through the writers of 4 executors on localhost (a
   ``SparkCompatShuffleManager`` driver and executors, spill files under
   one temporary directory; map 0 on two of them), hash-partitioned into
   200 reduce partitions,
   reduced on the card by the fused driver in budget-sized rounds (the
   headline: wall time, GB/s, the host's time per part from the tracer,
   one more run traced), the fused driver in one shot, the one-shot
   ``run_mesh_reduce``, the streamed reduce pipelined and sequential, and
   the hierarchical reduce on two slices of 4 shards; each held to one
   numpy oracle (byte-equal per shard; per partition for the
   hierarchical run), then ``split_by_partition`` and
   ``CachedPartitionReader`` over run 1's result, and ``read_to_device``
   of the 8 committed outputs (1 GiB) with its GB/s;
12. engine: the same records as a real engine job (``DAGEngine`` over a
    ``SparkCompatShuffleManager`` driver and 4 executors on localhost,
    ``mesh=VirtualMesh(8)``, the default cost model and budget): 8 map
    tasks write their 128 MiB through the writer into spill files, 200
    result tasks read their partitions off the device plane; it must pick
    the device plane, degrade nothing, read no remote byte, tick one
    exchange per round and return every partition byte-equal to the
    oracle, with the native shim loaded. Prints the map stage's, the
    reduce's and the job's walls, the reduce's GB/s and host time per
    span, and a traced second run's device time and idle share; then
    TPC-DS q95 as an engine job (``build_q95_job`` at SF10's web_sales
    rows) through the same engine, against ``numpy_q95``, every shuffle
    on the device plane with no degrade;
13. small runs of every workload against their numpy oracles, and small
    engine jobs under the mesh engine: the star and q64 plans (4
    partitions, so a round's source shard sends to one or two
    destinations), the
    README's ``EngineContext`` word count and ``BatchRDD.sort_by_key``
    over 2**20 rows, each on the device plane with no degrade; and a
    skewed stage whose receive overflows and degrades to the host plane,
    still exact;
14. multihost: the multi-process path (``parallel/multihost.py``) with two
    worker processes on the one card (this script under
    ``--multihost-worker``), 4 shards each, a global mesh of 8 whose
    exchange under ``impl="auto"`` (``native``) range-launches the ragged
    kernel over each process's own shards, writing each pair's rows
    through CUDA IPC peer pointers into the receiving process's arena:
    ``run_multihost_terasort`` at the main path's 1 GiB under ``auto``
    and under ``impl="ring"`` (the ring kernel's range launch into
    per-pair slots) in turns (auto, ring, ring, auto), each global shard
    of each run digest-equal to the single-process ``VirtualMesh(8)``
    step over the same rows; the step
    alone timed under both in turns and traced once each; the
    mesh-service stage (phase 11's records, maps 0-3 written in worker 0,
    4-7 in worker 1, the driver in worker 0) through
    ``run_multihost_mesh_reduce`` one shot and in rounds under ``auto``,
    each partition digest-equal to the oracle, the topology two slices
    and its cross-slice bytes counted; each kernel's cross-process
    launches held to its plain version over the global data and timed
    at every shape they ran at, one process at a time (the other waits
    at a barrier), into the peers' arenas and into a local buffer;
15. cli_and_benches: the command line and the device benches.
    ``python -m sparkrdma_tpu_torch`` ``info`` (must name the card),
    ``config``, ``selftest``, ``engine-demo`` and ``rdd-demo`` as
    processes started together, each exiting 0 and verified; ``demo``
    (TeraSort of 800,000 rows) and ``engine-mesh-demo`` (the TPC-DS star
    as an engine job on the device plane) in this process through
    ``main([...])``, each launching the ragged kernel, every shape
    held to the plain version; ``shuffle-service`` as a real process
    that adopts a stopped executor's spill directory (2 of 4 maps of
    2**18 100-byte records), a reducer reading all 16 partitions exactly
    through it, and SIGTERM ending it with exit 0; ``device_bench``
    (the host-staged TCP reduce with a 6 ms service delay per request
    against ``run_mesh_reduce_fused``) at its defaults and at the
    mesh_service phase's records cut to 256 MiB, each byte-identical
    and launching the kernel; ``topo_bench`` (flat against hierarchical
    on two slices, ``impl="gather"``: no kernel) at its defaults and at
    65,536 rows a shard, each identical with strictly fewer hierarchical
    cross-slice bytes; ``client_bench`` at its ``main``'s defaults with
    checksums off and on: client CPU per GB, GB/s and wire-to-device ms
    of the Python and the native receive paths, identical, and their
    ratios, not gated;
16. analysis: the port's analysis suite (``sparkrdma_tpu_torch/analysis``)
    on the card machine. ``python -m sparkrdma_tpu_torch.analysis
    --model-check`` in a process of its own, clean, with its schedule
    counts per scenario; both sanitized shims built through
    ``runtime/shim_build.py`` and ``analysis/native_harness.py`` run under
    each that built (ASan preloaded into that process only, which
    imports no ``torch``); a kind that does not build prints one
    ``"sanitizers": "unavailable: ..."`` line with the compiler's error
    and runs no harness; then phase 12's engine stage,
    cut to 256 MiB (8 maps of 32 MiB), as a ``DAGEngine`` job on
    ``VirtualMesh(8)`` in a process (this script under
    ``--lockgraph-worker``) that installs the port's lock-order shim
    before it imports anything else of the port: every partition
    byte-equal to the oracle, no lock-order cycle, its orderings, tracked
    lock sites and walls printed, the kernel's launches counted under
    ``analysis/lockgraph_engine`` and held to the plain version at every
    block shape;
17. the kernel table line (the ring and ragged kernels, each with the
    launches of the paths that ran it: ``auto`` is the ragged kernel, on
    one card and over the multihost phase's global mesh; the row gather
    with the launches of each counted path of this process), then the
    device line last.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import gc
import hashlib
import io
import itertools
import json
import os
import queue
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

LG_WORKER_FLAG = "--lockgraph-worker"
if __name__ == "__main__" and sys.argv[1:2] == [LG_WORKER_FLAG]:
    # the analysis phase's engine stage runs under the port's lock-order
    # shim, installed before anything else of the port is imported:
    # ops/_build.py and parallel/topology.py create their locks at import
    from sparkrdma_tpu_torch.analysis import lockgraph
    lockgraph.install()

from sparkrdma_tpu_torch import bench
from sparkrdma_tpu_torch.__main__ import main as cli_main
from sparkrdma_tpu_torch.config import _KEYS as _CONF_KEYS
from sparkrdma_tpu_torch.config import TpuShuffleConf
from sparkrdma_tpu_torch.engine import DAGEngine, MapStage, ResultStage
from sparkrdma_tpu_torch.models import (
    als,
    join,
    pagerank,
    tpcds,
    tpcds_queries,
)
from sparkrdma_tpu_torch.models.terasort import (
    TeraSortConfig,
    generate_rows,
    make_terasort_step,
    numpy_terasort,
    run_terasort,
    run_terasort_streamed,
    verify_terasort,
)
from sparkrdma_tpu_torch.ops import (
    _build,
    dest_partition,
    hash_lookup,
    normal_equations,
    ragged_exchange,
    ring_exchange,
    row_gather,
    run_merge,
)
from sparkrdma_tpu_torch.ops.sort import sort_received
from sparkrdma_tpu_torch.parallel.exchange import (
    bucket_quota,
    chunked_exchange,
)
from sparkrdma_tpu_torch.parallel import (
    device_plane,
    exchange,
    mesh,
    multihost,
    topology,
)
from sparkrdma_tpu_torch.parallel.device_plane import (
    auto_rows_per_round,
    run_fused_exchange,
    run_hierarchical_exchange,
    stage_to_device,
)
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.rdd import EngineContext
from sparkrdma_tpu_torch.runtime import native, shim_build
from sparkrdma_tpu_torch.shuffle import (
    client_bench,
    device_bench,
    mesh_service,
    topo_bench,
)
from sparkrdma_tpu_torch.shuffle.manager import (
    PartitionerSpec,
    ShuffleHandle,
    TpuShuffleManager,
)
from sparkrdma_tpu_torch.shuffle.reader import read_to_device
from sparkrdma_tpu_torch.shuffle.spark_compat import (
    ShuffleDependency,
    SparkCompatShuffleManager,
)
from sparkrdma_tpu_torch.utils.trace import Tracer
from sparkrdma_tpu_torch.utils.u32 import (
    rows_from_numpy,
    rows_to_numpy,
    shards_from_numpy,
)

SHARDS = 8
DATA_BYTES = 1024 << 20      # BASELINE.md config #1, bench.py's default
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
L2_BYTES = 50 << 20          # H100 L2: blocks this small are timed warm too
COLD_BYTES = 100 << 20       # bytes one rotation touches to evict the L2
HOST_LAUNCHES = 100          # launches timed on the host clock, no sync
# the kernel's warp tile: kTileVecs = 128 vectors of 4 words; a CTA of
# four warps takes four tiles
TILE_WORDS = 512
# the kernel's edges: a block shorter than a scalar head plus tail (under
# 16 words), one tile, one tile + 1 word, three tile groups and a tail,
# at D = 1, 2, 3, 8
EDGE_SHAPES = tuple((d, d, c, w) for d in (1, 2, 3, 8)
                    for c, w in ((3, 5), (TILE_WORDS // 4, 4),
                                 (TILE_WORDS + 1, 1),
                                 (3 * TILE_WORDS + 7, 4)))
# blocks that are no multiple of 16 bytes, at the shapes the round
# drivers, the engine, device_bench, the streamed TeraSort, the
# hierarchical mesh reduce and q95 launch the kernel at
MISALIGNED_SHAPES = ((8, 8, 27962, 25), (8, 8, 83886, 25), (8, 8, 69905, 10),
                     (4, 4, 334406, 25), (8, 8, 3277, 1))
# 16-byte-aligned blocks of 64 KB and less, at the shapes q95, q64, the
# engine's q95, the CLI's engine-mesh demo and device_bench's defaults
# launch the kernel at
SMALL_SHAPES = ((8, 8, 2, 2), (8, 8, 46, 2), (8, 8, 100, 2), (8, 8, 2, 4),
                (8, 8, 46, 4), (8, 8, 100, 4), (8, 8, 256, 4),
                (8, 8, 388, 4), (8, 8, 512, 4), (8, 8, 256, 3),
                (8, 8, 4095, 4))
# the ring block shapes the card's paths launch under impl="ring" besides
# the lists above and the ALS shape (phase_kernel_chunked); held here
# directly, since impl="auto" is the ragged kernel on the card
PATH_RING_SHAPES = ((8, 8, 131072, 2), (8, 8, 262144, 2), (8, 8, 14746, 2),
                    (8, 8, 524288, 2), (8, 8, 524288, 3), (8, 8, 8192, 3),
                    (8, 8, 4194304, 2), (8, 8, 58982, 2),
                    (8, 8, 2097152, 2), (8, 8, 337386, 8),
                    (8, 8, 4095, 3), (8, 8, 4095, 5), (4, 4, 55924, 25),
                    (8, 8, 65536, 25), (4, 4, 334494, 25),
                    (4, 4, 336595, 25), (4, 4, 336682, 25), (8, 8, 819, 3),
                    (8, 8, 25000, 5), (8, 8, 29, 3))
# csrc/ sources: the ring and ragged kernels are in one, the row gather
# and the receive merge each in one of their own
KERNELS = ("ring_exchange", "row_gather", "run_merge", "dest_partition",
           "hash_lookup", "normal_equations")
RING = "ring_all_to_all"
NATIVE = "ragged_all_to_all"
GATHER = "row_gather"
MERGE = "run_merge"
# the partition by destination's cases: (name, shards, rows a shard, share
# of pads): q95's SF10 fact rows of round 1 and a padded receive buffer of
# rounds 2-4 (three times the live rows)
PARTITION_CASES = (
    ("q95.round1", 8, 899_696, 0.0),
    ("q95.group", 8, 2_699_088, 2 / 3),
)
# the receive merge's cases: (name, shards, rows a shard, row words), the
# receive of a range step over rows made on the card: the main path's
# 1 GiB TeraSort and the benchmark's HiBench large
MERGE_CASES = (
    ("terasort.1gib", 8, 1024 * 1024 * 1024 // 100 // 8, 25),
    ("terasort.hibench_large", 8, 4_000_000, 25),
)
# CUDA group_by_destination calls with rows in this process, counted by
# the wrapper _count_groupings installs: each partitions once; the
# partition's launches of the process, banked from dest_partition.LAUNCHES
# each time _launches zeroes it; its launches per counted path, set by
# _launches; the paths that must have grouped on the card
GROUPINGS = {"calls": 0}
PARTITION_BANKED = {"launches": 0}
PARTITION_OF_PATH: dict = {}
GROUPING_PATHS = ("q95", "q64", "fused_rounds", "chunked/als", "pagerank",
                  "mesh_service/fused_rounds")
# CUDA hash_lookup calls in this process, counted by the wrapper
# _count_lookups installs: each launches the lookup once; the lookup's
# launches of the process, banked from hash_lookup.LAUNCHES each time
# _launches zeroes it; its launches per counted path, set by _launches;
# the paths that must have looked up on the card
LOOKUPS = {"calls": 0}
LOOKUP_BANKED = {"launches": 0}
LOOKUP_OF_PATH: dict = {}
LOOKUP_PATHS = ("tpcds", "q95", "q64")
# CUDA range steps over more than one shard run in this process, counted
# by the wrapper _count_range_steps installs: each merges once; the
# merge's launches of the process, banked from run_merge.LAUNCHES each
# time _launches zeroes it; its launches per counted path, set by
# _launches
RANGE_STEPS = {"calls": 0}
MERGE_BANKED = {"launches": 0}
MERGE_OF_PATH: dict = {}
# the row gather's cases: (name, D, N, K, row words, indices), indices
# "group" (a stable sort of random destinations, the first third of the
# rows live where K = 3 x the live rows) or "perm" (a random permutation
# a shard, or random rows where K != N)
GATHER_CASES = (
    ("q95.round1", 8, 899_696, 899_696, 8, "group"),
    ("q95.group", 8, 2_699_088, 2_699_088, 8, "group"),
    ("q95.aggregate", 8, 2_699_088, 2_699_088, 8, "perm"),
    ("q95.customer_address", 8, 31_250, 31_250, 2, "group"),
    ("q95.web_returns", 8, 89_902, 89_902, 1, "group"),
    ("terasort.local", 8, 4_000_000, 4_000_000, 25, "perm"),
    ("terasort.receive", 8, 8_000_000, 8_000_000, 25, "perm"),
    ("odd.w1", 8, 100_003, 77_777, 1, "perm"),
    ("odd.w3", 5, 100_003, 123_457, 3, "perm"),
)
# CUDA take_rows calls with a non-empty result in this process and the
# kernel launches they ask for, counted by the wrapper _count_take_rows
# installs; the row gather's launches and shapes of the process, banked
# from row_gather.LAUNCHES and SHAPES each time _launches zeroes them; its
# launches per counted path, set by _launches
TAKE_ROWS = {"calls": 0, "launches": 0}
GATHER_BANKED = {"launches": 0, "shapes": {}}
GATHER_OF_PATH: dict = {}
# each kernel's wrapper module, which holds its LAUNCHES and SHAPES
COUNTERS = {RING: ring_exchange, NATIVE: ragged_exchange}
# the kernel each counted path launched: set by _launches, and by the
# phases whose paths run in processes of their own
KERNEL_OF_PATH: dict = {}
# the ragged kernel's sweep: rows a shard, row widths in words, counts
NATIVE_CAP = 1 << 17
NATIVE_WIDTHS = (1, 2, 3, 5, 25)
NATIVE_COUNTS = ("random", "skewed", "empty", "flood", "holes")
STEP_SAMPLES = 20             # untraced steps timed before the traced one
WORKLOAD_SAMPLES = 5          # warm steps timed per workload phase

# BASELINE.md config #5: 100M ratings, the Netflix Prize's user and item
# counts, the repo's default rank; quota = per_device // 8 as in bench.py
ALS_CFG = als.ALSConfig(num_users=480_189, num_items=17_770, rank=8,
                        zipf_a=1.3)
ALS_PER_DEVICE = 100_000_000 // SHARDS
ALS_QUOTA = ALS_PER_DEVICE // SHARDS
ALS_SAMPLED_ITEMS = 32
# a shard of the ALS cell (benchmarks/configs/als-netflix-mllib.json:
# 100,480,507 ratings over MLlib's 10 blocks at rank 10), for the normal
# equations kernel: each side's entities and bounded Zipf exponent, then
# the other side's
GRAM_ROWS = 10_048_051
GRAM_RANK = 10
GRAM_BLOCKS = 10
GRAM_SIDES = {"items": (17_770, 0.437736, 480_189, 0.37467),
              "users": (480_189, 0.37467, 17_770, 0.437736)}
# BASELINE.md config #3, cut from 19 GB to 2**27 edges (1 GiB of edges)
PAGERANK_CFG = pagerank.PageRankConfig(num_vertices=1 << 24,
                                       edges_per_device=1 << 24,
                                       out_factor=2)
PAGERANK_ITERATIONS = 5
# BASELINE.md config #4: bench.py's row count per device; key space = the
# global row count, so a left key matches about one right row and each
# shard's int32 pair_sum stays near 2**30
JOIN_CFG = join.JoinConfig(rows_per_device_left=1 << 20,
                           rows_per_device_right=1 << 20, key_space=1 << 23,
                           out_factor=2)
# bench.py's TPC-DS proportions at SF10 scale (33.5M fact rows)
TPCDS_CFG = tpcds.TpcdsConfig(fact_rows_per_device=1 << 22,
                              dim1_size=1 << 20, dim2_size=1 << 20,
                              num_groups=1024, zipf_a=1.2, out_factor=4)
# q95 over TPC-DS SF10's web_sales row count (7,197,568 rows); orders are
# capped at 2**16 - 1 by the 16-bit pair-key convention of the plans
Q95_CFG = tpcds_queries.Q95Config(ws_rows_per_device=899_696,
                                  num_orders=65_535, out_factor=3)
# q64 at the largest size its 16-bit keys admit (65,528 store and 65,528
# catalog sales rows); TPC-DS SF1's 18,000 items
Q64_CFG = tpcds_queries.Q64Config(ss_rows_per_device=8191,
                                  cs_rows_per_device=8191, num_items=18_000,
                                  zipf_a=1.3, out_factor=4)
# the device plane's round drivers: 1 GiB of 100-byte rows (25 words, a
# u64 key in words 0-1) in rounds sized from the default 64 MiB budget
FUSED_ROWS = SHARDS * (DATA_BYTES // 100 // SHARDS)
FUSED_WORDS = 25
FUSED_BUDGET = 64 << 20
FUSED_ROWS_PER_ROUND = auto_rows_per_round(4 * FUSED_WORDS, FUSED_BUDGET, 2)
HIER_TOPOLOGY = topology.Topology((4, 4))
# the mesh-service stage: 100-byte records (the Sort Benchmark's record: an
# 8-byte key, a 92-byte payload) in map inputs of 128 MiB (Spark's
# spark.sql.files.maxPartitionBytes default), 1 GiB in all, over 200
# reduce partitions (spark.sql.shuffle.partitions default), 2 maps per
# executor; rounds from the engine's default 64 MiB budget, receive
# headroom the engine's 2 * ceil(D / min(P, D))
MS_PAYLOAD = 92
MS_PARTITIONS = 200
MS_MAPS = 8
MS_EXECUTORS = 4
MS_MAP_ROWS = (128 << 20) // (8 + MS_PAYLOAD)
MS_ROWS = MS_MAPS * MS_MAP_ROWS
MS_OUT_FACTOR = 2 * -(-SHARDS // min(MS_PARTITIONS, SHARDS))
MS_ROWS_PER_ROUND = auto_rows_per_round(
    4 * mesh_service.device_row_words(MS_PAYLOAD), FUSED_BUDGET,
    MS_OUT_FACTOR)
MS_SHUFFLE_ID = 7
MS_PARTITIONER = PartitionerSpec("hash")
MS_READER_RANGES = ((0, 1), (17, 42), (199, 200), (0, MS_PARTITIONS))
# the engine phase: the mesh-service stage's records as an engine job on 4
# executors; q95 as an engine job at SF10's web_sales rows (8 x 899,696),
# 8 map tasks per source, 200 shuffle partitions
ENGINE_EXECUTORS = 4
ENGINE_Q95_SCALE = SHARDS
# the small engine jobs: the CPU tests' sizes
SMALL_STAR_CFG = tpcds.TpcdsConfig(fact_rows_per_device=2048, dim1_size=150,
                                   dim2_size=200, num_groups=48)
SMALL_Q64_CFG = tpcds_queries.Q64Config(ss_rows_per_device=640,
                                        cs_rows_per_device=512,
                                        num_items=300, out_factor=4)
SORT_ROWS = 1 << 20
# the multihost phase: two processes sharing the card, 4 shards each
MH_PROCESSES = 2
MH_LOCAL_SHARDS = SHARDS // MH_PROCESSES
MH_TIMEOUT_S = 400         # per worker, start to finish
MH_WORKER_FLAG = "--multihost-worker"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, repeats: int = 7, per_repeat: int = 10,
            warmup: int = 2) -> float:
    """Median over ``repeats`` of the CUDA-event time of ``per_repeat``
    back-to-back calls of ``fn``, per call, in milliseconds: device time.
    Each reading starts behind a device-side sleep twice as long as the
    host took to queue ``per_repeat`` calls in the warm-up, so the host's
    launch work is off the clock even where a call is shorter on the card
    than on the host."""
    queue_s = _warm_queue_s(fn, warmup, per_repeat)
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _device_sleep(2 * queue_s)
        start.record()
        for _ in range(per_repeat):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_repeat)
    return statistics.median(times)


def _warm_queue_s(fn, rounds: int, calls: int) -> float:
    """Warm-up: ``rounds`` rounds of ``calls`` calls of ``fn``; returns
    the longest host time one round took to queue them."""
    queue_s = 0.0
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        queue_s = max(queue_s, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return queue_s


def _device_sleep(seconds: float) -> None:
    """Hold the current stream for at least ``seconds`` (at least 1 ms),
    counted in cycles of a 2 GHz clock: the H100's SM clock is slower,
    so the sleep lasts at least as long."""
    torch.cuda._sleep(int(max(seconds, 1e-3) * 2e9))


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "numpy": np.__version__})
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build(KERNELS)
    # each kernel's "Function properties" line names it; its registers
    # and spills follow
    ptxas = {name: [line for line in r["log"].splitlines()
                    if "registers" in line or "spill" in line
                    or "Function properties" in line]
             for name, r in built.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_seconds": {k: r["seconds"] for k, r in built.items()},
          "ptxas": ptxas})


def _random_blocks(shape, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                         device="cuda", generator=gen)


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def _check_kernel(blocks: torch.Tensor) -> int:
    """The kernel against its plain version on ``blocks``: raises unless
    bit-equal and launched once; returns the max abs error (0)."""
    before = ring_exchange.LAUNCHES
    got = ring_exchange.ring_all_to_all(blocks)
    plain = ring_exchange.ring_all_to_all_plain(blocks)
    torch.cuda.synchronize()
    err = _max_abs_err(got, plain)
    if not torch.equal(got, plain):
        raise AssertionError(
            f"ring_all_to_all != plain at {tuple(blocks.shape)}")
    if ring_exchange.LAUNCHES != before + 1:
        raise AssertionError("ring_all_to_all did not launch the kernel")
    return err


def _rotating(fn, blocks: torch.Tensor):
    """A call of ``fn`` on the next of enough copies of ``blocks`` that one
    round of calls touches more than ``COLD_BYTES`` (the copies and the
    outputs, each kept until its copy's next turn), so no call finds its
    bytes in the L2."""
    copies = -(-COLD_BYTES // (2 * blocks.nbytes)) + 1
    inputs = [blocks.clone() for _ in range(copies)]
    outs = [None] * copies
    turn = itertools.count()

    def call():
        i = next(turn) % copies
        outs[i] = fn(inputs[i])
    return call


def _host_us_per_launch(launch, rounds: int = 5) -> float:
    """Host-clock time of ``HOST_LAUNCHES`` back-to-back calls of
    ``launch()`` with no synchronisation, per call, in microseconds: what
    one launch costs the host. Median of ``rounds`` such rounds."""
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_LAUNCHES):
            launch()
        per_call.append((time.perf_counter() - t0) / HOST_LAUNCHES * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def _kernel_times(blocks: torch.Tensor) -> dict:
    """CUDA-event times of the kernel, its plain version and the library
    transpose on ``blocks``, the host's time per launch, and the byte
    bound (each word read once and written once at the card's memory
    rate). Times are cold: blocks that fit in the L2 are timed by
    rotating through copies (``ms``, share) and also warm (``warm_ms``)."""
    kernel = ring_exchange.ring_all_to_all
    plain = ring_exchange.ring_all_to_all_plain

    def library(b):
        return b.transpose(0, 1).contiguous()

    times = {"shape": list(blocks.shape)}
    if blocks.nbytes <= L2_BYTES:
        times["warm_ms"] = cuda_ms(lambda: kernel(blocks))
        times["library_warm_ms"] = cuda_ms(lambda: library(blocks))
        calls = [_rotating(fn, blocks) for fn in (kernel, plain, library)]
    else:
        calls = [lambda fn=fn: fn(blocks) for fn in (kernel, plain, library)]
    ms, plain_ms, library_ms = (cuda_ms(call) for call in calls)
    del calls
    moved = 2 * blocks.numel() * blocks.element_size()  # read + write
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    times.update({"bytes_moved": moved, "ms": ms, "plain_ms": plain_ms,
                  "library_ms": library_ms, "bound_ms": bound_ms,
                  "roofline_share": bound_ms / ms,
                  "host_us_per_launch": _host_us_per_launch(
                      lambda: kernel(blocks))})
    return times


def phase_kernel(cfg: TeraSortConfig) -> dict:
    """The ring kernel against its plain version at the main path's
    block shape (q = out_cap // D rows of 1+P words) and an odd one."""
    q = cfg.rows_per_device * cfg.out_factor // SHARDS
    main_shape = (SHARDS, SHARDS, q, 1 + cfg.payload_words)
    errs = {}
    for i, shape in enumerate((main_shape, (SHARDS, SHARDS, 3, 3),
                               (3, 3, 5, 7)) + EDGE_SHAPES):
        errs[str(shape)] = _check_kernel(_random_blocks(shape, i))
    blocks = _random_blocks(main_shape, 0)
    times = _kernel_times(blocks)
    # one row fewer per slot: C*W is odd, no block is 16-byte aligned and
    # the pairs shift by 0-3 words, at full size
    odd = blocks[:, :, 1:].contiguous()
    del blocks
    odd_shape = str(tuple(odd.shape))
    errs[odd_shape] = _check_kernel(odd)
    unaligned_ms = cuda_ms(lambda: ring_exchange.ring_all_to_all(odd))
    del odd
    torch.cuda.empty_cache()
    times["max_abs_err"] = errs[str(main_shape)]
    row = {"name": "ring_all_to_all", "route": "cuda",
           "source": "sparkrdma_tpu_torch/csrc/ring_exchange.cu",
           "replaces": "sparkrdma_tpu/ops/ring_exchange.py:49",
           "launches": 0, "max_abs_err": max(errs.values()),
           "ms": times["ms"], "plain_ms": times["plain_ms"],
           "bound_ms": times["bound_ms"], "bound_by": "bytes",
           "library_ms": times["library_ms"], "by_shape": [times]}
    emit({"phase": "kernel", **times, "max_abs_err_by_shape": errs,
          "unaligned_shape": [SHARDS, SHARDS, q - 1, 1 + cfg.payload_words],
          "unaligned_ms": unaligned_ms})
    phase_kernel_shapes(row, "kernel_misaligned", MISALIGNED_SHAPES, 20)
    phase_kernel_shapes(row, "kernel_small", SMALL_SHAPES, 40)
    phase_kernel_shapes(row, "kernel_paths", PATH_RING_SHAPES, 60)
    return row


def phase_kernel_shapes(row: dict, phase: str, shapes, seed: int) -> None:
    """The kernel against its plain version, bit for bit, at every shape
    of ``shapes``, each timed like ``phase_kernel`` with ``vs_library`` =
    library ms / kernel ms; the entries join the kernel row's
    ``by_shape``."""
    entries = []
    for i, shape in enumerate(shapes):
        blocks = _random_blocks(shape, seed + i)
        err = _check_kernel(blocks)
        times = _kernel_times(blocks)
        del blocks
        torch.cuda.empty_cache()
        times["max_abs_err"] = err
        times["vs_library"] = times["library_ms"] / times["ms"]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["by_shape"].append(times)
        entries.append(times)
    emit({"phase": phase, "by_shape": entries})


def _native_counts(kind: str, d: int, cap: int, seed: int,
                   device="cuda") -> torch.Tensor:
    """int32[d, d] counts on the card, each row summing to at most ``cap``:
    ``full`` (every source sends all ``cap`` rows, spread evenly, as
    TeraSort does), ``random``, ``skewed`` (90% to shard 0), ``empty``,
    ``flood`` (every source's rows to one receiver, past any receive
    capacity below ``d * cap``), ``holes`` (random with a zero row and a
    zero column)."""
    rng = np.random.default_rng(seed)
    mat = np.zeros((d, d), np.int64)
    if kind == "flood":
        mat[:, d // 2] = cap
    elif kind != "empty":
        p = np.full(d, 1.0 / d)
        if kind == "skewed" and d > 1:
            p = np.full(d, 0.1 / (d - 1))
            p[0] = 0.9
        for i in range(d):
            total = cap if kind == "full" else rng.integers(cap // 2, cap + 1)
            mat[i] = rng.multinomial(total, p / p.sum())
        if kind == "holes":
            mat[d // 2] = 0
            mat[:, -1] = 0
    return torch.from_numpy(mat.astype(np.int32)).to(device)


def _native_rows_moved(mat: np.ndarray, cap: int, out_cap: int) -> int:
    """The rows the ragged kernel copies for ``mat``: each pair's count,
    cut at its source's capacity and at its receiver's."""
    d = mat.shape[0]
    m = np.maximum(mat.astype(np.int64), 0)
    start = np.cumsum(m, axis=1) - m
    land = np.cumsum(m, axis=0) - m
    rows = np.minimum(m, np.minimum(cap - start, out_cap - land))
    return int(np.maximum(rows, 0).sum()) if d else 0


def _check_native(data: torch.Tensor, mat: torch.Tensor,
                  out_cap: int) -> int:
    """The ragged kernel against its plain version and against the
    ``gather`` transport on ``data`` and ``mat``: raises unless all three
    are byte-equal and the kernel launched once; returns the max abs
    error (0)."""
    d, _, w = data.shape
    out = torch.zeros((d, out_cap, w), dtype=torch.int32, device=data.device)
    before = ragged_exchange.LAUNCHES
    got = ragged_exchange.ragged_all_to_all(data, mat, out)
    plain = ragged_exchange.ragged_all_to_all_plain(data, mat,
                                                    torch.zeros_like(out))
    gathered = exchange._gather_exchange(data, mat, torch.zeros_like(out))
    torch.cuda.synchronize()
    err = max(_max_abs_err(got, plain), _max_abs_err(got, gathered))
    if not (torch.equal(got, plain) and torch.equal(got, gathered)):
        raise AssertionError(f"ragged_all_to_all != plain or gather at "
                             f"{tuple(data.shape)} -> {out_cap} rows")
    if ragged_exchange.LAUNCHES != before + 1:
        raise AssertionError("ragged_all_to_all did not launch the kernel")
    return err


def _native_times(data: torch.Tensor, mat: torch.Tensor,
                  out_cap: int) -> dict:
    """CUDA-event times of the ragged kernel, its plain version and the
    ``gather`` transport (``gather_ms``: the nearest PyTorch computation
    of the same function; no one library call computes it, so
    ``library_ms`` is null), the host's time per launch, and the byte
    bound of the rows these counts move (each read once and written
    once). Inputs that fit in the L2 are timed rotating through copies."""
    d, cap, w = data.shape
    out = torch.zeros((d, out_cap, w), dtype=torch.int32, device=data.device)
    fns = (lambda x, o: ragged_exchange.ragged_all_to_all(x, mat, o),
           lambda x, o: ragged_exchange.ragged_all_to_all_plain(x, mat, o),
           lambda x, o: exchange._gather_exchange(x, mat, o))
    copies = 1
    if data.nbytes + out.nbytes <= L2_BYTES:
        copies = -(-COLD_BYTES // (data.nbytes + out.nbytes)) + 1
    pairs = [(data, out)] + [(data.clone(), out.clone())
                             for _ in range(copies - 1)]

    def rotating(fn):
        turn = itertools.count()
        return lambda: fn(*pairs[next(turn) % copies])

    ms, plain_ms, gather_ms = (cuda_ms(rotating(fn)) for fn in fns)
    rows = _native_rows_moved(mat.cpu().numpy(), cap, out_cap)
    moved = 2 * rows * w * 4
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    return {"shape": [d, cap, w, out_cap], "rows_moved": rows,
            "bytes_moved": moved, "ms": ms, "plain_ms": plain_ms,
            "gather_ms": gather_ms, "library_ms": None,
            "bound_ms": bound_ms,
            "roofline_share": bound_ms / ms if ms else None,
            "vs_gather": gather_ms / ms,
            "host_us_per_launch": _host_us_per_launch(
                lambda: ragged_exchange.ragged_all_to_all(data, mat, out))}


def _native_graph_check(d: int, cap: int, w: int) -> dict:
    """One ``native`` exchange (``ragged_exchange_shard``) captured in a
    CUDA graph and replayed on new rows and new counts, each replay
    byte-equal to the ``gather`` transport on those inputs."""
    data = _random_blocks((d, cap, w), 140)
    mat = _native_counts("random", d, cap, 140)
    out = torch.zeros((d, 2 * cap, w), dtype=torch.int32, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm-up outside the capture
        exchange.ragged_exchange_shard(data, mat, output=out.clone(),
                                       impl="native")
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.zero_()
        got = exchange.ragged_exchange_shard(data, mat, output=out,
                                             impl="native")
    errs = []
    for seed, kind in ((141, "skewed"), (142, "flood"), (143, "holes")):
        data.copy_(_random_blocks((d, cap, w), seed))
        mat.copy_(_native_counts(kind, d, cap, seed))
        graph.replay()
        want = exchange.ragged_exchange_shard(
            data, mat, output=torch.zeros_like(out), impl="gather")
        torch.cuda.synchronize()
        for g, w_ in zip(got, want):
            if not torch.equal(g, w_):
                raise AssertionError(f"native graph replay ({kind}) != "
                                     "gather")
        errs.append(_max_abs_err(got[0], want[0]))
    return {"shape": [d, cap, w, 2 * cap], "replays": len(errs),
            "max_abs_err": max(errs)}


def phase_kernel_native(cfg: TeraSortConfig) -> dict:
    """The ragged all-to-all kernel against its plain version and the
    ``gather`` transport, byte for byte: at the TeraSort path's shape
    (``[D, rows_per_device, 1+P]`` into ``out_factor`` times the rows,
    every source sending all its rows, evenly spread), timed; at every
    width of ``NATIVE_WIDTHS`` and every count pattern of
    ``NATIVE_COUNTS`` at ``NATIVE_CAP`` rows a shard, the receive
    capacity at the send capacity (a flood truncates) and at twice it,
    each width timed under random counts; and one ``native`` exchange
    replayed in a CUDA graph. Returns the kernel's row."""
    d, cap = SHARDS, cfg.rows_per_device
    w, out_cap = 1 + cfg.payload_words, cfg.rows_per_device * cfg.out_factor
    data = _random_blocks((d, cap, w), 100)
    mat = _native_counts("full", d, cap, 100)
    errs = {"terasort": _check_native(data, mat, out_cap)}
    times = _native_times(data, mat, out_cap)
    times.update(counts="full", max_abs_err=errs["terasort"])
    del data
    torch.cuda.empty_cache()
    sweep = []
    for i, width in enumerate(NATIVE_WIDTHS):
        data = _random_blocks((d, NATIVE_CAP, width), 110 + i)
        for kind in NATIVE_COUNTS:
            mat = _native_counts(kind, d, NATIVE_CAP, 120 + i)
            for oc in (NATIVE_CAP, 2 * NATIVE_CAP):
                errs[f"w{width}/{kind}/{oc}"] = _check_native(data, mat, oc)
        entry = _native_times(data, _native_counts("random", d, NATIVE_CAP,
                                                   130 + i), 2 * NATIVE_CAP)
        entry.update(counts="random", max_abs_err=max(
            v for k, v in errs.items() if k.startswith(f"w{width}/")))
        sweep.append(entry)
        del data
        torch.cuda.empty_cache()
    graph = _native_graph_check(d, 1 << 16, w)
    errs["cuda_graph"] = graph["max_abs_err"]
    row = {"name": NATIVE, "route": "cuda",
           "source": "sparkrdma_tpu_torch/csrc/ring_exchange.cu",
           "replaces": "sparkrdma_tpu/parallel/exchange.py:178",
           "launches": 0, "max_abs_err": max(errs.values()),
           "ms": times["ms"], "plain_ms": times["plain_ms"],
           "bound_ms": times["bound_ms"], "bound_by": "bytes",
           "library_ms": None, "gather_ms": times["gather_ms"],
           "by_shape": [times] + sweep}
    emit({"phase": "kernel_native", **times, "max_abs_err_by_case": errs,
          "sweep": sweep, "cuda_graph": graph})
    return row


def _gather_indices(kind: str, d: int, n: int, k: int,
                    seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "group":
        dest = torch.randint(0, SHARDS, (d, n), device="cuda", generator=gen)
        if k == n and n > 1_000_000 and n % 3 == 0:
            dest[:, n // 3:] = SHARDS          # padding sorts to the end
        return torch.sort(dest, dim=1, stable=True).indices[:, :k]
    if k == n:
        return torch.stack([torch.randperm(n, device="cuda", generator=gen)
                            for _ in range(d)])
    return torch.randint(0, n, (d, k), device="cuda", generator=gen)


def phase_kernel_gather() -> dict:
    """The row gather kernel against its plain version at
    ``GATHER_CASES``, byte for byte and one launch a call; each case
    timed (its rows are read where ``take_rows`` finds them: the larger
    ones exceed the L2, the dimension tables fit it) against the bytes
    ``gather.bytes`` counts at the card's memory rate, the plain version
    and one flat ``index_select`` over a ready index. Returns the
    kernel's row. The phase's own launches leave ``row_gather``'s counts
    as they were: they are no ``take_rows`` call's."""
    first, shapes = row_gather.LAUNCHES, dict(row_gather.SHAPES)
    by_shape = []
    for i, (name, d, n, k, w, kind) in enumerate(GATHER_CASES):
        rows = _random_blocks((d, n, w), 200 + i)
        idx = _gather_indices(kind, d, n, k, 300 + i)
        before = row_gather.LAUNCHES
        got = row_gather.row_gather(rows, idx)
        plain = row_gather.row_gather_plain(rows, idx)
        torch.cuda.synchronize()
        if row_gather.LAUNCHES != before + len(row_gather.pieces(d, k)):
            raise AssertionError(f"row_gather launched "
                                 f"{row_gather.LAUNCHES - before} times "
                                 f"at {name}")
        if not torch.equal(got, plain):
            raise AssertionError(f"row_gather != plain at {name}")
        err = _max_abs_err(got, plain)
        del got, plain
        flat = (idx + torch.arange(d, device="cuda")[:, None] * n).reshape(-1)
        table = rows.reshape(d * n, w)
        row_bytes = w * 4
        moved = idx.numel() * (2 * row_bytes + 8)
        ms = cuda_ms(lambda: row_gather.row_gather(rows, idx), 5, 5)
        entry = {"case": name, "shape": [d, n, w], "picked": k,
                 "indices": kind, "vector_bytes": row_gather.vector_bytes(
                     row_bytes, rows.data_ptr(), 0),
                 "bytes_moved": moved, "ms": ms,
                 "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                 "plain_ms": cuda_ms(
                     lambda: row_gather.row_gather_plain(rows, idx), 5, 5),
                 "library_ms": cuda_ms(
                     lambda: table.index_select(0, flat), 5, 5),
                 "max_abs_err": err}
        entry["roofline_share"] = entry["bound_ms"] / ms
        entry["vs_library"] = entry["library_ms"] / ms
        by_shape.append(entry)
        emit({"phase": "kernel_gather", **entry})
        del rows, idx, flat, table
        torch.cuda.empty_cache()
    row_gather.LAUNCHES = first
    row_gather.SHAPES.clear()
    row_gather.SHAPES.update(shapes)
    main = next(e for e in by_shape if e["case"] == "q95.group")
    return {"name": GATHER, "route": "cuda",
            "source": "sparkrdma_tpu_torch/csrc/row_gather.cu",
            "replaces": None, "launches": 0,
            "max_abs_err": max(e["max_abs_err"] for e in by_shape),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": main["library_ms"], "by_shape": by_shape}


def _count_take_rows() -> None:
    """Count each CUDA ``take_rows`` call with a non-empty result, and the
    kernel launches it asks for, in ``TAKE_ROWS``: every module of the
    port that holds ``take_rows`` (and ``parallel.mesh``, for later
    imports) gets a counting wrapper."""
    inner = mesh.take_rows

    def counted(rows, idx):
        out = inner(rows, idx)
        if out.is_cuda and out.numel():
            TAKE_ROWS["calls"] += 1
            TAKE_ROWS["launches"] += len(row_gather.pieces(idx.shape[0],
                                                           idx.shape[1]))
        return out
    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith("sparkrdma_tpu_torch")
                and getattr(mod, "take_rows", None) is inner):
            mod.take_rows = counted


def _count_groupings() -> None:
    """Count each CUDA ``group_by_destination`` call with rows in
    ``GROUPINGS``: every module of the port that holds
    ``group_by_destination`` (``parallel.exchange`` included, whose
    ``shuffle_shard`` calls it) gets a counting wrapper."""
    inner = exchange.group_by_destination

    def counted(data, dest, num_partitions):
        if dest.is_cuda and dest.numel():
            GROUPINGS["calls"] += 1
        return inner(data, dest, num_partitions)
    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith("sparkrdma_tpu_torch")
                and getattr(mod, "group_by_destination", None) is inner):
            mod.group_by_destination = counted


def _count_lookups() -> None:
    """Count each CUDA ``hash_lookup`` call in ``LOOKUPS``: every module
    of the port that holds ``hash_lookup`` (the star join's, the query
    plans', the op module's own) gets a counting wrapper."""
    inner = hash_lookup.hash_lookup

    def counted(dim_keys, dim_valid, dim_attr, probe_keys, probe_valid,
                bound):
        if probe_keys[0].is_cuda:
            LOOKUPS["calls"] += 1
        return inner(dim_keys, dim_valid, dim_attr, probe_keys, probe_valid,
                     bound)
    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith("sparkrdma_tpu_torch")
                and getattr(mod, "hash_lookup", None) is inner):
            mod.hash_lookup = counted


def _range_receive(d: int, n: int, w: int, seed: int):
    """The receive buffer and counts that one TeraSort range step over
    rows made on the card hands the merge, and the step's output."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = torch.randint(-2**31, 2**31, (d, n, w), dtype=torch.int32,
                         device="cuda", generator=gen)
    kept = []
    inner = run_merge.merge_runs

    def keep(received, counts):
        kept.append((received, counts))
        return inner(received, counts)
    run_merge.merge_runs = keep
    try:
        out, _, overflowed = make_terasort_step(
            VirtualMesh(d), TeraSortConfig(rows_per_device=n,
                                           payload_words=w - 1))(rows)
    finally:
        run_merge.merge_runs = inner
    if bool(overflowed.any()):
        raise AssertionError(f"the range step at {(d, n, w)} overflowed")
    return kept[0], out


def phase_kernel_merge() -> dict:
    """The receive merge kernel at ``MERGE_CASES``, on the receive buffer
    and counts of a range step's own exchange: byte for byte against
    ``sort_received`` (the stable key sort of the whole buffer it
    replaced, and the merge's plain version, which the CPU runs) and the
    step's output, one launch a call; timed against the bytes
    ``fused.merge_bytes`` counts at the card's memory rate and against
    ``sort_received`` (its ``torch.sort`` and row gather: ``plain_ms``
    and ``library_ms`` both). Returns the kernel's row; the phase's own
    launches leave ``run_merge.LAUNCHES`` as it was."""
    first = run_merge.LAUNCHES
    by_shape = []
    for i, (name, d, n, w) in enumerate(MERGE_CASES):
        (received, counts), out = _range_receive(d, n, w, 400 + i)
        before = run_merge.LAUNCHES
        got = run_merge.merge_runs(received, counts)
        want = sort_received(received, counts)
        torch.cuda.synchronize()
        if run_merge.LAUNCHES != before + 1:
            raise AssertionError(f"run_merge launched "
                                 f"{run_merge.LAUNCHES - before} times at "
                                 f"{name}")
        for other, label in ((want, "sort_received"),
                             (out, "the step's output")):
            if not torch.equal(got, other):
                raise AssertionError(f"run_merge != {label} at {name}")
        err = _max_abs_err(got, want)
        del got, want, out
        torch.cuda.empty_cache()
        row_bytes = w * 4
        live = int(counts.sum())
        moved = (live + d * received.shape[1]) * row_bytes
        ms = cuda_ms(lambda: run_merge.merge_runs(received, counts), 5, 5)
        sort_ms = cuda_ms(lambda: sort_received(received, counts), 3, 3)
        entry = {"case": name, "shape": list(received.shape), "runs": d,
                 "live_rows": live, "bytes_moved": moved, "ms": ms,
                 "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                 "plain_ms": sort_ms, "library_ms": sort_ms,
                 "max_abs_err": err}
        entry["roofline_share"] = entry["bound_ms"] / ms
        entry["vs_library"] = entry["library_ms"] / ms
        by_shape.append(entry)
        emit({"phase": "kernel_merge", **entry})
        del received, counts
        torch.cuda.empty_cache()
    run_merge.LAUNCHES = first
    main = by_shape[-1]
    return {"name": MERGE, "route": "cuda",
            "source": "sparkrdma_tpu_torch/csrc/run_merge.cu",
            "replaces": None, "launches": 0,
            "max_abs_err": max(e["max_abs_err"] for e in by_shape),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": main["library_ms"], "by_shape": by_shape}


def phase_kernel_partition() -> dict:
    """The partition by destination at ``PARTITION_CASES``: byte for byte
    against its plain version (order and totals) and one launch a call;
    timed against the bytes it must move at the card's memory rate (each
    destination read and each index written), the plain version (a stable
    sort of the destinations widened to int64, a search and a difference)
    and ``torch.sort`` with ``searchsorted`` on the int32 destinations,
    pads mapped up front (``library_ms``). Returns the kernel's row; the
    phase's own launches leave ``dest_partition.LAUNCHES`` as it was."""
    first = dest_partition.LAUNCHES
    by_shape = []
    parts = SHARDS
    for i, (name, d, n, pad_share) in enumerate(PARTITION_CASES):
        gen = torch.Generator(device="cuda").manual_seed(500 + i)
        dest = torch.randint(0, parts, (d, n), dtype=torch.int32,
                             device="cuda", generator=gen)
        pads = torch.rand((d, n), device="cuda", generator=gen) < pad_share
        dest = torch.where(pads, -1, dest)
        before = dest_partition.LAUNCHES
        got = dest_partition.dest_partition(dest, parts)
        want = dest_partition.dest_partition_plain(dest, parts)
        torch.cuda.synchronize()
        if dest_partition.LAUNCHES != before + 1:
            raise AssertionError(f"dest_partition launched "
                                 f"{dest_partition.LAUNCHES - before} times "
                                 f"at {name}")
        for g, w, what in zip(got, want, ("order", "totals")):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"dest_partition's {what} != plain at "
                                     f"{name}")
        err = max(_max_abs_err(g, w) for g, w in zip(got, want))
        del got, want
        mapped = torch.where(dest < 0, parts, dest)
        bounds = torch.arange(parts + 2, dtype=torch.int32,
                              device="cuda").expand(d, -1).contiguous()

        def library():
            keys, order = torch.sort(mapped, dim=1, stable=True)
            return order, torch.searchsorted(keys, bounds)

        moved = d * n * (dest.element_size() + 8)
        ms = cuda_ms(lambda: dest_partition.dest_partition(dest, parts), 5, 5)
        entry = {"case": name, "shape": [d, n], "partitions": parts,
                 "pad_share": pad_share, "bytes_moved": moved, "ms": ms,
                 "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                 "plain_ms": cuda_ms(
                     lambda: dest_partition.dest_partition_plain(dest, parts),
                     3, 3),
                 "library_ms": cuda_ms(library, 3, 3),
                 "max_abs_err": err}
        entry["roofline_share"] = entry["bound_ms"] / ms
        entry["vs_library"] = entry["library_ms"] / ms
        by_shape.append(entry)
        emit({"phase": "kernel_partition", **entry})
        del dest, pads, mapped, bounds
        torch.cuda.empty_cache()
    dest_partition.LAUNCHES = first
    main = by_shape[-1]
    return {"name": "dest_partition", "route": "cuda",
            "source": "sparkrdma_tpu_torch/csrc/dest_partition.cu",
            "replaces": None, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": "bytes",
            "library_ms": main["library_ms"], "by_shape": by_shape}


def _store_join_sides(d: int, n: int, live_dim: int, live_probe: int):
    """q64's store join at SF10 made on the card: sales ``[d, n, 4]``
    (item, ticket and two words; the first ``live_probe`` rows a shard
    live, the rest dead with the PAD item) and returns ``[d, n, 2]``, the
    first ``live_dim`` rows a shard the pairs of as many distinct sales
    (drawn without replacement, so every return finds its sale), and
    both valid masks."""
    gen = torch.Generator(device="cuda").manual_seed(29)
    ss = torch.zeros((d, n, 4), dtype=torch.int32, device="cuda")
    ss[:, :live_probe] = torch.randint(-2**31, 2**31 - 1, (d, live_probe, 4),
                                       dtype=torch.int32, device="cuda",
                                       generator=gen)
    ss[:, :live_probe, 0] = torch.randint(0, 102_000, (d, live_probe),
                                          dtype=torch.int32, device="cuda",
                                          generator=gen)
    ss[:, live_probe:, 0] = -1
    pick = torch.stack([torch.randperm(live_probe, device="cuda",
                                       generator=gen)[:live_dim]
                        for _ in range(d)])
    sr = torch.zeros((d, n, 2), dtype=torch.int32, device="cuda")
    sr[:, :live_dim] = ss[:, :, :2].gather(1, pick[..., None].expand(-1, -1,
                                                                      2))
    pos = torch.arange(n, device="cuda")
    return (ss, sr, (pos < live_probe).expand(d, n).contiguous(),
            (pos < live_dim).expand(d, n).contiguous())


def _date_join_sides(d: int, m: int, live_dim: int, n: int,
                     live_probe: int):
    """q64's date join at SF10 made on the card, the one-word form: the
    date table ``[d, m, 2]`` (date key, year word) whose first
    ``live_dim`` rows a shard are distinct dates of that shard, and the
    survivors ``[d, n, 4]`` whose first ``live_probe`` rows a shard carry
    a date key in word 2: a date of their own shard, or, every eighth
    row, one of the next shard's (a miss). Returns both buffers, both
    valid masks and the probes that must be found."""
    gen = torch.Generator(device="cuda").manual_seed(64)
    dates = (2_415_022 + torch.randperm(d * live_dim, device="cuda",
                                        generator=gen)).view(d, live_dim)
    dim = torch.zeros((d, m, 2), dtype=torch.int32, device="cuda")
    dim[:, :live_dim, 0] = dates.to(torch.int32)
    dim[:, :live_dim, 1] = torch.randint(0, 200, (d, live_dim),
                                         dtype=torch.int32, device="cuda",
                                         generator=gen)
    pick = torch.randint(0, live_dim, (d, live_probe), device="cuda",
                         generator=gen)
    miss = (torch.arange(live_probe, device="cuda") % 8 == 7).expand(
        d, live_probe)
    keys = torch.where(miss, dates.roll(-1, 0).gather(1, pick),
                       dates.gather(1, pick))
    probe = torch.zeros((d, n, 4), dtype=torch.int32, device="cuda")
    probe[:, :live_probe, 2] = keys.to(torch.int32)
    pos_m = torch.arange(m, device="cuda")
    pos_n = torch.arange(n, device="cuda")
    want = torch.zeros((d, n), dtype=torch.bool, device="cuda")
    want[:, :live_probe] = ~miss
    return (dim, probe, (pos_m < live_dim).expand(d, m).contiguous(),
            (pos_n < live_probe).expand(d, n).contiguous(), want)


def phase_kernel_lookup() -> dict:
    """The unique-key lookup at q64's SF10 shapes, in both of its forms.
    Two words: the store join, [8, 14,400,496] receive slots a side,
    359,429 live returns a shard (each a distinct sale's pair) against
    3,600,124 live sales, with the refund-like attribute and without (the
    store join's form). One word: the date join, 9,132 live dates a
    shard in [8, 73,056] slots against 359,429 live survivors in
    [8, 14,400,496], with the year. Held to its plain version (``found``
    exact, ``attr`` exact where found and 0 elsewhere) and to what the
    data must give (every return's sale found; exactly the survivors of
    a date of their own shard), one launch a call, and timed against the
    bytes each row must move at the card's memory rate (every valid byte
    read, each live row's key words, each probe's found byte and
    attribute word written) and the plain version (the int64 keys, their
    stable sort and the binary search: what the port ran before, and
    what one PyTorch call chain computes). Returns the kernel's row; the
    phase's own launches leave ``hash_lookup.LAUNCHES`` as it was."""
    first = hash_lookup.LAUNCHES
    d, n, live_dim, live_probe = SHARDS, 14_400_496, 359_429, 3_600_124
    ss, sr, ss_v, sr_v = _store_join_sides(d, n, live_dim, live_probe)
    dim, probe, dim_v, probe_v, want_date = _date_join_sides(
        d, 73_056, 9_132, n, live_dim)
    # name, args, bound, key words, live rows a side, the found rule
    cases = [
        (name, ((sr[..., 0], sr[..., 1]), sr_v, attr_words,
                (ss[..., 0], ss[..., 1]), ss_v), d * live_dim, 2,
         (live_dim, live_probe), lambda found: bool(
             found.sum() >= d * live_dim))
        for name, attr_words in (("q64.store_join", None),
                                 ("q64.store_join+attr", sr[..., 1]))]
    cases.append(("q64.date_join", ((dim[..., 0],), dim_v, dim[..., 1],
                                    (probe[..., 2],), probe_v),
                  d * 9_132, 1, (9_132, live_dim),
                  lambda found: torch.equal(found, want_date)))
    by_shape = []
    for name, args, bound, words, (live_d, live_p), rule in cases:
        before = hash_lookup.LAUNCHES
        attr, found, over = hash_lookup.hash_lookup(*args, bound)
        want_attr, want_found = hash_lookup.hash_lookup_plain(*args)
        torch.cuda.synchronize()
        if hash_lookup.LAUNCHES != before + 1:
            raise AssertionError(f"hash_lookup launched "
                                 f"{hash_lookup.LAUNCHES - before} times "
                                 f"at {name}")
        if bool(over.any()) or not torch.equal(found, want_found):
            raise AssertionError(f"hash_lookup's found != plain at {name}")
        if attr is not None and not (
                torch.equal(attr[found], want_attr[found])
                and not attr[~found].any()):
            raise AssertionError(f"hash_lookup's attr != plain at {name}")
        hits = int(found.sum())
        if not rule(found):
            raise AssertionError(f"hash_lookup found {hits} probes at "
                                 f"{name}, not what its data holds")
        del want_attr, want_found
        m, p = args[0][0].shape[1], found.shape[1]
        moved = (d * m + d * p + 4 * words * d * (live_d + live_p) + d * p
                 + (0 if attr is None else 8 * d * p + 4 * hits))
        del attr
        ms = cuda_ms(lambda: hash_lookup.hash_lookup(*args, bound), 5, 5)
        entry = {"case": name, "shape": [d, m, p], "words": words,
                 "live_dim": live_d, "live_probe": live_p, "found": hits,
                 "bytes_moved": moved, "ms": ms,
                 "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                 "plain_ms": cuda_ms(
                     lambda: hash_lookup.hash_lookup_plain(*args), 3, 3),
                 "max_abs_err": 0}
        entry["roofline_share"] = entry["bound_ms"] / ms
        entry["vs_plain"] = entry["plain_ms"] / ms
        by_shape.append(entry)
        emit({"phase": "kernel_lookup", **entry})
        torch.cuda.empty_cache()
    del ss, sr, ss_v, sr_v, dim, probe, dim_v, probe_v, want_date, cases
    del args, found, over
    torch.cuda.empty_cache()
    hash_lookup.LAUNCHES = first
    main = by_shape[0]
    return {"name": "hash_lookup", "route": "cuda",
            "source": "sparkrdma_tpu_torch/csrc/hash_lookup.cu",
            "replaces": None, "max_abs_err": 0, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "library_ms": main["plain_ms"],
            "by_shape": by_shape}


def _count_range_steps() -> None:
    """Count each call of a CUDA ``range`` step over more than one shard
    in ``RANGE_STEPS``: every module of the port that holds
    ``make_fused_step`` gets a wrapper whose steps count their calls."""
    inner = device_plane.make_fused_step

    def counted(mesh_, **kw):
        step = inner(mesh_, **kw)
        if (kw.get("partition", "range") != "range"
                or mesh_.num_shards == 1
                or torch.device(mesh_.device).type != "cuda"):
            return step

        def run(*args, **kwargs):
            RANGE_STEPS["calls"] += 1
            return step(*args, **kwargs)
        return run
    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith("sparkrdma_tpu_torch")
                and getattr(mod, "make_fused_step", None) is inner):
            mod.make_fused_step = counted


def _bank_merge_counts() -> None:
    """Add ``run_merge.LAUNCHES`` to ``MERGE_BANKED`` and set it to 0."""
    MERGE_BANKED["launches"] += run_merge.LAUNCHES
    run_merge.LAUNCHES = 0


def _check_merge_launches() -> None:
    """Raise unless the merge launched once for each CUDA range step this
    process ran since the counter was installed."""
    _bank_merge_counts()
    if MERGE_BANKED["launches"] != RANGE_STEPS["calls"]:
        raise AssertionError(
            f"run_merge launched {MERGE_BANKED['launches']} times after its "
            f"phase; {RANGE_STEPS['calls']} CUDA range steps ran")


def _bank_partition_counts() -> None:
    """Add ``dest_partition.LAUNCHES`` to ``PARTITION_BANKED`` and set it
    to 0."""
    PARTITION_BANKED["launches"] += dest_partition.LAUNCHES
    dest_partition.LAUNCHES = 0


def _check_partition_launches() -> None:
    """Raise unless the partition launched once for each CUDA grouping
    this process ran since the counter was installed."""
    _bank_partition_counts()
    if PARTITION_BANKED["launches"] != GROUPINGS["calls"]:
        raise AssertionError(
            f"dest_partition launched {PARTITION_BANKED['launches']} times "
            f"after its phase; {GROUPINGS['calls']} CUDA groupings ran")


def _bank_lookup_counts() -> None:
    """Add ``hash_lookup.LAUNCHES`` to ``LOOKUP_BANKED`` and set it to
    0."""
    LOOKUP_BANKED["launches"] += hash_lookup.LAUNCHES
    hash_lookup.LAUNCHES = 0


def _check_lookup_launches() -> None:
    """Raise unless the lookup launched once for each CUDA
    ``hash_lookup`` call this process made since the counter was
    installed."""
    _bank_lookup_counts()
    if LOOKUP_BANKED["launches"] != LOOKUPS["calls"]:
        raise AssertionError(
            f"hash_lookup launched {LOOKUP_BANKED['launches']} times after "
            f"its phase; {LOOKUPS['calls']} CUDA lookups were called")


def _bank_gather_counts() -> None:
    """Add ``row_gather.LAUNCHES`` and ``SHAPES`` to ``GATHER_BANKED`` and
    set them to 0."""
    GATHER_BANKED["launches"] += row_gather.LAUNCHES
    shapes = GATHER_BANKED["shapes"]
    for key, n in row_gather.SHAPES.items():
        shapes[key] = shapes.get(key, 0) + n
    row_gather.LAUNCHES = 0
    row_gather.SHAPES.clear()


def phase_kernel_chunked(row: dict) -> None:
    """The kernel against its plain version at the ALS path's block shape
    ``[D, D, bucket_quota(quota), 3]``, timed like ``phase_kernel``; the
    numbers join the kernel row's ``by_shape``."""
    shape = (SHARDS, SHARDS, bucket_quota(ALS_QUOTA), 3)
    blocks = _random_blocks(shape, 3)
    err = _check_kernel(blocks)
    times = _kernel_times(blocks)
    del blocks
    torch.cuda.empty_cache()
    times["max_abs_err"] = err
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["by_shape"].append(times)
    emit({"phase": "kernel_chunked", **times})


def _trace(fn, span_prefixes) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device time per
    ``record_function`` span whose name starts with one of
    ``span_prefixes``, the top kernels, and the card's idle share of the
    call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kernels = {}, []
    for evt in prof.key_averages():
        if evt.key.startswith(span_prefixes):
            spans[evt.key] = {"device_ms": evt.device_time_total / 1e3,
                              "host_ms": evt.cpu_time_total / 1e3,
                              "count": evt.count}
        elif evt.device_type == DeviceType.CUDA:
            kernels.append((evt.self_device_time_total / 1e3, evt.count,
                            evt.key[:120]))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / wall_ms if wall_ms else None,
            "spans": spans,
            "top_kernels": [{"ms": ms, "count": c, "name": name}
                            for ms, c, name in kernels[:12]]}


def _host_times_ms(fn, samples: int) -> list:
    """Sorted host-clock times of ``samples`` calls of ``fn``, each ended
    by a device synchronisation, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)


def _timing(times_ms: list) -> dict:
    return {"samples": len(times_ms),
            "median_ms": statistics.median(times_ms),
            "min_ms": times_ms[0], "max_ms": times_ms[-1]}


def phase_profile(mesh: VirtualMesh, cfg: TeraSortConfig,
                  rows: np.ndarray) -> None:
    """``STEP_SAMPLES`` warm, untraced TeraSort steps of each transport,
    ``auto`` (the ragged kernel) and ``ring``, timed on the host clock in
    turns (auto, ring, ring, auto, half the samples a turn), then one
    step of each under ``torch.profiler``: device time per layer span
    (``fused.*``, ``exchange.*``), the top kernels, and the device's idle
    share of the step's wall time."""
    steps = {impl: make_terasort_step(mesh, cfg, impl=impl)
             for impl in ("auto", "ring")}
    rows_d = rows_from_numpy(rows, mesh)
    samples = {impl: [] for impl in steps}
    for impl in ("auto", "ring", "ring", "auto"):
        samples[impl] += _host_times_ms(lambda: steps[impl](rows_d),
                                        STEP_SAMPLES // 2)
    for impl, times in samples.items():
        times.sort()
        emit({"phase": "step_times", "impl": impl,
              "resolved": exchange.resolve_transport(mesh, impl),
              **_timing(times),
              "median_gb_per_s": rows.nbytes / statistics.median(times)
              / 1e6})
    for impl, step in steps.items():
        emit({"phase": "profile", "impl": impl,
              **_trace(lambda: step(rows_d), ("fused.", "exchange."))})


def phase_main_path(cfg: TeraSortConfig, table: dict) -> dict:
    """TeraSort of 1 GiB through ``run_terasort``, with ``impl="auto"``
    (the ragged kernel) and again with ``impl="ring"`` (the ring kernel),
    each verified; then the steps timed and traced, a small run held to
    ``numpy_terasort`` and a streamed run. Returns the launches per
    path."""
    mesh = VirtualMesh(SHARDS)
    rows = generate_rows(cfg, SHARDS, seed=0)
    launches = {}
    for path, impl, kernel in (("terasort", "auto", NATIVE),
                               ("terasort/ring", "ring", RING)):
        torch.cuda.reset_peak_memory_stats()
        (out, counts, dt), launches[path], shapes = _launches(
            path, lambda impl=impl: run_terasort(mesh, cfg, impl=impl,
                                                 rows=rows), kernel)
        peak = torch.cuda.max_memory_allocated()
        verify_terasort(out, counts, rows, SHARDS)
        emit({"phase": "main_path", "path": path, "impl": impl,
              "kernel": kernel, "shards": SHARDS,
              "rows_per_device": cfg.rows_per_device,
              "row_bytes": cfg.row_bytes, "data_bytes": int(rows.nbytes),
              "step_s": dt, "gb_per_s": rows.nbytes / dt / 1e9,
              "kernel_launches": launches[path],
              "kernel_shapes": _check_path_shapes(table, path, shapes),
              "peak_device_bytes": peak, "verified": True})
        del out
    phase_profile(mesh, cfg, rows)
    del rows

    small = TeraSortConfig(rows_per_device=4096)
    rows = generate_rows(small, SHARDS, seed=1)
    out, counts, _ = run_terasort(mesh, small, rows=rows)
    per = out.reshape(SHARDS, -1, out.shape[-1])
    got = np.concatenate([per[d][:int(counts[d].sum())]
                          for d in range(SHARDS)])
    np.testing.assert_array_equal(got, numpy_terasort(rows, SHARDS))

    streamed = TeraSortConfig(rows_per_device=65536)
    n_rows = int(2.5 * SHARDS * streamed.rows_per_device)
    rows = generate_rows(TeraSortConfig(rows_per_device=n_rows // SHARDS),
                         SHARDS, seed=2)[:n_rows - 13]
    merged, rounds = run_terasort_streamed(mesh, streamed, rows)
    if rounds != 3:
        raise AssertionError(f"expected 3 streamed rounds, ran {rounds}")
    np.testing.assert_array_equal(np.concatenate(merged),
                                  numpy_terasort(rows, SHARDS))
    emit({"phase": "checks", "small_bit_exact": True,
          "streamed_rounds": rounds, "streamed_bit_exact": True})
    return launches


STREAMED_ROUNDS = 4           # the streamed phase's rounds over 1 GiB
PEAK_SLACK = 1.10             # a streamed run's peak over its bound


def _peak_base() -> int:
    """Reset the card's peak-memory counter; returns the bytes allocated
    now, which the peak read after counts from."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _verify_merged(merged: list, rows: np.ndarray) -> None:
    """``verify_terasort``'s global-sort contract over a streamed run's
    per-shard outputs: each shard padded to one length, its row count
    in its first count column."""
    width = rows.shape[1]
    padded = np.zeros((SHARDS, max(len(m) for m in merged), width),
                      rows.dtype)
    counts = np.zeros((SHARDS, SHARDS), np.int64)
    for d, m in enumerate(merged):
        padded[d, :len(m)] = m
        counts[d, 0] = len(m)
    verify_terasort(padded.reshape(-1, width), counts, rows, SHARDS)


def phase_streamed(cfg: TeraSortConfig, table: dict) -> dict:
    """``run_terasort_streamed`` over the main path's 1 GiB of rows in
    ``STREAMED_ROUNDS`` rounds (a quarter of the main path's rows a
    shard, the last round padded), pipelined and with
    ``pipeline_rounds=False``: the two outputs byte-equal, each holding
    ``verify_terasort``'s contract; each run's ``phase_times``, wall and
    device memory peak against one round's (a round's upload, step and
    read-back alone): within one round's peak + 10% unpipelined, two
    rounds' + 10% pipelined; the kernel's launches per run, every block
    shape held to the plain version."""
    mesh = VirtualMesh(SHARDS)
    rows = generate_rows(cfg, SHARDS, seed=0)
    scfg = TeraSortConfig(
        rows_per_device=-(-cfg.rows_per_device // STREAMED_ROUNDS))
    step = make_terasort_step(mesh, scfg)
    chunk = rows[:SHARDS * scfg.rows_per_device]
    step(rows_from_numpy(chunk, mesh))           # warm-up: allocator pools
    base = _peak_base()
    out, counts, overflowed = step(rows_from_numpy(chunk, mesh))
    rows_to_numpy(out), counts.cpu(), overflowed.cpu()
    del out, counts, overflowed
    one_round = torch.cuda.max_memory_allocated() - base
    runs, outputs, launches = {}, {}, {}
    for name, pipelined in (("pipelined", True), ("sequential", False)):
        path = f"streamed/{name}"
        times = {}
        base = _peak_base()
        t0 = time.perf_counter()
        (merged, rounds), launches[path], shapes = _launches(
            path, lambda: run_terasort_streamed(
                mesh, scfg, rows, pipeline_rounds=pipelined,
                phase_times=times))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        if rounds != STREAMED_ROUNDS:
            raise AssertionError(f"{path}: {rounds} rounds, expected "
                                 f"{STREAMED_ROUNDS}")
        bound = (1 if not pipelined else 2) * one_round * PEAK_SLACK
        if peak > bound:
            raise AssertionError(f"{path}: device peak {peak} bytes over "
                                 f"{bound:.0f} (one round {one_round})")
        _verify_merged(merged, rows)
        outputs[name] = merged
        runs[name] = {"wall_s": wall, "phase_times": times,
                      "peak_device_bytes": peak,
                      "peak_over_one_round": peak / one_round,
                      "kernel_launches": launches[path],
                      "kernel_shapes": _check_path_shapes(table, path, shapes)}
    for d in range(SHARDS):
        if not np.array_equal(outputs["pipelined"][d],
                              outputs["sequential"][d]):
            raise AssertionError(f"streamed shard {d}: pipelined and "
                                 "sequential outputs differ")
    emit({"phase": "streamed", "rows": len(rows),
          "rows_per_device": scfg.rows_per_device,
          "rounds": STREAMED_ROUNDS,
          "tail_pad_rows": STREAMED_ROUNDS * SHARDS * scfg.rows_per_device
          - len(rows),
          "one_round_peak_bytes": one_round, "runs": runs,
          "byte_equal": True, "verified": True})
    return launches


BENCH_TIMEOUT_S = 600          # the bench process, start to finish
BENCH_SECONDARIES = (
    ("pagerank", "pagerank_edges_per_s", bench.bench_pagerank, 5),
    ("join", "join_rows_per_s", bench.bench_join, 3),
    ("tpcds", "tpcds_fact_rows_per_s", bench.bench_tpcds, 3),
)


def phase_bench(table: dict) -> dict:
    """``python -m sparkrdma_tpu_torch.bench`` with the secondaries
    skipped, in a process of its own: its last line must parse and carry
    the headline metric, a value above 0, ``platform`` ``cuda``, the
    ``ring`` transport and a ``vs_baseline``; the line is printed. Then
    the four device secondaries (PageRank, the join, the TPC-DS star,
    ALS) in this process through the bench module's own builders, each
    under ``_launches`` (paths ``bench/<name>``), every block shape held
    to the plain version; any secondary's recorded error fails the
    phase."""
    torch.cuda.empty_cache()
    env = dict(_child_env(), BENCH_SKIP_SECONDARY="1")
    for key in [k for k in env if k.startswith("BENCH_")
                and k != "BENCH_SKIP_SECONDARY"]:
        del env[key]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sparkrdma_tpu_torch.bench"], env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"bench exited {proc.returncode}: "
                             f"{proc.stdout[-600:]} {proc.stderr[-1500:]}")
    rec = json.loads(lines[-1])
    detail = rec["detail"]
    if not (rec["metric"] == "terasort_shuffle_throughput_per_chip"
            and rec["value"] > 0 and detail["platform"] == "cuda"
            and detail["exchange_impl"] == "native"
            and rec.get("vs_baseline")):
        raise AssertionError(f"bench line fails its checks: {lines[-1]}")
    print(lines[-1], flush=True)
    emit({"phase": "bench", "step": "headline", "wall_s": wall,
          "value": rec["value"], "vs_baseline": rec["vs_baseline"],
          "tpu_step_s": detail["tpu_step_s"],
          "tpu_step_latency_s": detail["tpu_step_latency_s"],
          "cpu_baseline_s": detail["cpu_baseline_s"]})

    mesh = VirtualMesh(SHARDS)
    found, launches, shapes_by_path = {}, {}, {}

    def secondary(prefix: str, fn) -> None:
        fn()
        if prefix + "_error" in found:
            raise AssertionError(f"bench secondary {prefix}: "
                                 f"{found[prefix + '_error']}")

    for prefix, rate_key, build, reps in BENCH_SECONDARIES:
        path = f"bench/{prefix}"
        _, launches[path], shapes = _launches(path, lambda: secondary(
            prefix, lambda: bench._bench_secondary(
                found, prefix, rate_key, lambda: build(mesh, SHARDS, True),
                reps)))
        shapes_by_path[path] = _check_path_shapes(table, path, shapes)
    _, launches["bench/als"], shapes = _launches(
        "bench/als", lambda: secondary(
            "als", lambda: bench._bench_als(found, mesh, SHARDS, True)))
    shapes_by_path["bench/als"] = _check_path_shapes(table, "bench/als",
                                                     shapes)
    emit({"phase": "bench", "step": "secondaries", "detail": found,
          "launches_by_path": launches, "kernel_shapes": shapes_by_path})
    return launches


def _launches(path: str, fn, kernel: str = NATIVE):
    """``fn()`` with both transport kernels', the row gather's, the
    merge's, the partition's and the lookup's launch counts set to 0 just
    before it and read just after; raises if the path never launched
    ``kernel`` (``impl="auto"`` on the card is the ragged kernel),
    launched the other one, launched the row gather other than its CUDA
    ``take_rows`` calls asked (the gather runs beside either transport),
    the merge other than once for each of its CUDA range steps, the
    partition other than once for each of its CUDA groupings, or the
    lookup other than once for each of its CUDA ``hash_lookup`` calls.
    The path's gather, merge, partition and lookup launches go to
    ``GATHER_OF_PATH``, ``MERGE_OF_PATH``, ``PARTITION_OF_PATH`` and
    ``LOOKUP_OF_PATH``. Returns ``(fn(), launches, launches per
    shape)``."""
    for mod in COUNTERS.values():
        mod.LAUNCHES = 0
        mod.SHAPES.clear()
    _bank_gather_counts()
    _bank_merge_counts()
    _bank_partition_counts()
    _bank_lookup_counts()
    asked = TAKE_ROWS["launches"]
    steps = RANGE_STEPS["calls"]
    groupings = GROUPINGS["calls"]
    looked = LOOKUPS["calls"]
    out = fn()
    torch.cuda.synchronize()
    asked = TAKE_ROWS["launches"] - asked
    steps = RANGE_STEPS["calls"] - steps
    groupings = GROUPINGS["calls"] - groupings
    looked = LOOKUPS["calls"] - looked
    if row_gather.LAUNCHES != asked:
        raise AssertionError(
            f"the {path} path launched row_gather {row_gather.LAUNCHES} "
            f"times; its CUDA take_rows calls asked for {asked}")
    if run_merge.LAUNCHES != steps:
        raise AssertionError(
            f"the {path} path launched run_merge {run_merge.LAUNCHES} "
            f"times; it ran {steps} CUDA range steps")
    if dest_partition.LAUNCHES != groupings:
        raise AssertionError(
            f"the {path} path launched dest_partition "
            f"{dest_partition.LAUNCHES} times; it ran {groupings} CUDA "
            f"groupings")
    if hash_lookup.LAUNCHES != looked:
        raise AssertionError(
            f"the {path} path launched hash_lookup {hash_lookup.LAUNCHES} "
            f"times; it made {looked} CUDA lookups")
    GATHER_OF_PATH[path] = row_gather.LAUNCHES
    MERGE_OF_PATH[path] = run_merge.LAUNCHES
    PARTITION_OF_PATH[path] = dest_partition.LAUNCHES
    LOOKUP_OF_PATH[path] = hash_lookup.LAUNCHES
    launched = {name: mod.LAUNCHES for name, mod in COUNTERS.items()}
    if launched[kernel] == 0:
        raise AssertionError(f"the {path} path never launched {kernel}")
    if any(n for name, n in launched.items() if name != kernel):
        raise AssertionError(f"the {path} path launched {launched}, not "
                             f"{kernel} alone")
    KERNEL_OF_PATH[path] = kernel
    return out, launched[kernel], dict(COUNTERS[kernel].SHAPES)


def _ring_entry(shape, seed: int) -> dict:
    """The ring kernel checked and timed at a block shape."""
    blocks = _random_blocks(shape, seed)
    err = _check_kernel(blocks)
    entry = _kernel_times(blocks)
    del blocks
    torch.cuda.empty_cache()
    entry["max_abs_err"] = err
    return entry


def _native_entry(shape, seed: int) -> dict:
    """The ragged kernel checked and timed at ``(D, cap, W, out_cap)``
    under random counts."""
    d, cap, w, out_cap = shape
    data = _random_blocks((d, cap, w), seed)
    mat = _native_counts("random", d, cap, seed)
    err = _check_native(data, mat, out_cap)
    entry = _native_times(data, mat, out_cap)
    del data
    torch.cuda.empty_cache()
    entry.update(counts="random", max_abs_err=err)
    return entry


def _check_path_shapes(table: dict, path: str, shapes: dict) -> list:
    """The kernel the ``path`` run launched against its plain version, bit
    for bit on random inputs, at every shape the run gave it; a shape not
    met before is timed like that kernel's phase and joins its row's
    ``by_shape``, and each shape's entry records the path's launches at
    it. Returns ``[[shape, launches], ...]``."""
    kernel = KERNEL_OF_PATH[path]
    row = table[kernel]
    by_shape = {tuple(e["shape"]): e for e in row["by_shape"]}
    for shape, count in sorted(shapes.items()):
        entry = by_shape.get(shape)
        if entry is None:
            check = _ring_entry if kernel == RING else _native_entry
            entry = check(shape, 10 + len(by_shape))
            row["max_abs_err"] = max(row["max_abs_err"], entry["max_abs_err"])
            row["by_shape"].append(entry)
            by_shape[shape] = entry
        entry.setdefault("launches_by_path", {})[path] = count
    return [[list(shape), count] for shape, count in sorted(shapes.items())]


def _stable_grouping(rows: np.ndarray, dest: np.ndarray, n: int) -> list:
    """What each shard must receive: per receiving shard, every source
    shard's rows with that destination, source-major, each source's rows
    in their original order."""
    per = len(rows) // n
    return [np.concatenate([rows[s * per:(s + 1) * per][
        dest[s * per:(s + 1) * per] == d] for s in range(n)])
        for d in range(n)]


def _zipf_draws(n: int, exponent: float, weights_of, gen) -> torch.Tensor:
    """``GRAM_ROWS`` int64 draws from a bounded Zipf law over ``n`` ranks
    restricted to the ranks ``weights_of`` keeps, as indices among them."""
    weights = torch.arange(1, n + 1, dtype=torch.float64,
                           device="cuda").pow_(-exponent)[weights_of]
    cdf = torch.cumsum(weights, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(GRAM_ROWS, dtype=torch.float64, device="cuda",
                   generator=gen)
    return torch.searchsorted(cdf, u).clamp_(max=weights.numel() - 1)


def _gram_inputs(side: str, seed: int):
    """One block of the ALS cell's ``side`` made on the card: the block's
    entities (every tenth of a seeded permutation of the ranks) drawn by
    their Zipf law, the other side's ids by theirs, stars 1-5, unit
    factors. Returns the normal equations' arguments and the entities."""
    n, exponent, other_n, other_exponent = GRAM_SIDES[side]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mine = torch.randperm(n, device="cuda", generator=gen) % GRAM_BLOCKS == 0
    key = _zipf_draws(n, exponent, mine, gen)
    other = _zipf_draws(other_n, other_exponent, slice(None), gen)
    rows = torch.stack([key.to(torch.int32), other.to(torch.int32),
                        torch.randint(1, 6, (GRAM_ROWS,), device="cuda",
                                      generator=gen).to(torch.float32)
                        .view(torch.int32)], 1)
    fixed = torch.randn((other_n, GRAM_RANK), device="cuda", generator=gen)
    fixed /= torch.linalg.vector_norm(fixed, dim=1, keepdim=True)
    entities = int(mine.sum())
    n_pad = 1 << max(4, (entities - 1).bit_length())
    return (rows[:, 0].to(torch.int64), rows[:, 1],
            rows[:, 2].view(torch.float32), fixed, n_pad), entities


def _gram_rel_err(sums, want) -> float:
    """The largest over entities of the float32 sums' distance from the
    float64 ones over the latter's norm (``ata`` and ``atr`` together)."""
    got = torch.cat([sums[0].flatten(1), sums[1]], 1).to(torch.float64)
    ref = torch.cat([want[0].flatten(1), want[1]], 1)
    norm = torch.linalg.vector_norm(ref, dim=1)
    dist = torch.linalg.vector_norm(got - ref, dim=1)
    return float((dist / norm.clamp(min=1e-300)).max())


def _gram_times() -> dict:
    """The normal equations kernel at a block of the ALS cell, each side:
    its counts equal to the plain version's and its sums' worst relative
    error against float64 no larger than the plain version's; timed
    against the plain version (the chunked ``index_add_``) and the bytes
    ``als.gram_bytes`` counts (each row's factor, rating and entity id
    read, each entity's sums written) at the card's memory rate."""
    out = {}
    for i, side in enumerate(GRAM_SIDES):
        args, entities = _gram_inputs(side, 40 + i)
        local_key, other, rating, fixed, n_pad = args
        got = normal_equations.normal_equations(*args)
        plain = normal_equations.normal_equations_plain(*args)
        want = [torch.zeros((n_pad, GRAM_RANK, GRAM_RANK),
                            dtype=torch.float64, device="cuda"),
                torch.zeros((n_pad, GRAM_RANK), dtype=torch.float64,
                            device="cuda")]
        for lo in range(0, GRAM_ROWS, 1 << 20):
            f = fixed.to(torch.float64)[other[lo:lo + (1 << 20)].long()]
            key = local_key[lo:lo + (1 << 20)]
            want[0].index_add_(0, key, f[:, :, None] * f[:, None, :])
            want[1].index_add_(0, key, f * rating[lo:lo + (1 << 20),
                                                  None].to(torch.float64))
        if not torch.equal(got[2], plain[2]):
            raise AssertionError(f"normal_equations' counts != plain at the "
                                 f"{side} side")
        err, plain_err = _gram_rel_err(got, want), _gram_rel_err(plain, want)
        if err > plain_err:
            raise AssertionError(f"normal_equations' worst relative error "
                                 f"{err} past the plain version's "
                                 f"{plain_err} at the {side} side")
        del got, plain, want, f
        moved = (GRAM_ROWS * (4 * GRAM_RANK + 8)
                 + entities * 4 * (GRAM_RANK ** 2 + GRAM_RANK))
        ms = cuda_ms(lambda: normal_equations.normal_equations(*args), 5, 5)
        out[side] = {
            "rows": GRAM_ROWS, "entities": entities, "n_pad": n_pad,
            "rank": GRAM_RANK, "ms": ms,
            "plain_ms": cuda_ms(
                lambda: normal_equations.normal_equations_plain(*args), 3, 1),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
            "max_rel_err": err, "plain_max_rel_err": plain_err}
        out[side]["roofline_share"] = out[side]["bound_ms"] / ms
        del args
        torch.cuda.empty_cache()
    return out


def phase_als(mesh: VirtualMesh, table: dict) -> int:
    """ALS half-step (items from users) over 100M zipf-skewed ratings
    through the chunked exchange; the received rows held exactly to a
    numpy grouping, 32 sampled items' factors (the hottest included) to
    float64 normal equations; warm calls timed, one traced. The normal
    equations kernel launches once for each ``solve_item_factors`` call,
    one a shard a half-step; then it is checked and timed at a block of
    the ALS cell (``_gram_times``)."""
    t0 = time.perf_counter()
    ratings = als.generate_ratings(ALS_CFG, SHARDS, ALS_PER_DEVICE, seed=0)
    rng = np.random.default_rng(1)
    fixed = (rng.standard_normal((ALS_CFG.num_users, ALS_CFG.rank))
             .astype(np.float32) / np.sqrt(ALS_CFG.rank))
    generate_s = time.perf_counter() - t0

    def half_step(rows):
        half_steps[0] += 1
        return als.als_half_step(mesh, ALS_CFG, rows, fixed, ALS_QUOTA)

    # every CUDA solve with rows launches the normal equations once
    half_steps, solves = [0], [0]
    solve = als.solve_item_factors

    def counted(rows, *args, **kwargs):
        if rows.is_cuda and rows.shape[0]:
            solves[0] += 1
        return solve(rows, *args, **kwargs)

    als.solve_item_factors = counted
    gram_first = normal_equations.LAUNCHES
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (factors, rounds), launches, shapes = _launches(
        "chunked/als", lambda: half_step(ratings))
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    kernel_shapes = _check_path_shapes(table, "chunked/als", shapes)
    warm_ms = _host_times_ms(lambda: half_step(ratings), 2)

    # the exchange, held to a stable numpy grouping by item owner
    received, _ = als.exchange_ratings(mesh, ratings, ALS_QUOTA)
    recv_totals = [int(r.shape[0]) for r in received]
    want = _stable_grouping(ratings, ratings[:, 0] % SHARDS, SHARDS)
    for d in range(SHARDS):
        np.testing.assert_array_equal(
            received[d].cpu().numpy().view(np.uint32), want[d],
            err_msg=f"ALS exchange, shard {d}")
    del received, want

    per_item = np.bincount(ratings[:, 0], minlength=ALS_CFG.num_items)
    rated = np.flatnonzero(per_item)
    sample = np.concatenate([[0], rng.choice(
        rated[rated != 0], ALS_SAMPLED_ITEMS - 1, replace=False)])
    oracle = als.numpy_als_half_step(ratings, fixed, ALS_CFG,
                                     items=sample)[sample].astype(np.float64)
    got = factors[sample].astype(np.float64)
    np.testing.assert_allclose(got, oracle, rtol=2e-2, atol=1e-3)

    ratings_d = rows_from_numpy(ratings, mesh)
    resident_ms = _host_times_ms(lambda: half_step(ratings_d), 2)
    trace = _trace(lambda: half_step(ratings_d),
                   ("als.", "chunked.", "exchange."))
    als.solve_item_factors = solve
    gram_launches = normal_equations.LAUNCHES - gram_first
    if not gram_launches == solves[0] == SHARDS * half_steps[0]:
        raise AssertionError(
            f"normal_equations launched {gram_launches} times over "
            f"{half_steps[0]} ALS half-steps of {SHARDS} shards; "
            f"{solves[0]} CUDA solves had rows")
    emit({"phase": "als", "ratings": int(len(ratings)),
          "per_device": ALS_PER_DEVICE, "num_users": ALS_CFG.num_users,
          "num_items": ALS_CFG.num_items, "rank": ALS_CFG.rank,
          "quota": ALS_QUOTA, "bucketed_quota": bucket_quota(ALS_QUOTA),
          "rounds": rounds, "kernel_launches": launches,
          "kernel_shapes": kernel_shapes, "recv_totals": recv_totals,
          "hot_item_ratings": int(per_item[0]),
          "first_call_s": first_s, "warm_ms": warm_ms,
          "als_ratings_per_s": len(ratings) / statistics.median(warm_ms)
          * 1e3,
          "resident_warm_ms": resident_ms,
          "als_ratings_per_s_resident": len(ratings)
          / statistics.median(resident_ms) * 1e3,
          "peak_device_bytes": peak, "generate_s": generate_s,
          "exchange_exact": True, "sampled_items": len(sample),
          "factor_max_abs_err": float(np.abs(got - oracle).max()),
          # per item, the error against the size of its factor vector
          "factor_max_rel_err": float(
              (np.abs(got - oracle).max(axis=1)
               / np.abs(oracle).max(axis=1)).max()),
          "normal_equations_launches": gram_launches,
          "normal_equations": _gram_times()})
    emit({"phase": "als_profile", **trace})
    return launches


def phase_pagerank(mesh: VirtualMesh, table: dict) -> int:
    """``run_pagerank`` for 5 iterations over 2**27 edges, held to the
    float64 oracle; warm iterations timed, one traced."""
    cfg = PAGERANK_CFG
    t0 = time.perf_counter()
    graph = pagerank.random_graph(cfg, SHARDS, seed=0)
    generate_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ranks, launches, shapes = _launches(
        "pagerank", lambda: pagerank.run_pagerank(
            mesh, cfg, PAGERANK_ITERATIONS, graph=graph))
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    kernel_shapes = _check_path_shapes(table, "pagerank", shapes)
    edges, ranks0, out_deg = graph
    t0 = time.perf_counter()
    want = pagerank.numpy_pagerank(edges, cfg.num_vertices, cfg.damping,
                                   PAGERANK_ITERATIONS)
    oracle_s = time.perf_counter() - t0
    np.testing.assert_allclose(ranks, want, rtol=1e-4)

    step = pagerank.make_pagerank_step(mesh, cfg)
    args = (rows_from_numpy(edges, mesh), shards_from_numpy(ranks0, mesh),
            shards_from_numpy(out_deg, mesh))
    times = _host_times_ms(lambda: step(*args), WORKLOAD_SAMPLES)
    overflowed = step(*args)[1].cpu().tolist()
    trace = _trace(lambda: step(*args), ("pagerank.", "exchange."))
    n_edges = len(edges)
    emit({"phase": "pagerank", "num_vertices": cfg.num_vertices,
          "edges": n_edges, "iterations": PAGERANK_ITERATIONS,
          "kernel_launches": launches, "kernel_shapes": kernel_shapes,
          "run_s": run_s,
          "step_times": _timing(times),
          "s_per_iteration": statistics.median(times) / 1e3,
          "pagerank_edges_per_s": n_edges / statistics.median(times) * 1e3,
          "max_rel_err": float((np.abs(ranks - want) / want).max()),
          "overflowed": overflowed, "peak_device_bytes": peak,
          "generate_s": generate_s, "oracle_s": oracle_s})
    emit({"phase": "pagerank_profile", **trace})
    return launches


def phase_join(mesh: VirtualMesh, table: dict) -> int:
    """``run_join`` at bench.py's row count, held exactly to the oracle;
    warm steps timed, one traced."""
    cfg = JOIN_CFG
    tables = join.generate_tables(cfg, SHARDS, seed=0)
    torch.cuda.reset_peak_memory_stats()
    (matches, pair_sum), launches, shapes = _launches(
        "join", lambda: join.run_join(mesh, cfg, tables=tables))
    peak = torch.cuda.max_memory_allocated()
    kernel_shapes = _check_path_shapes(table, "join", shapes)
    want = join.numpy_join(*tables)
    if (matches, pair_sum) != want:
        raise AssertionError(f"join {(matches, pair_sum)} != oracle {want}")
    step = join.make_join_step(mesh, cfg)
    args = tuple(rows_from_numpy(t, mesh) for t in tables)
    times = _host_times_ms(lambda: step(*args), WORKLOAD_SAMPLES)
    _, shard_sums, overflowed = step(*args)
    trace = _trace(lambda: step(*args), ("join.", "exchange."))
    rows = sum(len(t) for t in tables)
    emit({"phase": "join", "rows": rows, "key_space": cfg.key_space,
          "matches": matches, "pair_sum": pair_sum, "exact": True,
          "max_shard_pair_sum": int(shard_sums.max().item()),
          "kernel_launches": launches, "kernel_shapes": kernel_shapes,
          "step_times": _timing(times),
          "join_rows_per_s": rows / statistics.median(times) * 1e3,
          "overflowed": overflowed.cpu().tolist(),
          "peak_device_bytes": peak})
    emit({"phase": "join_profile", **trace})
    return launches


def phase_tpcds(mesh: VirtualMesh, table: dict) -> int:
    """``run_tpcds`` at SF10 scale, held exactly to the oracle; warm
    steps timed, one traced."""
    cfg = TPCDS_CFG
    t0 = time.perf_counter()
    star = tpcds.generate_star(cfg, SHARDS, seed=0)
    generate_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    (counts, sums), launches, shapes = _launches(
        "tpcds", lambda: tpcds.run_tpcds(mesh, cfg, star=star))
    peak = torch.cuda.max_memory_allocated()
    kernel_shapes = _check_path_shapes(table, "tpcds", shapes)
    want_c, want_s = tpcds.numpy_tpcds(*star, cfg.num_groups)
    np.testing.assert_array_equal(counts, want_c)
    np.testing.assert_array_equal(sums, want_s)
    fact, dim1, dim2 = star
    step = tpcds.make_tpcds_step(mesh, cfg)
    args = (rows_from_numpy(fact, mesh),
            rows_from_numpy(tpcds.pad_to_devices(dim1, SHARDS), mesh),
            rows_from_numpy(tpcds.pad_to_devices(dim2, SHARDS), mesh))
    times = _host_times_ms(lambda: step(*args), WORKLOAD_SAMPLES)
    overflowed = step(*args)[2].cpu().tolist()
    trace = _trace(lambda: step(*args), ("tpcds.", "exchange."))
    hot = np.bincount(fact[:, 0]).max()
    emit({"phase": "tpcds", "fact_rows": len(fact),
          "dim_rows": [len(dim1), len(dim2)], "groups": cfg.num_groups,
          "joined_rows": int(counts.sum()), "exact": True,
          "hot_key_share": float(hot / len(fact)),
          "kernel_launches": launches, "kernel_shapes": kernel_shapes,
          "step_times": _timing(times),
          "tpcds_fact_rows_per_s": len(fact) / statistics.median(times)
          * 1e3,
          "overflowed": overflowed, "peak_device_bytes": peak,
          "generate_s": generate_s})
    emit({"phase": "tpcds_profile", **trace})
    return launches


def _worst_pair(src: np.ndarray, dst: np.ndarray) -> int:
    """The largest row count one (source shard, destination shard) pair
    of a shuffle carries."""
    live = dst >= 0
    return int(np.bincount(src[live] * SHARDS + dst[live],
                           minlength=SHARDS * SHARDS).max())


def _owner(keys: np.ndarray) -> np.ndarray:
    return tpcds_queries._np_owner(keys, SHARDS)


def _query_phase(name: str, mesh: VirtualMesh, table: dict, cfg, tables,
                 run, make_step, by_shard, spans) -> dict:
    """One TPC-DS plan through its runner (kernel launches counted per
    block shape, the kernel held to its plain version at each), its totals
    and per-shard partials held to the numpy oracle, warm steps timed and
    one traced. Returns the phase's record."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got, launches, shapes = _launches(
        name, lambda: run(mesh, cfg, tables=tables))
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    kernel_shapes = _check_path_shapes(table, name, shapes)
    t0 = time.perf_counter()
    want_by_shard = by_shard(*tables, cfg, SHARDS)
    oracle_s = time.perf_counter() - t0
    want = tuple(int(x) for x in want_by_shard.sum(axis=0))
    if got != want:
        raise AssertionError(f"{name} {got} != oracle {want}")
    step = make_step(mesh, cfg)
    args = [stage_to_device(tpcds_queries.pad_rows_to_devices(t, SHARDS),
                            mesh) for t in tables]
    partial, overflowed = step(*args)
    if overflowed.any().item():
        raise AssertionError(f"{name} step overflowed")
    np.testing.assert_array_equal(partial.cpu().numpy().astype(np.int64),
                                  want_by_shard)
    times = _host_times_ms(lambda: step(*args), WORKLOAD_SAMPLES)
    emit({"phase": f"{name}_profile",
          **_trace(lambda: step(*args), spans + ("exchange.",))})
    return {"phase": name, "totals": list(got), "exact": True,
            # the tables' bytes: numpy versions may draw other samples
            # from the same seed
            "tables_crc32": [zlib.crc32(t.tobytes()) for t in tables],
            "per_shard_exact": True,
            "partials": partial.cpu().numpy().tolist(),
            "kernel_launches": launches, "kernel_shapes": kernel_shapes,
            "first_call_s": first_s, "step_times": _timing(times),
            "peak_device_bytes": peak, "oracle_s": oracle_s,
            "overflowed": overflowed.cpu().tolist()}


def phase_q95(mesh: VirtualMesh, table: dict) -> int:
    """TPC-DS q95 over SF10's web_sales row count, exact against the
    oracle in total and per shard; warm steps timed, one traced."""
    cfg = Q95_CFG
    t0 = time.perf_counter()
    tables = tpcds_queries.generate_q95(cfg, SHARDS, seed=0)
    generate_s = time.perf_counter() - t0
    ws = tables[0]
    record = _query_phase("q95", mesh, table, cfg, tables,
                          tpcds_queries.run_q95, tpcds_queries.make_q95_step,
                          tpcds_queries.numpy_q95_by_shard,
                          ("q95.",))
    # the four fact routes: every row moves in each, from the shard the
    # previous route left it on
    src = np.arange(len(ws)) // cfg.ws_rows_per_device
    pairs = {}
    for route, col in (("date", 2), ("addr", 3), ("site", 4), ("order", 0)):
        dst = _owner(ws[:, col])
        pairs[route] = _worst_pair(src, dst)
        src = dst
    record.update({
        "ws_rows": int(len(ws)), "orders": cfg.num_orders,
        "rows_per_order": len(ws) / cfg.num_orders,
        "worst_pair_by_route": pairs,
        "slot_rows": cfg.ws_rows_per_device * cfg.out_factor // SHARDS,
        "ws_rows_per_s": len(ws) / record["step_times"]["median_ms"] * 1e3,
        "generate_s": generate_s})
    emit(record)
    return record["kernel_launches"]


def phase_q64(mesh: VirtualMesh, table: dict) -> int:
    """TPC-DS q64 at the largest size its 16-bit keys admit, exact against
    the oracle in total and per shard; warm steps timed, one traced."""
    cfg = Q64_CFG
    t0 = time.perf_counter()
    tables = tpcds_queries.generate_q64(cfg, SHARDS, seed=0)
    generate_s = time.perf_counter() - t0
    ss, _, cs, _, _ = tables
    record = _query_phase("q64", mesh, table, cfg, tables,
                          tpcds_queries.run_q64, tpcds_queries.make_q64_step,
                          tpcds_queries.numpy_q64_by_shard,
                          ("q64.",))
    cs_pk = tpcds_queries._pairkey(cs[:, 0], cs[:, 1])
    ss_pk = tpcds_queries._pairkey(ss[:, 0], ss[:, 1])
    record.update({
        "ss_rows": int(len(ss)), "cs_rows": int(len(cs)),
        "num_items": cfg.num_items,
        "hot_item_share_ss": float(np.bincount(ss[:, 0]).max() / len(ss)),
        "worst_pair_by_route": {
            "cs_by_pair": _worst_pair(
                np.arange(len(cs)) // cfg.cs_rows_per_device, _owner(cs_pk)),
            "cs_by_item": _worst_pair(_owner(cs_pk), _owner(cs[:, 0])),
            "ss_by_pair": _worst_pair(
                np.arange(len(ss)) // cfg.ss_rows_per_device,
                _owner(ss_pk))},
        "slot_rows": cfg.ss_rows_per_device * cfg.out_factor // SHARDS,
        "rows_per_s": (len(ss) + len(cs))
        / record["step_times"]["median_ms"] * 1e3,
        "generate_s": generate_s})
    emit(record)
    return record["kernel_launches"]


def _round_host_ms(tracer: Tracer) -> dict:
    """Host milliseconds the driver spent per part, from its spans:
    staging (padding into the pinned buffers and queueing the upload),
    dispatch (queueing the step and the download), collect (waiting for
    the round and copying its rows out) and merge."""
    def total(name):
        return sum(e["dur"] for e in tracer.events(name)) / 1e3
    rounds = len(tracer.events("exchange.round"))
    parts = {"staging": total("exchange.stage"),
             "dispatch": total("exchange.round") - total("exchange.stage"),
             "collect": total("exchange.collect"),
             "merge": total("exchange.merge")}
    return {"total_ms": parts,
            "per_round_ms": {k: v / max(1, rounds) for k, v in parts.items()
                             if k != "merge"}}


def _fused_rows():
    """1 GiB of 100-byte rows from seed 0: a uniform random u64 key in
    words 0-1 (word 1 the high word), 23 random payload words, and the
    destination shard ``key % 8``."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 2**32, (FUSED_ROWS, FUSED_WORDS), dtype=np.uint32)
    keys = rows[:, :2].copy().view(np.uint64).reshape(-1)
    return rows, keys, (keys % SHARDS).astype(np.int32)


def phase_fused_rounds(mesh: VirtualMesh, table: dict):
    """``run_fused_exchange`` over 1 GiB in budget-sized rounds, pipelined
    and sequential, each shard held to a numpy stable sort of its rows by
    u64 key; one more run traced. Returns (launches, rows, dest, result)
    for the hierarchical phase."""
    t0 = time.perf_counter()
    rows, keys, dest = _fused_rows()
    generate_s = time.perf_counter() - t0
    distinct = int(np.unique(keys).size)
    kw = dict(key_words=2, rows_per_round=FUSED_ROWS_PER_ROUND,
              out_factor=2)
    tracer = Tracer()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (piped, rounds), launches, shapes = _launches(
        "fused_rounds",
        lambda: run_fused_exchange(mesh, rows, dest, tracer=tracer, **kw))
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    kernel_shapes = _check_path_shapes(table, "fused_rounds", shapes)
    seq_tracer = Tracer()
    t0 = time.perf_counter()
    seq, seq_rounds = run_fused_exchange(mesh, rows, dest,
                                         pipeline_rounds=False,
                                         tracer=seq_tracer, **kw)
    seq_s = time.perf_counter() - t0
    if seq_rounds != rounds:
        raise AssertionError(f"sequential ran {seq_rounds} rounds, "
                             f"pipelined {rounds}")
    t0 = time.perf_counter()
    for d in range(SHARDS):
        np.testing.assert_array_equal(piped[d], seq[d],
                                      err_msg=f"pipelined != sequential, "
                                      f"shard {d}")
        mine = dest == d
        want = rows[mine][np.argsort(keys[mine], kind="stable")]
        np.testing.assert_array_equal(piped[d], want,
                                      err_msg=f"fused rounds, shard {d}")
    oracle_s = time.perf_counter() - t0
    del seq
    emit({"phase": "fused_rounds_profile",
          **_trace(lambda: run_fused_exchange(mesh, rows, dest, **kw),
                   ("exchange.", "fused."))})
    emit({"phase": "fused_rounds", "rows": FUSED_ROWS,
          "row_bytes": 4 * FUSED_WORDS, "data_bytes": int(rows.nbytes),
          "distinct_keys": distinct, "hbm_budget": FUSED_BUDGET,
          "rows_per_round": FUSED_ROWS_PER_ROUND, "rounds": rounds,
          "last_round_rows": FUSED_ROWS
          - (rounds - 1) * FUSED_ROWS_PER_ROUND * SHARDS,
          "overlap_instants": len(tracer.events("exchange.overlap")),
          "round_spans": len(tracer.events("exchange.round")),
          "wall_s": wall_s, "gb_per_s": rows.nbytes / wall_s / 1e9,
          "sequential_wall_s": seq_s,
          "sequential_gb_per_s": rows.nbytes / seq_s / 1e9,
          "host_ms": _round_host_ms(tracer),
          "sequential_host_ms": _round_host_ms(seq_tracer),
          "kernel_launches": launches, "kernel_shapes": kernel_shapes,
          "peak_device_bytes": peak, "pipelined_equals_sequential": True,
          "exact": True, "generate_s": generate_s, "oracle_s": oracle_s})
    return launches, rows, dest, piped


def phase_hierarchical(mesh: VirtualMesh, table: dict, rows: np.ndarray,
                       dest: np.ndarray, flat: list) -> int:
    """The same rows through ``run_hierarchical_exchange`` on two slices
    of 4 shards, each row homed in its source shard's slice, with the
    same budget; byte-equal to the flat driver's result, cross-slice
    bytes equal to the residue's; one more run traced."""
    topo = HIER_TOPOLOGY
    source = np.arange(len(rows)) // (len(rows) // SHARDS)
    home = topo.device_slices()[source]
    kw = dict(key_words=2, rows_per_round=FUSED_ROWS_PER_ROUND,
              out_factor=2)
    tracer = Tracer()
    before = topology.cross_slice_snapshot()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (hier, rounds), launches, shapes = _launches(
        "hierarchical", lambda: run_hierarchical_exchange(
            mesh, topo, rows, dest, home, tracer=tracer, **kw))
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    after = topology.cross_slice_snapshot()
    kernel_shapes = _check_path_shapes(table, "hierarchical", shapes)
    for d in range(SHARDS):
        np.testing.assert_array_equal(hier[d], flat[d],
                                      err_msg=f"hierarchical, shard {d}")
    residue = int((topo.device_slices()[dest] != home).sum())
    moved = after["bytes"] - before["bytes"]
    if moved != residue * rows.shape[1] * 4:
        raise AssertionError(f"cross-slice bytes {moved} != residue "
                             f"{residue} rows")
    del hier
    phases = {}
    for e in tracer.events("exchange.round"):
        key = f'{e["args"]["phase"]}/slice{e["args"]["slice"]}'
        phases[key] = phases.get(key, 0) + 1
    emit({"phase": "hierarchical_profile",
          **_trace(lambda: run_hierarchical_exchange(mesh, topo, rows, dest,
                                                     home, **kw),
                   ("exchange.", "fused."))})
    emit({"phase": "hierarchical", "slices": list(topo.slice_sizes),
          "rows": int(len(rows)), "rounds": rounds,
          "slice_rounds_by_phase": phases,
          "degrades": len(tracer.events("exchange.degrade")),
          "cross_slice_moves": after["moves"] - before["moves"],
          "cross_slice_bytes": moved, "residue_rows": residue,
          "wall_s": wall_s, "gb_per_s": rows.nbytes / wall_s / 1e9,
          "host_ms": _round_host_ms(tracer),
          "kernel_launches": launches, "kernel_shapes": kernel_shapes,
          "peak_device_bytes": peak, "equals_flat": True})
    return launches


@contextlib.contextmanager
def _engine_cluster(executors: int = ENGINE_EXECUTORS):
    """A ``SparkCompatShuffleManager`` driver and ``executors`` executors
    of the port on localhost, each spilling under one temporary
    directory; every manager is stopped on the way out."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_engine_") as tmp:
        conf = TpuShuffleConf(connect_timeout_ms=5000)
        driver = SparkCompatShuffleManager(conf, isDriver=True)
        execs = []
        try:
            for i in range(executors):
                execs.append(SparkCompatShuffleManager(
                    conf, driverAddr=driver.driverAddr, executorId=str(i),
                    spill_dir=os.path.join(tmp, f"e{i}")))
            for ex in execs:
                ex.native.executor.wait_for_members(executors)
            yield driver, execs
        finally:
            for ex in execs:
                ex.stop()
            driver.stop()


def _mesh_records(rows: int = MS_ROWS):
    """The stage's records from seed 0 (uniform random u64 keys, random
    payload bytes). Returns (keys, payload, seconds to generate)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**64, rows, dtype=np.uint64)
    payload = np.frombuffer(rng.bytes(rows * MS_PAYLOAD),
                            np.uint8).reshape(rows, MS_PAYLOAD)
    return keys, payload, time.perf_counter() - t0


def _mesh_stage(driver, execs, keys: np.ndarray, payload: np.ndarray):
    """Register the stage on ``driver`` and write ``MS_MAPS`` map outputs
    through the executors' writers: map ``m`` on executor ``m // 2`` and
    map 0 again on executor 1 (a speculative copy: staging must read it
    once). Returns (the executors' managers, the handle, seconds to
    commit)."""
    t0 = time.perf_counter()
    managers = [ex.native for ex in execs]
    handle = driver.native.register_shuffle(
        MS_SHUFFLE_ID, MS_MAPS, MS_PARTITIONS, MS_PARTITIONER,
        row_payload_bytes=MS_PAYLOAD)
    for m, e in [(m, m // 2) for m in range(MS_MAPS)] + [(0, 1)]:
        rows = slice(m * MS_MAP_ROWS, (m + 1) * MS_MAP_ROWS)
        writer = managers[e].get_writer(handle, m)
        writer.write_batch(keys[rows], payload[rows])
        writer.close()
    return managers, handle, time.perf_counter() - t0


def _mesh_oracle(keys: np.ndarray, payload: np.ndarray) -> list:
    """Per shard, what every flat reduce must return: the rows whose
    partition ``p`` has ``p % D == d``, stably sorted by key, with their
    partition ids."""
    parts = MS_PARTITIONER.build(MS_PARTITIONS)(keys)
    shard = parts % SHARDS
    want = []
    for d in range(SHARDS):
        mine = np.flatnonzero(shard == d)
        order = mine[np.argsort(keys[mine], kind="stable")]
        want.append((keys[order], payload[order], parts[order]))
    return want


def _same_rows(name: str, got: list, want: list) -> None:
    """Raise unless each shard's (keys, payload, partition ids) equal the
    oracle's byte for byte."""
    for d, (g, w) in enumerate(zip(got, want)):
        for what, a, b in zip(("keys", "payload", "partition ids"), g, w):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"mesh_service {name}: shard {d} "
                                     f"{what} differ from the oracle")


def _mesh_host_ms(tracer: Tracer, wall_s: float) -> dict:
    """The host's milliseconds per part of one traced fused reduce, from
    its spans: read and decode of the committed outputs, ``_rows_to_u32``,
    the partitioner, padding into the pinned buffers and queueing the
    upload, queueing the step and the download, waiting for each round
    and copying its rows out, the merge, the unpack; ``other`` is the
    wall time no span covers (round blocks assembled from the batches)."""
    def total(name):
        return sum(e["dur"] for e in tracer.events(name)) / 1e3
    parts = {"decode": total("mesh.decode"), "pack": total("mesh.pack"),
             "partition": total("mesh.partition"),
             "staging": total("exchange.stage"),
             "dispatch": total("exchange.round") - total("exchange.stage"),
             "collect": total("exchange.collect"),
             "merge": total("exchange.merge"),
             "unpack": total("mesh.unpack")}
    parts["other"] = wall_s * 1e3 - sum(parts.values())
    rounds = len(tracer.events("exchange.round"))
    return {"total_ms": parts, "rounds": rounds,
            "per_round_ms": {k: parts[k] / max(1, rounds)
                             for k in ("staging", "dispatch", "collect")}}


def _mesh_run(name: str, table: dict, launches: dict, fn) -> tuple:
    """One reduce of the stage, its kernel launches counted and the
    kernel held to its plain version at every block shape it was given.
    Returns (result, record)."""
    path = f"mesh_service/{name}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result, launches[path], shapes = _launches(path, fn)
    wall_s = time.perf_counter() - t0
    record = {"wall_s": wall_s,
              "gb_per_s": MS_ROWS * (8 + MS_PAYLOAD) / wall_s / 1e9,
              "kernel_launches": launches[path],
              "peak_device_bytes": torch.cuda.max_memory_allocated(),
              "kernel_shapes": _check_path_shapes(table, path, shapes)}
    return result, record


def phase_mesh_service(mesh: VirtualMesh, table: dict, keys: np.ndarray,
                       payload: np.ndarray, generate_s: float) -> tuple:
    """The mesh shuffle service over one engine shuffle stage (see the
    module docstring, phase 11): ``keys`` and ``payload`` written by
    ``_mesh_stage`` on a cluster of their own. Returns the kernel's
    launches per path and the per-shard oracle."""
    with _engine_cluster(MS_EXECUTORS) as (driver, execs):
        executors, handle, commit_s = _mesh_stage(driver, execs, keys,
                                                  payload)
        return _mesh_service_runs(mesh, table, executors, handle, keys,
                                  payload, generate_s, commit_s)


def _mesh_service_runs(mesh: VirtualMesh, table: dict, executors, handle,
                       keys: np.ndarray, payload: np.ndarray,
                       generate_s: float, commit_s: float) -> tuple:
    """``phase_mesh_service``'s runs over the committed stage."""
    t0 = time.perf_counter()
    ordered = np.sort(keys)   # distinct keys by one sort, timed apart
    distinct = 1 + int(np.count_nonzero(ordered[1:] != ordered[:-1]))
    del ordered
    distinct_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = _mesh_oracle(keys, payload)
    oracle_s = time.perf_counter() - t0
    launches, runs = {}, {}
    kw = dict(out_factor=MS_OUT_FACTOR, expect_maps=MS_MAPS)

    # 1. the headline: the fused driver in budget-sized rounds
    tracer = Tracer()
    fused, runs["fused_rounds"] = _mesh_run(
        "fused_rounds", table, launches,
        lambda: mesh_service.run_mesh_reduce_fused(
            executors, handle, mesh, rows_per_round=MS_ROWS_PER_ROUND,
            tracer=tracer, **kw))
    _same_rows("fused_rounds", fused, want)
    runs["fused_rounds"]["host_ms"] = _mesh_host_ms(
        tracer, runs["fused_rounds"]["wall_s"])
    emit({"phase": "mesh_service_profile",
          **_trace(lambda: mesh_service.run_mesh_reduce_fused(
              executors, handle, mesh, rows_per_round=MS_ROWS_PER_ROUND,
              **kw), ("exchange.", "fused."))})

    # 2-4. one shot, fused and not; streamed, pipelined and sequential
    for name, fn in (
            ("fused_one_shot", lambda: mesh_service.run_mesh_reduce_fused(
                executors, handle, mesh, **kw)),
            ("one_shot", lambda: mesh_service.run_mesh_reduce(
                executors, handle, mesh, sort_by_key=True, **kw)),
            ("streamed", lambda: mesh_service.run_mesh_reduce_streamed(
                executors, handle, mesh, **kw)),
            ("streamed_sequential",
             lambda: mesh_service.run_mesh_reduce_streamed(
                 executors, handle, mesh, pipeline_rounds=False, **kw))):
        result, runs[name] = _mesh_run(name, table, launches, fn)
        _same_rows(name, result, want)
        del result

    # 5. two slices of 4 shards: partitions placed by the slice-aligned
    # map, so compare per partition
    before = topology.cross_slice_snapshot()
    hier_tracer = Tracer()
    hier, runs["hier"] = _mesh_run(
        "hier", table, launches, lambda: mesh_service.run_mesh_reduce_hier(
            executors, handle, mesh, HIER_TOPOLOGY, tracer=hier_tracer,
            **kw))
    after = topology.cross_slice_snapshot()
    want_parts = mesh_service.split_by_partition(want, MS_PARTITIONS,
                                                 MS_PAYLOAD)
    for p, (got, exp) in enumerate(zip(mesh_service.split_by_partition(
            hier, MS_PARTITIONS, MS_PAYLOAD), want_parts)):
        if not (np.array_equal(got[0], exp[0])
                and np.array_equal(got[1], exp[1])):
            raise AssertionError(f"mesh_service hier: partition {p} "
                                 "differs from the oracle")
    # each partition is served by exactly one shard
    serving = [len(np.unique(parts)) for _, _, parts in hier]
    if sum(serving) != MS_PARTITIONS:
        raise AssertionError(f"hier: {sum(serving)} (shard, partition) "
                             f"pairs for {MS_PARTITIONS} partitions")
    runs["hier"].update({
        "slices": list(HIER_TOPOLOGY.slice_sizes),
        "cross_slice_bytes": after["bytes"] - before["bytes"],
        "cross_slice_moves": after["moves"] - before["moves"],
        "cross_slice_share": (after["bytes"] - before["bytes"])
        / (MS_ROWS * 4 * mesh_service.device_row_words(MS_PAYLOAD)),
        "partitions_per_shard": serving,
        "degrades": len(hier_tracer.events("exchange.degrade"))})
    del hier

    # 6. per-partition reads of run 1's result
    per_partition = mesh_service.split_by_partition(fused, MS_PARTITIONS,
                                                    MS_PAYLOAD)
    del fused
    reads = []
    for lo, hi in MS_READER_RANGES:
        reader = mesh_service.CachedPartitionReader(per_partition, lo, hi,
                                                    MS_PAYLOAD)
        k, p = reader.read_sorted()
        wk = np.concatenate([want_parts[i][0] for i in range(lo, hi)])
        wp = np.concatenate([want_parts[i][1] for i in range(lo, hi)])
        order = np.argsort(wk, kind="stable")
        if not (np.array_equal(k, wk[order])
                and np.array_equal(p, wp[order])
                and reader.metrics.local_bytes == len(k) * (8 + MS_PAYLOAD)):
            raise AssertionError(f"CachedPartitionReader [{lo}, {hi}) "
                                 "differs from the oracle")
        reads.append({"range": [lo, hi], "rows": int(len(k)),
                      "local_bytes": reader.metrics.local_bytes})
    del per_partition, want_parts

    # 7. the on-ramp: every committed output's bytes to the card
    chunks = [executors[m // 2].resolver.local_blocks(
        handle.shuffle_id, m, 0, MS_PARTITIONS) for m in range(MS_MAPS)]
    staged = sum(len(c) for c in chunks)
    ramp = {}
    for attempt in ("first", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev_keys, dev_payload = read_to_device(chunks, MS_PAYLOAD)
        ramp[f"{attempt}_s"] = time.perf_counter() - t0
        ramp[f"{attempt}_gb_per_s"] = staged / ramp[f"{attempt}_s"] / 1e9
        if attempt == "first":
            del dev_keys, dev_payload
    if not (dev_keys.is_cuda and dev_payload.is_cuda):
        raise AssertionError("read_to_device did not stage on the card")
    host_keys = dev_keys.cpu().numpy()
    host_payload = dev_payload.cpu().numpy()
    del dev_keys, dev_payload
    at = 0
    for chunk in chunks:
        rows = np.frombuffer(chunk, np.uint8).reshape(-1, 8 + MS_PAYLOAD)
        n = len(rows)
        if not (np.array_equal(host_keys[at:at + n].view(np.uint8),
                               rows[:, :8])
                and np.array_equal(host_payload[at:at + n], rows[:, 8:])):
            raise AssertionError("read_to_device bytes differ from the "
                                 "committed outputs")
        at += n
    if at != MS_ROWS:
        raise AssertionError(f"read_to_device staged {at} rows")
    ramp.update({"bytes": staged, "rows": at, "exact": True})
    emit({"phase": "mesh_service", "rows": MS_ROWS,
          "record_bytes": 8 + MS_PAYLOAD,
          "staged_bytes": MS_ROWS * (8 + MS_PAYLOAD),
          "device_row_bytes": 4 * mesh_service.device_row_words(MS_PAYLOAD),
          "maps": MS_MAPS, "map_rows": MS_MAP_ROWS,
          "executors": MS_EXECUTORS, "partitions": MS_PARTITIONS,
          "partitioner": "hash", "out_factor": MS_OUT_FACTOR,
          "rows_per_round": MS_ROWS_PER_ROUND, "hbm_budget": FUSED_BUDGET,
          "distinct_keys": distinct, "runs": runs,
          "all_exact": True, "cached_reads": reads, "read_to_device": ramp,
          "generate_s": generate_s, "commit_s": commit_s,
          "distinct_s": distinct_s, "oracle_s": oracle_s})
    return launches, want


def _mesh_engine(driver, execs, mesh: VirtualMesh, **kw) -> DAGEngine:
    """A mesh-mode engine with a live tracer of its own."""
    engine = DAGEngine(driver, execs, mesh=mesh, **kw)
    engine.tracer = Tracer()
    return engine


def _planes(engine: DAGEngine) -> dict:
    """What the engine's job chose and suffered: planes by shuffle, the
    degrades with their reasons, the rounds its reduces ran and the slot
    rows of each round's ring pairs."""
    return {"planes": [e["args"]["plane"]
                       for e in engine.tracer.events("exchange.select")],
            "degrades": [e["args"]["reason"]
                         for e in engine.tracer.events("exchange.degrade")],
            "rounds": len(engine.tracer.events("exchange.round")),
            "slot_rows": [e["args"]["slot_rows"]
                          for e in engine.tracer.events("exchange.round")]}


def _on_device(name: str, chosen: dict) -> None:
    """Fail unless every shuffle of the job rode the device plane and none
    degraded to the host plane."""
    if (not chosen["planes"] or set(chosen["planes"]) != {"device"}
            or chosen["degrades"]):
        raise AssertionError(f"{name}: a shuffle left the device plane: "
                             f"planes {chosen['planes']}, degrades "
                             f"{chosen['degrades']}")


def _engine_stage(keys: np.ndarray, payload: np.ndarray, reads: list,
                  map_rows: int = MS_MAP_ROWS):
    """The mesh-service stage as an engine job: map task ``m`` writes
    records ``[m * map_rows, (m + 1) * map_rows)`` through the writer;
    result task ``p`` drains partition ``p`` and returns ``(keys,
    payload, remote bytes)``, appending its read's start and end to
    ``reads``."""
    def map_fn(ctx, writer, task_id):
        rows = slice(task_id * map_rows, (task_id + 1) * map_rows)
        writer.write((keys[rows], payload[rows]))

    def reduce_fn(ctx, task_id):
        t0 = time.perf_counter()
        reader = ctx.read(0)
        got = list(reader.readBatches())
        out = (np.concatenate([k for k, _ in got]) if got
               else np.zeros(0, np.uint64),
               np.concatenate([p for _, p in got]) if got
               else np.zeros((0, MS_PAYLOAD), np.uint8),
               reader.metrics.remote_bytes)
        reads.append((t0, time.perf_counter()))
        return out

    stage = MapStage(MS_MAPS, ShuffleDependency(
        MS_PARTITIONS, PartitionerSpec("hash"),
        row_payload_bytes=MS_PAYLOAD), map_fn)
    return ResultStage(MS_PARTITIONS, reduce_fn, parents=[stage])


def phase_engine(mesh: VirtualMesh, table: dict, keys: np.ndarray,
                 payload: np.ndarray, want: list) -> dict:
    """The mesh-service stage as a real engine job (see the module
    docstring, phase 12). Returns the kernel's launches per path."""
    if native.LIB is None:
        raise AssertionError(f"the native shim did not load from "
                             f"{native._LIB_PATH}")
    t0 = time.perf_counter()   # the engine's reduce splits the same way
    want_parts = mesh_service.split_by_partition(want, MS_PARTITIONS,
                                                 MS_PAYLOAD)
    split_s = time.perf_counter() - t0
    launches = {}
    with _engine_cluster() as (driver, execs):
        engine = _mesh_engine(driver, execs, mesh)
        reads = []
        before = exchange.DATA_PLANE["exchanges"]
        t0 = time.perf_counter()
        out, launches["engine"], shapes = _launches(
            "engine", lambda: engine.run(_engine_stage(keys, payload,
                                                       reads)))
        job_s = time.perf_counter() - t0
        exchanges = exchange.DATA_PLANE["exchanges"] - before
        chosen = _planes(engine)
        stages = {("map" if "shuffle" in e["args"] else "result"):
                  e["dur"] / 1e6
                  for e in engine.tracer.events("engine.stage")}
        reduce_s = (max(end for _, end in reads)
                    - min(start for start, _ in reads))
        host_ms = _mesh_host_ms(engine.tracer, reduce_s)
        host_ms["dispatch_ms_by_round"] = [
            (r["dur"] - st["dur"]) / 1e3 for r, st in zip(
                engine.tracer.events("exchange.round"),
                engine.tracer.events("exchange.stage"))]
        host_ms["split_by_partition_ms"] = split_s * 1e3
        if chosen["planes"] != ["device"] or chosen["degrades"]:
            raise AssertionError(f"engine: the stage did not stay on the "
                                 f"device plane: {chosen}")
        if exchanges != chosen["rounds"] or not exchanges:
            raise AssertionError(f"engine: {exchanges} exchanges for "
                                 f"{chosen['rounds']} rounds")
        for p, ((k, v, remote), (wk, wv)) in enumerate(zip(out,
                                                           want_parts)):
            if remote:
                raise AssertionError(f"engine: partition {p} read "
                                     f"{remote} remote bytes")
            if not (np.array_equal(k, wk) and np.array_equal(v, wv)):
                raise AssertionError(f"engine: partition {p} differs from "
                                     "the oracle")
        rows = sum(len(k) for k, _, _ in out)
        del out
        # a second run of the same job, traced, its tasks one at a time
        # on this thread (the profiler records this thread's spans): the
        # reduce's device time and idle share
        reads.clear()
        traced_engine = _mesh_engine(driver, execs, mesh,
                                     max_parallel_tasks=1)
        traced = _trace(lambda: traced_engine.run(
            _engine_stage(keys, payload, reads)), ("exchange.", "fused."))
        traced_reduce_s = (max(end for _, end in reads)
                           - min(start for start, _ in reads))
        traced["reduce_wall_ms"] = traced_reduce_s * 1e3
        traced["reduce_idle_share"] = (1 - traced["device_busy_ms"]
                                       / traced["reduce_wall_ms"])
        traced.update(_planes(traced_engine))
        traced["max_parallel_tasks"] = 1
        traced["host_ms"] = _mesh_host_ms(traced_engine.tracer,
                                          traced_reduce_s)
    staged = MS_ROWS * (8 + MS_PAYLOAD)
    emit({"phase": "engine", "executors": ENGINE_EXECUTORS,
          "maps": MS_MAPS, "partitions": MS_PARTITIONS, "rows": rows,
          "record_bytes": 8 + MS_PAYLOAD, "native_shim": True,
          "shim": os.path.basename(native._LIB_PATH),
          **chosen, "exchanges": exchanges,
          "map_stage_s": stages.get("map"),
          "result_stage_s": stages.get("result"), "reduce_s": reduce_s,
          "reduce_gb_per_s": staged / reduce_s / 1e9, "job_s": job_s,
          "job_gb_per_s": staged / job_s / 1e9, "host_ms": host_ms,
          "kernel_launches": launches["engine"],
          "kernel_shapes": _check_path_shapes(table, "engine", shapes),
          "remote_bytes": 0, "all_exact": True})
    emit({"phase": "engine_profile", **traced})
    return launches


def phase_engine_q95(mesh: VirtualMesh, table: dict) -> dict:
    """TPC-DS q95 as an engine job (``build_q95_job``: five sources, three
    dimension joins, the by-order result stage) over SF10's web_sales
    rows through the mesh engine, against ``numpy_q95``."""
    cfg = Q95_CFG
    launches = {}
    with _engine_cluster() as (driver, execs):
        engine = _mesh_engine(driver, execs, mesh)
        t0 = time.perf_counter()
        job, finish = tpcds_queries.build_q95_job(
            cfg, num_maps=MS_MAPS, num_partitions=MS_PARTITIONS, seed=0,
            data_scale=ENGINE_Q95_SCALE)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        results, launches["engine_q95"], shapes = _launches(
            "engine_q95", lambda: engine.run(job))
        job_s = time.perf_counter() - t0
        got = finish(results)
        chosen = _planes(engine)
    _on_device("engine q95", chosen)
    t0 = time.perf_counter()
    want = tpcds_queries.numpy_q95(*tpcds_queries.generate_q95(
        cfg, ENGINE_Q95_SCALE, seed=0), cfg)
    oracle_s = time.perf_counter() - t0
    if got != want:
        raise AssertionError(f"engine q95 {got} != numpy_q95 {want}")
    emit({"phase": "engine_q95", "data_scale": ENGINE_Q95_SCALE,
          "ws_rows": ENGINE_Q95_SCALE * cfg.ws_rows_per_device,
          "maps": MS_MAPS, "partitions": MS_PARTITIONS,
          "result": list(got), "exact": True, "build_s": build_s,
          "job_s": job_s, "oracle_s": oracle_s,
          "plane_counts": dict(collections.Counter(chosen["planes"])),
          "degrades": chosen["degrades"], "rounds": chosen["rounds"],
          "slot_rows": chosen["slot_rows"],
          "kernel_launches": launches["engine_q95"],
          "kernel_shapes": _check_path_shapes(table, "engine_q95", shapes)})
    return launches


def _small_engine_runs(mesh: VirtualMesh) -> dict:
    """Small engine jobs under the mesh engine, each against its truth:
    the star and q64 plans at the CPU tests' sizes, the README's word
    count, ``BatchRDD.sort_by_key`` over ``SORT_ROWS`` rows, each on the
    device plane with no degrade, and a skewed stage whose receive
    overflows (degraded to the host plane)."""
    record = {}
    with _engine_cluster() as (driver, execs):
        job, finish = tpcds.build_tpcds_job(SMALL_STAR_CFG, num_maps=3,
                                            num_partitions=4, seed=5)
        engine = _mesh_engine(driver, execs, mesh)
        for got, want in zip(finish(engine.run(job)), tpcds.numpy_tpcds(
                *tpcds.generate_star(SMALL_STAR_CFG, 1, seed=5),
                SMALL_STAR_CFG.num_groups)):
            np.testing.assert_array_equal(got, want)
        record["star"] = _planes(engine)
        _on_device("small star engine job", record["star"])

        job, finish = tpcds_queries.build_q64_job(
            SMALL_Q64_CFG, num_maps=3, num_partitions=4, seed=13,
            data_scale=SHARDS)
        engine = _mesh_engine(driver, execs, mesh)
        got = finish(engine.run(job))
        if got != tpcds_queries.numpy_q64(*tpcds_queries.generate_q64(
                SMALL_Q64_CFG, SHARDS, seed=13), SMALL_Q64_CFG):
            raise AssertionError(f"small q64 engine job: {got}")
        record["q64"] = {**_planes(engine), "result": list(got)}
        _on_device("small q64 engine job", record["q64"])

        rng = np.random.default_rng(17)
        words = [f"w{int(i)}" for i in rng.zipf(1.5, 20_000) % 500]
        engine = _mesh_engine(driver, execs, mesh)
        counts = dict(EngineContext(engine).parallelize(words, 8)
                      .map(lambda w: (w, 1))
                      .reduceByKey(lambda a, b: a + b).collect())
        if counts != dict(collections.Counter(words)):
            raise AssertionError("word count differs from its truth")
        record["word_count"] = {**_planes(engine), "words": len(words),
                                "distinct": len(counts)}
        _on_device("word count", record["word_count"])

        keys = rng.integers(0, 2**64, SORT_ROWS, dtype=np.uint64)
        payload = rng.integers(0, 256, (SORT_ROWS, 8), dtype=np.uint8)
        parts = [(keys[i::8], payload[i::8]) for i in range(8)]
        engine = _mesh_engine(driver, execs, mesh)
        out = EngineContext(engine).batches(parts).sort_by_key(
            16).collect_batches()
        order = np.argsort(keys, kind="stable")
        if not (np.array_equal(np.concatenate([k for k, _ in out]),
                               keys[order])
                and np.array_equal(np.concatenate([p for _, p in out]),
                                   payload[order])):
            raise AssertionError("sort_by_key differs from a numpy sort")
        record["sort_by_key"] = {**_planes(engine), "rows": SORT_ROWS}
        _on_device("sort_by_key", record["sort_by_key"])

        # every key in partition 0 of 4: shard 0 receives all rows, past
        # the engine's receive headroom
        skew_p, skew_maps, skew_rows = 4, 4, 5000

        def skew_table(m):
            r = np.random.default_rng(300 + m)
            return (r.integers(0, 1000, skew_rows).astype(np.uint64)
                    * skew_p,
                    r.integers(0, 256, (skew_rows, 4), dtype=np.uint8))

        def skew_map(ctx, writer, task_id):
            writer.write(skew_table(task_id))

        def skew_reduce(ctx, task_id):
            return ctx.read(0)._r.read_all()

        engine = _mesh_engine(driver, execs, mesh)
        out = engine.run(ResultStage(skew_p, skew_reduce, parents=[
            MapStage(skew_maps, ShuffleDependency(
                skew_p, PartitionerSpec("modulo"), row_payload_bytes=4),
                skew_map)]))
        skew = _planes(engine)
        if skew["degrades"] != ["overflow"]:
            raise AssertionError(f"skewed stage did not degrade: {skew}")
        k_all, p_all = (np.concatenate(c) for c in zip(
            *(skew_table(m) for m in range(skew_maps))))
        got_k, got_p = out[0]

        def canon(k, v):
            rows = np.concatenate([k.view(np.uint8).reshape(-1, 8), v], 1)
            return rows[np.lexsort(rows.T[::-1])]

        if not (np.array_equal(canon(got_k, got_p), canon(k_all, p_all))
                and all(len(k) == 0 for k, _ in out[1:])):
            raise AssertionError("degraded stage differs from its truth")
        record["overflow_degrade"] = {**skew, "rows": int(len(got_k))}
    return record


def phase_small_runs(mesh: VirtualMesh) -> None:
    """Small runs of every workload on the card against the numpy
    oracles: integers exact, floats at the tests' tolerances."""
    rng = np.random.default_rng(7)
    per = 50
    dest = rng.integers(0, SHARDS, SHARDS * per).astype(np.uint32)
    rows = np.stack([dest, rng.integers(0, 2**32, SHARDS * per,
                                        dtype=np.uint32)], axis=1)
    for s in range(SHARDS):   # destination-grouped per source
        seg = slice(s * per, (s + 1) * per)
        rows[seg] = rows[seg][np.argsort(rows[seg, 0], kind="stable")]
    counts = np.stack([np.bincount(rows[s * per:(s + 1) * per, 0],
                                   minlength=SHARDS) for s in range(SHARDS)])
    received, rounds = chunked_exchange(mesh, rows, counts, quota=7)
    for got, want in zip(received,
                         _stable_grouping(rows, rows[:, 0], SHARDS)):
        np.testing.assert_array_equal(got, want)

    cfg = als.ALSConfig(num_users=64, num_items=16, rank=4, zipf_a=1.3)
    ratings = als.generate_ratings(cfg, SHARDS, 80, seed=5)
    fixed = rng.normal(size=(cfg.num_users, cfg.rank)).astype(np.float32)
    factors, als_rounds = als.als_half_step(mesh, cfg, ratings, fixed, 16)
    np.testing.assert_allclose(
        factors, als.numpy_als_half_step(ratings, fixed, cfg), rtol=2e-2,
        atol=1e-3)
    cfg = als.ALSConfig(num_users=96, num_items=24, rank=6, zipf_a=1.3)
    _, _, history, _ = als.run_als(
        mesh, cfg, als.generate_ratings(cfg, SHARDS, 160, seed=8), quota=32,
        iterations=3, seed=8)
    if not (history[1] < 0.5 * history[0]
            and history[3] <= history[2] <= history[1]):
        raise AssertionError(f"ALS RMSE did not fall: {history}")

    cfg = pagerank.PageRankConfig(num_vertices=64, edges_per_device=96,
                                  out_factor=SHARDS)
    edges, _, _ = pagerank.random_graph(cfg, SHARDS, seed=3)
    np.testing.assert_allclose(
        pagerank.run_pagerank(mesh, cfg, 5, seed=3),
        pagerank.numpy_pagerank(edges, cfg.num_vertices, cfg.damping, 5),
        rtol=1e-4)

    cfg = join.JoinConfig(rows_per_device_left=128, rows_per_device_right=96,
                          key_space=256, out_factor=4)
    tables = join.generate_tables(cfg, SHARDS, seed=7)
    if join.run_join(mesh, cfg, tables=tables) != join.numpy_join(*tables):
        raise AssertionError("small join disagrees with its oracle")

    for cfg, seed in ((tpcds.TpcdsConfig(fact_rows_per_device=512,
                                         dim1_size=200, dim2_size=300,
                                         num_groups=64, out_factor=4), 3),
                      (tpcds.TpcdsConfig(fact_rows_per_device=256,
                                         dim1_size=50, dim2_size=80,
                                         num_groups=32, zipf_a=1.05,
                                         out_factor=8), 11)):
        star = tpcds.generate_star(cfg, SHARDS, seed)
        for got, want in zip(tpcds.run_tpcds(mesh, cfg, star=star),
                             tpcds.numpy_tpcds(*star, cfg.num_groups)):
            np.testing.assert_array_equal(got, want)

    for run, gen, oracle, cfg in (
            (tpcds_queries.run_q95, tpcds_queries.generate_q95,
             tpcds_queries.numpy_q95,
             tpcds_queries.Q95Config(ws_rows_per_device=768,
                                     num_orders=600)),
            (tpcds_queries.run_q64, tpcds_queries.generate_q64,
             tpcds_queries.numpy_q64,
             tpcds_queries.Q64Config(ss_rows_per_device=640,
                                     cs_rows_per_device=512,
                                     num_items=300))):
        tables = gen(cfg, SHARDS, 9)
        if run(mesh, cfg, tables=tables) != oracle(*tables, cfg):
            raise AssertionError(f"small {run.__name__} disagrees with "
                                 "its oracle")
    engine_jobs = _small_engine_runs(mesh)
    emit({"phase": "small_runs", "chunked_rounds": rounds,
          "als_rounds": als_rounds, "als_rmse": history,
          "engine_jobs": engine_jobs, "all_match_oracles": True})


def _digest(*arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).view(np.uint8).data)
    return h.hexdigest()


def _partition_digests(results) -> dict:
    """Per partition, the digest of its keys and payload in the order a
    reduce returned them (key-sorted): ``{partition: sha1}``."""
    out = {}
    for keys, payload, parts in results:
        order = np.argsort(parts, kind="stable")
        parts = parts[order]
        edges = np.flatnonzero(np.diff(parts)) + 1
        for seg in np.split(np.arange(len(parts)), edges):
            if len(seg):
                rows = order[seg]
                out[int(parts[seg[0]])] = _digest(keys[rows], payload[rows])
    return out


def _peer_shape_check(mesh, shape, seed: int) -> dict:
    """The cross-process launch at ``shape = (Dl, G, C, W)`` against the
    plain move of the same global blocks (every process draws all ``G``
    sources from ``seed`` and sends its own), then CUDA-event times of
    this process's launch into the arenas, of the same launch into a
    local buffer (``local_dst_ms``: what the IPC mapping costs), of the
    plain PyTorch block moves of the same bytes, of one library copy
    doing them, the host's time per range launch, and the byte bound. The processes time in turn, each
    while the others wait at a barrier, so no other process's kernel
    runs meanwhile."""
    dl, g, c, w = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    glob = torch.randint(-2**31, 2**31 - 1, (g, g, c, w), dtype=torch.int32,
                         device="cuda", generator=gen)
    lo = mesh.first_shard
    mine = glob[lo:lo + dl].contiguous()
    got = ring_exchange.ring_all_to_all_peers(mine, mesh).clone()
    want = ring_exchange.ring_all_to_all_plain(glob)[lo:lo + dl]
    torch.cuda.synchronize()
    dist.barrier(group=mesh.group)   # both arenas read before timing
    err = _max_abs_err(got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"ring_all_to_all_peers != plain at {shape}")
    del got, want, glob
    src, dst = ring_exchange._peer_pointer_table(mine, mesh.arena.bases)
    full = torch.empty((g, g, c, w), dtype=torch.int32, device="cuda")
    local_dst = [full[j].data_ptr() for j in range(g)]

    def plain():
        for i in range(dl):
            for j in range(g):
                full[j, lo + i].copy_(mine[i, j])

    times = {}
    for turn in range(mesh.num_processes):
        if turn == mesh.rank:
            times = {
                "ms": cuda_ms(lambda: ring_exchange._launch(
                    mine, src, dst, src_begin=lo)),
                "local_dst_ms": cuda_ms(lambda: ring_exchange._launch(
                    mine, src, local_dst, src_begin=lo)),
                # the pointer table and the launch, without the fences
                "host_us_per_launch": _host_us_per_launch(
                    lambda: ring_exchange._launch(
                        mine, *ring_exchange._peer_pointer_table(
                            mine, mesh.arena.bases), src_begin=lo)),
                "plain_ms": cuda_ms(plain, repeats=3, per_repeat=2),
                "library_ms": cuda_ms(lambda: full[:, lo:lo + dl].copy_(
                    mine.transpose(0, 1)))}
            torch.cuda.synchronize()
        dist.barrier(group=mesh.group)
    moved = 2 * mine.numel() * 4
    return {"shape": list(shape), "max_abs_err": err,
            "bytes_moved": moved, **times,
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def _peer_ragged_check(mesh, shape, seed: int) -> dict:
    """The ragged kernel's cross-process launch at ``shape = (Dl, G, cap,
    W, out_cap)`` against its plain version over the global data: every
    process draws all ``G`` sources and the ``[G, G]`` random counts from
    ``seed`` and sends its own through ``ragged_all_to_all_peers``; its
    receivers must equal ``ragged_all_to_all_plain`` over all ``G``
    sources, sliced to its shards. Then CUDA-event times of this
    process's range launch into the peers' arenas (``ms``) and into a
    local buffer (``local_dst_ms``: what the IPC mapping costs), of the
    plain PyTorch slice copies of the same pairs into the local buffer,
    the host's time per range launch (pointer table, scratch and launch,
    without the fences), and the byte bound of the rows this process's
    sources move (each read once and written once). The processes time
    in turn, each while the others wait at a barrier."""
    dl, g, cap, w, out_cap = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    glob = torch.randint(-2**31, 2**31 - 1, (g, cap, w), dtype=torch.int32,
                         device="cuda", generator=gen)
    mat = _native_counts("random", g, cap, seed)
    lo = mesh.first_shard
    mine = glob[lo:lo + dl].contiguous()
    got = ragged_exchange.ragged_all_to_all_peers(
        mine, mat, torch.zeros((dl, out_cap, w), dtype=torch.int32,
                               device="cuda"), mesh)
    want = ragged_exchange.ragged_all_to_all_plain(
        glob, mat, torch.zeros((g, out_cap, w), dtype=torch.int32,
                               device="cuda"))[lo:lo + dl]
    torch.cuda.synchronize()
    err = _max_abs_err(got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"ragged_all_to_all_peers != plain at {shape}")
    del got, want, glob
    m = mat.cpu().numpy().astype(np.int64)
    starts = np.cumsum(m, axis=1) - m
    lands = np.cumsum(m, axis=0) - m
    pairs = []
    for i in range(dl):
        for j in range(g):
            s = lo + i
            rows = min(int(m[s, j]), cap - int(starts[s, j]),
                       out_cap - int(lands[s, j]))
            if rows > 0:
                pairs.append((i, j, int(starts[s, j]), int(lands[s, j]),
                              rows))
    src, dst = ragged_exchange._ragged_peer_pointer_table(
        mine, mesh.arena.bases, out_cap)
    full = torch.empty((g, out_cap, w), dtype=torch.int32, device="cuda")
    local_dst = [full[j].data_ptr() for j in range(g)]
    book = ragged_exchange._book(g, mine.device)

    def launch(bases):
        return lambda: ragged_exchange._launch_range(mine, mat, book, src,
                                                     bases, lo, out_cap)

    def plain():
        for i, j, start, land, rows in pairs:
            full[j, land:land + rows].copy_(mine[i, start:start + rows])

    def host_launch():
        ragged_exchange._launch_range(
            mine, mat, ragged_exchange._book(g, mine.device),
            *ragged_exchange._ragged_peer_pointer_table(
                mine, mesh.arena.bases, out_cap), lo, out_cap)

    times = {}
    for turn in range(mesh.num_processes):
        if turn == mesh.rank:
            times = {"ms": cuda_ms(launch(dst)),
                     "local_dst_ms": cuda_ms(launch(local_dst)),
                     "host_us_per_launch": _host_us_per_launch(host_launch),
                     "plain_ms": cuda_ms(plain, repeats=3, per_repeat=2)}
            torch.cuda.synchronize()
        dist.barrier(group=mesh.group)
    rows = sum(p[4] for p in pairs)
    moved = 2 * rows * w * 4
    return {"shape": list(shape), "max_abs_err": err, "counts": "random",
            "rows_moved": rows, "bytes_moved": moved, **times,
            "library_ms": None, "bound_ms": moved / HBM_BYTES_PER_S * 1e3}


def multihost_worker(rank: int, port: str, work_dir: str) -> None:
    """One process of the ``multihost`` phase: prints one line
    ``MULTIHOST_WORKER {json}`` and exits 0, or raises."""
    t_start = time.perf_counter()
    multihost.init_multihost(f"127.0.0.1:{port}", MH_PROCESSES, rank,
                             local_device_count=MH_LOCAL_SHARDS,
                             platform="cuda")
    _count_take_rows()
    _count_groupings()
    _count_lookups()
    _count_range_steps()
    mesh = multihost.global_mesh("shuffle")
    dl, g = mesh.local_shards, mesh.num_shards
    report = {"rank": rank, "init_s": time.perf_counter() - t_start}
    shapes_seen = {NATIVE: {}, RING: {}}

    # TeraSort at the main path's size, this process's half of it: under
    # auto (the ragged kernel's range launch) and under the ring, in turns
    # (auto, ring, ring, auto: the first run also pays the arena's
    # growth), each run's shards digest-checked
    rpd = DATA_BYTES // 100 // SHARDS
    report["terasort"] = {}
    kernel_of = {"auto": ("multihost/terasort", NATIVE),
                 "ring": ("multihost/terasort_ring", RING)}
    for impl in ("auto", "ring", "ring", "auto"):
        path, kernel = kernel_of[impl]
        t0 = time.perf_counter()
        (ts_out, ts_counts), launches, shapes = _launches(
            path, lambda impl=impl: multihost.run_multihost_terasort(
                mesh, "shuffle", rpd, payload_words=24, seed=0, impl=impl),
            kernel)
        wall = time.perf_counter() - t0
        per = ts_out.reshape(dl, -1, ts_out.shape[-1])
        digests, rows = [], 0
        for d in range(dl):
            total = int(ts_counts[d].sum())
            keys = per[d][:total, 0]
            if not (np.diff(keys.astype(np.int64)) >= 0).all():
                raise AssertionError(f"process {rank} shard {d} unsorted "
                                     f"({impl})")
            digests.append(_digest(per[d][:total]))
            rows += total
        del ts_out, per
        run = report["terasort"].setdefault(impl, {
            "path": path, "kernel": kernel, "wall_s": [], "rows": rows,
            "digests": digests, "kernel_launches": 0, "kernel_shapes": {},
            "merge_launches": 0})
        if digests != run["digests"]:
            raise AssertionError(f"process {rank}: two TeraSort runs under "
                                 f"{impl} differ")
        run["wall_s"].append(wall)
        run["kernel_launches"] += launches
        run["merge_launches"] += MERGE_OF_PATH[path]
        for k, v in shapes.items():
            run["kernel_shapes"][k] = run["kernel_shapes"].get(k, 0) + v
        shapes_seen[kernel].update(shapes)
    for run in report["terasort"].values():
        run["kernel_shapes"] = [[list(k), v]
                                for k, v in run["kernel_shapes"].items()]
    # the step alone, both transports timed in turns (auto, ring, ring,
    # auto), then one traced step of each
    cfg = TeraSortConfig(rows_per_device=rpd, payload_words=24,
                         out_factor=2)
    rows_d = multihost.shard_local_rows(
        mesh, "shuffle", generate_rows(cfg, dl, seed=rank), g * rpd)
    steps = {impl: make_terasort_step(mesh, cfg, impl)
             for impl in ("auto", "ring")}
    samples = {impl: [] for impl in steps}
    for impl in ("auto", "ring", "ring", "auto"):
        samples[impl] += _host_times_ms(lambda: steps[impl](rows_d),
                                        STEP_SAMPLES // 2)
    report["terasort_steps"] = {impl: _timing(sorted(t))
                                for impl, t in samples.items()}
    report["terasort_profile"] = {
        impl: _trace(lambda: step(rows_d), ("fused.", "exchange."))
        for impl, step in steps.items()}
    del rows_d, steps
    torch.cuda.empty_cache()

    # the mesh-service stage as a two-process job
    conf = TpuShuffleConf(connect_timeout_ms=5000)
    addr_file = os.path.join(work_dir, "driver_addr.txt")
    driver = None
    if rank == 0:
        driver = SparkCompatShuffleManager(conf, isDriver=True)
        handle = driver.native.register_shuffle(
            MS_SHUFFLE_ID, MS_MAPS, MS_PARTITIONS, MS_PARTITIONER,
            row_payload_bytes=MS_PAYLOAD)
        with open(addr_file + ".tmp", "w") as f:
            f.write("%s:%d" % driver.driverAddr)
        os.replace(addr_file + ".tmp", addr_file)   # atomic publish
        driver_addr = driver.driverAddr
    else:
        handle = ShuffleHandle(MS_SHUFFLE_ID, MS_MAPS, MS_PARTITIONS,
                               MS_PAYLOAD, MS_PARTITIONER)
        deadline = time.monotonic() + 120
        while not os.path.exists(addr_file):
            if time.monotonic() > deadline:
                raise RuntimeError("the driver's address never appeared")
            time.sleep(0.05)
        host, p = open(addr_file).read().split(":")
        driver_addr = (host, int(p))
    ex = SparkCompatShuffleManager(
        conf, driverAddr=driver_addr, executorId=f"w{rank}",
        spill_dir=os.path.join(work_dir, f"spill{rank}"))
    try:
        ex.native.executor.wait_for_members(MH_PROCESSES)
        t0 = time.perf_counter()
        keys, payload, _ = _mesh_records()
        per_proc = MS_MAPS // MH_PROCESSES
        for m in range(rank * per_proc, (rank + 1) * per_proc):
            rows_m = slice(m * MS_MAP_ROWS, (m + 1) * MS_MAP_ROWS)
            writer = ex.native.get_writer(handle, m)
            writer.write_batch(keys[rows_m], payload[rows_m])
            writer.close()
        del keys, payload
        report["commit_s"] = time.perf_counter() - t0
        runs = {}
        for name, kw in (("one_shot", {}),
                         ("rounds", {"rows_per_round": MS_ROWS_PER_ROUND})):
            before = topology.cross_slice_snapshot()
            t0 = time.perf_counter()
            result, launches, shapes = _launches(
                f"multihost/mesh_{name}",
                lambda kw=kw: multihost.run_multihost_mesh_reduce(
                    [ex.native], handle, mesh, out_factor=MS_OUT_FACTOR,
                    **kw), NATIVE)
            wall = time.perf_counter() - t0
            after = topology.cross_slice_snapshot()
            runs[name] = {
                "wall_s": wall, "kernel_launches": launches,
                "kernel_shapes": [[list(k), v] for k, v in shapes.items()],
                "rows": int(sum(len(k) for k, _, _ in result)),
                "cross_slice_bytes": after["bytes"] - before["bytes"],
                "partition_digests": _partition_digests(result)}
            shapes_seen[NATIVE].update(shapes)
            del result
        topo = topology.detect_topology(mesh)
        report["mesh"] = {"runs": runs, "slices": list(topo.slice_sizes),
                          "flat": topo.is_flat}
        report["mesh_profile"] = _trace(
            lambda: multihost.run_multihost_mesh_reduce(
                [ex.native], handle, mesh, out_factor=MS_OUT_FACTOR),
            ("exchange.", "fused."))
        dist.barrier(group=mesh.group)   # the driver outlives the readers
    finally:
        ex.stop()
        if driver is not None:
            driver.stop()
    report["ragged_checks"] = [
        _peer_ragged_check(mesh, shape, 30 + i)
        for i, shape in enumerate(sorted(shapes_seen[NATIVE]))]
    report["kernel_checks"] = [
        _peer_shape_check(mesh, shape, 50 + i)
        for i, shape in enumerate(sorted(shapes_seen[RING]))]
    _check_merge_launches()
    _check_partition_launches()
    _check_lookup_launches()
    report["ipc"] = dict(ring_exchange.PEER)
    report["wall_s"] = time.perf_counter() - t_start
    multihost.shutdown_multihost()
    print("MULTIHOST_WORKER " + json.dumps(report), flush=True)


def _terasort_reference(cfg: TeraSortConfig) -> list:
    """Per global shard, the digest of the single-process ``VirtualMesh(8)``
    TeraSort step's valid rows over both processes' slices (each process
    generates from seed ``seed * 100_003 + rank``, here seed 0)."""
    rows = np.concatenate([generate_rows(cfg, MH_LOCAL_SHARDS, seed=p)
                           for p in range(MH_PROCESSES)])
    mesh = VirtualMesh(SHARDS)
    out, counts, overflowed = make_terasort_step(mesh, cfg, "ring")(
        rows_from_numpy(rows, mesh))
    if bool(overflowed.any()):
        raise AssertionError("reference TeraSort overflowed")
    del rows
    out = rows_to_numpy(out).reshape(SHARDS, -1, 1 + cfg.payload_words)
    counts = counts.cpu().numpy()
    return [_digest(out[d][:int(counts[d].sum())]) for d in range(SHARDS)]


def phase_multihost(table: dict, cfg: TeraSortConfig,
                    want_partitions: dict) -> dict:
    """The multi-process path (module docstring, phase 14). Returns the
    kernel's launches per path."""
    t0 = time.perf_counter()
    want_ts = _terasort_reference(cfg)
    reference_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    root = os.path.dirname(os.path.abspath(__file__))
    env = _child_env()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mh_") as work:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), MH_WORKER_FLAG,
             str(rank), port, work], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env, cwd=root)
            for rank in range(MH_PROCESSES)]
        outputs = []
        try:
            for proc in procs:
                left = MH_TIMEOUT_S - (time.perf_counter() - t0)
                outputs.append(proc.communicate(timeout=max(1, left))[0]
                               .decode(errors="replace"))
        finally:
            for proc in procs:
                proc.kill()
                proc.wait()
        wall_s = time.perf_counter() - t0
    reports = []
    for rank, (proc, text) in enumerate(zip(procs, outputs)):
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("MULTIHOST_WORKER ")]
        if proc.returncode != 0 or not lines:
            raise AssertionError(f"multihost worker {rank} failed (exit "
                                 f"{proc.returncode}):\n{text[-4000:]}")
        reports.append(json.loads(lines[-1][len("MULTIHOST_WORKER "):]))

    for impl in ("auto", "ring"):
        got_ts = [dg for r in reports for dg in r["terasort"][impl]["digests"]]
        if got_ts != want_ts:
            bad = [i for i, (a, b) in enumerate(zip(got_ts, want_ts))
                   if a != b]
            raise AssertionError(f"multihost TeraSort ({impl}) shards {bad} "
                                 "differ from the single-process step")
        ts_rows = sum(r["terasort"][impl]["rows"] for r in reports)
        if ts_rows != SHARDS * cfg.rows_per_device:
            raise AssertionError(f"multihost TeraSort ({impl}) holds "
                                 f"{ts_rows} rows")
    for name in ("one_shot", "rounds"):
        got = {}
        for r in reports:
            got.update({int(k): v for k, v in
                        r["mesh"]["runs"][name]["partition_digests"].items()})
        if got != want_partitions:
            bad = sorted(p for p in want_partitions
                         if got.get(p) != want_partitions[p])
            raise AssertionError(f"multihost mesh reduce {name}: "
                                 f"partitions {bad[:10]} differ from the "
                                 "oracle")
        if sum(r["mesh"]["runs"][name]["rows"] for r in reports) != MS_ROWS:
            raise AssertionError(f"multihost mesh reduce {name} lost rows")
        if any(r["mesh"]["runs"][name]["cross_slice_bytes"] <= 0
               for r in reports):
            raise AssertionError("no cross-slice bytes counted")
    rounds = min(r["mesh"]["runs"]["rounds"]["kernel_launches"]
                 for r in reports)
    if rounds < 2:
        raise AssertionError(f"the rounds reduce ran {rounds} round(s)")
    if any(r["mesh"]["flat"] or r["mesh"]["slices"] != [MH_LOCAL_SHARDS] * 2
           for r in reports):
        raise AssertionError("the global mesh's topology is not two slices")

    launches = {}
    # the kernel each path must have launched (each worker's _launches
    # failed a path that ran the other): auto over the global mesh is the
    # ragged kernel's range launch
    paths = {"multihost/terasort": (NATIVE, lambda r: r["terasort"]["auto"]),
             "multihost/terasort_ring": (RING,
                                         lambda r: r["terasort"]["ring"]),
             "multihost/mesh_one_shot": (NATIVE, lambda r: r["mesh"]["runs"][
                 "one_shot"]),
             "multihost/mesh_rounds": (NATIVE, lambda r: r["mesh"]["runs"][
                 "rounds"])}
    for impl, path in (("auto", "multihost/terasort"),
                       ("ring", "multihost/terasort_ring")):
        MERGE_OF_PATH[path] = sum(r["terasort"][impl]["merge_launches"]
                                  for r in reports)
        if not MERGE_OF_PATH[path]:
            raise AssertionError(f"the {path} path never launched {MERGE}")
    by_shape = {NATIVE: collections.defaultdict(dict),
                RING: collections.defaultdict(dict)}
    for path, (kernel, pick) in paths.items():
        KERNEL_OF_PATH[path] = kernel
        launches[path] = sum(pick(r)["kernel_launches"] for r in reports)
        if launches[path] == 0:
            raise AssertionError(f"the {path} path never launched {kernel}")
        for r in reports:
            for shape, n in pick(r)["kernel_shapes"]:
                entry = by_shape[kernel][tuple(shape)]
                entry[path] = entry.get(path, 0) + n
    # per shape, the slowest process's time and the larger of the two
    # processes' bytes and bound (the ring's are equal; each ragged
    # launch moves its own sources' rows)
    worst = ("ms", "plain_ms", "local_dst_ms", "host_us_per_launch",
             "bytes_moved", "bound_ms")
    for kernel, key in ((NATIVE, "ragged_checks"), (RING, "kernel_checks")):
        checks = {}
        for r in reports:
            for c in r[key]:
                checks.setdefault(tuple(c["shape"]), []).append(c)
        if set(checks) != set(by_shape[kernel]):
            raise AssertionError(f"a cross-process shape of {kernel} went "
                                 "unchecked")
        row = table[kernel]
        for shape, per_proc in sorted(checks.items()):
            err = max(c["max_abs_err"] for c in per_proc)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            entry = {"shape": list(shape), "processes": MH_PROCESSES,
                     "shared_card": True,
                     **{k: max(c[k] for c in per_proc) for k in worst},
                     "library_ms": (None if kernel == NATIVE else
                                    max(c["library_ms"] for c in per_proc)),
                     "ms_by_process": [c["ms"] for c in per_proc],
                     "bound_ms_by_process": [c["bound_ms"]
                                             for c in per_proc],
                     "max_abs_err": err,
                     "launches_by_path": by_shape[kernel][shape]}
            row["by_shape"].append(entry)
    emit({"phase": "multihost", "processes": MH_PROCESSES,
          "local_shards": MH_LOCAL_SHARDS, "wall_s": wall_s,
          "reference_s": reference_s, "terasort_exact": True,
          "terasort_ring_exact": True, "mesh_exact": True,
          "mesh_rounds": rounds, "launches_by_path": launches,
          "workers": [{
              "rank": r["rank"], "wall_s": r["wall_s"],
              "init_s": r["init_s"], "commit_s": r["commit_s"],
              "ipc": r["ipc"],
              "terasort": {impl: {k: v for k, v in run.items()
                                  if k != "digests"}
                           for impl, run in r["terasort"].items()},
              "terasort_steps": r["terasort_steps"],
              "terasort_profile": r["terasort_profile"],
              "mesh": {name: {k: v for k, v in run.items()
                              if k != "partition_digests"}
                       for name, run in r["mesh"]["runs"].items()},
              "mesh_profile": {k: r["mesh_profile"][k] for k in (
                  "wall_ms", "device_busy_ms", "idle_share", "spans")},
              "ragged_checks": r["ragged_checks"],
              "kernel_checks": r["kernel_checks"]} for r in reports]})
    return launches


# ---------------------------------------------------------------------------
# cli_and_benches: the command line and the device benches
# ---------------------------------------------------------------------------

CLI_SUBPROCESS = ("info", "config", "selftest", "engine-demo", "rdd-demo")
CLI_TIMEOUT_S = 240         # per command, start to finish
SVC_MAPS = 4                # the shuffle-service step: 4 maps of 2**18
SVC_MAP_ROWS = 1 << 18      # 100-byte records (100 MiB), 2 per executor,
SVC_PARTITIONS = 16         # modulo-partitioned
SVC_SHUFFLE_ID = 11
SVC_BANNER_S = 60
# device_bench at a real stage size: the mesh_service phase's records
# (92-byte payload, 200 partitions, 8 maps) cut to 256 MiB, since the
# host side reads every byte over loopback TCP three times
DB_STAGE = dict(num_maps=MS_MAPS, num_partitions=MS_PARTITIONS,
                rows_per_map=335_544, payload_bytes=MS_PAYLOAD)
TOPO_ROWS_PER_DEV = 65_536  # 6 MiB: ~3 s of modelled flat-side sleep a run
# client_bench at its main()'s defaults
CLIENT_BENCH = dict(file_mb=64, total_mb=512, block_kb=256)


def _child_env() -> dict:
    """This process's environment with the checkout first on
    ``PYTHONPATH``, for the processes the script starts."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _cli_subprocesses() -> dict:
    """``python -m sparkrdma_tpu_torch <cmd>`` for each command of
    ``CLI_SUBPROCESS``, all started together; each must exit 0, ``info``
    must name the card, and each JSON line must say it verified."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = {cmd: subprocess.Popen(
        [sys.executable, "-m", "sparkrdma_tpu_torch", cmd],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_child_env(), cwd=root) for cmd in CLI_SUBPROCESS}
    out = {}
    try:
        for cmd, proc in procs.items():
            left = CLI_TIMEOUT_S - (time.perf_counter() - t0)
            stdout, stderr = proc.communicate(timeout=max(1, left))
            if proc.returncode != 0:
                raise AssertionError(f"`python -m sparkrdma_tpu_torch {cmd}` "
                                     f"exited {proc.returncode}:\n"
                                     f"{stderr[-3000:]}")
            out[cmd] = stdout
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    name = torch.cuda.get_device_name(0)
    devices = [ln for ln in out["info"].splitlines()
               if ln.startswith("devices:")]
    if devices != [f"devices: {torch.cuda.device_count()} x {name} (cuda)"]:
        raise AssertionError(f"info does not name the card: {out['info']}")
    if len(out["config"].splitlines()) != len(_CONF_KEYS):
        raise AssertionError("config printed the wrong number of keys")
    checks = {"selftest": ("selftest", "ok"),
              "engine-demo": ("oracle_exact", True),
              "rdd-demo": ("verified", True)}
    records = {}
    for cmd, (key, want) in checks.items():
        lines = _json_lines(out[cmd])
        if len(lines) != 1 or lines[0].get(key) != want:
            raise AssertionError(f"{cmd} did not verify: {out[cmd]}")
        records[cmd] = lines[0]
    return {"wall_s": time.perf_counter() - t0, "info": out["info"]
            .splitlines(), "config_keys": len(_CONF_KEYS), **records}


def _cli_in_process(argv) -> dict:
    """``main(argv)`` of the port's CLI in this process (so its kernel
    launches count here); it must exit 0 and print one JSON line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    lines = _json_lines(buf.getvalue())
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"{argv} exited {rc}: {buf.getvalue()}")
    return lines[0]


def _service_records():
    """The shuffle-service step's maps: unique u64 keys (a shuffled
    stride, so each partition sorts to one order) and random payload
    bytes, from seed 5."""
    rng = np.random.default_rng(5)
    n = SVC_MAPS * SVC_MAP_ROWS
    keys = rng.permutation(n).astype(np.uint64) * np.uint64(0x9E3779B1)
    payload = np.frombuffer(rng.bytes(n * MS_PAYLOAD), np.uint8).reshape(
        n, MS_PAYLOAD)
    return keys, payload


def _shuffle_service_step() -> dict:
    """``python -m sparkrdma_tpu_torch shuffle-service`` as a real
    process: two executors commit ``SVC_MAPS`` maps, executor 1 stops
    (its spill directory survives), the service adopts that directory and
    re-publishes its committed outputs, and executor 0 reads every
    partition exactly with no map recomputed; SIGTERM then ends the
    service with exit 0."""
    root = os.path.dirname(os.path.abspath(__file__))
    keys, payload = _service_records()
    conf = TpuShuffleConf(connect_timeout_ms=5000, max_connection_attempts=2)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_svc_") as tmp:
        driver = TpuShuffleManager(conf, is_driver=True)
        execs = [TpuShuffleManager(conf, driver_addr=driver.driver_addr,
                                   executor_id=str(i),
                                   spill_dir=os.path.join(tmp, f"e{i}"))
                 for i in range(2)]
        svc = None
        try:
            for ex in execs:
                ex.executor.wait_for_members(2)
            handle = driver.register_shuffle(
                SVC_SHUFFLE_ID, num_maps=SVC_MAPS,
                num_partitions=SVC_PARTITIONS,
                partitioner=PartitionerSpec("modulo"),
                row_payload_bytes=MS_PAYLOAD)
            for m in range(SVC_MAPS):
                rows = slice(m * SVC_MAP_ROWS, (m + 1) * SVC_MAP_ROWS)
                w = execs[m % 2].get_writer(handle, m)
                w.write_batch(keys[rows], payload[rows])
                w.close()
            lost = execs[1].executor.manager_id
            execs[1].executor.stop()
            if execs[1].block_server is not None:
                execs[1].block_server.stop()
            driver.driver.remove_member(lost)
            time.sleep(0.3)

            host, port = driver.driver_addr
            t0 = time.perf_counter()
            svc = subprocess.Popen(
                [sys.executable, "-m", "sparkrdma_tpu_torch",
                 "shuffle-service", f"{host}:{port}",
                 os.path.join(tmp, "e1"), "svc1"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=_child_env(), cwd=root)
            banner = queue.Queue()
            threading.Thread(target=lambda: banner.put(svc.stdout.readline()),
                             daemon=True).start()
            try:
                line = banner.get(timeout=SVC_BANNER_S)
            except queue.Empty:
                raise AssertionError("shuffle-service printed no banner in "
                                     f"{SVC_BANNER_S} s") from None
            banner_s = time.perf_counter() - t0
            want = f"serving {SVC_MAPS // 2} recovered map outputs"
            if want not in line:
                raise AssertionError(f"shuffle-service banner: {line!r}")

            execs[0].executor.invalidate_shuffle(SVC_SHUFFLE_ID)
            t0 = time.perf_counter()
            part = keys % np.uint64(SVC_PARTITIONS)
            rows_read = 0
            for p in range(SVC_PARTITIONS):
                got_k, got_p = execs[0].get_reader(handle, p, p + 1).read_all()
                mine = np.flatnonzero(part == p)
                order = np.argsort(got_k, kind="stable")
                want_order = mine[np.argsort(keys[mine], kind="stable")]
                if not (np.array_equal(got_k[order], keys[want_order])
                        and np.array_equal(got_p[order],
                                           payload[want_order])):
                    raise AssertionError(f"partition {p} served by the "
                                         "shuffle service is not exact")
                rows_read += len(got_k)
            read_s = time.perf_counter() - t0
            svc.terminate()
            rc = svc.wait(timeout=30)
            if rc != 0:
                raise AssertionError(f"shuffle-service exited {rc} on "
                                     "SIGTERM")
        finally:
            if svc is not None and svc.poll() is None:
                svc.kill()
                svc.wait()
            for ex in execs:
                ex.stop()
            driver.stop()
    return {"banner": line.strip(), "banner_s": banner_s,
            "rows": rows_read, "bytes": rows_read * (8 + MS_PAYLOAD),
            "partitions": SVC_PARTITIONS, "read_s": read_s,
            "exact": True, "sigterm_exit": rc}


def _bench_run(table: dict, path: str, fn) -> tuple:
    """One bench run wrapped by ``_launches``: its result, the run's wall
    time (set-up and warm-up included), launches and ring shapes (each
    checked against the plain version)."""
    t0 = time.perf_counter()
    res, launches, shapes = _launches(path, fn)
    run_s = time.perf_counter() - t0
    if not res["identical"]:
        raise AssertionError(f"{path}: the two dataplanes disagree: {res}")
    return res, {"run_s": run_s, "kernel_launches": launches,
                 "kernel_shapes": _check_path_shapes(table, path, shapes)}


def phase_cli_and_benches(table: dict) -> dict:
    """The CLI and the device benches (module docstring, phase 15).
    Returns the kernel's launches per path."""
    t_phase = time.perf_counter()
    launches = {}
    cli = _cli_subprocesses()
    emit({"phase": "cli_and_benches", "step": "cli_subprocesses", **cli})

    for path, argv in (("cli/demo", ["demo"]),
                       ("cli/engine_mesh_demo", ["engine-mesh-demo"])):
        t0 = time.perf_counter()
        record, launches[path], shapes = _launches(
            path, lambda argv=argv: _cli_in_process(argv))
        if not (record.get("verified") or record.get("oracle_exact")):
            raise AssertionError(f"{argv} did not verify: {record}")
        emit({"phase": "cli_and_benches", "step": path, **record,
              "wall_s": time.perf_counter() - t0,
              "kernel_launches": launches[path],
              "kernel_shapes": _check_path_shapes(table, path, shapes)})

    emit({"phase": "cli_and_benches", "step": "shuffle_service",
          **_shuffle_service_step()})

    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp:
        for path, kw in (("device_bench/default", {}),
                         ("device_bench/stage", DB_STAGE)):
            spill = os.path.join(tmp, path.replace("/", "_"))
            res, info = _bench_run(table, path, lambda kw=kw, spill=spill:
                                   device_bench.run_device_microbench(
                                       spill, **kw))
            launches[path] = info["kernel_launches"]
            emit({"phase": "cli_and_benches", "step": path, "args": kw,
                  **res, **info})

        for rows_per_dev in (2048, TOPO_ROWS_PER_DEV):
            ring_exchange.LAUNCHES = ragged_exchange.LAUNCHES = 0
            t0 = time.perf_counter()
            res = topo_bench.run_topo_microbench(rows_per_dev=rows_per_dev)
            run_s = time.perf_counter() - t0
            cross = res["cross_slice_bytes"]
            if not (res["identical"] and res["slices"] == 2
                    and cross["hier"] < cross["flat"]):
                raise AssertionError(f"topo_bench at {rows_per_dev} rows a "
                                     f"shard: {res}")
            emit({"phase": "cli_and_benches", "step": "topo_bench",
                  "rows_per_dev": rows_per_dev, **res, "run_s": run_s,
                  "kernel_launches": {RING: ring_exchange.LAUNCHES,
                                      NATIVE: ragged_exchange.LAUNCHES}})

        for checksum in (False, True):
            t0 = time.perf_counter()
            res = client_bench.run_client_microbench(
                os.path.join(tmp, f"client_{int(checksum)}"),
                checksum=checksum, **CLIENT_BENCH)
            db = res["doorbell"]
            if not (res["identical"] and 0 < db["writevs"] < db["frames"]):
                raise AssertionError(f"client_bench: {res}")
            w2d = res["wire_to_device_ms"]
            thr = res["throughput_gb_s"]
            emit({"phase": "cli_and_benches", "step": "client_bench", **res,
                  "run_s": time.perf_counter() - t0,
                  "ratios": {
                      "cpu_python_over_native": res["cpu_speedup"],
                      "w2d_native_over_python":
                          w2d["native"] / w2d["python"],
                      "throughput_native_over_python":
                          thr["native"] / thr["python"]}})
    emit({"phase": "cli_and_benches", "step": "done",
          "wall_s": time.perf_counter() - t_phase,
          "launches_by_path": launches})
    return launches


# the analysis phase: the engine stage's records cut to 256 MiB (8 maps of
# 32 MiB, as device_bench's stage is), so the phase stays near 60 s
LG_MAP_ROWS = (32 << 20) // (8 + MS_PAYLOAD)
LG_PATH = "analysis/lockgraph_engine"
ANALYSIS_TIMEOUT_S = 300     # per process, start to finish
_MODELCHECK_LINE = re.compile(r"modelcheck: (\d+) schedule\(s\) enumerated "
                              r"\+ (\d+) random walk\(s\) \[(.*)\]")


def _analysis_static() -> dict:
    """``python -m sparkrdma_tpu_torch.analysis --model-check`` in a process
    of its own: it must exit 0 (no finding). Returns its seconds and the
    schedules enumerated per scenario (``+``: the budget was hit)."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mc_") as traces:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sparkrdma_tpu_torch.analysis",
             "--model-check", "--trace-dir", traces],
            capture_output=True, text=True, env=_child_env(), cwd=root,
            timeout=ANALYSIS_TIMEOUT_S)
        seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the analysis suite exited {proc.returncode}:"
                             f"\n{proc.stdout[-4000:]}{proc.stderr[-2000:]}")
    m = _MODELCHECK_LINE.search(proc.stdout)
    if m is None:
        raise AssertionError(f"no modelcheck line: {proc.stdout[-2000:]}")
    scenarios = dict(item.split(":") for item in m.group(3).split(", "))
    return {"seconds": seconds, "schedules": int(m.group(1)),
            "random_walks": int(m.group(2)), "by_scenario": scenarios,
            "report": proc.stdout.strip().splitlines()[-1]}


def _sanitizer_runs() -> dict:
    """Both sanitized shims, built together through ``shim_build``, and
    ``analysis/native_harness.py`` under each that built, in a process of
    its own (ASan's runtime preloaded there, never here: libasan and the
    CUDA driver do not mix). A kind whose build fails is printed as
    unavailable with the compiler's error, and its harness counts as not
    run; a harness that fails raises."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        builds = {kind: pool.submit(shim_build.sanitized_shim_path, kind)
                  for kind in ("asan", "ubsan")}
        concurrent.futures.wait(builds.values())
    runs = {"build_s": time.perf_counter() - t0}
    for kind, build in builds.items():
        try:
            lib = build.result()
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            emit({"phase": "analysis", "sanitizer": kind,
                  "sanitizers": f"unavailable: {e}"})
            runs[kind] = "unavailable"
            continue
        env = _child_env()
        if kind == "asan":
            env["LD_PRELOAD"] = subprocess.run(
                [os.environ.get("CXX", "g++"), "-print-file-name=libasan.so"],
                capture_output=True, text=True, check=True).stdout.strip()
            env["ASAN_OPTIONS"] = "detect_leaks=0"
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m",
             "sparkrdma_tpu_torch.analysis.native_harness", str(lib)],
            capture_output=True, text=True, cwd=root, env=env,
            timeout=ANALYSIS_TIMEOUT_S)
        if proc.returncode != 0 or "all exercises passed" not in proc.stdout:
            raise AssertionError(f"the {kind} harness failed (exit "
                                 f"{proc.returncode}):\n{proc.stdout[-3000:]}"
                                 f"{proc.stderr[-3000:]}")
        runs[kind] = {"passed": True, "lib": lib.name,
                      "seconds": time.perf_counter() - t1,
                      "exercises": sum(ln.lstrip().startswith("ok:")
                                       for ln in proc.stdout.splitlines())}
    return runs


def lockgraph_worker(out_path: str) -> None:
    """The analysis phase's engine stage, in a process whose lock-order
    shim went in before the port's imports (see the top of this file):
    the records cut to ``LG_MAP_ROWS`` a map, a ``DAGEngine`` job on
    ``VirtualMesh(8)``, every partition held byte-equal to the oracle;
    writes the graph's verdict, the kernel's launches and shapes, and the
    walls to ``out_path`` as JSON."""
    from sparkrdma_tpu_torch.analysis import lockgraph

    graph = lockgraph.current()
    if graph is None:
        raise AssertionError("the lock-order shim is not installed")
    _count_take_rows()
    _count_groupings()
    _count_lookups()
    keys, payload, generate_s = _mesh_records(MS_MAPS * LG_MAP_ROWS)
    t0 = time.perf_counter()
    want = mesh_service.split_by_partition(_mesh_oracle(keys, payload),
                                           MS_PARTITIONS, MS_PAYLOAD)
    oracle_s = time.perf_counter() - t0
    mesh = VirtualMesh(SHARDS)
    with _engine_cluster() as (driver, execs):
        engine = _mesh_engine(driver, execs, mesh)
        reads = []
        t0 = time.perf_counter()
        out, launches, shapes = _launches(LG_PATH, lambda: engine.run(
            _engine_stage(keys, payload, reads, LG_MAP_ROWS)))
        job_s = time.perf_counter() - t0
    lockgraph.uninstall()
    chosen = _planes(engine)
    _on_device(LG_PATH, chosen)
    for p, ((k, v, remote), (wk, wv)) in enumerate(zip(out, want)):
        if remote or not (np.array_equal(k, wk) and np.array_equal(v, wv)):
            raise AssertionError(f"{LG_PATH}: partition {p} differs from "
                                 f"the oracle ({remote} remote bytes)")
    stages = {("map" if "shuffle" in e["args"] else "result"):
              e["dur"] / 1e6 for e in engine.tracer.events("engine.stage")}
    sites = sorted({o._site for o in gc.get_objects()
                    if isinstance(o, lockgraph._TrackedLock)})
    with open(out_path, "w") as f:
        json.dump({
            "rows": int(sum(len(k) for k, _, _ in out)),
            "generate_s": generate_s, "oracle_s": oracle_s, "job_s": job_s,
            "map_stage_s": stages.get("map"),
            "result_stage_s": stages.get("result"),
            "reduce_s": (max(end for _, end in reads)
                         - min(start for start, _ in reads)),
            "rounds": chosen["rounds"], "launches": launches,
            "shapes": [[list(k), n] for k, n in sorted(shapes.items())],
            "orderings": sorted(f"{a} -> {b}" for a, b in graph.edges()),
            "tracked_sites": sites, "cycles": graph.cycles(),
            "report": graph.format_cycles()}, f)


def phase_analysis(table: dict) -> dict:
    """The port's analysis suite on the card machine (module docstring,
    phase 16). Returns the kernel's launches per path."""
    t_phase = time.perf_counter()
    static = _analysis_static()
    emit({"phase": "analysis", "step": "static_and_modelcheck", **static})
    emit({"phase": "analysis", "step": "sanitizers", **_sanitizer_runs()})

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lg_") as work:
        out_path = os.path.join(work, "verdict.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), LG_WORKER_FLAG,
             out_path], capture_output=True, text=True, env=_child_env(),
            cwd=root, timeout=ANALYSIS_TIMEOUT_S)
        process_s = time.perf_counter() - t0
        if proc.returncode != 0 or not os.path.exists(out_path):
            raise AssertionError(f"the lockgraph worker failed (exit "
                                 f"{proc.returncode}):\n{proc.stdout[-3000:]}"
                                 f"{proc.stderr[-3000:]}")
        with open(out_path) as f:
            res = json.load(f)
    if res["cycles"]:
        raise AssertionError(f"{LG_PATH}: {res['report']}")
    shapes = {tuple(shape): n for shape, n in res.pop("shapes")}
    KERNEL_OF_PATH[LG_PATH] = NATIVE     # auto on a VirtualMesh
    staged = MS_MAPS * LG_MAP_ROWS * (8 + MS_PAYLOAD)
    emit({"phase": "analysis", "step": "lockgraph_engine",
          "cut": f"the engine stage's records cut from 1 GiB to "
                 f"{round(staged / 2**20)} MiB ({MS_MAPS} maps of "
                 f"{LG_MAP_ROWS} rows), as device_bench's stage",
          "executors": ENGINE_EXECUTORS, "partitions": MS_PARTITIONS,
          **res, "distinct_orderings": len(res["orderings"]),
          "process_s": process_s, "acyclic": True, "all_exact": True,
          "reduce_gb_per_s": staged / res["reduce_s"] / 1e9,
          "kernel_launches": res["launches"],
          "kernel_shapes": _check_path_shapes(table, LG_PATH, shapes)})
    emit({"phase": "analysis", "step": "done",
          "wall_s": time.perf_counter() - t_phase})
    return {LG_PATH: res["launches"]}


def main() -> None:
    phase_device()
    phase_build()
    cfg = TeraSortConfig(rows_per_device=DATA_BYTES // 100 // SHARDS)
    _count_take_rows()
    _count_groupings()
    table = {RING: phase_kernel(cfg), NATIVE: phase_kernel_native(cfg)}
    gather_row = phase_kernel_gather()
    merge_row = phase_kernel_merge()
    partition_row = phase_kernel_partition()
    lookup_row = phase_kernel_lookup()
    _count_range_steps()
    _count_lookups()
    launches = phase_main_path(cfg, table)
    launches.update(phase_streamed(cfg, table))
    launches.update(phase_bench(table))
    phase_kernel_chunked(table[RING])
    mesh = VirtualMesh(SHARDS)
    launches["chunked/als"] = phase_als(mesh, table)
    launches["pagerank"] = phase_pagerank(mesh, table)
    launches["join"] = phase_join(mesh, table)
    launches["tpcds"] = phase_tpcds(mesh, table)
    launches["q95"] = phase_q95(mesh, table)
    launches["q64"] = phase_q64(mesh, table)
    launches["fused_rounds"], rows, dest, flat = phase_fused_rounds(mesh,
                                                                    table)
    launches["hierarchical"] = phase_hierarchical(mesh, table, rows, dest,
                                                  flat)
    del rows, dest, flat
    keys, payload, generate_s = _mesh_records()
    mesh_launches, want = phase_mesh_service(mesh, table, keys, payload,
                                             generate_s)
    launches.update(mesh_launches)
    launches.update(phase_engine(mesh, table, keys, payload, want))
    del keys, payload
    want_partitions = _partition_digests(want)
    del want
    launches.update(phase_engine_q95(mesh, table))
    phase_small_runs(mesh)
    launches.update(phase_multihost(table, cfg, want_partitions))
    launches.update(phase_cli_and_benches(table))
    launches.update(phase_analysis(table))
    for kernel, row in table.items():
        mine = {path: n for path, n in launches.items()
                if KERNEL_OF_PATH[path] == kernel}
        if not sum(mine.values()):
            raise AssertionError(f"no path launched {kernel}")
        row["launches"] = sum(mine.values())
        row["launches_by_path"] = mine
    _bank_gather_counts()
    if GATHER_BANKED["launches"] != TAKE_ROWS["launches"]:
        raise AssertionError(
            f"row_gather launched {GATHER_BANKED['launches']} times after "
            f"its phase; the {TAKE_ROWS['calls']} CUDA take_rows calls "
            f"asked for {TAKE_ROWS['launches']}")
    for path in ("terasort", "terasort/ring"):
        if not GATHER_OF_PATH[path]:
            raise AssertionError(f"the {path} path never launched "
                                 f"{GATHER}")
    mine = {path: n for path, n in GATHER_OF_PATH.items() if n}
    gather_row["launches"] = sum(mine.values())
    gather_row["launches_by_path"] = mine
    gather_row["shapes"] = [[list(k), n] for k, n in
                            sorted(GATHER_BANKED["shapes"].items())]
    table[GATHER] = gather_row
    _check_merge_launches()
    for path in ("terasort", "terasort/ring"):
        if not MERGE_OF_PATH[path]:
            raise AssertionError(f"the {path} path never launched {MERGE}")
    mine = {path: n for path, n in MERGE_OF_PATH.items() if n}
    merge_row["launches"] = sum(mine.values())
    merge_row["launches_by_path"] = mine
    table[MERGE] = merge_row
    _check_partition_launches()
    for path in GROUPING_PATHS:
        if not PARTITION_OF_PATH[path]:
            raise AssertionError(f"the {path} path never launched "
                                 f"dest_partition")
    mine = {path: n for path, n in PARTITION_OF_PATH.items() if n}
    partition_row["launches"] = sum(mine.values())
    partition_row["launches_by_path"] = mine
    table["dest_partition"] = partition_row
    _check_lookup_launches()
    for path in LOOKUP_PATHS:
        if not LOOKUP_OF_PATH[path]:
            raise AssertionError(f"the {path} path never launched "
                                 f"hash_lookup")
    mine = {path: n for path, n in LOOKUP_OF_PATH.items() if n}
    lookup_row["launches"] = sum(mine.values())
    lookup_row["launches_by_path"] = mine
    table["hash_lookup"] = lookup_row
    emit({"kernels": list(table.values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == MH_WORKER_FLAG:
        multihost_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    elif len(sys.argv) > 1 and sys.argv[1] == LG_WORKER_FLAG:
        lockgraph_worker(sys.argv[2])
    else:
        main()
