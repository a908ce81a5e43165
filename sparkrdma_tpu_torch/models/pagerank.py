"""PageRank: iterative shuffle over the virtual mesh.

Port of ``sparkrdma_tpu/models/pagerank.py`` (BASELINE.md config #3, the
reference's GraphX PageRank benchmark). Vertices are range-sharded over
the mesh (shard d owns ``[d*V/D, (d+1)*V/D)``); edges live on their
source vertex's shard. One iteration is one step over every shard:

1. contribution per local edge = ``rank[src] / out_degree[src]`` (a
   local gather: src is local by construction; span ``pagerank.contrib``);
2. ``exchange.shuffle_into`` moves ``(dst, contribution bits)`` int32
   rows to dst's owner (the GraphX shuffle; on ``cuda`` through the
   ragged all-to-all kernel; span ``pagerank.exchange``);
3. one ``index_add_`` sums the received contributions into local ranks,
   then ``rank = (1 - d)/V + d * sums`` (span ``pagerank.sum``). On the
   card ``index_add_`` adds with atomics, so the sum order is free and
   ranks agree with the JAX package to a tolerance, not bit for bit.

Ranks never leave their shard; only contributions move.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from sparkrdma_tpu_torch.parallel.exchange import (
    resolve_transport,
    shuffle_into,
    spread_index,
)
from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh
from sparkrdma_tpu_torch.utils import trace as trace_mod
from sparkrdma_tpu_torch.utils.u32 import (
    rows_from_numpy,
    shards_from_numpy,
    shards_to_numpy,
)


@dataclass(frozen=True)
class PageRankConfig:
    num_vertices: int          # global, multiple of mesh size
    edges_per_device: int      # local edge capacity (padded)
    damping: float = 0.85
    out_factor: int = 2


def make_pagerank_step(mesh: VirtualMesh, cfg: PageRankConfig,
                       impl: str = "auto"):
    """One PageRank iteration over ``mesh``.

    ``step(edges, ranks, out_deg)`` takes ``edges: int32[D, E, 2]``
    (src, dst global vertex ids; padding rows have src = -1), ``ranks``
    and ``out_deg``: float32 ``[D, V/D]`` (``utils.u32.shards_from_numpy``
    of the global vectors). Returns ``(ranks [D, V/D], overflowed
    bool[D])``; ``overflowed[d]`` flags a receive buffer too small for the
    contribution fan-in (results invalid: raise ``out_factor``)."""
    n = mesh.num_shards
    impl = resolve_transport(mesh, impl)
    v_local = cfg.num_vertices // n
    teleport = (1.0 - cfg.damping) / cfg.num_vertices

    def step(edges: torch.Tensor, ranks: torch.Tensor,
             out_deg: torch.Tensor):
        dev = edges.device
        first = torch.arange(n, device=dev)[:, None] * v_local
        src, dst = edges[..., 0], edges[..., 1]
        valid = src >= 0
        with trace_mod.span("pagerank.contrib"):
            src_local = torch.where(valid, src - first, 0)
            contrib = torch.where(
                valid, ranks.gather(1, src_local)
                / torch.clamp(out_deg.gather(1, src_local), min=1.0), 0.0)
            # (dst, contribution bits): one int32 matrix for the exchange
            rows = torch.stack([dst, contrib.view(torch.int32)], dim=-1)
            dest = torch.where(valid, torch.div(dst, v_local,
                                                rounding_mode="floor"), -1)
        with trace_mod.span("pagerank.exchange"):
            received, rvalid, overflowed = shuffle_into(
                rows, dest, edges.shape[1] * cfg.out_factor, impl)
        with trace_mod.span("pagerank.sum"):
            # shard d's local vertex i sits at d*V/D + i of the flat
            # [D*V/D] sums, which is its global id; a pad row adds 0.0
            rdst = spread_index(rvalid, received[..., 0] - first, v_local)
            rcontrib = torch.where(rvalid,
                                   received[..., 1].view(torch.float32), 0.0)
            sums = torch.zeros(n * v_local, dtype=torch.float32, device=dev)
            sums.index_add_(0, rdst.reshape(-1), rcontrib.reshape(-1))
            new_ranks = teleport + cfg.damping * sums.reshape(n, v_local)
        return new_ranks, overflowed

    return step


def random_graph(cfg: PageRankConfig, num_devices: int, seed: int = 0,
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random directed graph, edges placed on their src's device. Returns
    ``(edges int32[D*E, 2], ranks float32[V], out_deg float32[V])``, the
    same arrays as the JAX package's generator for the same seed (the
    out-degrees are counted with ``np.bincount``, exact below 2**24)."""
    rng = np.random.default_rng(seed)
    v_local = cfg.num_vertices // num_devices
    edges = np.full((num_devices * cfg.edges_per_device, 2), -1,
                    dtype=np.int32)
    for d in range(num_devices):
        e = rng.integers(0, v_local, size=(cfg.edges_per_device, 2))
        e[:, 0] += d * v_local                          # src local to d
        e[:, 1] = rng.integers(0, cfg.num_vertices,     # dst anywhere
                               size=cfg.edges_per_device)
        lo = d * cfg.edges_per_device
        edges[lo:lo + cfg.edges_per_device] = e
    src = edges[:, 0]
    out_deg = np.bincount(src[src >= 0], minlength=cfg.num_vertices).astype(
        np.float32)
    ranks = np.full(cfg.num_vertices, 1.0 / cfg.num_vertices,
                    dtype=np.float32)
    return edges, ranks, out_deg


def run_pagerank(mesh: VirtualMesh, cfg: PageRankConfig, iterations: int,
                 seed: int = 0, impl: str = "auto",
                 graph: Optional[Tuple[np.ndarray, np.ndarray,
                                       np.ndarray]] = None) -> np.ndarray:
    """Host loop: ``iterations`` steps with ranks resident on the device;
    returns the final ranks ``float32[V]``. ``graph`` is a
    ``random_graph`` result (made from ``seed`` when not given). Raises
    ``OverflowError`` when the contribution fan-in overflowed the receive
    headroom."""
    n = mesh.num_shards
    edges, ranks, out_deg = graph if graph is not None else random_graph(
        cfg, n, seed)
    step = make_pagerank_step(mesh, cfg, impl)
    edges_d = rows_from_numpy(edges, mesh)
    ranks_d = shards_from_numpy(ranks, mesh)
    deg_d = shards_from_numpy(out_deg, mesh)
    overflowed = None
    for _ in range(iterations):
        ranks_d, overflowed = step(edges_d, ranks_d, deg_d)
    ranks_h = shards_to_numpy(ranks_d)
    if overflowed is not None and overflowed.any().item():
        raise OverflowError(
            "pagerank receive buffer overflow: contribution fan-in exceeds "
            "out_factor headroom; raise PageRankConfig.out_factor")
    return ranks_h


def numpy_pagerank(edges: np.ndarray, num_vertices: int, damping: float,
                   iterations: int) -> np.ndarray:
    """Dense host oracle in float64. ``np.bincount`` with weights adds in
    the same order as the JAX package's ``np.add.at`` oracle, and takes
    a fraction of its time at a hundred million edges."""
    valid = edges[:, 0] >= 0
    src, dst = edges[valid, 0], edges[valid, 1]
    out_deg = np.bincount(src, minlength=num_vertices).astype(np.float64)
    deg_of_src = np.maximum(out_deg, 1.0)[src]
    ranks = np.full(num_vertices, 1.0 / num_vertices, dtype=np.float64)
    for _ in range(iterations):
        sums = np.bincount(dst, weights=ranks[src] / deg_of_src,
                           minlength=num_vertices)
        ranks = (1.0 - damping) / num_vertices + damping * sums
    return ranks.astype(np.float32)
