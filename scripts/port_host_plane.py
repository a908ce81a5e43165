#!/usr/bin/env python3
"""Copy the JAX package's host plane into the PyTorch port, verbatim.

    python3 scripts/port_host_plane.py           # write the copies
    python3 scripts/port_host_plane.py --check   # compare, write nothing

Each module in ``LOCKSTEP`` goes from ``sparkrdma_tpu/<path>`` to
``sparkrdma_tpu_torch/<path>`` with one rewrite: the package prefix
``\\bsparkrdma_tpu\\b`` becomes ``sparkrdma_tpu_torch``, which also points
every lazy import at the port's own module. ``HUNKS`` names the only other
changes, each with its reason. ``--check`` exits 1 when a copy differs
from its original rewritten; ``tests/test_torch_lockstep.py`` makes the
same comparison in the tests.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "sparkrdma_tpu"
PORT = ROOT / "sparkrdma_tpu_torch"
PREFIX = re.compile(r"\bsparkrdma_tpu\b")

# the modules the engine reaches, lazily too, that import no JAX; then
# stage retry (shuffle/recovery.py), the host benches and the registries
# the CLI and the device benches reach; then the analysis suite
LOCKSTEP = (
    "config.py",
    "rdd.py",
    "shared_vars.py",
    "tasks.py",
    "parallel/__init__.py",
    "parallel/driver_client.py",
    "parallel/endpoints.py",
    "parallel/faults.py",
    "parallel/membership.py",
    "parallel/messages.py",
    "parallel/rpc_msg.py",
    "parallel/transport.py",
    "runtime/__init__.py",
    "runtime/blockserver.py",
    "runtime/native.py",
    "runtime/pool.py",
    "runtime/staging.py",
    "shuffle/__init__.py",
    "shuffle/cold_tier.py",
    "shuffle/dist_cache.py",
    "shuffle/external.py",
    "shuffle/fetcher.py",
    "shuffle/ha.py",
    "shuffle/location_plane.py",
    "shuffle/manager.py",
    "shuffle/map_output.py",
    "shuffle/native_fetch.py",
    "shuffle/planner.py",
    "shuffle/push_merge.py",
    "shuffle/pushed_store.py",
    "shuffle/resolver.py",
    "shuffle/shard_plane.py",
    "shuffle/spark_compat.py",
    "shuffle/tenancy.py",
    "shuffle/writer.py",
    "shuffle/recovery.py",
    "shuffle/cold_bench.py",
    "shuffle/ctrl_bench.py",
    "shuffle/elastic_bench.py",
    "shuffle/fetch_bench.py",
    "shuffle/ha_bench.py",
    "shuffle/iter_bench.py",
    "shuffle/merge_bench.py",
    "shuffle/plan_bench.py",
    "shuffle/pushplan_bench.py",
    "shuffle/serve_bench.py",
    "shuffle/tenant_bench.py",
    "shuffle/write_bench.py",
    "utils/benchgate.py",
    "utils/codecs.py",
    "utils/ids.py",
    "utils/integrity.py",
    "utils/stats.py",
    "utils/tombstones.py",
    "utils/trace_names.py",
    "analysis/core.py",
    "analysis/wire.py",
    "analysis/concurrency.py",
    "analysis/drift.py",
    "analysis/resources.py",
    "analysis/lockgraph.py",
    "analysis/scheduler.py",
    "analysis/modelcheck.py",
    "analysis/native_harness.py",
    "analysis/__init__.py",
    "analysis/__main__.py",
)

# path -> [(text after the prefix rewrite, replacement, reason)]
HUNKS = {
    "runtime/native.py": [(
        '_LIB_PATH = os.path.join(os.path.dirname(__file__), '
        '"libtpushuffle.so")\n',
        "# the port's own shim, compiled from the checkout's csrc/*.cpp into\n"
        "# build/ on first import (runtime/shim_build.py)\n"
        "from sparkrdma_tpu_torch.runtime.shim_build import host_shim_path\n"
        "\n"
        "_LIB_PATH = str(host_shim_path())\n",
        "the port never loads the JAX package's libtpushuffle.so: it "
        "builds its own from csrc/ into build/ and loads that"),
    ],
    "utils/trace_names.py": [(
        '    "writer.publish",\n})\n',
        '    "writer.publish",\n'
        "    # emitted only by the port: its host drivers' round phases\n"
        "    # (parallel/device_plane.py) and its mesh service's host work\n"
        "    # (shuffle/mesh_service.py)\n"
        '    "exchange.collect",\n'
        '    "exchange.merge",\n'
        '    "exchange.stage",\n'
        '    "mesh.decode",\n'
        '    "mesh.pack",\n'
        '    "mesh.partition",\n'
        '    "mesh.unpack",\n'
        "    # and its step spans (utils/trace.span): the device plane's\n"
        "    # layers, the row gather, the exchange's phases and each\n"
        "    # model's rounds, which the benchmark's readers select on\n"
        '    "als.group",\n'
        '    "als.solve",\n'
        '    "chunked.land",\n'
        '    "chunked.pack",\n'
        '    "chunked.slot_fill",\n'
        '    "chunked.transport",\n'
        '    "exchange.arena_copy",\n'
        '    "exchange.group",\n'
        '    "exchange.pack",\n'
        '    "exchange.receive_fill",\n'
        '    "exchange.slot_fill",\n'
        '    "exchange.transport",\n'
        '    "fused.counts",\n'
        '    "fused.local_sort",\n'
        '    "fused.receive_sort",\n'
        '    "join.exchange",\n'
        '    "join.merge",\n'
        '    "lookup.unique",\n'
        '    "mesh.take_rows",\n'
        '    "pagerank.contrib",\n'
        '    "pagerank.exchange",\n'
        '    "pagerank.sum",\n'
        '    "q64.by_item",\n'
        '    "q64.catalog_group",\n'
        '    "q64.catalog_join",\n'
        '    "q64.date_join",\n'
        '    "q64.pair_lookup",\n'
        '    "q64.store_join",\n'
        '    "q95.addr",\n'
        '    "q95.aggregate",\n'
        '    "q95.aggregate.sort",\n'
        '    "q95.by_order",\n'
        '    "q95.date",\n'
        '    "q95.site",\n'
        '    "tpcds.aggregate",\n'
        '    "tpcds.join1",\n'
        '    "tpcds.join2",\n'
        "})\n",
        "names the port's host drivers, mesh service and step paths emit "
        "that the reference lacks: the drift pass holds every emitted span "
        "to this registry"),
    ],
    "analysis/concurrency.py": [(
        '    "sparkrdma_tpu_torch/utils/trace.py",\n]\n',
        '    "sparkrdma_tpu_torch/utils/trace.py",\n'
        "    # the port's own modules that lock or keep per-thread state\n"
        '    "sparkrdma_tpu_torch/ops/_build.py",\n'
        '    "sparkrdma_tpu_torch/ops/ring_exchange.py",\n'
        '    "sparkrdma_tpu_torch/parallel/topology.py",\n'
        "]\n",
        "the port's kernel build, the kernel's per-thread launch state "
        "and the cross-slice counter are written for the port and lock "
        "or keep per-thread state, so the lints scan them too"),
    ],
}


def expected(path: str) -> str:
    """What ``sparkrdma_tpu_torch/<path>`` must hold: the original with
    the prefix rewritten and the path's named hunks applied. Raises if a
    hunk's text is not in the original exactly once."""
    text = PREFIX.sub("sparkrdma_tpu_torch",
                      (REFERENCE / path).read_text())
    for old, new, _reason in HUNKS.get(path, ()):
        if text.count(old) != 1:
            raise ValueError(f"{path}: hunk text found {text.count(old)} "
                             "times in the original")
        text = text.replace(old, new)
    return text


def main(argv) -> int:
    check = "--check" in argv
    differ = []
    for path in LOCKSTEP:
        want = expected(path)
        target = PORT / path
        if target.exists() and target.read_text() == want:
            continue
        differ.append(path)
        if not check:
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_text(want)
    verb = "differ" if check else "written"
    print(f"{len(differ)} of {len(LOCKSTEP)} copies {verb}: "
          + (", ".join(differ) or "none"))
    return 1 if check and differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
