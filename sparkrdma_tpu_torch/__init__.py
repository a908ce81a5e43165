"""sparkrdma_tpu_torch: the PyTorch/CUDA port of ``sparkrdma_tpu``.

The port runs on one NVIDIA H100: D virtual shards held as a leading
tensor axis in the card's memory, with the ring all-to-all as a
hand-written CUDA kernel. Its layout mirrors the JAX package's, so each
module's counterpart has the same path there.

It imports ``torch`` and numpy, never ``jax`` and nothing of
``sparkrdma_tpu``: what it needs from there it keeps a copy of. The host
plane (configuration, control-plane RPC, writer, resolver, fetcher,
reader, push-merge, HA, cold tier, tenancy, the buffer pool and its C++
shim) is a verbatim copy under the port's prefix, held equal to the
reference by ``tests/test_torch_lockstep.py``.

Subpackages and modules
-----------------------
``config``    typed, range-validated configuration.
``utils``     ids, codecs, stats, integrity, tracing, u32 word helpers.
``runtime``   host buffer pools, spill staging, the native shim, built
              from ``csrc/`` into ``build/`` on first import.
``parallel``  control-plane RPC and membership; the virtual mesh, the
              ragged exchange and the device plane.
``ops``       partitioners, sorts, aggregates and the ring kernel.
``shuffle``   Manager / Writer / Reader / Resolver, the mesh shuffle
              service and the host-to-device on-ramp.
``models``    TeraSort, ALS, PageRank, the join, the TPC-DS star, q95,
              q64, and the TPC-DS engine jobs.
``engine``    the DAG scheduler; with ``mesh=VirtualMesh(...)`` its
              shuffles ride the device plane.
``tasks``, ``shared_vars``, ``rdd``  task shipping, broadcasts and
              accumulators, and the RDD-style API on the engine.

Every device entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no CPU request it raises.
"""

__version__ = "0.1.0"

from sparkrdma_tpu_torch.config import TpuShuffleConf  # noqa: F401


def __getattr__(name):
    # Lazy top-level conveniences: the engine-facing API without forcing
    # torch/socket imports at package-import time.
    if name in ("TpuShuffleManager", "PartitionerSpec", "ShuffleHandle"):
        from sparkrdma_tpu_torch.shuffle import manager
        return getattr(manager, name)
    if name == "SparkCompatShuffleManager":
        from sparkrdma_tpu_torch.shuffle.spark_compat import (
            SparkCompatShuffleManager,
        )
        return SparkCompatShuffleManager
    if name in ("DAGEngine", "MapStage", "ResultStage"):
        from sparkrdma_tpu_torch import engine
        return getattr(engine, name)
    if name in ("Broadcast", "Accumulator"):
        from sparkrdma_tpu_torch import shared_vars
        return getattr(shared_vars, name)
    if name in ("EngineContext", "RDD", "BatchRDD"):
        from sparkrdma_tpu_torch import rdd
        return getattr(rdd, name)
    if name == "ShuffleDependency":
        from sparkrdma_tpu_torch.shuffle.spark_compat import ShuffleDependency
        return ShuffleDependency
    raise AttributeError(
        f"module 'sparkrdma_tpu_torch' has no attribute {name!r}")
