"""sparkrdma_tpu_torch: the PyTorch/CUDA port of ``sparkrdma_tpu``.

The port runs the TeraSort main path on one NVIDIA H100: D virtual
shards held as a leading tensor axis in the card's memory, with the ring
all-to-all as a hand-written CUDA kernel. Its layout mirrors the JAX
package's, so each module's counterpart has the same path there.

It imports ``torch`` and numpy, never ``jax`` and nothing of
``sparkrdma_tpu``: what it needs from there it keeps a copy of.

Subpackages
-----------
``utils``     unsigned 32-bit word helpers and the numpy <-> mesh carry.
``parallel``  the virtual mesh, the ragged exchange and the fused step.
``ops``       partitioners and the ring all-to-all kernel.
``shuffle``   the mesh shuffle service (committed map outputs reduced on
              the mesh), the host-to-device on-ramp, an in-memory
              store of committed outputs, positional merges of sorted
              runs, and the few host-plane names these need.
``models``    TeraSort, ALS, PageRank, the join, the TPC-DS star, q95, q64.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no CPU request it raises.
"""
