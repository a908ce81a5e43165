"""Inputs shared by ``test_torch_multihost.py`` and the worker processes it
spawns (port and JAX alike), in a module that imports neither package."""

import numpy as np

G, DL, CAP, W, OUT_FACTOR = 8, 4, 32, 3, 2
TS_ROWS, TS_WORDS, TS_SEED = 64, 2, 5
PARTS, MAPS, ROWS, PAYLOAD, ROUND_ROWS = 16, 4, 2000, 8, 64


def exchange_inputs():
    """Rows ``u32[G, CAP, W]`` and destinations ``[G, CAP]`` (-1 = padding)
    from one seed; no pair exceeds the slot transports' even share."""
    rng = np.random.default_rng(11)
    data = rng.integers(0, 2**32, (G, CAP, W), dtype=np.uint32)
    dest = rng.integers(-1, G, (G, CAP)).astype(np.int32)
    return data, dest


def table(m):
    """Map ``m``'s records: ``ROWS`` keys below 100000 and their payload."""
    rng = np.random.default_rng(1000 + m)
    return (rng.integers(0, 100000, ROWS).astype(np.uint64),
            rng.integers(0, 255, (ROWS, PAYLOAD)).astype(np.uint8))


def skewed_inputs():
    """Rows and destinations like ``exchange_inputs`` whose skew the
    slot-free transports must carry: 40% of every source's rows go to
    shard 0, so its receive passes ``CAP * OUT_FACTOR`` (truncated) and
    its pairs pass the even share ``CAP * OUT_FACTOR // G``."""
    rng = np.random.default_rng(12)
    data = rng.integers(0, 2**32, (G, CAP, W), dtype=np.uint32)
    p = np.full(G + 1, 0.6 / G)
    p[1] = 0.4
    dest = (rng.choice(G + 1, size=(G, CAP), p=p) - 1).astype(np.int32)
    return data, dest
