"""Inputs shared by the port's grouping by destination on the card
(``test_torch_dest_partition.py``) and the JAX package's on the CPU
(``test_torch_exchange.py``), in a module that imports neither package.
Rows and destinations come from integer arithmetic alone (no random
generator), so every machine builds the same arrays whatever its numpy;
``grouping`` is the JAX package's function in numpy (pads mapped past the
last partition, a stable argsort, a take and a count), which
``test_torch_exchange.py`` holds to ``jx.group_by_destination`` on these
very arrays, shard by shard."""

import numpy as np

# (shards, rows a shard, partitions, destination dtype, row words): each
# shard several of the kernel's 2048-row tiles and not a whole number of
# them; the destinations spread over [-3, P + 3), so some rows are pads
# below 0 and some at or past P
CASES = {
    "p8_int32": (8, 2 * 2048 + 77, 8, np.int32, 2),
    "p8_int64": (8, 3 * 2048 + 1, 8, np.int64, 3),
    "p128_int32": (8, 5 * 2048 + 333, 128, np.int32, 1),
    "p128_int64": (4, 4 * 2048 + 1000, 128, np.int64, 2),
}


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser on ``uint64`` words."""
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def inputs(case: str):
    """``(data int32[D, N, W], dest [D, N], P)`` of one case; the second
    shard of ``p8_int64`` is all pads."""
    d, n, p, dtype, w = CASES[case]
    salt = np.uint64(sum(map(ord, case)) << 40)
    words = _mix(np.arange(d * n * (w + 1), dtype=np.uint64) + salt)
    data = (words[:d * n * w] >> np.uint64(32)).astype(np.uint32)
    data = data.view(np.int32).reshape(d, n, w)
    dest = (words[d * n * w:] % np.uint64(p + 6)).astype(np.int64) - 3
    dest = dest.reshape(d, n)
    if case == "p8_int64":
        dest[1] = np.where(dest[1] < p // 2, -1, p + 5)
    return data, dest.astype(dtype), p


def grouping(data: np.ndarray, dest: np.ndarray, p: int):
    """``(grouped [D, N, W], counts int32[D, P])``: each shard's rows
    grouped by destination, stably, the pads last and not counted."""
    mapped = np.where((dest < 0) | (dest >= p), p, dest).astype(np.int64)
    order = np.argsort(mapped, axis=1, kind="stable")
    grouped = np.take_along_axis(data, order[..., None], axis=1)
    counts = np.stack([np.bincount(row, minlength=p + 1)[:p]
                       for row in mapped])
    return grouped, counts.astype(np.int32)
