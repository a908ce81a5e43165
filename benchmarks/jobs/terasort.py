"""TeraSort jobs: one round of ``records`` rows through the port's
``make_terasort_step``, every job on the same input.

The input is made on the device from the seed: ``rows_per_device`` rows of
``1 + payload_words`` u32 words on each of ``shards`` shards, every word
uniform (gensort's uniform keys and incompressible payload, as the port's
``generate_rows`` draws them on the host). A job's host result is its count
matrix and overflow flags. Two jobs drawn from the seed keep their sorted
rows to the end of the window for the check.
"""

from __future__ import annotations

import random

import torch

from benchmarks.reference import terasort as reference


def _words(cfg: dict) -> int:
    return 1 + cfg["payload_words"]


def input_bytes(cfg: dict) -> int:
    """The rows handed to the port, as int32 words."""
    return cfg["shards"] * cfg["rows_per_device"] * _words(cfg) * 4


def exchange_bytes(cfg: dict) -> int:
    """Each row read once and written once by the job's one exchange."""
    return 2 * input_bytes(cfg)


def make_inputs(cfg: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = torch.randint(-2**31, 2**31, (cfg["shards"], cfg["rows_per_device"],
                                         _words(cfg)),
                         dtype=torch.int32, device=device, generator=gen)
    return {"rows": rows}


def _port_step(cfg: dict, device):
    from sparkrdma_tpu_torch.models import terasort as port
    from sparkrdma_tpu_torch.parallel.exchange import resolve_transport
    from sparkrdma_tpu_torch.parallel.mesh import VirtualMesh

    mesh = VirtualMesh(cfg["shards"], device)
    step = port.make_terasort_step(
        mesh, port.TeraSortConfig(rows_per_device=cfg["rows_per_device"],
                                  payload_words=cfg["payload_words"],
                                  out_factor=cfg["out_factor"]),
        impl="auto")
    return step, resolve_transport(mesh, "auto")


def _control_step(cfg: dict):
    """The reference in the program's place, sorting on 16 key bits."""
    def step(rows):
        d, n, w = rows.shape
        out = torch.zeros((d, n * cfg["out_factor"], w), dtype=rows.dtype,
                          device=rows.device)
        flat, counts = reference.terasort(rows, d, key_bits=16)
        start = 0
        for s, total in enumerate(counts.sum(dim=1).tolist()):
            out[s, :total] = flat[start:start + total]
            start += total
        return (out, counts.to(torch.int32),
                torch.zeros(d, dtype=torch.bool, device=rows.device))
    return step


class Cell:
    """One run's TeraSort: inputs, the entry, results kept for the check."""

    def __init__(self, cfg: dict, work: dict, seed: int, device,
                 control: bool = False):
        self.cfg = cfg
        self.inputs = make_inputs(cfg, seed, device)
        if control:
            self.step, self.transport = _control_step(cfg), "control"
        else:
            self.step, self.transport = _port_step(cfg, device)
        self.sampled = set(random.Random(seed).sample(
            range(work["sample_from_first"]), work["sampled_jobs"]))
        self.kept = {}

    def submit(self):
        return self.step(self.inputs["rows"])

    @staticmethod
    def fetch(result) -> tuple:
        """Copies of the job's counts and overflow flags on their way to
        the host, not waited for."""
        _, counts, overflowed = result
        return (counts.to("cpu", non_blocking=True),
                overflowed.to("cpu", non_blocking=True))

    def finish(self, index: int, result, host) -> dict:
        """The job's host result, once its work and copies are done,
        copied out of the pinned buffers so that they are reused."""
        counts, overflowed = host
        if index in self.sampled:
            self.kept[index] = result[:2]
        return {"counts": counts.numpy().copy(),
                "overflowed": bool(overflowed.any())}

    def kept_bytes(self) -> int:
        return sum(out.nbytes + counts.nbytes
                   for out, counts in self.kept.values())

    def release(self) -> None:
        """Drop the program's step before the reference runs."""
        self.step = None

    def check(self, records: list) -> dict:
        """Numbers compared, each ``(value, limit)``."""
        rows = self.inputs["rows"]
        ref_rows, ref_counts = reference.terasort(rows, self.cfg["shards"])
        ref_counts = ref_counts.cpu()
        totals = ref_counts.sum(dim=1).tolist()
        rows_wrong = 0
        for out, _ in self.kept.values():
            start = 0
            for s, total in enumerate(totals):
                got = out[s, :total]
                want = ref_rows[start:start + total]
                rows_wrong += int((got != want).any(dim=1).sum())
                start += total
        counts_wrong = sum(int((torch.from_numpy(r["counts"]).to(
            torch.int64) != ref_counts).sum()) for r in records)
        return {
            "sampled_jobs_missing": (len(self.sampled) - len(self.kept), 0),
            "rows_wrong": (rows_wrong, 0),
            "counts_wrong": (counts_wrong, 0),
            "jobs_overflowed": (sum(r["overflowed"] for r in records), 0),
        }
