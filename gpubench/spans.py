"""Host spans the harness records around its calls into the program, and
the seeded sample of outputs it keeps for the correctness check."""
from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np


class Spans:
    """Self time per span name (a nested span's time is its own, not its
    parent's) and the count of each. Off, a span costs one attribute
    test. ``annotate`` marks each span in a profiler trace instead
    (``gpubench:<name>``), so that the trace names what the host did in an
    idle gap."""

    def __init__(self, on: bool):
        self.on = on
        self.annotate = False
        self.total: dict = {}
        self.count: dict = {}
        self._stack: list = []  # [name, start of its current stretch]

    @contextmanager
    def __call__(self, name: str):
        if self.annotate:
            from torch.profiler import record_function

            with record_function(f"gpubench:{name}"):
                yield
            return
        if not self.on:
            yield
            return
        now = time.perf_counter()
        if self._stack:
            parent = self._stack[-1]
            self.total[parent[0]] = self.total.get(parent[0], 0.0) + now - parent[1]
        self._stack.append([name, now])
        try:
            yield
        finally:
            end = time.perf_counter()
            _, stretch = self._stack.pop()
            self.total[name] = self.total.get(name, 0.0) + end - stretch
            self.count[name] = self.count.get(name, 0) + 1
            if self._stack:  # the parent's next stretch starts here
                self._stack[-1][1] = end


class Sampler:
    """Reservoir samples, one per output kind, of ``batches`` batches each,
    drawn from the seed; from each kept batch, ``rows`` rows spread evenly
    over its real rows (one drawn in each equal stretch), so that every
    shard of a split batch is sampled."""

    def __init__(self, seed_rng: np.random.Generator, batches: int, rows: int):
        self.rng = seed_rng
        self.k = batches
        self.rows = rows
        self.seen: dict = {}
        self.kept: dict = {}

    def offer(self, kind: str, n_real: int, take) -> None:
        """``take(rows)`` copies what the check needs of the batch and those
        rows; called only for a batch the reservoir keeps."""
        i = self.seen.get(kind, 0)
        self.seen[kind] = i + 1
        slots = self.kept.setdefault(kind, [])
        if i < self.k:
            j = len(slots)
            slots.append(None)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j >= self.k:
                return
        edges = np.linspace(0, n_real, min(self.rows, n_real) + 1).astype(int)
        rows = [int(self.rng.integers(a, b)) for a, b in zip(edges, edges[1:]) if b > a]
        slots[j] = take(rows)

    def items(self, kind: str) -> list:
        return [s for s in self.kept.get(kind, []) if s is not None]
