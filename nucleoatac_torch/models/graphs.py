"""Step programs: one captured CUDA graph per input signature.

Counterpart of the reference's compiled step programs: DeviceEngine
compiles each stage chain once with ``jax.jit`` and XLA keeps one
executable per input shape (``emax`` a static argument), so a run issues a
handful of executables per batch. Here a fused step's chain is captured
once per signature into a ``torch.cuda.CUDAGraph`` and replayed for every
later batch of that signature: one host call in place of the chain's two
hundred launches.

The key is the step's name, the device, the shape and dtype of each tensor
argument and the other arguments as they are (the static ints). The first
call of a key runs the chain eagerly on a side stream (PyTorch's warm-up
before a capture: it builds the kernel library and warms cuBLAS) and
returns that result, then copies the inputs into static buffers and
captures the chain reading them, in its own memory pool. Every later call
copies its inputs into the static buffers on the current stream, replays
the graph there and returns a clone of the static output, so that a later
replay never overwrites an output its caller still holds (the pipelined
loop keeps several in flight). There is no fallback: a capture or replay
error raises.

Python does not run on a replay, so the counters the chain advances
(kernel launches, nuc steps) are read around the capture, put back, and
added once per replay: the warm-up counts as itself, the capture counts
nothing.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch


class Program(NamedTuple):
    """One captured step: its static inputs (tensors, and the static
    values as they were), static output, the counter steps one run of the
    chain made, and the bytes its memory pool reserved."""
    replay: Callable[[], None]
    inputs: tuple
    out: torch.Tensor
    counts: tuple
    pool_bytes: int


def cuda_capture(run: Callable[[], torch.Tensor], device: torch.device):
    """Capture ``run()`` on ``device`` into a CUDA graph with its own
    memory pool: (replay, static output, bytes the pool reserved).

    Captures on a stream of its own in thread-local mode: the finishing
    threads may free pinned download buffers (CUDA calls of their own)
    while a capture runs; the capturing thread's unsafe calls still
    raise."""
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(device)
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(device),
                          capture_error_mode="thread_local"):
        out = run()
    return graph.replay, out, torch.cuda.memory_reserved(device) - before


def signature(name: str, args: Sequence) -> tuple:
    """(name, device, per argument: (shape, dtype) of a tensor, else the
    value itself)."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors:
        raise ValueError(f"{name}: a step program needs a tensor argument")
    devs = {a.device for a in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: arguments on several devices {devs}")
    return (name, tensors[0].device, tuple(
        (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a for a in args))


class StepPrograms:
    """The step-program cache of one engine: ``programs(name, chain,
    *args)`` is ``chain(*args)``, captured on a key's first call and
    replayed after. ``counters`` are the (object, attribute) integers the
    chain advances; ``capture`` is cuda_capture unless a test stands in
    for it."""

    def __init__(self, counters: Sequence[tuple] = (), capture=cuda_capture):
        self.counters = list(counters)
        self.capture = capture
        self.entries: dict = {}
        self.captures = 0
        self.replays = 0
        self._side: dict = {}  # device -> the warm-up stream

    @property
    def pool_bytes(self) -> int:
        """Bytes reserved by every entry's memory pool."""
        return sum(p.pool_bytes for p in self.entries.values())

    def _read(self) -> list:
        return [getattr(o, a) for o, a in self.counters]

    def _add(self, counts) -> None:
        for (o, a), n in zip(self.counters, counts):
            setattr(o, a, getattr(o, a) + n)

    def __call__(self, name: str, chain: Callable, *args):
        key = signature(name, args)
        prog = self.entries.get(key)
        if prog is None:
            return self._first(key, chain, args)
        for s, a in zip(prog.inputs, args):
            if isinstance(s, torch.Tensor):
                s.copy_(a)
        prog.replay()
        self.replays += 1
        self._add(prog.counts)
        return prog.out.clone()

    def _warm(self, chain: Callable, args: tuple, dev: torch.device):
        """chain(*args) on a side stream ordered after and before the
        current one (on a card), as itself elsewhere."""
        if dev.type != "cuda":
            return chain(*args)
        if dev not in self._side:
            self._side[dev] = torch.cuda.Stream(dev)
        side, cur = self._side[dev], torch.cuda.current_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = chain(*args)
        cur.wait_stream(side)
        return out

    def _first(self, key: tuple, chain: Callable, args: tuple):
        dev = key[1]
        out = self._warm(chain, args, dev)
        static = tuple(a.clone(memory_format=torch.contiguous_format)
                       if isinstance(a, torch.Tensor) else a for a in args)
        before = self._read()
        try:
            replay, static_out, nbytes = self.capture(lambda: chain(*static), dev)
            counts = tuple(n - b for n, b in zip(self._read(), before))
        finally:
            for (o, a), b in zip(self.counters, before):
                setattr(o, a, b)
        self.entries[key] = Program(replay, static, static_out, counts, nbytes)
        self.captures += 1
        return out
