"""Scaling bench: windows/s of the sharded fused step at 1..N devices.

Counterpart of scripts/bench_scaling.py. For n = 1, 2, 4, 8, ... up to
the visible cards, an engine at core 1024 takes a batch of
``--per-device-batch`` x n windows sharded over cuda:0 .. cuda:n-1, and
full_step_packed_seq (packed fragments and sequence codes, resident on
the first card) is timed over ``--iters`` calls between two
torch.cuda.synchronize(), best of three: one line per n with the weak
scaling efficiency against n = 1. ``--virtual N`` puts N shards on one
device (["cuda:0"] * N, or ["cpu"] * N under ``--device cpu``), the
reference's ``--virtual`` without XLA_FLAGS: it exercises the sharded
path, but the shards share one device, so its efficiency is not hardware
scaling (the lines say ``virtual: true``, as they do when one card is
visible).

Run: python3 -m nucleoatac_torch.bench.scaling [--virtual N]
[--per-device-batch 16] [--frag-cap 2048] [--iters 10] [--core 1024]
[--device cuda]
One JSON line per device count.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from nucleoatac_torch.bench import common
from nucleoatac_torch.models.data import pack_fragments
from nucleoatac_torch.parallel.mesh import local_devices

COUNTS = (1, 2, 4, 8, 16, 32)


def scaling(devices_for, counts, virtual: bool, per_device_batch: int = 16,
            frag_cap: int = 2048, iters: int = 10, core: int = 1024):
    """Yield one line per n in ``counts``: ``devices_for(n)`` are the n
    devices the batch shards over."""
    from nucleoatac_torch.entry import _tiny_engine

    base_wps = None
    rng = np.random.default_rng(1)
    for n in counts:
        B = per_device_batch * n
        _, eng = _tiny_engine(core=core, batch=B, device=devices_for(n))
        W, F = eng.width, frag_cap
        mids = rng.integers(0, W, size=(B, F)).astype(np.int32)
        szs = np.clip(rng.normal(147, 40, size=(B, F)).astype(np.int32), 1, 250)
        packed = np.zeros((B, F), np.int32)
        for b in range(B):
            pack_fragments(mids[b], szs[b], packed, b)
        codes = rng.integers(0, 4, size=(B, eng.seq_codes_width())).astype(np.uint8)
        dev_in = tuple(torch.from_numpy(a).to(eng.device) for a in (packed, codes))
        eng.full_step_packed_seq(*dev_in)  # warm-up, the kernels' build included
        common.sync(eng.devices)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                eng.full_step_packed_seq(*dev_in)
            common.sync(eng.devices)
            best = min(best, (time.perf_counter() - t0) / iters)
        wps = B / best
        base_wps = base_wps or wps
        yield {"devices": n, "batch": B, "windows_per_s": wps,
               "weak_scaling_efficiency": wps / (base_wps * n),
               "virtual": virtual, "steps": eng.steps,
               "device": common.card(eng.device) or "cpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--virtual", type=int, default=None,
                    help="N shards on one device (not hardware scaling)")
    ap.add_argument("--per-device-batch", type=int, default=16)
    ap.add_argument("--frag-cap", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--core", type=int, default=1024, help="window core, bp")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)

    dev = common.device(args.device)
    if args.virtual or dev.type != "cuda":
        n_total = args.virtual or 1

        def devices_for(n):
            return [dev] * n
    else:
        n_total = torch.cuda.device_count()
        devices_for = local_devices
    virtual = bool(args.virtual) or n_total == 1
    if virtual and not args.virtual:
        print("# WARNING: one device; pass --virtual N to exercise the sharded path "
              "(numbers are not hardware scaling)", file=sys.stderr)
    for line in scaling(devices_for, [n for n in COUNTS if n <= n_total], virtual,
                        args.per_device_batch, args.frag_cap, args.iters, args.core):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
