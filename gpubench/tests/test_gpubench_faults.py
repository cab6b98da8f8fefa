"""The check fails where the timed path is broken underneath: each fault
the cells can have, planted in the program's step outputs, makes
``correct`` come out false, and the control (the reference at TF32
operand precision in the program's place) fails too. Drives the harness
past its look for a card, on the CPU at a tiny size."""
import numpy as np
import pytest
import torch

from gpubench.harness import run_cell


def _plant(fault: str):
    """A hook that wraps the engine's sharded entry (every step of both
    routes goes through it) or its gather."""

    def hook(port):
        eng = port.engine
        shard, gather = eng.shard, eng._gather
        last = {}
        n_occ = 2 * eng.core + (eng.core + 3) // 4  # wire v8 occ bytes
        N = eng.core + 2 * eng.smooth_margin()  # u16 norm: N low, N high, 8 meta

        def faulty(chain, *args):
            out = shard(chain, *args)
            if fault == "stale":  # the previous batch's output of this shape
                prev = last.get(out.shape)
                last[out.shape] = out.clone()
                return out if prev is None else prev
            out = out.clone()
            if fault == "half":  # the second half of the batch is the first half's
                h = out.shape[0] // 2
                out[h:2 * h] = out[:h]
            elif fault == "altered":  # one answer of each window changed
                w = out.shape[1]
                if w == n_occ:  # the occupancy pick at core position 40
                    out[:, 40] ^= 1
                else:  # the high byte of norm position 100
                    out[:, w - 8 - N + 100] ^= 0x80
            return out

        def no_exchange(outs):  # every shard's rows are the first shard's
            return gather([outs[0]] * len(outs))

        if fault == "exchange":
            eng._gather = no_exchange
        elif fault == "tile_dropped":  # the program's tiling loses one window
            port.tiles = port.tiles[:-1]
        else:
            eng.shard = faulty

    return hook


@pytest.mark.parametrize("workload,fault", [
    ("tiny.fused", "stale"), ("tiny.fused", "half"), ("tiny.fused", "altered"),
    ("tiny.twopass", "stale"), ("tiny.twopass", "half"), ("tiny.twopass", "altered"),
    ("tiny2.fused", "exchange"), ("tiny.fused", "tile_dropped"),
    ("tiny.twopass", "tile_dropped"),
])
def test_fault_fails_the_check(tiny_root, workload, fault):
    torch.manual_seed(0)
    line = run_cell(tiny_root, workload, 2**31 + 21, 3.0, False, device_type="cpu",
                    hooks=_plant(fault))
    assert not line["correct"], line["checks"]
    if fault == "tile_dropped":  # no sampled window is wrong; the tiling is
        assert line["checks"]["tile_mismatch"]["value"] == 1
    else:
        assert line["failed"] > 0, line


@pytest.mark.parametrize("workload", ["tiny.fused", "tiny.twopass"])
def test_control_fails_and_program_passes(tiny_root, workload):
    from gpubench.check import judge, limits

    line = run_cell(tiny_root, workload, 2**31 + 22, 3.0, False, device_type="cpu",
                    control=True)
    assert line["correct"]
    ctl = line["control"]
    lim = limits(tiny_root, workload.split(".")[0], workload.split(".")[1])
    ok, failed, rows = judge({"numbers": ctl["numbers"], "windows": ctl["windows"]}, lim)
    assert not ok and failed > 0
    # each number the control fails reads at least three times the program's
    for name, value, limit in rows:
        if value > limit and name != "occ_cert_mismatch":
            assert value >= 3 * line["checks"][name]["value"]
    assert np.isfinite(ctl["numbers"]["nuc_norm_steps"])
