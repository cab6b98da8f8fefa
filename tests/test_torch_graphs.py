"""The step-program cache (nucleoatac_torch/models/graphs.py), the
counterpart of the reference's jit executables, on the CPU through a
stand-in for the CUDA capture:

  * the key: the same signature captures once and replays after; a new
    emax, pool capacity, batch size, device or step name captures anew;
  * a replay copies its inputs into the static buffers and returns a copy
    of the static output;
  * the counters: K2 launches, K3 launches and engine.steps advance once
    per batch, warm-up or replay, and not for the capture; a replay of
    run_step_pool2 adds one K3 launch per shard; a failed capture raises
    and leaves them as they were;
  * a CPU engine creates no entry, and its four fused steps keep the JAX
    DeviceEngine's bytes on the seeded example (test_torch_forms' bars:
    grid indices equal wherever both certify, the u16 norm within
    nuc.exact_tol + one step) and one set of bytes among themselves;
  * on a card (marked cuda; skips here): each replay byte-equal to the
    eager chain, counted, with one capture per signature.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nucleoatac_tpu.models import data as jdata
from nucleoatac_torch.entry import _tiny_engine
from nucleoatac_torch.models import engine as tengine_mod
from nucleoatac_torch.models.graphs import StepPrograms, signature
from nucleoatac_torch.ops import nuc_scores as k2_ops
from nucleoatac_torch.ops import occ_window as k3_ops
from nucleoatac_torch.profiling import stages
from test_torch_transfer import CFG, TOL, _engine, example  # noqa: F401 (a fixture)

T = torch.from_numpy


class StandIn:
    """Records each capture and replay; the capture runs the chain once on
    the static inputs, as a CUDA capture records it, and reserves 4096
    bytes."""

    def __init__(self):
        self.log = []

    def __call__(self, run, device):
        self.log.append(("capture", str(device)))
        out = run()
        return (lambda: self.log.append(("replay", str(device)))), out, 4096


def _toy(pool, table, emax):
    """A chain of a pool step's argument kinds: [B, 2] from the pool's
    first emax records and the table."""
    return table[:, :2].float() + pool[:emax].float().sum()


def _args(cap=12, batch=4, emax=6, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    pool = torch.randint(0, 255, (cap,), dtype=torch.uint8, generator=g)
    table = torch.randint(0, 9, (batch, 3), dtype=torch.int32, generator=g)
    return pool.to(device), table.to(device), emax


def test_same_signature_captures_once_and_replays():
    cap = StandIn()
    progs = StepPrograms(capture=cap)
    first = progs("run_step_pool", _toy, *_args())
    assert torch.equal(first, _toy(*_args()))  # the warm-up's real result
    for seed in (1, 2):
        args = _args(seed=seed)
        out = progs("run_step_pool", _toy, *args)
        (prog,) = progs.entries.values()
        # the batch's inputs now sit in the static buffers; the output is a
        # copy of the static one, not the buffer a later replay overwrites
        assert all(torch.equal(s, a) for s, a in zip(prog.inputs[:2], args[:2]))
        assert torch.equal(out, prog.out) and out.data_ptr() != prog.out.data_ptr()
    assert (progs.captures, progs.replays, progs.pool_bytes) == (1, 2, 4096)
    assert cap.log == [("capture", "cpu"), ("replay", "cpu"), ("replay", "cpu")]


@pytest.mark.parametrize("change", [
    {"emax": 8}, {"cap": 16}, {"batch": 8}, {"device": "meta"}, {"name": "run_step_pool2"}])
def test_a_new_signature_captures_anew(change):
    """A new emax, pool capacity, batch size, device or step: a second
    entry, each replayed after; the old one still replays."""
    progs = StepPrograms(capture=StandIn())
    change = dict(change)
    name = change.pop("name", "run_step_pool")
    old, new = _args(), _args(**change)
    assert signature("run_step_pool", old) != signature(name, new)
    for args, n in ((old, "run_step_pool"), (new, name), (old, "run_step_pool"),
                    (new, name)):
        progs(n, _toy, *args)
    assert (progs.captures, progs.replays, len(progs.entries)) == (2, 2, 2)
    assert progs.pool_bytes == 2 * 4096


def test_signature_refuses_arguments_on_two_devices():
    pool, table, emax = _args()
    with pytest.raises(ValueError, match="several devices"):
        signature("run_step_pool", (pool, table.to("meta"), emax))


def _count_k2_on_the_cpu(monkeypatch):
    """The engine's K2 calls count a launch on the CPU too, as they do on
    the card."""
    real = tengine_mod.nuc_scores

    def counted(*a):
        k2_ops.LAUNCHES += 1
        return real(*a)

    monkeypatch.setattr(tengine_mod, "nuc_scores", counted)


def _count_k3_on_the_cpu(monkeypatch):
    """The engine's wire-v8 occ calls count a K3 launch on the CPU too, as
    they do on the card."""
    real = tengine_mod.occupancy_packed2

    def counted(*a):
        k3_ops.LAUNCHES += 1
        return real(*a)

    monkeypatch.setattr(tengine_mod, "occupancy_packed2", counted)


def test_counts_advance_once_per_batch_and_not_for_the_capture(monkeypatch):
    """The warm-up counts as itself, the capture nothing, each replay the
    counts its capture saw: K2 launches == K3 launches == engine.steps ==
    batches."""
    _count_k2_on_the_cpu(monkeypatch)
    _count_k3_on_the_cpu(monkeypatch)
    _, eng = _tiny_engine(core=256, batch=2, device="cpu")
    progs = StepPrograms(eng.programs.counters, capture=StandIn())
    b = stages.synthetic_batch(eng, frags=128)
    args = [T(b[k]) for k in ("pool", "table", "packed2", "esc")] + [b["emax"]]
    k0, j0 = k2_ops.LAUNCHES, k3_ops.LAUNCHES
    out = progs("run_step_pool2", eng._run_pool2, *args)
    assert (k2_ops.LAUNCHES - k0, k3_ops.LAUNCHES - j0, eng.steps, progs.captures) == (
        1, 1, 1, 1)
    assert torch.equal(out, eng._run_pool2(*args))
    assert (k2_ops.LAUNCHES - k0, k3_ops.LAUNCHES - j0, eng.steps) == (2, 2, 2)
    for n in (3, 4):
        progs("run_step_pool2", eng._run_pool2, *args)
        assert (k2_ops.LAUNCHES - k0, k3_ops.LAUNCHES - j0, eng.steps) == (n, n, n)
    (prog,) = progs.entries.values()
    assert prog.counts == (1, 0, 1, 1) and progs.replays == 2


def test_a_replay_of_run_step_pool2_adds_one_k3_launch_per_shard(monkeypatch):
    """Through the engine's StepPrograms counters: on two shards each
    run_step_pool2 adds two K3 launches (one per shard), the capture none."""
    _count_k3_on_the_cpu(monkeypatch)
    _, eng = _tiny_engine(core=256, batch=4, device=["cpu", "cpu"])
    progs = StepPrograms(eng.programs.counters, capture=StandIn())
    monkeypatch.setattr(eng, "_program", lambda name, chain: (
        lambda *a: progs(name, chain, *a)))
    b = stages.synthetic_batch(eng, frags=128)
    args = [T(b[k]) for k in ("pool", "table", "packed2", "esc")] + [b["emax"]]
    j0 = k3_ops.LAUNCHES
    first = eng.run_step_pool2(*args)  # shard 0 warms up and captures, shard 1 replays
    assert (k3_ops.LAUNCHES - j0, progs.captures, progs.replays) == (2, 1, 1)
    for n in (2, 3):
        assert torch.equal(eng.run_step_pool2(*args), first)
        assert (k3_ops.LAUNCHES - j0, progs.replays) == (2 * n, 2 * n - 1)
    (prog,) = progs.entries.values()
    assert prog.counts[[o for o, _ in progs.counters].index(k3_ops)] == 1


def test_a_failed_capture_raises_and_leaves_the_counts(monkeypatch):
    """No fallback: the capture's error reaches the caller, no entry is
    kept, and the counters hold the warm-up's counts only."""
    _count_k2_on_the_cpu(monkeypatch)
    _, eng = _tiny_engine(core=256, batch=2, device="cpu")

    def refuse(run, device):
        run()
        raise RuntimeError("operation not permitted when stream is capturing")

    progs = StepPrograms(eng.programs.counters, capture=refuse)
    b = stages.synthetic_batch(eng, frags=128)
    nib = T(jdata.pack_nibble_codes(np.zeros((2, eng.seq_codes_width()), np.uint8)))
    k0 = k2_ops.LAUNCHES
    with pytest.raises(RuntimeError, match="capturing"):
        progs("run_step_pool", eng._run_pool, T(b["pool"]), T(b["table"]), nib, b["emax"])
    assert (k2_ops.LAUNCHES - k0, eng.steps, progs.captures, progs.entries) == (1, 1, 0, {})


def test_cpu_engine_creates_no_program_and_keeps_the_reference_bytes(example):
    """The four fused steps of a CPU engine run eagerly (no entry, no
    capture) and print one set of bytes, the JAX DeviceEngine's at
    test_torch_forms' bars on every batch."""
    fits, jeng, wires, codes, _ = example
    teng = _engine(fits, CFG)
    for d, d12, p, c in zip(wires["delta"], wires["delta12"], wires["pool"], codes):
        nib = jdata.pack_nibble_codes(c)
        packed2, esc, ok = jdata.pack_2bit_codes(c)
        assert ok
        args = {"run_step_delta12": (d12.buf, nib), "run_step_delta": (d.delta, nib),
                "run_step_pool": (p.pool, p.table, nib, p.emax),
                "run_step_pool2": (p.pool, p.table, packed2, esc, p.emax)}
        got = {n: getattr(teng, n)(*(T(a) if isinstance(a, np.ndarray) else a for a in v))
               for n, v in args.items()}
        want = {n: np.asarray(getattr(jeng, n)(
            *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in v)))
            for n, v in args.items()}
        for n in args:
            assert torch.equal(got[n], got["run_step_delta12"]), n
            g, w = got[n].numpy(), want[n]
            assert g.shape == w.shape and g.dtype == w.dtype == np.uint8
            (gi, gc, gn, gq), (wi, wc, wn, wq) = teng.unpack_run(g), jeng.unpack_run(w)
            both = gc & wc
            assert both.mean() > 0.5
            for ch in range(3):
                np.testing.assert_array_equal(gi[:, ch][both], wi[:, ch][both])
            assert (np.abs(gn - wn) <= TOL + np.maximum(gq, wq)[:, None]).all()
    assert teng.programs.entries == {} and teng.programs.captures == 0
    assert teng.programs.replays == 0 and teng.steps == 4 * len(codes)


@pytest.mark.cuda
def test_replays_print_the_eager_chains_bytes_on_the_card():
    """On a card: a capture on the first call, then every replay of each
    fused step byte-equal to its eager chain on the same inputs, K2
    launches == engine.steps."""
    if not torch.cuda.is_available():
        pytest.skip("no GPU: chip_smoke.py phase 5g runs this on the card")
    _, eng = _tiny_engine(core=256, batch=2, device="cuda")
    dev = eng.device
    b = stages.synthetic_batch(eng, frags=256)
    t = stages.resident(eng, b)
    pool2 = (t["pool"], t["table"], t["packed2"], t["esc"], t["emax"])
    pool = (t["pool"], t["table"], t["nib"], t["emax"])
    k0 = k2_ops.LAUNCHES
    for name, chain, args in (("run_step_pool2", eng._run_pool2, pool2),
                              ("run_step_pool", eng._run_pool, pool)):
        for _ in range(3):
            assert torch.equal(getattr(eng, name)(*args), chain(*args)), name
    torch.cuda.synchronize(dev)
    assert (eng.programs.captures, eng.programs.replays) == (2, 4)
    assert k2_ops.LAUNCHES - k0 == eng.steps == 12
    assert eng.programs.pool_bytes > 0
