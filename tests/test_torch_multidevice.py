"""The port's one-process multi-device run against the reference's mesh
(CPU; conftest gives JAX 8 virtual devices): the device rule of
parallel/mesh.py :: auto_devices, TorchEngine sharded over k CPU devices
(bit-equal to one device, and within test_torch_engine's bars of the
reference's DeviceEngine on an 8-device mesh), and run_pipeline sharded
over two devices (all ten files byte-equal to one device, and meeting
parity.compare_runs against the reference's run_pipeline, which shards
over the 8 devices)."""
import dataclasses
import gzip

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nucleoatac_tpu.config import RunConfig, WindowParams
from nucleoatac_tpu.core.chunk import ChunkList
from nucleoatac_tpu.core.pwm import PWM
from nucleoatac_tpu.io.bam import scan_bam
from nucleoatac_tpu.models import data as jdata
from nucleoatac_tpu.models.engine import DeviceEngine
from nucleoatac_tpu.models.pipeline import auto_mesh
from nucleoatac_tpu.parallel.mesh import make_mesh
from nucleoatac_torch.config import RunConfig as TRunConfig, WindowParams as TWindowParams
from nucleoatac_torch.core.chunk import ChunkList as TChunkList
from nucleoatac_torch.core.pwm import PWM as TPWM
from nucleoatac_torch.io.fasta import FastaFile as TFastaFile
from nucleoatac_torch.models.engine import TorchEngine
from nucleoatac_torch.models.nuc import SeqCodesProvider
from nucleoatac_torch.models.pipeline import run_pipeline
from nucleoatac_torch.parallel import mesh as tmesh
from nucleoatac_torch.parity import (
    EXACT_SUFFIXES,
    NUCPOS_SUFFIXES,
    RUN_SUFFIXES,
    SIGNAL_SUFFIXES,
    compare_runs,
    port_config,
)
from synth import make_example
from test_torch_engine import _check_run_buffers, _norms, _tiny_config

B = 8  # windows per batch: 8 virtual JAX devices, k = 1, 2, 4 torch shards
SHARDS = (2, 4)


# ---------------- (a) the device rule ----------------------------------
@pytest.mark.parametrize("device,visible,batch,in_group,want", [
    ("cuda", 8, 8, False, 8),     # every card: 8 % 8 == 0 (test_parallel's case)
    ("cuda", 8, 9, False, 1),     # 9 % 8 != 0: one card
    ("cuda", 4, 64, False, 4),
    ("cuda", 3, 64, False, 1),
    ("cuda", 1, 64, False, 1),    # one visible card
    ("cuda", 0, 64, False, 1),
    ("cuda:1", 4, 64, False, 1),  # an explicit card alone
    ("cuda", 4, 64, True, 1),     # a torchrun rank keeps its card
    ("cpu", 4, 64, False, 1),
])
def test_shard_count(device, visible, batch, in_group, want):
    assert tmesh.shard_count(device, visible, batch, in_group) == want


@pytest.fixture
def four_cards(monkeypatch):
    """auto_devices on a pretend 4-card machine: device_count 4, devices
    taken as given, set_device recorded."""
    current = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(tmesh, "resolve_device", torch.device)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    return current


@pytest.mark.parametrize("device,batch,local_rank,want", [
    ("cuda", 64, None, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    ("cuda", 6, None, ["cuda"]),        # 6 % 4 != 0: the one device asked for
    ("cuda:2", 64, None, ["cuda:2"]),
    ("cuda", 64, "3", ["cuda:3"]),      # torchrun: cuda:{LOCAL_RANK}
    ("cpu", 64, None, ["cpu"]),
])
def test_auto_devices_on_four_cards(four_cards, monkeypatch, device, batch,
                                    local_rank, want):
    if local_rank is not None:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    cfg = TRunConfig(window=TWindowParams(batch=batch))
    got = tmesh.auto_devices(cfg, device)
    assert got == [torch.device(w) for w in want]
    # one card is made the current device, as local_device always has
    assert four_cards == ([] if len(want) > 1 or want == ["cpu"] else got)


def test_auto_devices_takes_a_list_as_given():
    cfg = TRunConfig(window=TWindowParams(batch=B))
    assert tmesh.auto_devices(cfg, ["cpu"] * 4) == [torch.device("cpu")] * 4
    assert tmesh.auto_devices(cfg, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.auto_devices(cfg, ["cpu"] * 3)


def test_engine_rejects_a_batch_that_does_not_divide():
    cfg, fs, mix = _tiny_config(batch=6, port=True)
    with pytest.raises(ValueError, match="does not divide"):
        TorchEngine(cfg, mix, fs, pwm=TPWM.default(), device=["cpu"] * 4)


# ---------------- (b) the sharded engine -------------------------------
@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The reference's DeviceEngine on an 8-device mesh, the port's engine
    on 1, 2 and 4 CPU devices, and make_example's pool and delta12
    batches of 8 windows."""
    cfg, fs, mix = _tiny_config(batch=B)
    tcfg, tfs, tmix = _tiny_config(batch=B, port=True)
    jeng = DeviceEngine(cfg, mix, fs, pwm=PWM.default(), mesh=make_mesh(8))
    tengs = {k: TorchEngine(tcfg, tmix, tfs, pwm=TPWM.default(), device=["cpu"] * k)
             for k in (1, *SHARDS)}
    ex = make_example(tmp_path_factory.mktemp("multidevice_example"))
    frags = scan_bam(ex["bam"], cfg.ingest)
    chunks = ChunkList.read(ex["bed"], frags.chrom_dict).merge()
    tiles = jdata.tile_chunks(chunks, cfg.window, cfg.occ, cfg.vmat)
    tchunks = TChunkList.read(ex["bed"], frags.chrom_dict).merge()
    seq = SeqCodesProvider(TFastaFile(ex["fasta"]), tchunks, tengs[1], B)
    pool = []
    for b in jdata.make_pool_batches(frags, tiles, jeng.width, B):
        rows = seq.rows(b.meta).copy()
        # N bases in rows of every shard, so the escape list splits by row
        rows[[0, 3, 5, 6], [2, 40, 7, 99]] = 4
        pool.append((b, rows))
    delta12 = list(jdata.make_delta12_batches(frags, tiles, jeng.width, B))
    return jeng, tengs, pool, delta12


def test_sharded_run_step_pool2_is_bit_equal_and_meets_the_mesh(sharded):
    """run_step_pool2 over k = 2, 4 devices: the bytes of one device. The
    reference on its 8-device mesh: occ indices equal where both certify,
    f32 norm within nuc.exact_tol, decoded norm within exact_tol plus one
    u16 step (test_torch_engine's bars)."""
    jeng, tengs, pool, _ = sharded
    assert pool
    for b, rows in pool:
        packed2, esc, ok = jdata.pack_2bit_codes(rows)
        assert ok and (esc[:, 1] < tengs[1].seq_codes_width()).sum() >= 4
        args = (b.pool, b.table, packed2, esc, b.emax)
        want = tengs[1].run_step_pool2(*args).numpy()
        for k in SHARDS:
            got = tengs[k].run_step_pool2(*map(_tensor, args)).numpy()
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), k
        jbuf = np.asarray(jeng.run_step_pool2(*map(_jax, args)))
        codes = (packed2, esc)
        jn, tn = _norms(jeng, tengs[2], b, codes, codes, "_logbias_2bit")
        n = len(b.meta)  # the windows of the batch; padding rows follow
        _check_run_buffers(jeng, tengs[2], jbuf[:n], want[:n], jn[:n], tn[:n])


def test_sharded_pool_reads_one_copy_per_device(sharded):
    """A replicated pool (one upload per device) gives the bytes of the
    pool handed over whole."""
    _, tengs, pool, _ = sharded
    b, rows = pool[0]
    packed2, esc, _ = jdata.pack_2bit_codes(rows)
    eng = tengs[4]
    rep = eng.replicate(b.pool)
    assert len(rep) == 1  # four shards on one device hold one copy
    assert torch.equal(eng.run_step_pool2(rep, b.table, packed2, esc, b.emax),
                       eng.run_step_pool2(b.pool, b.table, packed2, esc, b.emax))


def test_sharded_occ_step_delta12_is_bit_equal_and_meets_the_mesh(sharded):
    """occ_step_delta12_p2 over k = 2, 4 devices: the bytes of one device;
    against the reference's mesh engine, grid indices equal wherever both
    certify (test_torch_transfer's bar)."""
    jeng, tengs, _, delta12 = sharded
    steps = {k: e.steps for k, e in tengs.items()}
    for b in delta12:
        want = tengs[1].occ_step_delta12_p2(b.buf).numpy()
        for k in SHARDS:
            assert tengs[k].occ_step_delta12_p2(torch.from_numpy(b.buf)).numpy().tobytes() \
                == want.tobytes(), k
        n = len(b.meta)
        jidx, jcert = jeng.decode_occ2(
            np.asarray(jeng.occ_step_delta12_p2(jnp.asarray(b.buf)))[:n])
        tidx, tcert = tengs[1].decode_occ2(want[:n])
        both = jcert & tcert
        assert both.mean() > 0.5
        for c in range(3):
            np.testing.assert_array_equal(tidx[:, c][both], jidx[:, c][both])
    assert {k: e.steps for k, e in tengs.items()} == steps  # no nuc batch ran


def test_sharded_nuc_steps_count_per_shard(sharded):
    """Each shard's chain is one nuc batch: k shards count k steps, and the
    u16 norm is the bytes of one device."""
    _, tengs, _, delta12 = sharded
    b = delta12[0]
    codes = np.zeros((B, (tengs[1].seq_codes_width() + 1) // 2), np.uint8)
    want = tengs[1].nuc_step_delta12_seq_m16(b.buf, codes)
    for k in SHARDS:
        before = tengs[k].steps
        got = tengs[k].nuc_step_delta12_seq_m16(b.buf, codes)
        assert tengs[k].steps - before == k
        assert torch.equal(got, want), k


def _tensor(a):
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


def _jax(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


# ---------------- (c) run_pipeline over two devices ---------------------
CFG = RunConfig(window=WindowParams(core=256, batch=B))
TOL = CFG.nuc.exact_tol
WIRES = ("pool", "delta12", "frags")


def _cfg(wire):
    return dataclasses.replace(CFG, window=dataclasses.replace(CFG.window, transfer=wire))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per wire: the reference's run_pipeline (its 8-device mesh) and the
    port's on one and on two CPU devices."""
    from nucleoatac_tpu.models.pipeline import run_pipeline as run_jax

    d = tmp_path_factory.mktemp("multidevice_runs")
    ex = make_example(d)
    kw = dict(fasta_path=ex["fasta"], write_plots=False)
    out, steps = {}, {}
    for wire in WIRES:
        out[wire] = {k: str(d / f"{wire}_{k}") for k in ("jax", 1, 2)}
        run_jax(ex["bam"], ex["bed"], out[wire]["jax"], cfg=_cfg(wire), **kw)
        for k in (1, 2):
            res = run_pipeline(ex["bam"], ex["bed"], out[wire][k],
                               cfg=port_config(_cfg(wire)), device=["cpu"] * k, **kw)
            assert res.engine.devices == [torch.device("cpu")] * k
            steps[wire, k] = res.engine.steps
    return out, steps


def test_reference_run_shards_over_its_mesh():
    assert auto_mesh(CFG) is not None and auto_mesh(CFG).size == 8


@pytest.mark.parametrize("wire", WIRES)
def test_two_device_run_prints_the_one_device_bytes(runs, wire):
    """All ten files, decompressed, byte for byte those of one device; each
    shard counts its nuc batches."""
    out, steps = runs
    for sfx in RUN_SUFFIXES:
        with gzip.open(out[wire][1] + sfx) as a, gzip.open(out[wire][2] + sfx) as b:
            one = a.read()
            assert one and b.read() == one, sfx
    assert steps[wire, 2] == 2 * steps[wire, 1] > 0


@pytest.mark.parametrize("wire", WIRES)
def test_two_device_run_meets_the_reference_mesh_run(runs, wire):
    """parity.compare_runs against the reference's sharded run, at
    test_torch_wires' bar: eight files row-equal (nucpos but its column
    8), signal tracks within nuc.exact_tol."""
    out, _ = runs
    stats = compare_runs(out[wire]["jax"], out[wire][2], TOL)
    for sfx in EXACT_SUFFIXES + NUCPOS_SUFFIXES:
        assert stats[sfx] > 0, sfx
    for sfx in SIGNAL_SUFFIXES:
        assert stats[sfx + " max_abs_diff"] <= TOL
