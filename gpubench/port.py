"""The program under test, set up from the benchmark's inputs.

Everything the benchmark takes from the program is here: its run
configuration, its fragment store, its peak chunks and tiles, its mixture
fit, its engine on the configuration's devices and the two stages whose
batch loops the routes drive. The raw reads become the program's adjusted
fragments as its BAM scanner makes them (left + 4, length - 9, lengths
outside [1, max_size] dropped), then its own midpoint sort; the genome is
served to it through ``fetch``, as its FASTA reader serves a file.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nucleoatac_torch.config import RunConfig
from nucleoatac_torch.core.chunk import Chunk, ChunkList
from nucleoatac_torch.core.pwm import PWM
from nucleoatac_torch.core.vmat import VMat
from nucleoatac_torch.io.bam import BamFragments, _to_mid_sorted
from nucleoatac_torch.models.data import tile_chunks
from nucleoatac_torch.models.engine import TorchEngine
from nucleoatac_torch.models.nuc import NucStage
from nucleoatac_torch.models.occ import OccStage, fit_mixture
from nucleoatac_torch.parallel.mesh import auto_devices

from gpubench.inputs import tn5_pwm, vplot_template

_ASCII = np.frombuffer(b"ACGT", np.uint8)


class GenomeFasta:
    """The genome's base codes behind the FASTA reader's ``fetch``:
    0-based half-open, clipped to the chromosome, upper case."""

    def __init__(self, genome: dict):
        self.genome = genome

    def fetch(self, chrom: str, start: int, end: int) -> bytes:
        codes = self.genome[chrom]
        return _ASCII[codes[max(0, start):min(len(codes), end)]].tobytes()


def run_config(stated: dict) -> RunConfig:
    """RunConfig with every group's stated fields."""
    base = RunConfig()
    return dataclasses.replace(base, **{
        group: dataclasses.replace(getattr(base, group), **fields)
        for group, fields in stated.items()})


def devices(cfg: RunConfig, n: int, device_type: str) -> list:
    """One card (cuda:0), or every visible card as the program's own rule
    picks them; on the CPU, ``n`` shards of the CPU."""
    if device_type == "cpu":
        return ["cpu"] * n
    if n == 1:
        return ["cuda:0"]
    devs = auto_devices(cfg, "cuda")
    if len(devs) != n:
        raise RuntimeError(f"the batch shards over {len(devs)} cards, the cell asks for {n}")
    return devs


class Port:
    """The program's objects for one run of a cell."""

    def __init__(self, stated: dict, data, n_devices: int, device_type: str):
        cfg = self.cfg = run_config(stated)
        ing = cfg.ingest
        shift, shrink = (4, 9) if ing.atac else (0, 0)
        lefts, sizes = {}, {}
        for c in data.names:
            size = data.tlens[c] - shrink
            keep = (size >= 1) & (size <= ing.max_size)
            lefts[c] = (data.lefts[c][keep] + shift).astype(np.int32)
            sizes[c] = size[keep].astype(np.int32)
        mids, msizes = _to_mid_sorted(lefts, sizes)
        self.frags = BamFragments(list(data.names), list(data.lengths), mids, msizes)
        self.fasta = GenomeFasta(data.genome)
        probs, up = tn5_pwm()
        self.pwm = PWM(probs, up)
        v = cfg.vmat
        self.vmat = VMat(vplot_template(v.lower, v.upper, v.width, v.smooth_sd_size,
                                        v.smooth_sd_pos), v.lower, v.upper)
        self.chunks = ChunkList([Chunk(c, a, b) for c, a, b in data.peaks]).merge()
        self.tiles = tile_chunks(self.chunks, cfg.window, cfg.occ, cfg.vmat)
        self.fs, self.mix = fit_mixture(self.frags, self.chunks, cfg)
        self.devices = devices(cfg, n_devices, device_type)
        self.engine = TorchEngine(cfg, self.mix, self.fs, self.vmat, pwm=self.pwm,
                                  device=self.devices, conv=cfg.window.conv)
        self.occ_stage = OccStage(cfg, self.engine)
        self.nuc_stage = NucStage(cfg, self.engine, self.pwm, self.fasta)

    def synchronize(self) -> None:
        for d in dict.fromkeys(self.engine.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
