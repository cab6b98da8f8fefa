"""`nucleoatac run` on PyTorch: occ -> nuc -> merge -> nfr.

Counterpart of nucleoatac_tpu/models/pipeline.py :: run_pipeline:
ingest, mixture fit, the occ and nuc stages on ``device`` — the fused pass
(models/fused.py) on the pool wire, else the two-pass stages
(``--bias_track``, every other wire, non-exact mode) — then merge and nfr,
writing every reference output file. ``resume`` rebuilds the occ stage from
its files and runs the nuc stage alone.
"""
from __future__ import annotations

import gzip
import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from nucleoatac_torch.config import RunConfig
from nucleoatac_torch.core.chunk import Chunk, ChunkList
from nucleoatac_torch.core.fragmentsizes import FragmentSizes
from nucleoatac_torch.core.mixture import FragmentMixDistribution
from nucleoatac_torch.core.pwm import PWM
from nucleoatac_torch.core.vmat import VMat
from nucleoatac_torch.io.bam import scan_bam
from nucleoatac_torch.io.fasta import FastaFile
from nucleoatac_torch.models.engine import TorchEngine
from nucleoatac_torch.models.fused import fused_supported, run_fused
from nucleoatac_torch.models.merge import merge_maps
from nucleoatac_torch.models.nfr import call_nfrs
from nucleoatac_torch.models.nuc import BiasTrackSource, NucStage, NucStageResult
from nucleoatac_torch.models.occ import (
    OccPeak,
    OccStage,
    OccStageResult,
    fit_mixture,
)
from nucleoatac_torch.parallel.mesh import auto_devices
from nucleoatac_torch.models.standalone import (
    OccTrackReader,
    SequentialOccTracks,
    _LazyOccTracks,
    warn_synthetic_defaults,
)


@dataclass
class RunResult:
    occ: OccStageResult
    nuc: NucStageResult
    combined: list
    nfrs: list
    engine: TorchEngine
    occ_stage: Optional[OccStage]  # None when the occ stage was resumed
    nuc_stage: NucStage


def _occ_outputs_exist(prefix: str) -> bool:
    return all(
        os.path.exists(prefix + s)
        for s in (
            ".occ.bedgraph.gz", ".occ.lower_bound.bedgraph.gz",
            ".occ.upper_bound.bedgraph.gz", ".occpeaks.bed.gz",
            ".fragmentsizes.txt", ".occ_fit.txt",
        )
    )


def _load_occ_stage(prefix: str, cfg: RunConfig, chunks: ChunkList):
    """--resume: reconstruct the occ stage result from its file artifacts
    (the stage files double as checkpoints)."""
    fs = FragmentSizes.open(f"{prefix}.fragmentsizes.txt")
    mix = FragmentMixDistribution.open(f"{prefix}.occ_fit.txt")
    reader = OccTrackReader(prefix)
    res = OccStageResult(mix=mix, fragmentsizes=fs, chunks=chunks)
    for cid, chunk in enumerate(chunks):
        res.tracks[cid] = reader.chunk_tracks(chunk)
    flank = cfg.occ.flank
    with gzip.open(f"{prefix}.occpeaks.bed.gz", "rt") as fh:
        for line in fh:
            f = line.split("\t")
            if len(f) >= 6:
                res.peaks.append(
                    OccPeak(f[0], int(f[1]) + flank, float(f[3]), float(f[4]),
                            float(f[5]))
                )
    return fs, mix, res


def occ_lookup_from_tracks(occ_result: OccStageResult):
    """occ stat accessor for dyad calls, backed by in-memory chunk tracks."""

    def lookup(cid: int, chunk: Chunk, pos: int) -> Tuple[float, float, float]:
        tr = occ_result.tracks.get(cid)
        if tr is None:
            return 0.0, 0.0, 1.0
        i = pos - chunk.start
        if i < 0 or i >= len(tr["occ"]):
            return 0.0, 0.0, 1.0
        return float(tr["occ"][i]), float(tr["lower"][i]), float(tr["upper"][i])

    return lookup


def run_pipeline(
    bam: str,
    bed: str,
    out_prefix: str,
    fasta_path: Optional[str] = None,
    pwm_path: Optional[str] = None,
    vmat_path: Optional[str] = None,
    cfg: Optional[RunConfig] = None,
    write_plots: bool = True,
    resume: bool = False,
    bias_track: Optional[str] = None,
    device: Union[str, Sequence[str]] = "cuda",
    profile_dir: Optional[str] = None,
) -> RunResult:
    """Run the whole pipeline on ``device`` ("cuda" raises when no card is
    available; "cpu" runs the plain versions of the kernels). "cuda"
    shards each window batch over every visible card when the batch
    divides among them, "cuda:k" keeps card k, and a list names the
    devices to shard over (parallel/mesh.py :: auto_devices). The xcorr
    route is ``cfg.window.conv``; ``profile_dir`` writes a torch.profiler
    trace of the run there."""
    from nucleoatac_torch.utils.logging import log, maybe_profile, stage_timer

    cfg = cfg or RunConfig()
    warn_synthetic_defaults(pwm_path, vmat_path, bias_track, needs_vmat=True)
    with maybe_profile(profile_dir, device if isinstance(device, str) else device[0]):
        with stage_timer("ingest"):
            frags = scan_bam(bam, cfg.ingest)
            log.info("ingest: %d fragments, %d chroms",
                     frags.n_fragments(), len(frags.ref_names))
        fasta = FastaFile(fasta_path) if fasta_path else None
        pwm = PWM.open(pwm_path) if pwm_path else PWM.default()
        vmat = VMat.open(vmat_path) if vmat_path else VMat.default(cfg.vmat)
        bias_source = BiasTrackSource(bias_track) if bias_track else None
        chunks = ChunkList.read(bed, frags.chrom_dict).merge()
        log.info("peaks: %d chunks, %d bp", len(chunks), chunks.total_bp())

        devices = auto_devices(cfg, device)

        def make_engine(mix, fs):
            # a bias track replaces the on-device PWM (the nuc stage uploads
            # f32 log-bias rows), which also rules out the fused pass
            return TorchEngine(
                cfg, mix, fs, vmat, pwm=None if bias_source else pwm,
                device=devices, conv=cfg.window.conv,
            )

        occ_stage = None
        if resume and _occ_outputs_exist(out_prefix):
            with stage_timer("occ (resumed from files)"):
                fs, mix, occ_res = _load_occ_stage(out_prefix, cfg, chunks)
                engine = make_engine(mix, fs)
            with stage_timer("nuc"):
                nuc_stage = NucStage(cfg, engine, pwm, fasta, bias_source=bias_source)
                nuc_res = nuc_stage.run(
                    frags, chunks, occ_lookup_from_tracks(occ_res), out_prefix
                )
                log.info("nuc: %d dyads (%d redundant)",
                         len(nuc_res.calls), len(nuc_res.redundant))
        else:
            with stage_timer("fit"):
                fs, mix = fit_mixture(frags, chunks, cfg)
                fs.save(f"{out_prefix}.fragmentsizes.txt")
                mix.save(f"{out_prefix}.occ_fit.txt")
                if write_plots:
                    from nucleoatac_torch.utils import plotting

                    plotting.plot_occ_fit(mix, f"{out_prefix}.occ_fit.eps")
                engine = make_engine(mix, fs)
            occ_stage = OccStage(cfg, engine)
            nuc_stage = NucStage(cfg, engine, pwm, fasta, bias_source=bias_source)
            if fused_supported(cfg, engine):
                with stage_timer("occ+nuc (fused pass)"):
                    occ_res, nuc_res = run_fused(
                        cfg, engine, occ_stage, nuc_stage, frags, chunks, mix, fs,
                        out_prefix, keep_tracks=False,
                    )
                    log.info(
                        "occ: %d occ peaks; nuc: %d dyads (%d redundant)",
                        len(occ_res.peaks), len(nuc_res.calls),
                        len(nuc_res.redundant),
                    )
            else:
                with stage_timer("occ"):
                    occ_res = occ_stage.run(
                        frags, chunks, mix, fs, out_prefix, keep_tracks=True
                    )
                    log.info("occ: %d occ peaks", len(occ_res.peaks))
                with stage_timer("nuc"):
                    nuc_res = nuc_stage.run(
                        frags, chunks, occ_lookup_from_tracks(occ_res), out_prefix
                    )
                    log.info("nuc: %d dyads (%d redundant)",
                             len(nuc_res.calls), len(nuc_res.redundant))
            # both paths hand downstream consumers the SAME occ surface: the
            # bedgraphs just written (the fused pass evicted its tracks as nuc
            # consumed them; the reference's nfr stage also reads the files)
            occ_res.tracks = _LazyOccTracks(OccTrackReader(out_prefix), chunks)
        np.savetxt(
            f"{out_prefix}.nuc_dist.txt", nuc_res.nuc_dist[None], fmt="%d",
            delimiter="\t",
        )
        if write_plots:
            from nucleoatac_torch.utils import plotting

            plotting.plot_nuc_dist(nuc_res.nuc_dist, f"{out_prefix}.nuc_dist.eps")

        combined = merge_maps(
            nuc_res.calls, occ_res.peaks, cfg.occ.occ_sep,
            f"{out_prefix}.nucmap_combined.bed.gz",
        )
        with stage_timer("nfr"):
            # nfr iterates chunks strictly in order -> stream the written occ
            # bedgraphs in ONE pass (same printed surface as occ_res.tracks)
            nfrs = call_nfrs(
                cfg, chunks, combined, SequentialOccTracks(out_prefix, chunks),
                frags, pwm, fasta, f"{out_prefix}.nfrpos.bed.gz",
                bias_fn=bias_source.log_bias if bias_source else None,
            )
            log.info("nfr: %d NFRs; combined map: %d", len(nfrs), len(combined))
        return RunResult(occ_res, nuc_res, combined, nfrs, engine, occ_stage, nuc_stage)
