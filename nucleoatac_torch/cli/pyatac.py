"""`pyatac-torch` CLI: reusable ATAC-seq utilities.

Counterpart of nucleoatac_tpu/cli/pyatac.py with the same ten subcommands
(bias, vplot, bias_vplot, ins, cov, sizes, counts, pwm, signal,
nucleotide) and flags. ``vplot --device`` aggregates on the GPU and
raises without one.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from nucleoatac_tpu.config import IngestParams
from nucleoatac_tpu.core.chunk import ChunkList
from nucleoatac_tpu.core.pwm import PWM
from nucleoatac_tpu.core.vmat import VMat
from nucleoatac_tpu.io.bam import scan_bam
from nucleoatac_tpu.io.fasta import FastaFile
from nucleoatac_tpu.io.tabix import TabixWriter
from nucleoatac_torch import pyatac as P


def _add_bam(p, bed_required=True):
    p.add_argument("--bam", required=True)
    p.add_argument("--bed", required=bed_required, default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--not_atac", action="store_true")
    p.add_argument("--no_plots", action="store_true")


def pyatac_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pyatac-torch", description="ATAC-seq utilities"
    )
    sub = p.add_subparsers(dest="command", required=True)

    pb = sub.add_parser("bias", help="per-bp Tn5 insertion bias bedgraph")
    pb.add_argument("--fasta", required=True)
    pb.add_argument("--bed", default=None)
    pb.add_argument("--pwm", default=None)
    pb.add_argument("--out", required=True)

    pv = sub.add_parser("vplot", help="aggregate V-plot around BED features")
    _add_bam(pv)
    pv.add_argument("--lower", type=int, default=105)
    pv.add_argument("--upper", type=int, default=251)
    pv.add_argument("--flank", type=int, default=73)
    pv.add_argument(
        "--device", action="store_true",
        help="aggregate on the GPU (batched raster; equal to the host "
             "path)",
    )

    pbv = sub.add_parser("bias_vplot", help="expected V-plot from Tn5 bias")
    _add_bam(pbv)
    pbv.add_argument("--fasta", required=True)
    pbv.add_argument("--pwm", default=None)
    pbv.add_argument("--sizes", default=None, help="fragmentsizes.txt")
    pbv.add_argument("--lower", type=int, default=105)
    pbv.add_argument("--upper", type=int, default=251)
    pbv.add_argument("--flank", type=int, default=73)

    pi = sub.add_parser("ins", help="per-bp insertion track")
    _add_bam(pi)

    pc = sub.add_parser("cov", help="smoothed coverage track")
    _add_bam(pc)
    pc.add_argument("--window", type=int, default=121)
    pc.add_argument("--lower", type=int, default=0)
    pc.add_argument("--upper", type=int, default=1 << 30)

    ps = sub.add_parser("sizes", help="fragment size distribution")
    _add_bam(ps, bed_required=False)
    ps.add_argument("--lower", type=int, default=0)
    ps.add_argument("--upper", type=int, default=1000)

    pn = sub.add_parser("counts", help="fragment counts per region")
    _add_bam(pn)

    pp = sub.add_parser("pwm", help="nucleotide frequencies at insertions")
    _add_bam(pp, bed_required=False)
    pp.add_argument("--fasta", required=True)
    pp.add_argument("--up", type=int, default=9)
    pp.add_argument("--down", type=int, default=9)

    pg = sub.add_parser(
        "signal", help="extract track signal around BED feature centers"
    )
    pg.add_argument("--bed", required=True)
    pg.add_argument("--bg", required=True, help="tabixed bedgraph track")
    pg.add_argument("--out", required=True)
    pg.add_argument("--up", type=int, default=250)
    pg.add_argument("--down", type=int, default=250)
    pg.add_argument(
        "--all", action="store_true",
        help="also write the per-feature signal matrix",
    )
    pg.add_argument(
        "--norm", action="store_true",
        help="normalize each feature row by its mean before aggregating",
    )

    pt = sub.add_parser(
        "nucleotide", help="nucleotide frequencies around BED feature centers"
    )
    pt.add_argument("--bed", required=True)
    pt.add_argument("--fasta", required=True)
    pt.add_argument("--out", required=True)
    pt.add_argument("--up", type=int, default=250)
    pt.add_argument("--down", type=int, default=250)
    pt.add_argument("--no_plots", action="store_true")
    return p


def main(argv=None) -> int:
    args = pyatac_parser().parse_args(argv)
    cmd = args.command

    if cmd == "bias":
        fasta = FastaFile(args.fasta)
        pwm = PWM.open(args.pwm) if args.pwm else PWM.default()
        chrom_dict = fasta.get_chrom_dict()
        if args.bed:
            chunks = ChunkList.read(args.bed, chrom_dict).merge()
        else:
            from nucleoatac_tpu.core.chunk import Chunk

            chunks = ChunkList(
                [Chunk(n, 0, l) for n, l in chrom_dict.items()]
            ).sort()
        from nucleoatac_torch.models.nuc import chunk_log_bias

        with TabixWriter(f"{args.out}.Scores.bedgraph.gz") as w:
            for c in chunks:
                b = chunk_log_bias(fasta, pwm, c.chrom, c.start, c.end)
                w.add_bedgraph(c.chrom, c.start, b)
        return 0

    if cmd == "signal":
        from nucleoatac_tpu.io.tabix import TabixReader

        feats = ChunkList.read(args.bed)
        mat = P.track_signal_matrix(
            TabixReader(args.bg), feats, args.up, args.down
        )
        if args.norm:
            means = np.nanmean(mat, axis=1, keepdims=True)
            means[~np.isfinite(means) | (means == 0)] = 1.0
            mat = mat / means
        agg = np.nanmean(mat, axis=0)
        offs = np.arange(-args.up, args.down + 1)
        with open(f"{args.out}.signal.agg.txt", "w") as fh:
            for o, v in zip(offs, agg):
                fh.write(f"{o}\t{'NA' if np.isnan(v) else f'{v:.6g}'}\n")
        if args.all:
            np.savetxt(f"{args.out}.signal.txt", mat, fmt="%.6g")
        return 0

    if cmd == "nucleotide":
        fasta = FastaFile(args.fasta)
        feats = ChunkList.read(args.bed, fasta.get_chrom_dict())
        freq = P.nucleotide_freq_matrix(fasta, feats, args.up, args.down)
        offs = np.arange(-args.up, args.down + 1)
        with open(f"{args.out}.nucfreq.txt", "w") as fh:
            fh.write("#offset\tA\tC\tG\tT\n")
            for j, o in enumerate(offs):
                fh.write(
                    f"{o}\t" + "\t".join(f"{freq[i, j]:.6g}" for i in range(4))
                    + "\n"
                )
        return 0

    ingest = IngestParams(atac=not getattr(args, "not_atac", False))
    frags = scan_bam(args.bam, ingest)
    chunks = (
        ChunkList.read(args.bed, frags.chrom_dict).merge() if args.bed else None
    )

    if cmd == "vplot":
        feats = ChunkList.read(args.bed, frags.chrom_dict)
        if args.device:
            mat = P.aggregate_vplot_device(
                frags, feats, args.lower, args.upper, args.flank, device="cuda"
            )
        else:
            mat = P.aggregate_vplot(frags, feats, args.lower, args.upper, args.flank)
        v = VMat(mat, args.lower, args.upper)
        v.save(f"{args.out}.VMat")
        if not args.no_plots:
            from nucleoatac_tpu.utils import plotting

            plotting.plot_vmat(v, f"{args.out}.VMat.eps")
        return 0

    if cmd == "bias_vplot":
        fasta = FastaFile(args.fasta)
        pwm = PWM.open(args.pwm) if args.pwm else PWM.default()
        if args.sizes:
            from nucleoatac_tpu.core.fragmentsizes import FragmentSizes

            fs = FragmentSizes.open(args.sizes)
        else:
            fs = P.sizes_histogram(frags, chunks, 0, args.upper)
        mat = P.bias_vplot(
            frags, fasta, pwm, ChunkList.read(args.bed, frags.chrom_dict), fs,
            args.lower, args.upper, args.flank,
        )
        v = VMat(mat, args.lower, args.upper)
        v.save(f"{args.out}.Bias.VMat")
        if not args.no_plots:
            from nucleoatac_tpu.utils import plotting

            plotting.plot_vmat(v, f"{args.out}.Bias.VMat.eps")
        return 0

    if cmd == "ins":
        with TabixWriter(f"{args.out}.ins.bedgraph.gz") as w:
            for c in chunks:
                w.add_bedgraph(c.chrom, c.start, P.insertion_track(frags, c))
        return 0

    if cmd == "cov":
        with TabixWriter(f"{args.out}.cov.bedgraph.gz") as w:
            for c in chunks:
                track = P.coverage_track(frags, c, args.window, args.lower, args.upper)
                w.add_bedgraph(c.chrom, c.start, track)
        return 0

    if cmd == "sizes":
        fs = P.sizes_histogram(frags, chunks, args.lower, args.upper)
        fs.save(f"{args.out}.fragmentsizes.txt")
        if not args.no_plots:
            from nucleoatac_tpu.utils import plotting

            plotting.plot_fragmentsizes(fs, f"{args.out}.fragmentsizes.eps")
        return 0

    if cmd == "counts":
        cl = ChunkList.read(args.bed, frags.chrom_dict)
        counts = P.region_counts(frags, cl)
        with open(f"{args.out}.counts.txt", "w") as fh:
            for c, n in zip(cl, counts):
                fh.write(f"{c.chrom}\t{c.start}\t{c.end}\t{int(n)}\n")
        return 0

    if cmd == "pwm":
        fasta = FastaFile(args.fasta)
        pwm = P.pwm_from_data(frags, fasta, chunks, args.up, args.down)
        pwm.save(f"{args.out}.PWM.txt")
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
