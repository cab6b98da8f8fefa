"""`nucleoatac-torch` CLI: run / occ / vprocess / nuc / merge / nfr.

Counterpart of nucleoatac_tpu/cli/nucleoatac.py with the same subcommands
and flags, except:
  * ``--device {cuda,cuda:k,cpu}`` (default cuda) replaces
    ``--platform``: cuda shards each window batch over every visible card
    when the batch divides among them, as the reference's mesh does;
    cuda:k takes card k alone; cuda without a card is an error, never a
    silent CPU run;
  * ``--conv`` diag runs the K2 kernel, diag_pallas two K1 launches, and
    direct two full-float32 ``conv1d`` calls;
  * ``--transfer delta12`` and ``delta`` run the two passes, where the
    reference runs its fused pass (the same outputs; on the H100 the fused
    pass is the slower of the two);
  * ``--fetch-threads`` is gone (a relay setting);
  * ``--profile DIR`` writes a torch.profiler trace (TensorBoard format);
  * ``--num_hosts``/``--host_id`` run one host's shard on its devices
    (``cuda:{LOCAL_RANK}`` under torchrun, whose environment also forms
    the gloo process group), and ``--finalize`` merges the shards.
Plots need matplotlib, which is imported only when plots are written.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from nucleoatac_torch.config import (
    NFRParams,
    NucParams,
    OccParams,
    RunConfig,
    SizesParams,
    WindowParams,
)
from nucleoatac_torch.models.engine import CONV_ROUTES
from nucleoatac_torch.models.occ import WIRES


def _device_arg(s: str) -> str:
    """--device: cuda, cuda:k or cpu."""
    if s in ("cuda", "cpu") or (s.startswith("cuda:") and s[5:].isdigit()):
        return s
    raise argparse.ArgumentTypeError(f"{s!r}: expected cuda, cuda:k or cpu")


def _common(p: argparse.ArgumentParser, fasta_required: bool = False) -> None:
    p.add_argument("--bed", required=True, help="peak regions (BED)")
    p.add_argument("--bam", required=True, help="coordinate-sorted paired-end BAM")
    p.add_argument("--out", required=True, help="output prefix")
    p.add_argument("--fasta", required=fasta_required, default=None)
    p.add_argument("--pwm", default=None, help="Tn5 PWM file (default: built-in)")
    p.add_argument("--cores", type=int, default=1, help="compat flag (device-parallel)")
    p.add_argument("--no_plots", action="store_true")


def _tune(p: argparse.ArgumentParser) -> None:
    p.add_argument("--lower", type=int, default=SizesParams.lower)
    p.add_argument("--upper", type=int, default=SizesParams.upper)
    p.add_argument("--flank", type=int, default=OccParams.flank)
    p.add_argument("--min_occ", type=float, default=OccParams.min_occ)
    p.add_argument("--occ_sep", type=int, default=OccParams.occ_sep)
    p.add_argument("--nuc_sep", type=int, default=NucParams.nuc_sep)
    p.add_argument("--min_z", type=float, default=NucParams.min_z)
    p.add_argument("--min_lr", type=float, default=NucParams.min_lr)
    p.add_argument("--smooth_sd", type=float, default=NucParams.smooth_sd)
    p.add_argument("--max_occ_upper", type=float, default=NFRParams.max_occ_upper)
    p.add_argument("--min_nfr_len", type=int, default=NFRParams.min_nfr_len)
    p.add_argument("--max_nfr_len", type=int, default=NFRParams.max_nfr_len)
    p.add_argument("--not_atac", action="store_true", help="skip +4/-5 offsets")
    p.add_argument(
        "--strict", action="store_true",
        help="f64-refinish the smoothed-score column of every printed "
             "nucpos row",
    )
    p.add_argument(
        "--device", default="cuda", type=_device_arg,
        help="torch device of the occ and nuc stages: cuda shards each "
             "window batch over every visible GPU when the batch divides "
             "among them (one per rank under torchrun), cuda:k takes GPU k "
             "alone, cpu runs the kernels' plain versions; cuda raises "
             "without a GPU",
    )
    p.add_argument(
        "--batch", type=int, default=WindowParams.batch,
        help="windows per device batch",
    )
    p.add_argument(
        "--conv", default=WindowParams.conv, choices=list(CONV_ROUTES),
        help="nuc template xcorr: diag (the nuc_scores kernel), "
             "diag_pallas (two diag_xcorr launches, then the epilogue) or "
             "direct (two float32 conv1d calls, then the epilogue)",
    )
    p.add_argument(
        "--transfer", default=WindowParams.transfer, choices=list(WIRES),
        help="host->device wire format: pool runs the fused pass, the "
             "others the two passes; the standalone stages take pool as "
             "delta12. Only packed, frags and dense carry sizes above 255",
    )
    p.add_argument(
        "--finish-threads", type=int, default=WindowParams.finish_threads,
        help="host chunk-finishing worker threads (-1 = auto, 0 = serial; "
             "writes stay genome-ordered)",
    )


def build_config(args: argparse.Namespace) -> RunConfig:
    cfg = RunConfig()
    transfer = getattr(args, "transfer", cfg.window.transfer)
    if transfer in ("delta", "delta12", "pool") and args.upper > 255:
        print(
            f"WARNING: --upper {args.upper} > 255 is incompatible with the "
            f"'{transfer}' wire format (uint8 size field); falling back "
            "to 'packed'",
            file=sys.stderr,
        )
        transfer = "packed"
    return dataclasses.replace(
        cfg,
        ingest=dataclasses.replace(cfg.ingest, atac=not getattr(args, "not_atac", False)),
        window=dataclasses.replace(
            cfg.window,
            conv=getattr(args, "conv", cfg.window.conv),
            batch=getattr(args, "batch", cfg.window.batch),
            transfer=transfer,
            finish_threads=getattr(
                args, "finish_threads", cfg.window.finish_threads
            ),
        ),
        sizes=dataclasses.replace(cfg.sizes, lower=args.lower, upper=args.upper),
        occ=dataclasses.replace(
            cfg.occ, flank=args.flank, min_occ=args.min_occ, occ_sep=args.occ_sep
        ),
        nuc=dataclasses.replace(
            cfg.nuc,
            nuc_sep=args.nuc_sep,
            min_z=args.min_z,
            min_lr=args.min_lr,
            smooth_sd=args.smooth_sd,
            strict=getattr(args, "strict", False),
        ),
        nfr=dataclasses.replace(
            cfg.nfr,
            max_occ_upper=args.max_occ_upper,
            min_nfr_len=args.min_nfr_len,
            max_nfr_len=args.max_nfr_len,
        ),
    )


def nucleoatac_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nucleoatac-torch",
        description="Nucleosome calling from ATAC-seq on PyTorch/CUDA "
        "(capabilities of GreenleafLab/NucleoATAC)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("run", help="occ + nuc + merge + nfr")
    _common(pr)
    _tune(pr)
    pr.add_argument("--vmat", default=None, help="V-plot template (default built-in)")
    pr.add_argument("--bias_track", default=None, metavar="BEDGRAPH_GZ",
                    help="precomputed per-bp log-bias track (pyatac bias "
                    "output) used instead of FASTA+PWM scoring")
    pr.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace (TensorBoard "
                    "*.pt.trace.json) of the run to DIR")
    pr.add_argument("--num_hosts", type=int, default=None,
                    help="multi-host run: total hosts (or WORLD_SIZE from "
                    "torchrun)")
    pr.add_argument("--host_id", type=int, default=None,
                    help="multi-host run: this host's index (or RANK from "
                    "torchrun)")
    pr.add_argument("--resume", action="store_true",
                    help="reuse existing occ outputs (stage files are "
                    "checkpoints, as in the reference)")
    pr.add_argument("--finalize", action="store_true",
                    help="merge per-host shards + run merge/nfr (host 0, "
                    "after all hosts finish; automatic under torchrun)")

    po = sub.add_parser("occ", help="occupancy stage only")
    _common(po)
    _tune(po)

    pv = sub.add_parser("vprocess", help="raw aggregate V-plot -> template")
    pv.add_argument("--vplot", required=True, help="raw V-plot matrix (VMat text)")
    pv.add_argument("--out", required=True)
    pv.add_argument("--lower", type=int, default=105)
    pv.add_argument("--upper", type=int, default=251)
    pv.add_argument("--width", type=int, default=147)
    pv.add_argument("--smooth_sd_size", type=float, default=1.0)
    pv.add_argument("--smooth_sd_pos", type=float, default=1.0)
    pv.add_argument("--no_plots", action="store_true")

    pn = sub.add_parser("nuc", help="dyad-calling stage only")
    _common(pn)
    _tune(pn)
    pn.add_argument("--vmat", default=None)
    pn.add_argument(
        "--occ_track_prefix", default=None,
        help="prefix of a prior `occ` run (defaults to --out)",
    )
    pn.add_argument("--sizes", default=None, help="fragmentsizes.txt from occ run")
    pn.add_argument("--bias_track", default=None, metavar="BEDGRAPH_GZ",
                    help="precomputed per-bp log-bias track (pyatac bias "
                    "output) used instead of FASTA+PWM scoring")

    pm = sub.add_parser("merge", help="merge occpeaks + nucpos")
    pm.add_argument("--occpeaks", required=True)
    pm.add_argument("--nucpos", required=True)
    pm.add_argument("--out", required=True)
    pm.add_argument("--sep", type=int, default=OccParams.occ_sep)

    pf = sub.add_parser("nfr", help="NFR calling from a prior run")
    _common(pf)
    _tune(pf)
    pf.add_argument("--occ_track_prefix", default=None)
    pf.add_argument("--calls", default=None, help="nucmap_combined.bed.gz")
    pf.add_argument("--bias_track", default=None, metavar="BEDGRAPH_GZ",
                    help="precomputed per-bp log-bias track (pyatac bias "
                    "output) used instead of FASTA+PWM scoring")
    return p


def main(argv=None) -> int:
    args = nucleoatac_parser().parse_args(argv)
    if args.command == "run":
        if args.finalize:
            from nucleoatac_torch.models.distributed_pipeline import finalize_shards

            finalize_shards(
                args.out, args.num_hosts or 1, args.bam, args.bed,
                args.fasta, args.pwm, build_config(args),
            )
            return 0
        if args.num_hosts or args.host_id is not None:
            from nucleoatac_torch.models.distributed_pipeline import run_distributed

            run_distributed(
                args.bam, args.bed, args.out,
                fasta_path=args.fasta, pwm_path=args.pwm, vmat_path=args.vmat,
                cfg=build_config(args), host_id=args.host_id,
                num_hosts=args.num_hosts, device=args.device,
            )
            return 0
        from nucleoatac_torch.models.pipeline import run_pipeline

        run_pipeline(
            args.bam, args.bed, args.out,
            fasta_path=args.fasta, pwm_path=args.pwm, vmat_path=args.vmat,
            cfg=build_config(args), write_plots=not args.no_plots,
            resume=args.resume, bias_track=args.bias_track, device=args.device,
            profile_dir=args.profile,
        )
        return 0
    if args.command == "occ":
        from nucleoatac_torch.models.standalone import run_occ

        run_occ(args)
        return 0
    if args.command == "vprocess":
        from nucleoatac_torch.config import VMatParams
        from nucleoatac_torch.core.vmat import VMat

        raw = VMat.open(args.vplot)
        params = VMatParams(
            lower=args.lower, upper=args.upper, width=args.width,
            smooth_sd_size=args.smooth_sd_size, smooth_sd_pos=args.smooth_sd_pos,
        )
        v = VMat.process_raw(raw.mat, raw.lower, params)
        v.save(f"{args.out}.VMat")
        if not args.no_plots:
            from nucleoatac_torch.utils import plotting

            plotting.plot_vmat(v, f"{args.out}.VMat.eps")
            plotting.plot_vmat_1d(v, f"{args.out}.VMat.1d.eps")
        return 0
    if args.command == "nuc":
        from nucleoatac_torch.models.standalone import run_nuc

        run_nuc(args)
        return 0
    if args.command == "merge":
        from nucleoatac_torch.models.standalone import run_merge

        run_merge(args)
        return 0
    if args.command == "nfr":
        from nucleoatac_torch.models.standalone import run_nfr

        run_nfr(args)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
