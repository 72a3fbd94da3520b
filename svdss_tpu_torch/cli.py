"""Command-line interface: ``svdss-tpu-torch index|smooth|search|call|run``.

Mirrors the reference CLI (main.cpp:55-81, flags config.cpp:30-55 /
config.hpp:14-52) plus an end-to-end ``run`` driver replicating the
``run_svdss`` shell pipeline (run_svdss:136-204) entirely in-process:
index -> smooth -> search -> call (stages are skipped when their output
file already exists, which is also the checkpoint/resume mechanism), with
the internal genotyper standing in for the external ``kanpig gt`` step.

The device stages (search, call) run on the CUDA card unless ``--device
cpu`` asks for the plain PyTorch versions of the kernels on the CPU;
``--no-device`` runs the exact host engines instead. Single process: the
multi-host sharding of the JAX package is not ported yet, and neither are
its anchor search engines (``--engine fm``/``auto`` take the FM engine).
"""

from __future__ import annotations

import argparse
import os
import sys

from .config import Config
from .utils.device import resolve_device
from .utils.log import logger, set_verbose


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--threads", type=int, default=4,
                   help="worker threads for host-side stages (default: 4)")
    p.add_argument("--bsize", type=int, default=10000,
                   help="batch size (default: 10000)")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--no-device", action="store_true",
                   help="run search and call on the host engines")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="device of the search and call kernels (default: "
                        "cuda; cpu runs their plain PyTorch versions)")
    p.add_argument("--lanes", type=int, default=4096,
                   help="device search batch width (default: 4096)")
    p.add_argument("--engine", choices=("auto", "anchor", "fm"),
                   default="auto",
                   help="device search engine (default: auto = the FM rank "
                        "walk; the anchor engines are not ported yet)")


def _cfg(args: argparse.Namespace) -> Config:
    cfg = Config(
        threads=getattr(args, "threads", 4),
        batch_size=getattr(args, "bsize", 10000),
        verbose=getattr(args, "verbose", False),
        use_device=not getattr(args, "no_device", False),
        lanes=getattr(args, "lanes", 4096),
        engine=getattr(args, "engine", "auto"),
    )
    for field in ("accp", "min_mapq", "min_sv_length", "min_cluster_weight",
                  "clipped", "max_output"):
        if hasattr(args, field.replace("-", "_")):
            setattr(cfg, field, getattr(args, field.replace("-", "_")))
    if hasattr(args, "noassemble"):
        cfg.assemble = not args.noassemble
    if hasattr(args, "noputative"):
        cfg.putative = not args.noputative
    if hasattr(args, "noht"):
        cfg.useht = not args.noht
    if hasattr(args, "l") and args.l is not None:
        cfg.min_ratio = args.l
    set_verbose(cfg.verbose)
    return cfg


def cmd_index(args) -> int:
    from .io.fasta import load_chromosomes
    from .index.fmd import build_index
    chroms = load_chromosomes(args.reference)
    logger.info("index: %d sequences, %d bp total", len(chroms),
                sum(len(s) for s in chroms.values()))
    idx = build_index(chroms, threads=getattr(args, "threads", 1) or 1)
    idx.save(args.index)
    logger.info("index: %d BWT symbols -> %s", idx.n, args.index)
    return 0


def cmd_smooth(args) -> int:
    from .io.fasta import load_chromosomes
    from .pipeline.smooth import run_smooth
    cfg = _cfg(args)
    chroms = load_chromosomes(args.reference)
    out = args.out or "/dev/stdout"
    run_smooth(cfg, chroms, args.bam, out)
    return 0


def cmd_search(args) -> int:
    from .index.fmd import FMDIndex
    from .pipeline.search import run_search
    cfg = _cfg(args)
    index = FMDIndex.load(args.index)
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        run_search(cfg, index, bam=args.bam, fastx=args.fastx, out=out,
                   device=args.device)
    finally:
        if args.out:
            out.close()
    return 0


def cmd_call(args) -> int:
    from .io.fasta import load_chromosomes
    from .io.sfs_file import parse_sfs_file
    from .pipeline.call import run_call
    from .pipeline.clip import call_clipped
    cfg = _cfg(args)
    chroms = load_chromosomes(args.reference)
    sfs_map = parse_sfs_file(args.sfs)
    out = open(args.out, "w") if args.out else sys.stdout
    try:
        svs, cons, clips = run_call(cfg, chroms, args.bam, sfs_map, out=out,
                                    clusters_out=args.clusters,
                                    device=args.device)
        if args.poa:
            with open(args.poa, "w") as ph:
                ph.write("@HD\tVN:1.4\n")
                for name, seq in chroms.items():
                    ph.write(f"@SQ\tSN:{name}\tLN:{len(seq)}\n")
                for c in cons:
                    ph.write(c.sam_line() + "\n")
        if cfg.clipped:
            logger.warning("clipped-SV calling is experimental")
            for sv in call_clipped(clips, svs, chroms, cfg):
                out.write(sv.vcf_line() + "\n")
        if args.gt:
            _regenotype(svs, out)
    finally:
        if args.out:
            out.close()
    return 0


def _regenotype(svs, out) -> None:
    from .pipeline.genotype import genotype_call, parse_rvec
    for sv in svs:
        gt, q = genotype_call(parse_rvec(sv.rvec))
        sv.set_gt(gt, q)


def cmd_run(args) -> int:
    """End-to-end driver (run_svdss:136-204), artifacts in --workdir."""
    from .io.fasta import load_chromosomes
    from .io.sfs_file import parse_sfs_file
    from .index.fmd import FMDIndex, build_index
    from .pipeline.smooth import run_smooth
    from .pipeline.search import run_search
    from .pipeline.call import run_call
    from .pipeline.genotype import genotype_call, parse_rvec

    cfg = _cfg(args)
    wd = args.workdir
    os.makedirs(wd, exist_ok=True)
    index_path = os.path.join(wd, "index.fmd.npz")
    smoothed_path = os.path.join(wd, "smoothed.bam")
    sfs_path = os.path.join(wd, "specifics.txt")
    vcf_path = os.path.join(wd, "variations.vcf")

    import time as _time
    chroms = load_chromosomes(args.reference)
    if os.path.exists(index_path):
        logger.info("run: reusing existing index %s", index_path)
        index = FMDIndex.load(index_path)
    else:
        t0 = _time.time()
        index = build_index(chroms, threads=cfg.threads)
        index.save(index_path + ".tmp")
        os.replace(index_path + ".tmp.npz", index_path)
        logger.info("run: index built in %.1fs (%d symbols)",
                    _time.time() - t0, index.n)
    if not os.path.exists(smoothed_path):
        # artifacts are written to a temp name and renamed on success, so
        # an interrupted stage re-runs instead of resuming a partial file
        run_smooth(cfg, chroms, args.bam, smoothed_path + ".tmp")
        os.replace(smoothed_path + ".tmp", smoothed_path)
    else:
        logger.info("run: reusing %s", smoothed_path)
    if not os.path.exists(sfs_path):
        with open(sfs_path + ".tmp", "w") as fh:
            run_search(cfg, index, bam=smoothed_path, out=fh,
                       device=args.device)
        os.replace(sfs_path + ".tmp", sfs_path)
    else:
        logger.info("run: reusing %s", sfs_path)
    sfs_map = parse_sfs_file(sfs_path)
    with open(vcf_path + ".tmp", "w") as fh:
        svs, _, _ = run_call(cfg, chroms, smoothed_path, sfs_map, out=None,
                             device=args.device)
        if not args.no_gt:
            for sv in svs:
                gt, q = genotype_call(parse_rvec(sv.rvec))
                sv.set_gt(gt, q)
        from .io.vcf import write_vcf
        write_vcf(fh, chroms, svs)
    os.replace(vcf_path + ".tmp", vcf_path)
    logger.info("run: wrote %s (%d SVs)", vcf_path, len(svs))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="svdss-tpu-torch",
        description="Structural-variant discovery from sample-specific "
                    "strings, on a CUDA card (PyTorch port)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("index", help="build the FMD index of a reference")
    p.add_argument("--reference", required=True)
    p.add_argument("--index", required=True)
    p.add_argument("--threads", type=int, default=4)
    p.set_defaults(func=cmd_index)

    p = sub.add_parser("smooth", help="smooth a BAM against the reference")
    p.add_argument("--reference", required=True)
    p.add_argument("--bam", required=True)
    p.add_argument("--out", default=None, help="output BAM (default stdout)")
    p.add_argument("--accp", type=float, default=0.98)
    p.add_argument("--min-mapq", dest="min_mapq", type=int, default=20)
    _common(p)
    p.set_defaults(func=cmd_smooth)

    p = sub.add_parser("search", help="extract sample-specific strings")
    p.add_argument("--index", required=True)
    p.add_argument("--bam", default=None)
    p.add_argument("--fastx", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--omax", dest="max_output", type=int, default=100000)
    p.add_argument("--noputative", action="store_true")
    p.add_argument("--noassemble", action="store_true")
    _common(p)
    p.set_defaults(func=cmd_search)

    p = sub.add_parser("call", help="call SVs from SFSs")
    p.add_argument("--reference", required=True)
    p.add_argument("--bam", required=True)
    p.add_argument("--sfs", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--poa", default=None)
    p.add_argument("--clusters", default=None,
                   help="store clusters to this file")
    p.add_argument("--min-cluster-weight", dest="min_cluster_weight",
                   type=int, default=2)
    p.add_argument("--min-sv-length", dest="min_sv_length", type=int,
                   default=25)
    p.add_argument("--min-mapq", dest="min_mapq", type=int, default=20)
    p.add_argument("--noht", action="store_true")
    p.add_argument("--clipped", action="store_true")
    p.add_argument("--gt", action="store_true",
                   help="genotype with the internal Bayesian genotyper")
    p.add_argument("-l", type=float, default=None,
                   help="min length-similarity ratio (default 0.97)")
    _common(p)
    p.set_defaults(func=cmd_call)

    p = sub.add_parser("run", help="full pipeline: index+smooth+search+call")
    p.add_argument("--reference", required=True)
    p.add_argument("--bam", required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--min-cluster-weight", dest="min_cluster_weight",
                   type=int, default=2)
    p.add_argument("--min-sv-length", dest="min_sv_length", type=int,
                   default=25)
    p.add_argument("--no-gt", action="store_true",
                   help="skip internal genotyping")
    _common(p)
    p.set_defaults(func=cmd_run)

    args = parser.parse_args(argv)
    if args.cmd in ("search", "call", "run") and not args.no_device:
        # fail before any stage runs
        if args.engine == "anchor":
            parser.error("--engine anchor: the anchor search engines are "
                         "not ported yet (use fm or auto)")
        resolve_device(args.device)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
