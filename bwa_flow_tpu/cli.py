"""Command-line front-end: `bwa_flow_tpu index|mem` (main.cpp analog).

Mirrors the reference's option pipeline — gflags mirrored into a synthetic
argv re-parsed by bwa's getopt (/root/reference/src/preprocess.cpp:70-389)
— as a single bwa-mem-compatible parser: every original single-letter
`bwa mem` option plus the pipeline controls. `update_a` rescaling and `-x`
read-type presets follow preprocess.cpp:55-68, 291-320.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from . import __version__
from .index.build import index_fasta, parse_fasta
from .index.io import load_index, save_index
from .io.fastq import read_batches
from .utils.devinfo import device_report, setup_compile_cache
from .utils.opts import (MEM_F_ALL, MEM_F_KEEP_SUPP_MAPQ, MEM_F_NO_MULTI,
                         MEM_F_NO_RESCUE, MEM_F_PE, MEM_F_PRIMARY5,
                         MEM_F_REF_HDR, MEM_F_SMARTPE, MEM_F_SOFTCLIP,
                         MemOpt)


def _mem_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bwa_flow_tpu mem", add_help=False,
        description="BWA-MEM alignment on an accelerator (JAX)")
    a = p.add_argument
    a("-t", type=int, default=1, dest="n_threads")
    a("-k", type=int, dest="min_seed_len")
    a("-w", type=int, dest="band_width")
    a("-d", type=int, dest="zdrop")
    a("-r", type=float, dest="split_factor")
    a("-y", type=int, dest="max_mem_intv")
    a("-c", type=int, dest="max_occ")
    a("-D", type=float, dest="drop_ratio")
    a("-W", type=int, dest="min_chain_weight")
    a("-m", type=int, dest="max_matesw")
    a("-S", action="store_true", dest="skip_mate_rescue")
    a("-P", action="store_true", dest="skip_pairing")
    a("-A", type=int, dest="match_score")
    a("-B", type=int, dest="mismatch_penalty")
    a("-O", dest="gap_open")          # "INT[,INT]"
    a("-E", dest="gap_extend")
    a("-L", dest="clip_penalty")
    a("-U", type=int, dest="pen_unpaired")
    a("-x", dest="read_type")
    a("-p", action="store_true", dest="smart_pairing")
    a("-R", dest="rg_line")
    a("-H", dest="header_insert")
    a("-j", action="store_true", dest="ignore_alt")
    a("-5", action="store_true", dest="primary5")
    a("-q", action="store_true", dest="keep_supp_mapq")
    a("-K", type=int, dest="chunk_size")
    a("-v", type=int, default=3, dest="verbosity")
    a("-T", type=int, dest="min_score")
    a("-h", dest="max_xa_hits")       # "INT[,INT]"
    a("-a", action="store_true", dest="output_all")
    a("-C", action="store_true", dest="append_comment")
    a("-V", action="store_true", dest="ref_header")
    a("-Y", action="store_true", dest="softclip_supp")
    a("-M", action="store_true", dest="mark_short_split")
    a("-I", dest="insert_override")   # "FLOAT[,FLOAT[,INT[,INT]]]"
    a("-o", "--output", dest="output", default="-")
    a("--no-device", action="store_true", dest="no_device",
      help="run the golden host path (CPU) instead of device kernels")
    a("--batch-reads", type=int, default=0,
      help="cap reads per device batch (0 = by chunk bp)")
    a("--validate-every", type=int, dest="validate_every", default=0,
      help="cross-check a sample of every Nth device batch against the "
           "golden model; mismatch degrades to host (FPGA wrong-result "
           "detector analog)")
    a("--device-timeout", type=float, dest="device_timeout", default=300.0,
      help="seconds before a device fetch is declared hung and the run "
           "degrades to host (fpgaHangError analog; 0 disables)")
    a("--local-devices", type=int, dest="local_devices", default=0,
      help="shard every batch over this many local devices with a "
           "replicated index (0/1 = single device; the reference's "
           "one-work-queue-feeding-every-PE model, BWAOCLEnv::getPE)")
    a("--mp-context", dest="mp_context", default="fork",
      choices=("fork", "spawn", "forkserver"),
      help="worker pool start method (spawn is safest under JAX threads; "
           "fork shares the index copy-on-write)")
    # pipeline controls (reference: --disable_markdup, --sort, --temp_dir,
    # --num_buckets, --filter, --remove_duplicates; src/config.cpp)
    a("--disable-markdup", action="store_true", dest="disable_markdup",
      help="skip streaming duplicate marking (on by default, as in the "
           "reference pipeline)")
    a("--sort", action="store_true", dest="sort",
      help="bucket-sort and write a coordinate-sorted BAM to -o")
    a("--temp-dir", dest="temp_dir", default=None)
    a("--num-buckets", type=int, dest="num_buckets", default=512)
    a("--filter", type=int, dest="filter_mask", default=0,
      help="drop alignments matching this FLAG mask at output")
    a("--remove-duplicates", action="store_true", dest="remove_dups")
    # multi-host (bwa-mpi analog): run one process per host with
    # --nprocs/--proc-id (or BWA_TPU_NPROCS/BWA_TPU_PROC_ID env)
    a("--nprocs", type=int, default=None)
    a("--proc-id", type=int, dest="proc_id", default=None)
    a("--coordinator", dest="coordinator", default=None)
    a("--dist", choices=("pull", "stride"), default="pull",
      help="multi-host batch assignment: pull = dynamic work queue on "
      "rank 0 (the reference's MPI master loop, self-load-balancing); "
      "stride = static every-Nth-batch")
    a("--ext-mode", choices=("host", "waves"), default=None,
      dest="ext_mode",
      help="extension placement: host = harvester threads on the exact "
      "scalar kernel while the device seeds the next batch (default); "
      "waves = device extension kernels with CPU+accelerator work "
      "sharing (the reference's accx_priority). Also settable via "
      "BWA_TPU_EXT.")
    a("--help", action="help")
    a("ref")
    a("fastq", nargs="+")
    return p


def build_opt(args) -> MemOpt:
    """argparse namespace -> MemOpt with bwa's update_a / preset rules."""
    opt = MemOpt()
    set_ = set()

    def take(name, attr, cast=None):
        v = getattr(args, name)
        if v is not None:
            setattr(opt, attr, cast(v) if cast else v)
            set_.add(attr)

    take("min_seed_len", "min_seed_len")
    take("band_width", "w")
    take("zdrop", "zdrop")
    take("split_factor", "split_factor")
    take("max_mem_intv", "max_mem_intv")
    take("max_occ", "max_occ")
    if getattr(args, "drop_ratio", None) is not None:
        from .utils.opts import _round_f32
        args.drop_ratio = _round_f32(args.drop_ratio)  # C float field
    take("drop_ratio", "drop_ratio")
    take("min_chain_weight", "min_chain_weight")
    take("max_matesw", "max_matesw")
    take("match_score", "a")
    take("mismatch_penalty", "b")
    take("pen_unpaired", "pen_unpaired")
    take("min_score", "T")
    take("chunk_size", "chunk_size")
    # -t scales the batch budget: chunk_bp = chunk_size * n_threads
    # (fastmap.c main_mem: aux.actual_chunk_size)
    opt.n_threads = max(1, args.n_threads)
    if args.gap_open:
        parts = [int(x) for x in args.gap_open.split(",")]
        opt.o_del = opt.o_ins = parts[0]
        set_.update(("o_del", "o_ins"))
        if len(parts) > 1:
            opt.o_ins = parts[1]
    if args.gap_extend:
        parts = [int(x) for x in args.gap_extend.split(",")]
        opt.e_del = opt.e_ins = parts[0]
        set_.update(("e_del", "e_ins"))
        if len(parts) > 1:
            opt.e_ins = parts[1]
    if args.clip_penalty:
        parts = [int(x) for x in args.clip_penalty.split(",")]
        opt.pen_clip5 = opt.pen_clip3 = parts[0]
        set_.update(("pen_clip5", "pen_clip3"))
        if len(parts) > 1:
            opt.pen_clip3 = parts[1]
    if args.max_xa_hits:
        parts = [int(x) for x in args.max_xa_hits.split(",")]
        opt.max_XA_hits = opt.max_XA_hits_alt = parts[0]
        if len(parts) > 1:
            opt.max_XA_hits_alt = parts[1]
    for flagattr, bit in (
            ("skip_mate_rescue", MEM_F_NO_RESCUE),
            ("skip_pairing", 0x4),
            ("smart_pairing", MEM_F_SMARTPE),
            ("primary5", MEM_F_PRIMARY5),
            ("keep_supp_mapq", MEM_F_KEEP_SUPP_MAPQ),
            ("output_all", MEM_F_ALL),
            ("ref_header", MEM_F_REF_HDR),
            ("softclip_supp", MEM_F_SOFTCLIP),
            ("mark_short_split", MEM_F_NO_MULTI)):
        if getattr(args, flagattr):
            opt.flag |= bit

    mode = args.read_type
    if mode:  # preprocess.cpp:291-320
        def d(attr, val):
            if attr not in set_:
                setattr(opt, attr, val)
        if mode == "intractg":
            d("o_del", 16), d("o_ins", 16), d("b", 9)
            d("pen_clip5", 5), d("pen_clip3", 5)
        elif mode in ("pacbio", "pbref", "ont2d"):
            d("o_del", 1), d("e_del", 1), d("o_ins", 1), d("e_ins", 1)
            d("b", 1)
            if "split_factor" not in set_:
                opt.split_factor = 10.0
            if mode == "ont2d":
                d("min_chain_weight", 20), d("min_seed_len", 14)
            else:
                d("min_chain_weight", 40), d("min_seed_len", 17)
            d("pen_clip5", 0), d("pen_clip3", 0)
        else:
            raise SystemExit(f"[E] unknown read type '{mode}'")
    elif "a" in set_:  # update_a (preprocess.cpp:55-68)
        for attr in ("b", "T", "o_del", "e_del", "o_ins", "e_ins", "zdrop",
                     "pen_clip5", "pen_clip3", "pen_unpaired"):
            if attr not in set_:
                setattr(opt, attr, getattr(opt, attr) * opt.a)
    opt.refresh_mat()
    return opt


def parse_insert_override(spec: str):
    """-I FLOAT[,FLOAT[,INT[,INT]]] (preprocess.cpp / fastmap.c semantics):
    mean[,std[,max[,min]]] for the FR orientation."""
    from .ops.pe import PeStat
    parts = spec.split(",")
    mean = float(parts[0])
    std = float(parts[1]) if len(parts) > 1 else mean * 0.1
    high = int(parts[2]) if len(parts) > 2 else int(mean + 4.0 * std + 0.499)
    low = int(parts[3]) if len(parts) > 3 else max(
        int(mean - 4.0 * std + 0.499), 1)
    pes = [PeStat() for _ in range(4)]
    pes[1].failed = 0
    pes[1].avg, pes[1].std = mean, std
    pes[1].high, pes[1].low = high, low
    for i in (0, 2, 3):
        pes[i].failed = 1
    return pes


def sam_header(fm, rg_line, extra_lines, argv) -> str:
    """bwa_print_sam_hdr (bwa/bwa.c:380-401): @SQ lines carry AH:* for
    ALT contigs and are suppressed entirely when -H supplied @SQ lines;
    the -R RG line is appended after the -H lines (fastmap.c:233-235)."""
    out = []
    hdr_line = extra_lines or ""
    if rg_line:
        rg = rg_line.replace("\\t", "\t")
        hdr_line = hdr_line + "\n" + rg if hdr_line else rg
    n_sq = sum(1 for l in hdr_line.split("\n") if l.startswith("@SQ\t"))
    if n_sq == 0:
        for ann in fm.bns.anns:
            out.append(f"@SQ\tSN:{ann.name}\tLN:{ann.len}"
                       + ("\tAH:*" if ann.is_alt else ""))
    if hdr_line:
        out.append(hdr_line)
    out.append("@PG\tID:bwa_flow_tpu\tPN:bwa_flow_tpu"
               f"\tVN:{__version__}\tCL:{' '.join(argv)}")
    return "\n".join(out) + "\n"


def _rg_id(rg_line) -> str:
    if not rg_line:
        return ""
    for field in rg_line.replace("\\t", "\t").split("\t"):
        if field.startswith("ID:"):
            return field[3:]
    return ""


def main_mem(argv: list[str]) -> int:
    args = _mem_parser().parse_args(argv)
    opt = build_opt(args)
    if args.ext_mode:
        os.environ["BWA_TPU_EXT"] = args.ext_mode
    setup_compile_cache()
    from .parallel import distributed as dist
    pid, nprocs = dist.init_distributed(args.coordinator, args.nprocs,
                                        args.proc_id)
    if nprocs > 1 and args.output != "-":
        # per-rank output (the reference's <host>-<pid> dirs,
        # mpi_main.cpp:294-318)
        root, dot, ext = args.output.rpartition(".")
        args.output = f"{root or ext}.part{pid:03d}" + \
            (dot + ext if root else "")
    t0 = time.time()
    fm = load_index(args.ref, ignore_alt=args.ignore_alt)
    print(f"[M::mem] loaded index {args.ref} in {time.time()-t0:.3f} s",
          file=sys.stderr)
    pes0 = parse_insert_override(args.insert_override) \
        if args.insert_override else None
    paired = len(args.fastq) > 1 or args.smart_pairing
    if paired:
        opt.flag |= MEM_F_PE
    rg = _rg_id(args.rg_line)
    hdr_extra = None
    if args.header_insert:
        if not args.header_insert.startswith("@"):
            # -H FILE: insert the file's @-prefixed lines (fastmap.c:199-210)
            with open(args.header_insert) as hf:
                lines = [l.rstrip("\n") for l in hf if l.startswith("@")]
            hdr_extra = "\n".join(lines) if lines else None
        else:
            hdr_extra = args.header_insert.replace("\\t", "\t")
    header = sam_header(fm, args.rg_line, hdr_extra,
                        ["bwa_flow_tpu", "mem"] + argv)

    markdup = None
    if not args.disable_markdup:
        from .dedup.markdup import make_markdup_stage
        markdup = make_markdup_stage(fm, ignore_unmated=True)

    bucket = None
    out = None
    if args.sort:
        from .pipeline.sort import BucketSort, merge_sorted_bam
        import tempfile
        temp_dir = args.temp_dir or tempfile.mkdtemp(prefix="bwaflow_")
        if nprocs > 1:
            # per-rank bucket dirs on shared filesystems (the reference's
            # <host>-<pid> output dirs, mpi_main.cpp:294-318)
            temp_dir = os.path.join(temp_dir, f"rank{pid:03d}")
            os.makedirs(temp_dir, exist_ok=True)
        bucket = BucketSort(fm.bns.anns, temp_dir, args.num_buckets,
                            drop_dups=args.remove_dups)
        if args.output == "-":
            raise SystemExit("[E] --sort requires -o FILE.bam")
    else:
        out = sys.stdout if args.output == "-" else open(args.output, "w")
        out.write(header)
    fmask = args.filter_mask

    stats = {"n": 0, "t": time.time()}

    def emit(chunk):
        if markdup is not None:
            markdup.process(chunk)
        for r in chunk:
            sam = r.sam
            if fmask:
                sam = "".join(
                    l + "\n" for l in sam.splitlines()
                    if not int(l.split("\t", 2)[1]) & fmask)
            if bucket is not None:
                bucket.write_sam_text(sam)
            else:
                out.write(sam)
        stats["n"] += len(chunk)
        dt = time.time() - stats["t"]
        print(f"[M::mem] processed {stats['n']} reads in {dt:.3f} s "
              f"({stats['n']/dt:.0f} reads/s)", file=sys.stderr)

    fq2 = args.fastq[1] if len(args.fastq) > 1 else None

    wq_server = None
    wq_tally: dict = {}
    if nprocs > 1 and args.dist == "pull":
        # rank 0 hosts the work-queue service next to the jax.distributed
        # coordinator; every rank (0 included) pulls from it. Host/port
        # derive from the RESOLVED coordinator (flag -> env -> default,
        # round-3 advisor: env-configured runs must not pull localhost).
        wq_host, wq_port = dist.workqueue_addr(args.coordinator)
        # token derives from the RESOLVED coordinator (flag included):
        # env-only derivation would share one token across every
        # flag-configured job (advisor r4)
        wq_token = dist.run_token(args.coordinator)
        if pid == 0:
            wq_server = dist.WorkQueueServer(host=wq_host, port=wq_port,
                                             token=wq_token)

    def batches():
        it = read_batches(args.fastq[0], fq2,
                          chunk_bp=opt.chunk_size * opt.n_threads,
                          interleaved=args.smart_pairing)
        if nprocs > 1 and args.dist == "pull":
            it = dist.pull_batches(
                it, dist.WorkQueueClient(wq_host, wq_port,
                                         token=wq_token),
                tally=wq_tally)
        elif nprocs > 1:
            it = dist.shard_batches(it, pid, nprocs)
        for batch in it:
            if not args.append_comment:
                # FASTA/Q comments reach the output only with -C
                # (aux.copy_comment, fastmap.c)
                for r in batch:
                    r.comment = None
            if args.batch_reads:
                for i in range(0, len(batch), args.batch_reads):
                    yield batch[i:i + args.batch_reads]
            else:
                yield batch

    if args.no_device:
        from .models import golden
        for chunk in batches():
            # read ids are global across ranks/batches: the hash_64
            # primary tie-break must not depend on rank-local counting
            base = chunk[0].id if chunk else 0
            if paired:
                golden.align_pe(opt, fm, chunk, base, pes0, rg)
            else:
                golden.align_se(opt, fm, chunk, base, rg)
            emit(chunk)
    else:
        from .pipeline.dataflow import AlignPipeline
        pipe = AlignPipeline(opt, fm, paired=paired,
                             n_workers=max(0, args.n_threads - 1),
                             rg_id=rg, pes0=pes0,
                             mp_context=args.mp_context,
                             aligner_kw=dict(
                                 validate_every=args.validate_every,
                                 device_timeout=args.device_timeout,
                                 n_local_devices=args.local_devices or
                                 None))
        try:
            pipe.run(batches(), emit)
        finally:
            pipe.close()
        print(device_report(pipe.ba), file=sys.stderr)
    if bucket is not None:
        from .pipeline.sort import merge_sorted_bam
        paths = bucket.close()
        merge_sorted_bam(paths, args.output, fm.bns.anns, header)
        print(f"[M::mem] sorted BAM written to {args.output}",
              file=sys.stderr)
    elif out is not sys.stdout:
        out.close()
    if markdup is not None:
        print(f"[M::mem] markdup: {markdup.state.dup_count} duplicate "
              f"blocks", file=sys.stderr)
    if nprocs > 1:
        if args.dist == "pull" and "n_batches" in wq_tally:
            # exact-partition check: raises if any batch index was
            # consumed but never aligned (silent read loss)
            dist.verify_partition(wq_tally["n_batches"],
                                  wq_tally["n_aligned"])
        dist.barrier()  # final Barrier (mpi_main.cpp:319-325)
    if wq_server is not None:
        wq_server.close()
    print(f"[M::mem] total {time.time()-t0:.3f} s", file=sys.stderr)
    return 0


def main_index(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="bwa_flow_tpu index")
    p.add_argument("-p", dest="prefix", default=None)
    p.add_argument("fasta")
    args = p.parse_args(argv)
    prefix = args.prefix or args.fasta
    t0 = time.time()
    fm = index_fasta(args.fasta)
    save_index(prefix, fm)
    print(f"[M::index] built + saved {prefix}.* in {time.time()-t0:.1f}s",
          file=sys.stderr)
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: bwa_flow_tpu <index|mem> [options]", file=sys.stderr)
        print(f"version: {__version__}", file=sys.stderr)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "mem":
        return main_mem(rest)
    if cmd == "index":
        return main_index(rest)
    print(f"[E] unknown command '{cmd}'", file=sys.stderr)
    return 1
