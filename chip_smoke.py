#!/usr/bin/env python
"""Bring-up check: the aligner's main path on the GPU, checked for exactness.

    python chip_smoke.py                 # one card (all phases)
    python chip_smoke.py --four-cards    # the multi-card paths on four cards

One card, in order:

1. device and build: JAX's devices (the platform must be `gpu`), the
   card's name and power limit, and the six native host stages built from
   the committed sources;
2. fixture: a seeded, repeat-realistic 100 Mbp two-contig genome indexed
   with `bwa_flow_tpu index`, and 20,000 pairs of 2x151 reads with
   substitutions and indels (insert size 350 +- 40);
3. main path: `bwa_flow_tpu mem` paired-end to SAM, then `mem --sort` to a
   duplicate-marked, coordinate-sorted BAM, with wall time, reads/s, the
   first batch's time (compilation included) and device peak memory;
4. exactness: on the first 1,000 pairs the device SAM is byte-identical
   (bar @PG) to the golden host model (`mem --no-device`), both in a run
   of the subset alone and in the full-size run (every one-card run fixes
   the insert size with `-I 350,40`, so a pair's records do not depend on
   its batch), and the BAM holds the SAM run's records in coordinate
   order;
5. the wide (int64) seed machine (`smem_jax.FORCE_WIDE`) gives the same
   SAM as the narrow one;
6. device extension waves (`--ext-mode waves`) give the same SAM as host
   extension, timed against it.

Any run that reports a device error, degrades to the host path or prints
a `[W::align] device path failed` line fails the script. With
`--four-cards` only the multi-card paths run: `mem --local-devices 4` and
four `--nprocs 4` ranks, one card each, both compared with a one-card run.

Every device run is a child process, one at a time, and this process never
opens a card itself, so each child has its cards to itself. The last line
of stdout is {"ok": true, "device": {...}}; without a GPU, or when any
phase fails, the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

GENOME_LEN = 100_000_000
N_CONTIGS = 2
N_PAIRS = 20_000
N_SUBSET = 1_000
READ_LEN = 151
ISIZE = (350, 40)
SEED = 0x5EED
CHILD_TIMEOUT = 1100.0


class SmokeError(RuntimeError):
    """A phase failed."""


def log(msg: str) -> None:
    print(f"# {msg}", flush=True)


def child_env(**extra) -> dict:
    """This process's environment with the checkout first on PYTHONPATH."""
    env = dict(os.environ)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + path if path else "")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def spawn(cmd: list, env: dict, stdout=subprocess.PIPE) -> subprocess.Popen:
    """Start a child in its own process group (it may fork workers)."""
    return subprocess.Popen([str(c) for c in cmd], env=env, stdout=stdout,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def reap(p: subprocess.Popen) -> None:
    """End the child's whole process group, whether or not it is done."""
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    p.wait()


def run(cmd: list, env: dict, timeout: float = CHILD_TIMEOUT
        ) -> tuple[int, str, str]:
    """Run a child to its end; (returncode, stdout, stderr)."""
    p = spawn(cmd, env)
    try:
        out, err = p.communicate(timeout=timeout)
    finally:
        reap(p)
    return p.returncode, out, err


_PROBE = ("import json, jax; d = jax.devices(); print(json.dumps("
          "{'jax': jax.__version__, 'platform': d[0].platform, "
          "'kind': d[0].device_kind, 'count': len(d)}))")


def probe_devices(env: dict) -> dict:
    """JAX's view of the devices, asked in a child that then exits."""
    rc, out, err = run([sys.executable, "-c", _PROBE], env, timeout=300)
    if rc != 0:
        raise SmokeError("device probe failed:\n" + err[-2000:])
    return json.loads(out.strip().splitlines()[-1])


# ------------------------------------------------------------- phase 1
def build_phase() -> str:
    """Build the native stages; all six must import."""
    from bwa_flow_tpu.native_build import build_native, missing_modules
    t0 = time.monotonic()
    ok, msg = build_native()
    missing = missing_modules()
    if not ok or missing:
        raise SmokeError(f"{msg}; not importable: {missing}")
    return f"{msg} in {time.monotonic() - t0:.1f} s"


# ------------------------------------------------------------- phase 2
def _write_fastq(path, reads) -> None:
    with open(path, "w") as f:
        for name, seq, qual in reads:
            f.write(f"@{name}\n{seq.decode()}\n+\n{qual.decode()}\n")


def make_fixture(workdir: pathlib.Path, env: dict,
                 genome_len: int = GENOME_LEN, n_pairs: int = N_PAIRS,
                 n_subset: int = N_SUBSET, seed: int = SEED,
                 n_contigs: int = N_CONTIGS) -> dict:
    """Genome, index, read pairs and the subset's FASTQs under workdir."""
    import numpy as np
    for sub in ("tools", "tests"):
        if str(ROOT / sub) not in sys.path:
            sys.path.insert(0, str(ROOT / sub))
    from build_ref import BASES, make_genome, write_fasta
    from oracle import sample_pe

    workdir.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    g = make_genome(genome_len, seed,
                    n_islands=max(1, min(8, genome_len // 10_000_000)))
    ref = workdir / "ref.fa"
    write_fasta(ref, g, n_contigs)
    bounds = np.linspace(0, len(g), n_contigs + 1).astype(np.int64)
    contigs = [(f"chr{c + 1}", BASES[g[bounds[c]:bounds[c + 1]]].tobytes())
               for c in range(n_contigs)]
    del g
    t_genome = time.monotonic() - t0
    t0 = time.monotonic()
    rc, _, err = run([sys.executable, "-m", "bwa_flow_tpu", "index", ref],
                     dict(env, JAX_PLATFORMS="cpu"))
    if rc != 0:
        raise SmokeError("index failed:\n" + err[-2000:])
    t_index = time.monotonic() - t0
    pairs = sample_pe(np.random.default_rng(seed + 1), contigs, n_pairs,
                      read_len=READ_LEN, isize_mean=ISIZE[0],
                      isize_std=ISIZE[1])
    fx = dict(ref=str(ref), n_pairs=len(pairs),
              n_subset=min(n_subset, len(pairs)), genome_len=genome_len)
    for tag, part in (("r", pairs), ("s", pairs[:fx["n_subset"]])):
        for mate in (0, 1):
            path = workdir / f"{tag}{mate + 1}.fq"
            _write_fastq(path, [p[mate] for p in part])
            fx[f"{tag}{mate + 1}"] = str(path)
    fx.update(genome_s=t_genome, index_s=t_index)
    return fx


# ----------------------------------------------------------- CLI runs
def _first_float(text: str, prefix: str, after: str) -> float | None:
    for line in text.splitlines():
        if line.startswith(prefix) and after in line:
            try:
                return float(line.split(after, 1)[1].split()[0])
            except ValueError:
                return None
    return None


def check_device_run(tag: str, stderr: str, rep: dict | None,
                     platform: str) -> None:
    """A device run passes only if the device path ran without error."""
    if "[W::align]" in stderr:
        bad = [l for l in stderr.splitlines() if l.startswith("[W::align]")]
        raise SmokeError(f"{tag}: {bad[0]}")
    if rep is None:
        raise SmokeError(f"{tag}: no device report in stderr")
    if rep["platform"] != platform:
        raise SmokeError(f"{tag}: ran on {rep['platform']}, not {platform}")
    if not rep["device_ok"] or rep["stats"].get("device_errors", 0):
        raise SmokeError(f"{tag}: device path degraded: {rep['stats']}")


def _mem_result(tag, stderr, wall, n_reads, platform, device=True):
    from bwa_flow_tpu.utils.devinfo import parse_device_report
    rep = parse_device_report(stderr)
    if device:
        check_device_run(tag, stderr, rep, platform)
    return dict(tag=tag, wall_s=wall, reads=n_reads,
                reads_per_s=n_reads / wall if wall > 0 else None,
                index_load_s=_first_float(stderr, "[M::mem] loaded index",
                                          " in "),
                first_batch_s=_first_float(stderr, "[M::mem] processed",
                                           " in "),
                cli_total_s=_first_float(stderr, "[M::mem] total", "total"),
                peak_bytes_in_use=(rep or {}).get("peak_bytes_in_use"),
                stats=(rep or {}).get("stats"), spans=(rep or {}).get("spans"))


def run_mem(tag: str, args: list, env: dict, n_reads: int, platform: str,
            device: bool = True) -> dict:
    """One `bwa_flow_tpu mem` child; raises SmokeError on any failure."""
    t0 = time.monotonic()
    rc, _, err = run([sys.executable, "-m", "bwa_flow_tpu", "mem"] + args,
                     env)
    wall = time.monotonic() - t0
    if rc != 0:
        raise SmokeError(f"{tag}: mem exited {rc}:\n" + err[-3000:])
    return _mem_result(tag, err, wall, n_reads, platform, device)


def sam_lines(path) -> list[str]:
    """SAM lines without @PG (program name and command line differ)."""
    with open(path) as f:
        return [l for l in f.read().splitlines() if not l.startswith("@PG")]


def sam_body(path) -> list[str]:
    return [l for l in sam_lines(path) if not l.startswith("@")]


def check_same_sam(tag: str, got, want) -> None:
    a, b = sam_lines(got), sam_lines(want)
    if a != b:
        diff = [i for i in range(min(len(a), len(b))) if a[i] != b[i]]
        first = diff[0] if diff else min(len(a), len(b))
        raise SmokeError(
            f"{tag}: {got} differs from {want} ({len(a)} vs {len(b)} "
            f"lines, {len(diff)} differ; first at line {first}:\n"
            f"  {a[first] if first < len(a) else '<none>'}\n"
            f"  {b[first] if first < len(b) else '<none>'})")


def check_bam(bam, sam) -> int:
    """The BAM holds the SAM run's records, in coordinate order."""
    from bwa_flow_tpu.io.bam import bgzf_decompress, decode_bam_records
    with open(bam, "rb") as f:
        _, _, recs = decode_bam_records(bgzf_decompress(f.read()))
    body = sam_body(sam)
    if len(recs) != len(body):
        raise SmokeError(f"BAM has {len(recs)} records, SAM {len(body)}")
    names = collections.Counter(r["qname"] for r in recs)
    if names != collections.Counter(l.split("\t", 1)[0] for l in body):
        raise SmokeError("BAM and SAM read names differ")
    keys = [(r["tid"] if r["tid"] >= 0 else 1 << 31, r["pos"]) for r in recs]
    if any(b < a for a, b in zip(keys, keys[1:])):
        raise SmokeError("BAM records are not in coordinate order")
    return len(recs)


def check_subset_records(full, subset) -> None:
    """The full run's records of the subset's reads, in order, equal the
    subset run's records."""
    want = sam_body(subset)
    names = {l.split("\t", 1)[0] for l in want}
    got = [l for l in sam_body(full) if l.split("\t", 1)[0] in names]
    if got != want:
        diff = [i for i in range(min(len(got), len(want)))
                if got[i] != want[i]]
        raise SmokeError(
            f"{full} differs from {subset} on the subset's reads "
            f"({len(got)} vs {len(want)} records, {len(diff)} differ)")


# ------------------------------------------------------------- phase 5
def wide_child(ref: str, fq: str, n_reads: int, out_dir: str) -> int:
    """Child: align n_reads single-end reads with the narrow (int32) and
    then the wide (int64) seed machine on one AlignPipeline."""
    from bwa_flow_tpu.utils.devinfo import device_report, setup_compile_cache
    setup_compile_cache()
    from bwa_flow_tpu.index.io import load_index
    from bwa_flow_tpu.io.fastq import read_batches
    from bwa_flow_tpu.ops import smem_jax
    from bwa_flow_tpu.pipeline.dataflow import AlignPipeline
    from bwa_flow_tpu.utils.opts import MemOpt

    fm = load_index(ref)
    reads = next(read_batches(fq, chunk_bp=1 << 62))[:n_reads]
    pipe = AlignPipeline(MemOpt(), fm, paired=False, n_workers=0)
    try:
        for tag, wide in (("narrow", False), ("wide", True)):
            smem_jax.FORCE_WIDE = wide
            done: list = []
            pipe.run(iter([reads]), done.extend)
            with open(os.path.join(out_dir, f"{tag}.sam"), "w") as f:
                f.write("".join(r.sam for r in done))
    finally:
        smem_jax.FORCE_WIDE = False
        pipe.close()
    print(device_report(pipe.ba), file=sys.stderr)
    return 0


def wide_phase(fx: dict, workdir: pathlib.Path, env: dict,
               platform: str) -> dict:
    out = workdir / "wide"
    out.mkdir(exist_ok=True)
    t0 = time.monotonic()
    rc, _, err = run([sys.executable, ROOT / "chip_smoke.py", "--wide-child",
                      fx["ref"], fx["s1"], fx["n_subset"], out], env)
    wall = time.monotonic() - t0
    if rc != 0:
        raise SmokeError("wide child failed:\n" + err[-3000:])
    res = _mem_result("wide", err, wall, 2 * fx["n_subset"], platform)
    narrow, wide = sam_body(out / "narrow.sam"), sam_body(out / "wide.sam")
    if len(narrow) < fx["n_subset"] or narrow != wide:
        raise SmokeError(f"wide machine SAM differs from narrow "
                         f"({len(wide)} vs {len(narrow)} records)")
    res["records"] = len(wide)
    return res


# --------------------------------------------------------- the phases
def _fixture(workdir, env, out: dict, sizes: dict) -> dict:
    fx = make_fixture(workdir, env, **sizes)
    out["fixture"] = {k: fx[k] for k in ("genome_len", "n_pairs",
                                         "n_subset", "genome_s", "index_s")}
    log(f"fixture: {fx['genome_len']} bp genome in {fx['genome_s']:.1f} s, "
        f"indexed in {fx['index_s']:.1f} s; {fx['n_pairs']} pairs")
    return fx


def run_smoke(workdir: pathlib.Path, env: dict, platform: str,
              threads: int, **sizes) -> dict:
    """Phases 2-6 of the one-card smoke; returns the measured summary."""
    out: dict = {}
    fx = _fixture(workdir, env, out, sizes)
    # a fixed insert-size distribution: a pair's records then do not
    # depend on the batch it was aligned in, so the full-size run and the
    # subset runs can be compared record for record
    opts = ["-t", threads, "-I", f"{ISIZE[0]},{ISIZE[1]}"]
    ref, n_sub = fx["ref"], 2 * fx["n_subset"]

    # 4. the golden host model on the subset, the longest phase, runs off
    # the card (CPU backend, one core) beside every device run
    gold = workdir / "sub_golden.sam"
    golden = spawn([sys.executable, "-m", "bwa_flow_tpu", "mem",
                    "--no-device"] + opts + ["-o", gold, ref, fx["s1"],
                                             fx["s2"]],
                   dict(env, JAX_PLATFORMS="cpu"), stdout=subprocess.DEVNULL)
    t0 = time.monotonic()
    try:
        _device_runs(out, fx, workdir, env, platform, opts)
        _, gerr = golden.communicate(timeout=CHILD_TIMEOUT)
    finally:
        reap(golden)
    if golden.returncode != 0:
        raise SmokeError("golden host run failed:\n" + gerr[-3000:])
    out["golden"] = _mem_result("golden", gerr, time.monotonic() - t0,
                                n_sub, platform, device=False)
    check_same_sam("device vs golden", workdir / "sub_host.sam", gold)
    check_subset_records(workdir / "main.sam", gold)
    return out


def _device_runs(out, fx, workdir, env, platform, opts) -> None:
    """Phases 3, 5 and 6: every device run, one at a time."""
    ref, n_all, n_sub = fx["ref"], 2 * fx["n_pairs"], 2 * fx["n_subset"]
    # 3. main path: SAM (compiling, then with the compile cache warm),
    # then the sorted duplicate-marked BAM
    sam, bam = workdir / "main.sam", workdir / "main.bam"
    for tag in ("main_sam", "main_sam_warm"):
        out[tag] = run_mem(tag, opts + ["-o", sam, ref, fx["r1"], fx["r2"]],
                           env, n_all, platform)
    out["main_bam"] = run_mem("main_bam", opts + ["--sort", "-o", bam, ref,
                                                  fx["r1"], fx["r2"]],
                              env, n_all, platform)
    out["bam_records"] = check_bam(bam, sam)

    # 5. the wide seed machine
    out["wide"] = wide_phase(fx, workdir, env, platform)

    # 6. device extension waves against host extension: a first waves
    # run compiles the wave programs, then both modes run again warm
    host = workdir / "sub_host.sam"
    out["subset_host"] = run_mem("subset_host", opts + ["-o", host, ref,
                                                        fx["s1"], fx["s2"]],
                                 env, n_sub, platform)
    for tag, mode in (("subset_waves", "waves"), ("subset_waves_warm",
                                                  "waves"),
                      ("subset_host_warm", "host")):
        got = workdir / f"{tag}.sam"
        out[tag] = run_mem(tag, opts + ["--ext-mode", mode, "-o", got, ref,
                                        fx["s1"], fx["s2"]], env, n_sub,
                           platform)
        if mode == "waves" and not out[tag]["stats"].get("ext_tasks_device"):
            raise SmokeError(f"{tag}: no extension ran on the device")
        check_same_sam(f"{tag} vs host extension", got, host)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_four(workdir: pathlib.Path, env: dict, platform: str, threads: int,
             n_dev: int = 4, **sizes) -> dict:
    """--local-devices N and N pinned --nprocs ranks against one card."""
    out: dict = {}
    fx = _fixture(workdir, env, out, sizes)
    n_all = 2 * fx["n_pairs"]
    # ~8 input chunks, so the ranks share the work; the same -t and -K
    # everywhere keep every run's batches (and pestat) identical
    k = max(1, n_all * READ_LEN // 8 // threads)
    base = ["--disable-markdup", "-t", threads, "-K", k, fx["ref"],
            fx["r1"], fx["r2"]]
    one, loc = workdir / "one.sam", workdir / "local.sam"
    out["one_card"] = run_mem("one_card", ["-o", one] + base,
                              dict(env, CUDA_VISIBLE_DEVICES="0"), n_all,
                              platform)
    out["local_devices"] = run_mem(
        "local_devices", ["--local-devices", n_dev, "-o", loc] + base, env,
        n_all, platform)
    if len(out["local_devices"]["peak_bytes_in_use"] or []) < n_dev:
        raise SmokeError(f"--local-devices run saw fewer than {n_dev} "
                         "devices")
    check_same_sam(f"--local-devices {n_dev} vs one card", loc, one)

    coord = f"localhost:{_free_port()}"
    procs = []
    t0 = time.monotonic()
    try:
        for i in range(n_dev):
            procs.append(spawn(
                [sys.executable, "-m", "bwa_flow_tpu", "mem", "--nprocs",
                 n_dev, "--proc-id", i, "--coordinator", coord, "-o",
                 workdir / "ranks.sam"] + base,
                dict(env, CUDA_VISIBLE_DEVICES=str(i)),
                stdout=subprocess.DEVNULL))
        errs = [p.communicate(timeout=CHILD_TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            reap(p)
    wall = time.monotonic() - t0
    ranks = []
    for i, (p, err) in enumerate(zip(procs, errs)):
        if p.returncode != 0:
            raise SmokeError(f"rank {i} exited {p.returncode}:\n"
                             + err[-3000:])
        ranks.append(_mem_result(f"rank{i}", err, wall, n_all, platform))
    out["ranks"] = ranks
    union = []
    for i in range(n_dev):
        union += sam_body(workdir / f"ranks.part{i:03d}.sam")
    if sorted(union) != sorted(sam_body(one)):
        raise SmokeError(f"{n_dev} ranks' SAM differs from one card's")
    out["records"] = len(union)
    return out


def _report(tag: str, res: dict, card: str) -> None:
    peak = res.get("peak_bytes_in_use")
    log(f"{tag}: wall {res['wall_s']:.2f} s, {res['reads']} reads, "
        f"{res['reads_per_s']:.1f} reads/s (wall), first batch "
        f"{res['first_batch_s']} s, index load {res['index_load_s']} s, "
        f"peak device bytes {peak} [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths (needs 4 cards)")
    ap.add_argument("--workdir", default=None,
                    help="fixture and output directory "
                    "(default <checkout>/.cache/smoke)")
    ap.add_argument("--wide-child", nargs=4, default=None,
                    metavar=("REF", "FQ", "N", "OUT"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not (ROOT / "bwa_flow_tpu" / "__init__.py").exists():
        print("chip_smoke.py: no bwa_flow_tpu package beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.wide_child:
        ref, fq, n, out_dir = args.wide_child
        return wide_child(ref, fq, int(n), out_dir)

    env = child_env()
    try:
        dev = probe_devices(env)
    except SmokeError as e:
        print(f"chip_smoke.py: {e}", file=sys.stderr)
        return 2
    log(f"jax {dev['jax']}: platform {dev['platform']}, "
        f"kind {dev['kind']}, count {dev['count']}")
    from bwa_flow_tpu.utils.devinfo import card_line
    card = card_line()
    print(card if card else "nvidia-smi: no card reported", flush=True)
    n_need = 4 if args.four_cards else 1
    if dev["platform"] != "gpu" or dev["count"] < n_need:
        print(f"chip_smoke.py: needs {n_need} GPU(s); JAX found "
              f"{dev['count']} {dev['platform']} device(s)", file=sys.stderr)
        return 2
    card = (card or "card not reported").splitlines()[0]
    threads = os.cpu_count() or 1
    workdir = pathlib.Path(args.workdir) if args.workdir \
        else ROOT / ".cache" / "smoke"
    t0 = time.monotonic()
    try:
        log(build_phase())
        if args.four_cards:
            summary = run_four(workdir, env, "gpu", threads)
            for tag in ("one_card", "local_devices"):
                _report(tag, summary[tag], card)
            for i, r in enumerate(summary["ranks"]):
                _report(f"rank{i}", r, card)
        else:
            summary = run_smoke(workdir, env, "gpu", threads)
            for tag in ("main_sam", "main_sam_warm", "main_bam", "golden",
                        "subset_host", "subset_waves", "subset_waves_warm",
                        "subset_host_warm", "wide"):
                _report(tag, summary[tag], card)
    except (SmokeError, subprocess.TimeoutExpired) as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        return 1
    summary.update(card=card, threads=threads,
                   seconds=time.monotonic() - t0)
    print(json.dumps({"smoke": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
