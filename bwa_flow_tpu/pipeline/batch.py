"""Batched device aligner — the device compute path of the pipeline.

Orchestrates the per-batch "forward pass" the reference runs as kflow
stages (SeqsToChains -> ChainsToRegions, /root/reference/src/Pipeline.cpp
:333-544, FPGA variants src/fpga/FPGAPipeline.cpp:367-802):

  1. device SMEM seeding           (ops/smem_jax.py, batch of reads)
  2. device SA lookup              (ops/fm_jax.sa_batch, flattened probes)
  3. host chaining + filters       (ops/chain.py, exact bwa semantics)
  4. wave extension: every read owns a chain2aln_tasks generator
     (ops/region.py); each wave gathers at most one pending seed task per
     read into a fixed-shape device batch (ops/chain2aln_jax.py), runs it,
     and feeds results back. Sequencing *within* a read (bwa's
     seed-containment skip logic) is preserved exactly; parallelism comes
     from batching *across* reads — the same decomposition the FPGA path
     uses (chunks of seed tasks, packReadData
     /root/reference/src/fpga/FPGAPipeline.cpp:194-343).
  5. host dedup/patch/primary marking + SAM (golden tail).

Oversized tasks (long reads, huge reference windows) fall back to the host
runner inline, mirroring packReadData's per-read CPU fallback
(/root/reference/src/fpga/FPGAPipeline.cpp:204-221).
"""

from __future__ import annotations

import numpy as np

from ..index.fmindex import FMIndex
from ..io.sam import Read, mem_reg2sam
from ..models import golden
from ..ops import chain as chainops
from ..ops import fm as fmops
from ..ops import region as regionops
from ..ops import smem_jax
from ..ops.chain2aln_jax import DescTaskBuffer
from ..ops.fm_jax import DeviceFM, sa_batch_packed
from ..utils.opts import MEM_F_PRIMARY5, MemOpt


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class BatchAligner:
    """Device-accelerated batch aligner with golden fallback.

    `wave_cap` bounds tasks per device extension call; `smem_L` is the
    padded read length for the seeding machine (reads longer than that are
    seeded on host)."""

    def __init__(self, opt: MemOpt, fm: FMIndex, smem_L: int = 160,
                 wave_cap: int = 4096, qmax: int = 160, tmax: int = 512,
                 sa_chunk: int = 65536, validate_every: int = 0,
                 validate_sample: int = 2, device_timeout: float = 300.0,
                 drain_max: int | None = None,
                 harvest_workers: int | None = None,
                 n_local_devices: int | None = None):
        self.opt = opt
        self.fm = fm
        self.dfm = DeviceFM.from_host(fm)
        # Production multi-chip data parallelism (round-4 verdict task 7):
        # with n_local_devices > 1 every batch splits into contiguous
        # per-device shards; the FM-index replicates once per chip (the
        # reference uploads the genome to every FPGA DDR, BWAOCLEnv::
        # initPAC/initBWT, /root/reference/src/fpga/BWAOCLEnv.h:67-216)
        # and each chip runs its own seed machine / SA walks / extension
        # waves on its shard — the "one work queue feeding every PE"
        # model (BWAOCLEnv::getPE, :232-269) with the host loop as the
        # queue. No cross-chip collectives are needed on this path:
        # per-batch merges (pestat, markdup) already run host-side over
        # the gathered batch.
        self.devices = None
        self.dfms = [self.dfm]
        if n_local_devices is not None and n_local_devices > 1:
            import jax
            devs = jax.local_devices()[:n_local_devices]
            if len(devs) > 1:
                self.devices = devs
                smem_jax.narrow_cache_reserve(len(devs) + 1)
                self.dfms = [
                    jax.tree_util.tree_map(
                        lambda x, d=d: jax.device_put(x, d), self.dfm)
                    for d in devs]
                self.dfm = self.dfms[0]
        self.smem_L = smem_L
        self.sa_chunk = sa_chunk
        # Extension placement (BWA_TPU_EXT): "host" (default) runs every
        # extension task on the harvester threads' exact scalar kernel
        # while the device runs the next batch's seed program, so the
        # seed machine owns the device. "waves" re-enables device
        # extension waves (ops/extend_jax.extend_core) + harvester sharing
        # (the reference's accx_priority CPU/accelerator split,
        # kflow/include/kflow/MapStage.h:78-116). Which one wins depends
        # on the device and the host's core count: compare both end to
        # end (chip_smoke.py times them on the same reads).
        import os as _os
        ext_mode = _os.environ.get("BWA_TPU_EXT", "host")
        # tail waves at or below this many pending reads finish on the
        # host scalar kernel instead of paying a device round trip; in
        # host mode EVERY wave is "tail" by construction
        self.drain_max = drain_max if drain_max is not None \
            else (1 << 30 if ext_mode == "host"
                  else min(512, wave_cap // 16))
        # harvester threads run pending reads on the exact scalar kernel
        # WHILE device waves are in flight; pack() leaves them a
        # back-reserve of reads. 0 disables.
        ncpu = _os.cpu_count() or 2
        self.harvest_workers = harvest_workers if harvest_workers \
            is not None else (max(1, ncpu - 1) if ext_mode == "host"
                              else max(0, min(2, ncpu - 2)))
        # two buffers: wave streams ping-pong (SWTask double buffering)
        self.bufs = [DescTaskBuffer(wave_cap, qmax, tmax),
                     DescTaskBuffer(wave_cap, qmax, tmax)]
        self.buf = self.bufs[0]
        # hang detection (the reference's 10-s fpgaHangError timeouts,
        # SWTask.cpp:115-121); the default is generous because a
        # first-use fetch waits for the program's compilation too
        self.device_timeout = device_timeout
        self._dev_reads = None
        self._dev_shards = None
        self._dev_reads_n = 0
        # failure detection / graceful degradation (the reference's FPGA
        # result-validation + setUseAccx(false) pattern,
        # /root/reference/src/fpga/FPGAPipeline.cpp:29-130,526-551):
        # validate_every > 0 cross-checks a sample of reads against the
        # golden model every N batches; any mismatch or device exception
        # permanently falls back to the host path.
        self.validate_every = validate_every
        self.validate_sample = validate_sample
        self.device_ok = True
        self._batch_no = 0
        # perf counters (the reference's per-stage VLOG spans, src/util.h:33).
        # Mutated from harvester threads AND the main thread (extend_async
        # runs concurrently with the next batch's collect): dict += is not
        # atomic across GIL switches, so all updates go through _stat()
        # under a lock (advisor r4).
        import threading as _threading
        self._stats_lock = _threading.Lock()
        self.stats = {"reads": 0, "seed_host_redo": 0, "sa_host_redo": 0,
                      "ext_tasks_device": 0, "ext_tasks_host": 0,
                      "host_oversize_q": 0, "host_oversize_t": 0,
                      "host_sched": 0,
                      "waves": 0, "band_retries": 0, "validations": 0,
                      "device_errors": 0}

    def _stat(self, name: str, delta: int = 1) -> None:
        with self._stats_lock:
            self.stats[name] = self.stats.get(name, 0) + delta

    # ------------------------------------------------------------------
    def fetch(self, arr) -> np.ndarray:
        """Device->host fetch with hang detection: a fetch exceeding
        device_timeout raises TimeoutError (the fpgaHangError analog,
        SWTask.cpp:115-121) which the caller turns into host fallback."""
        if self.device_timeout <= 0:
            return np.asarray(arr)
        import threading
        box: dict = {}

        def work():
            try:
                box["v"] = np.asarray(arr)
            except Exception as e:  # pragma: no cover - device failure
                box["e"] = e

        th = threading.Thread(target=work, daemon=True)
        th.start()
        th.join(self.device_timeout)
        if th.is_alive():
            raise TimeoutError(
                f"device fetch exceeded {self.device_timeout}s "
                "(hung device)")
        if "e" in box:
            raise box["e"]
        return box["v"]

    # ------------------------------------------------------------------
    def resolve_sa_flat(self, all_intvs, seed_handle: dict | None = None,
                        post_dispatch=None):
        """Batch all (interval, occurrence) SA probes across reads on
        device; returns (vals int64[NO], off int64[n+1], owners) in
        chain_native.sa_probe_layout enumeration order — the layout both
        the native chain stage and the dict-based Python path consume.

        When the seed handle carries fused on-device SA values (dense-SA
        genomes; collect_intv_device resolves the occurrence enumeration
        in the same call), those reads need no probe round trip at all.

        post_dispatch (probe-path indexes): called once every probe
        program is enqueued, BEFORE blocking on results — the dataflow
        hooks the next batch's seed dispatch here so the probes don't
        queue behind a ~seconds-long seed program."""
        done_cb = [post_dispatch]

        def fire():
            cb, done_cb[0] = done_cb[0], None
            if cb is not None:
                cb()
        from ..ops import chain_native
        from ..ops.chain_native import sa_probe_layout
        # owners triplets only serve the dict-based Python chain path;
        # with the native stage they are rebuilt lazily for fallbacks
        rows, offs, owners = sa_probe_layout(
            self.opt, all_intvs,
            build_owners=not chain_native.available())
        vals_all = np.empty(len(rows), dtype=np.int64)
        if not len(rows):
            fire()
            return vals_all, offs, owners
        need = None
        sav = (seed_handle or {}).get("sa_vals")
        if sav is not None:
            need_idx = []
            for r in range(len(all_intvs)):
                lo, hi = int(offs[r]), int(offs[r + 1])
                v = sav[r] if r < len(sav) else None
                if v is not None and len(v) == hi - lo:
                    vals_all[lo:hi] = v
                else:
                    need_idx.append((lo, hi))
            if not need_idx:
                fire()
                return vals_all, offs, owners
            need = np.concatenate(
                [np.arange(lo, hi) for lo, hi in need_idx])
            rows = rows[need]
        # dispatch every chunk with async fetch before touching results,
        # so the copies back overlap the remaining chunks' compute
        handles = []
        # sub-2^31 genomes walk the LF chain in int32 against the
        # narrowed index view (half the gathered bytes)
        narrow = self.fm.seq_len < 2**31 and not smem_jax.FORCE_WIDE
        dfm_sa = smem_jax._narrow_dfm(self.dfm) if narrow else self.dfm
        pdt = np.int32 if narrow else np.int64
        # multi-device: probe chunks round-robin over the chips (SA rows
        # need no read residency — any replica serves any probe)
        dfm_sas = [dfm_sa]
        if self.devices is not None:
            dfm_sas = [smem_jax._narrow_dfm(d) if narrow else d
                       for d in self.dfms]
        ci = 0
        for off in range(0, len(rows), self.sa_chunk):
            chunk = rows[off:off + self.sa_chunk]
            # pow2 buckets: few compiled variants, one transfer each way
            width = 4096
            while width < len(chunk):
                width <<= 1
            pad = np.zeros(width, dtype=pdt)
            pad[:len(chunk)] = chunk
            if self.devices is not None:
                import jax
                pad = jax.device_put(pad, self.devices[ci % len(dfm_sas)])
            out = sa_batch_packed(dfm_sas[ci % len(dfm_sas)], pad,
                                  256, int(self.fm.sa_intv))
            ci += 1
            try:
                out.copy_to_host_async()
            except AttributeError:
                pass
            handles.append((off, chunk, out))
        fire()   # every probe program is enqueued; results pending
        for off, chunk, out in handles:
            packed = self.fetch(out)
            vals = packed[0, :len(chunk)].copy()  # writable: ovf redo below
            ovf = packed[1, :len(chunk)] != 0
            for j in np.nonzero(ovf)[0]:
                vals[j] = fmops.bwt_sa(self.fm, int(chunk[j]))
                self._stat("sa_host_redo")
            if need is None:
                vals_all[off:off + len(chunk)] = vals
            else:
                vals_all[need[off:off + len(chunk)]] = vals
        return vals_all, offs, owners

    def _resolve_sa(self, all_intvs):
        """Per-read dicts {(x0, k): rbeg} (mem_chain's sa_lookup
        contract) — the Python chain path's view of resolve_sa_flat."""
        from ..ops import chain_native
        vals, _, owners = self.resolve_sa_flat(all_intvs)
        if owners is None:
            owners = chain_native.owners_for(self.opt, all_intvs)
        luts = [dict() for _ in all_intvs]
        for (ridx, x0, k), v in zip(owners, vals):
            luts[ridx][(x0, k)] = int(v)
        return luts

    # ------------------------------------------------------------------
    def seeds_dispatch(self, seqs: list[np.ndarray],
                       n_parts: int = 1) -> dict:
        """Dispatch stage 1 (device SMEM seeding) without blocking; the
        returned handle feeds seeds_collect. Dispatching the NEXT batch's
        seeding while this batch's host stages run keeps the device busy
        (the pipeline-parallel analog of the reference's kflow stages).

        n_parts > 1 uploads the padded batch once but defers the machine
        sub-calls: seeds_step() launches one part at a time, letting the
        driver interleave them between wave rounds so wave fetches never
        wait behind one monolithic seed program.

        Multi-device: the batch splits into one contiguous shard per
        chip, each dispatched immediately against that chip's index
        replica (the shards run concurrently; device queues are async)."""
        import jax
        import jax.numpy as jnp
        n = len(seqs)
        if self.devices is not None:
            D = len(self.devices)
            per = -(-max(n, 1) // D)
            bounds = [(i, min(i + per, n)) for i in range(0, n, per)]
            h = dict(n_reads=n, seqs=seqs, bounds=bounds, parts=[],
                     next=len(bounds), q_devs=[], sharded=True)
            for di, (lo, hi) in enumerate(bounds):
                q, qlen = smem_jax.pad_reads(seqs[lo:hi], self.smem_L)
                qd = jax.device_put(q, self.devices[di])
                qld = jax.device_put(qlen, self.devices[di])
                sub = smem_jax.seed_dispatch(
                    self.opt, self.fm, self.dfms[di], seqs[lo:hi],
                    L=self.smem_L, padded=(qd, qld))
                h["parts"].append(sub)
                h["q_devs"].append(qd)
            return h
        q, qlen = smem_jax.pad_reads(seqs, self.smem_L)
        q_dev = jnp.asarray(q)
        qlen_dev = jnp.asarray(qlen)
        if n_parts <= 1 or n < 2 * n_parts:
            bounds = [(0, n)]
        else:
            per = -(-n // n_parts)
            bounds = [(i, min(i + per, n)) for i in range(0, n, per)]
        h = dict(n_reads=n, q_dev=q_dev, qlen_dev=qlen_dev, seqs=seqs,
                 bounds=bounds, parts=[], next=0)
        self.seeds_step(h)  # always get the first part in flight
        return h

    def seeds_step(self, h: dict) -> bool:
        """Launch the next pending seed sub-call; False when none left."""
        i = h["next"]
        if i >= len(h["bounds"]):
            return False
        lo, hi = h["bounds"][i]
        # pow2-bucket the part slice so parts share compiled programs
        width = 64
        while width < hi - lo:
            width <<= 1
        width = min(width, h["q_dev"].shape[0] - lo)
        sub = smem_jax.seed_dispatch(
            self.opt, self.fm, self.dfm, h["seqs"][lo:hi], L=self.smem_L,
            padded=(h["q_dev"][lo:lo + width],
                    h["qlen_dev"][lo:lo + width]))
        h["parts"].append(sub)
        h["next"] = i + 1
        return True

    def seeds_collect(self, h: dict):
        """Finish a seeds_dispatch as an array-native IntvBatch; pins the
        handle's padded read batch as the device-resident reads for the
        following extension waves."""
        from ..ops.smem import IntvBatch
        while self.seeds_step(h):
            pass
        self._stat("reads", h["n_reads"])
        if h.get("sharded"):
            self._dev_reads = None
            self._dev_shards = (h["q_devs"], h["bounds"])
        else:
            self._dev_reads = h["q_dev"]
            self._dev_shards = None
        self._dev_reads_n = h["n_reads"]
        parts = []
        sa_vals = []
        cb = h.pop("_post_redo_dispatch", None)
        for i, sub in enumerate(h["parts"]):
            if cb is not None and i == len(h["parts"]) - 1:
                sub["_post_redo_dispatch"] = cb
            parts.append(smem_jax.seed_collect_batch(sub, fetch=self.fetch))
            sa_vals.extend(sub.get("sa_vals") or [None] * len(sub["reads"]))
        h["sa_vals"] = sa_vals
        if len(parts) == 1:
            return parts[0]
        offs = [parts[0].iv_off]
        for p in parts[1:]:
            offs.append(p.iv_off[1:] + offs[-1][-1])
        return IntvBatch(
            np.concatenate(offs),
            *(np.concatenate([getattr(p, f) for p in parts])
              for f in ("x0", "x1", "sv", "st", "en")))

    def collect_seeds(self, seqs: list[np.ndarray]):
        """Stage 1: device SMEM seeding (long reads fall back inside)."""
        return self.seeds_collect(self.seeds_dispatch(seqs))

    @staticmethod
    def _luts_from(owners, vals, n):
        luts = [dict() for _ in range(n)]
        for (ridx, x0, k), v in zip(owners, vals):
            luts[ridx][(x0, k)] = int(v)
        return luts

    def _chain_python(self, seq, intvs, lut):
        opt, fm = self.opt, self.fm
        if len(seq) < opt.min_seed_len:
            return []
        chains = chainops.mem_chain(
            opt, fm, len(seq), intvs,
            sa_lookup=lambda x0, k, _lut=lut: _lut[(x0, k)])
        chains = chainops.mem_chain_flt(opt, chains)
        chainops.mem_flt_chained_seeds(opt, fm, len(seq), seq, chains)
        return chains

    def chain_reads(self, seqs, all_intvs, sa_flat):
        """Stage 3: host chaining (exact bwa semantics) — native C++ when
        the _chain extension is built, Python otherwise; long reads the
        seed-SW filter applies to always take the Python path."""
        from ..ops import chain_native
        vals, off, owners = sa_flat
        if chain_native.available():
            out = chain_native.chain_batch(self.opt, self.fm, seqs,
                                           all_intvs, vals, off)
            need = [r for r, c in enumerate(out) if c is None]
            if need:
                if owners is None:
                    owners = chain_native.owners_for(self.opt, all_intvs)
                luts = self._luts_from(owners, vals, len(seqs))
                for r in need:
                    out[r] = self._chain_python(seqs[r], all_intvs[r],
                                                luts[r])
            return out
        if owners is None:
            owners = chain_native.owners_for(self.opt, all_intvs)
        luts = self._luts_from(owners, vals, len(seqs))
        return [self._chain_python(s, iv, lut)
                for s, iv, lut in zip(seqs, all_intvs, luts)]

    def align_regs(self, seqs: list[np.ndarray]) -> list:
        """Seed+chain+extend+dedup for a batch of encoded reads; returns
        per-read AlnReg lists (mem_align1_core over a batch). Device
        failures and validation mismatches degrade to the host path
        (finishUpOnCPU + setUseAccx(false) analog)."""
        opt, fm = self.opt, self.fm
        if not self.device_ok:
            self._stat("reads", len(seqs))
            return [golden.mem_align1_core(opt, fm, seq) for seq in seqs]
        self._batch_no += 1
        try:
            from ..ops import wave_native
            h = self.seeds_dispatch(seqs)
            all_intvs = self.seeds_collect(h)
            sa_flat = self.resolve_sa_flat(all_intvs, h)
            if wave_native.available():
                from ..ops import region_native
                all_regs = region_native.unpack_regs(
                    *self.extend_waves_packed(seqs, all_intvs, sa_flat))
            else:
                all_chains = self.chain_reads(seqs, all_intvs, sa_flat)
                all_regs = self.extend_waves(seqs, all_chains)
        except Exception as e:  # device failure: degrade for good
            import sys
            print(f"[W::align] device path failed ({e!r}); falling back "
                  "to host for the rest of the run", file=sys.stderr)
            self._stat("device_errors")
            self.device_ok = False
            return [golden.mem_align1_core(opt, fm, seq) for seq in seqs]
        # dedup/patch + alt flags
        final = []
        for seq, regs in zip(seqs, all_regs):
            regs = regionops.mem_sort_dedup_patch(
                opt, fm, seq, regs, golden.make_patch_scorer(opt, fm, seq))
            for p in regs:
                if p.rid >= 0 and fm.bns.anns[p.rid].is_alt:
                    p.is_alt = 1
            final.append(regs)
        if (self.validate_every
                and self._batch_no % self.validate_every == 0):
            bad = self._validate(seqs, final)
            if bad:
                import sys
                print("[W::align] device/golden mismatch on validation "
                      "sample; falling back to host for the rest of the "
                      "run", file=sys.stderr)
                self.device_ok = False
                return [golden.mem_align1_core(opt, fm, seq)
                        for seq in seqs]
        return final

    def _validate(self, seqs, got_regs) -> bool:
        """Cross-check a deterministic sample of reads against the golden
        model (the FPGA wrong-result detector analog). True on mismatch."""
        self._stat("validations")
        n = len(seqs)
        step = max(1, n // max(1, self.validate_sample))
        for i in range(0, n, step):
            want = golden.mem_align1_core(self.opt, self.fm, seqs[i])
            got = got_regs[i]
            if len(want) != len(got):
                return True
            for a, b in zip(got, want):
                if (a.rb, a.re, a.qb, a.qe, a.rid, a.score, a.truesc,
                        a.w, a.seedcov) != (b.rb, b.re, b.qb, b.qe, b.rid,
                                            b.score, b.truesc, b.w,
                                            b.seedcov):
                    return True
        return False

    @staticmethod
    def _slice_sa_flat(sa_flat, lo, hi):
        """Per-shard view of (vals, off, owners) for reads [lo, hi)."""
        vals, off, owners = sa_flat
        off_s = off[lo:hi + 1] - off[lo]
        vals_s = vals[off[lo]:off[hi]]
        return vals_s, off_s, None

    def extend_async(self, seqs, all_intvs, sa_flat, on_started=None):
        """Run extend_waves_packed in a worker thread; returns a join()
        that re-raises and returns (rows, frac, off). The device-resident
        read batch is snapshotted HERE (main thread) because the caller
        will collect the NEXT batch — which repoints self._dev_reads —
        while this extension is still running. Only one extension may be
        in flight at a time (the wave buffers ping-pong a shared pair)."""
        import threading
        pinned = (self._dev_reads, self._dev_reads_n, self._dev_shards)
        box: dict = {}

        def work():
            try:
                box["v"] = self.extend_waves_packed(
                    seqs, all_intvs, sa_flat, on_started=on_started,
                    pinned=pinned)
            except BaseException as e:  # re-raised at join
                box["e"] = e

        th = threading.Thread(target=work, daemon=True)
        th.start()

        def join():
            th.join()
            if "e" in box:
                raise box["e"]
            return box["v"]

        return join

    def extend_waves_packed(self, seqs, all_intvs, sa_flat,
                            on_started=None, pinned=None):
        """Native chain + wave-driver path: per-read extension state
        machines live in C++ (_wave), Python only moves descriptor waves
        to the device; returns packed regions (rows, frac, off) that feed
        the native tail directly. Long reads the seed-SW filter applies
        to run through the golden Python path and are spliced in.

        Multi-device: one wave driver per chip shard; the round-robin
        loop keeps two wave streams in flight per chip."""
        import jax.numpy as jnp
        from ..ops import wave_native
        from ..ops.chain2aln_jax import seed_extend_desc_batch
        from ..utils.trace import GLOBAL as tracer
        buf = self.bufs[0]
        cap, qmax, tmax = buf.cap, buf.qmax, buf.tmax
        n = len(seqs)
        dev_reads, dev_reads_n, dev_shards = pinned if pinned is not None \
            else (self._dev_reads, self._dev_reads_n, self._dev_shards)
        dev_flags = np.fromiter(
            (1 if (i < dev_reads_n and len(seqs[i]) <= self.smem_L)
             else 0 for i in range(n)), np.uint8, n)
        if self.devices is not None and dev_shards is not None:
            return self._extend_waves_sharded(seqs, all_intvs, sa_flat,
                                              dev_flags, on_started,
                                              dev_shards)
        with tracer.span("wave.create"):
            wd, needs = wave_native.create_driver(
                self.opt, self.fm, seqs, all_intvs, sa_flat, dev_flags,
                qmax, tmax, cap)
        params = buf._params(self.opt)

        inflight = [0, 0]

        drain_ok = wave_native.can_drain()
        # harvester threads: run pending reads on the exact scalar kernel
        # WHILE device waves are in flight (concurrent CPU+accelerator
        # execution of one work queue — the reference's accx_priority,
        # kflow/include/kflow/MapStage.h:78-116). pack(reserve=-1) leaves
        # them a back-reserve; results are bit-identical either way.
        harvesting = (self.harvest_workers > 0 and drain_ok
                      and wave_native.can_steal())
        stop_ev = None
        hthreads: list = []
        if harvesting:
            import threading
            stop_ev = threading.Event()

            def _harvest():
                while not stop_ev.is_set():
                    if wave_native.steal(wd, 16) == 0:
                        stop_ev.wait(0.001)

            hthreads = [threading.Thread(target=_harvest, daemon=True)
                        for _ in range(self.harvest_workers)]
            # started AFTER the first two waves pack (below): the device
            # gets first claim on full waves; harvesters chew the reserve

        # kernel shape classes: slots arrive (class, cost)-sorted from the
        # native pack. With band retries recomputed on host, every packed
        # task runs at band w, so the DP can never touch target rows past
        # qlen_side + w (the exact clamp in seed_extend_desc_batch) — the
        # kernel tmax only needs qmax + w + 1, not the buffer's tmax.
        # Most tasks fit the small class (both query sides <= 96), whose
        # row ops cost ~40% less; the two dispatches pipeline on device.
        W_band = int(self.opt.w)
        q_small = min(96, qmax)
        shapes = [(q_small, -(-(q_small + W_band + 1) // 8) * 8),
                  (qmax, -(-(qmax + W_band + 1) // 8) * 8)]

        def pack_run(si):
            # a near-empty wave costs a full device round trip for a few
            # tasks that run in ~ms on the host scalar kernel: drain those
            # inline instead (CPU+accelerator sharing at wave granularity,
            # the accx_priority analog, kflow/include/kflow/MapStage.h:78)
            if drain_ok:
                eligible = wave_native.n_pending(wd) - inflight[1 - si]
                if 0 < eligible <= self.drain_max:
                    if harvesting:
                        return None   # the harvesters own the tail
                    with tracer.span("wave.drain"):
                        wave_native.drain(wd)
                    return None
            with tracer.span("wave.pack"):
                r = wave_native.pack(wd, si, -1 if harvesting else 0,
                                     q_small if q_small < qmax else 0)
            if r is None:
                return None
            slots_b, desc_b, n_small = r
            count = len(slots_b) // 4
            desc = np.frombuffer(desc_b, np.int64).reshape(11, cap)
            segs = [(0, n_small, shapes[0]), (n_small, count, shapes[1])]
            outs = []
            meta = []
            with tracer.span("wave.dispatch"):
                from ..ops.chain2aln_jax import narrow_desc
                off = 0
                for lo, hi, (qm, tm) in segs:
                    n_seg = hi - lo
                    if n_seg <= 0:
                        continue
                    # pow2-bucketed width: tail segments run a small
                    # compiled program (few shapes, persistent-cached)
                    width = 512
                    while width < n_seg:
                        width <<= 1
                    width = min(width, cap)
                    sub = np.zeros((11, width), desc.dtype)
                    sub[7:10] = 1          # padding lanes: h0/wl/wr = 1
                    sub[:, :n_seg] = desc[:, lo:hi]
                    out = seed_extend_desc_batch(
                        qm, tm, self.smem_L, self.dfm, dev_reads,
                        jnp.asarray(narrow_desc(sub)), *params)
                    outs.append(out)
                    meta.append((off, n_seg))
                    off += width
                # one result array per wave -> ONE blocking fetch
                full = outs[0] if len(outs) == 1 \
                    else jnp.concatenate(outs, axis=1)
                try:
                    full.copy_to_host_async()
                except AttributeError:
                    pass
            self._stat("waves")
            self._stat("ext_tasks_device", count)
            inflight[si] = count
            return full, meta

        try:
            streams = [pack_run(0), pack_run(1)]
            for t in hthreads:
                t.start()
            if on_started is not None:
                on_started()
            si = 0
            while streams[0] is not None or streams[1] is not None:
                if streams[si] is not None:
                    dev_full, meta = streams[si]
                    with tracer.span("wave.fetch"):
                        got = self.fetch(dev_full)
                    with tracer.span("wave.apply"):
                        parts = [got[:, off:off + n_seg]
                                 for off, n_seg in meta]
                        full = parts[0] if len(parts) == 1 \
                            else np.concatenate(parts, axis=1)
                        wave_native.apply_results(wd, si, full)
                    inflight[si] = 0
                    streams[si] = pack_run(si)
                    if on_started is not None:
                        on_started()  # interleave the next seed sub-call
                o = 1 - si
                if streams[o] is None:
                    streams[o] = pack_run(o)
                si = o
            if harvesting:
                # the main thread JOINS the harvest (4th worker) until no
                # claimable reads remain; harvesters exit once signalled
                with tracer.span("wave.drain"):
                    while wave_native.steal(wd, 16):
                        pass
                stop_ev.set()
        finally:
            # the harvesters hold a raw pointer into wd: they MUST exit
            # before this frame releases it (also on exceptions; threads
            # never started — exception before t.start() — can't join)
            if harvesting:
                stop_ev.set()
                for t in hthreads:
                    if t.ident is not None:
                        t.join()
        self._stat("ext_tasks_host", wave_native.host_tasks(wd))
        if hasattr(wave_native._ext, "host_breakdown"):
            hq, ht, hs = wave_native._ext.host_breakdown(wd)
            self._stat("host_oversize_q", hq)
            self._stat("host_oversize_t", ht)
            self._stat("host_sched", hs)
        rows, frac, off = wave_native.finish(wd)
        if needs:
            from ..ops import chain_native
            vals, offs, owners = sa_flat
            if owners is None:
                owners = chain_native.owners_for(self.opt, all_intvs)
            luts = self._luts_from(owners, vals, n)
            py = {}
            for r in needs:
                chains = self._chain_python(seqs[r], all_intvs[r], luts[r])
                regs: list = []
                for c in chains:
                    regionops.mem_chain2aln(self.opt, self.fm,
                                            len(seqs[r]), seqs[r], c, regs)
                py[r] = regs
                self._stat("ext_tasks_host", sum(
                    len(c.seeds) for c in chains))
            rows, frac, off = wave_native.splice(rows, frac, off, py)
        return rows, frac, off

    def _extend_waves_sharded(self, seqs, all_intvs, sa_flat, dev_flags,
                              on_started=None, dev_shards=None):
        """Per-chip wave drivers over the batch's device shards: each
        shard owns its reads, chains and state machines; the host loop
        keeps two wave streams in flight per chip (the reference's
        per-PE task pipelines fed from one queue, BWAOCLEnv::getPE
        /root/reference/src/fpga/BWAOCLEnv.h:232-269). Harvester threads
        steal tail reads round-robin across every shard."""
        import jax
        from ..ops import wave_native
        from ..ops.chain2aln_jax import narrow_desc, seed_extend_desc_batch
        from ..utils.trace import GLOBAL as tracer
        q_devs, bounds = dev_shards if dev_shards is not None \
            else self._dev_shards
        buf = self.bufs[0]
        cap, qmax, tmax = buf.cap, buf.qmax, buf.tmax
        n = len(seqs)
        W_band = int(self.opt.w)
        q_small = min(96, qmax)
        shapes = [(q_small, -(-(q_small + W_band + 1) // 8) * 8),
                  (qmax, -(-(qmax + W_band + 1) // 8) * 8)]
        params0 = buf._params(self.opt)
        ctxs = []
        needs_global: list = []
        with tracer.span("wave.create"):
            for di, (lo, hi) in enumerate(bounds):
                sub_iv = all_intvs.slice_reads(lo, hi) \
                    if hasattr(all_intvs, "slice_reads") \
                    else all_intvs[lo:hi]
                wd, needs = wave_native.create_driver(
                    self.opt, self.fm, seqs[lo:hi], sub_iv,
                    self._slice_sa_flat(sa_flat, lo, hi),
                    np.ascontiguousarray(dev_flags[lo:hi]),
                    qmax, tmax, cap)
                ctxs.append(dict(
                    wd=wd, dev=self.devices[di], dfm=self.dfms[di],
                    reads=q_devs[di], inflight=[0, 0],
                    params=tuple(jax.device_put(p, self.devices[di])
                                 for p in params0)))
                needs_global.extend(lo + r for r in needs)
        drain_ok = wave_native.can_drain()
        harvesting = (self.harvest_workers > 0 and drain_ok
                      and wave_native.can_steal())
        stop_ev = None
        hthreads: list = []
        if harvesting:
            import threading
            stop_ev = threading.Event()

            def _harvest(start):
                i = start
                while not stop_ev.is_set():
                    got = 0
                    for k in range(len(ctxs)):
                        got = wave_native.steal(
                            ctxs[(i + k) % len(ctxs)]["wd"], 16)
                        if got:
                            break
                    i += 1
                    if got == 0:
                        stop_ev.wait(0.001)

            hthreads = [threading.Thread(target=_harvest, args=(j,),
                                         daemon=True)
                        for j in range(self.harvest_workers)]

        drain_shard = max(64, self.drain_max // max(1, len(ctxs)))

        def pack_run(ctx, si):
            wd = ctx["wd"]
            if drain_ok:
                eligible = wave_native.n_pending(wd) - ctx["inflight"][1 - si]
                if 0 < eligible <= drain_shard:
                    if harvesting:
                        return None   # the harvesters own the tail
                    with tracer.span("wave.drain"):
                        wave_native.drain(wd)
                    return None
            with tracer.span("wave.pack"):
                r = wave_native.pack(wd, si, -1 if harvesting else 0,
                                     q_small if q_small < qmax else 0)
            if r is None:
                return None
            slots_b, desc_b, n_small = r
            count = len(slots_b) // 4
            desc = np.frombuffer(desc_b, np.int64).reshape(11, cap)
            outs = []
            meta = []
            with tracer.span("wave.dispatch"):
                import jax.numpy as jnp
                off = 0
                for lo_s, hi_s, (qm, tm) in ((0, n_small, shapes[0]),
                                             (n_small, count, shapes[1])):
                    n_seg = hi_s - lo_s
                    if n_seg <= 0:
                        continue
                    width = 512
                    while width < n_seg:
                        width <<= 1
                    width = min(width, cap)
                    sub = np.zeros((11, width), desc.dtype)
                    sub[7:10] = 1
                    sub[:, :n_seg] = desc[:, lo_s:hi_s]
                    dd = jax.device_put(narrow_desc(sub), ctx["dev"])
                    out = seed_extend_desc_batch(
                        qm, tm, self.smem_L, ctx["dfm"], ctx["reads"],
                        dd, *ctx["params"])
                    outs.append(out)
                    meta.append((off, n_seg))
                    off += width
                # one result array per wave -> ONE blocking fetch
                full = outs[0] if len(outs) == 1 \
                    else jnp.concatenate(outs, axis=1)
                try:
                    full.copy_to_host_async()
                except AttributeError:
                    pass
            self._stat("waves")
            self._stat("ext_tasks_device", count)
            ctx["inflight"][si] = count
            return full, meta

        try:
            slots_list = [[ctx, si, None] for ctx in ctxs for si in (0, 1)]
            for s in slots_list:
                s[2] = pack_run(s[0], s[1])
            for t in hthreads:
                t.start()
            if on_started is not None:
                on_started()
            while any(s[2] is not None for s in slots_list):
                for s in slots_list:
                    ctx, si, entry = s
                    if entry is None:
                        s[2] = pack_run(ctx, si)
                        continue
                    dev_full, meta = entry
                    with tracer.span("wave.fetch"):
                        got = self.fetch(dev_full)
                    with tracer.span("wave.apply"):
                        parts = [got[:, o:o + n_seg] for o, n_seg in meta]
                        full = parts[0] if len(parts) == 1 \
                            else np.concatenate(parts, axis=1)
                        wave_native.apply_results(ctx["wd"], si, full)
                    ctx["inflight"][si] = 0
                    s[2] = pack_run(ctx, si)
                    if on_started is not None:
                        on_started()
            if harvesting:
                # main thread joins the harvest across shards until no
                # claimable reads remain, then signals the harvesters
                with tracer.span("wave.drain"):
                    got = 1
                    while got:
                        got = 0
                        for ctx in ctxs:
                            got += wave_native.steal(ctx["wd"], 16)
                stop_ev.set()
            with tracer.span("wave.drain"):
                for ctx in ctxs:
                    wave_native.drain(ctx["wd"])
        finally:
            if harvesting:
                stop_ev.set()
                for t in hthreads:
                    if t.ident is not None:
                        t.join()
        rows_l, frac_l, off_parts = [], [], [np.zeros(1, np.int64)]
        total = 0
        for ctx in ctxs:
            self._stat("ext_tasks_host", wave_native.host_tasks(ctx["wd"]))
            if hasattr(wave_native._ext, "host_breakdown"):
                hq, ht, hs = wave_native._ext.host_breakdown(ctx["wd"])
                self._stat("host_oversize_q", hq)
                self._stat("host_oversize_t", ht)
                self._stat("host_sched", hs)
            rows, frac, off = wave_native.finish(ctx["wd"])
            rows_l.append(rows)
            frac_l.append(frac)
            off_parts.append(off[1:] + total)
            total += off[-1]
        rows = np.concatenate(rows_l) if rows_l else np.zeros((0, 12),
                                                              np.int64)
        frac = np.concatenate(frac_l) if frac_l else np.zeros(0)
        off = np.concatenate(off_parts)
        if needs_global:
            from ..ops import chain_native
            vals, offs, owners = sa_flat
            if owners is None:
                owners = chain_native.owners_for(self.opt, all_intvs)
            luts = self._luts_from(owners, vals, n)
            py = {}
            for r in needs_global:
                chains = self._chain_python(seqs[r], all_intvs[r], luts[r])
                regs: list = []
                for c in chains:
                    regionops.mem_chain2aln(self.opt, self.fm,
                                            len(seqs[r]), seqs[r], c, regs)
                py[r] = regs
                self._stat("ext_tasks_host", sum(
                    len(c.seeds) for c in chains))
            rows, frac, off = wave_native.splice(rows, frac, off, py)
        return rows, frac, off

    def extend_waves(self, seqs: list[np.ndarray], all_chains,
                     on_started=None) -> list:
        """Stage 4: cross-read wave extension on device (no dedup).
        `on_started()` fires once after the first wave rounds are on the
        device — the driver uses it to enqueue the NEXT batch's seeding
        behind the bulk of this batch's extension work (so most wave
        results don't queue behind a ~200 ms seed program).

        Each wave runs ONE banded try per extension side; bwa's band
        doubling (bwamem.c:737-744) is driven from here: a task whose
        max_off crossed the threshold is re-enqueued into a later wave
        with the doubled band (stage 1 = redo left@2w+right, stage 2 =
        right-only@2w with the saved left half). Retries are rare, so
        this halves device work vs an unconditional two-try kernel."""
        opt, fm = self.opt, self.fm
        all_regs = [[] for _ in seqs]

        def read_gen(ridx):
            for c in all_chains[ridx]:
                yield from regionops.chain2aln_tasks(
                    opt, fm, len(seqs[ridx]), seqs[ridx], c, all_regs[ridx])

        gens = {}
        pending = {}  # ridx -> [task, stage, saved_left_6tuple|None]
        for ridx in range(len(seqs)):
            g = read_gen(ridx)
            t = next(g, None)
            if t is not None:
                gens[ridx] = g
                pending[ridx] = [t, 0, None]

        def dev_idx(ridx):
            """Device read index for descriptor tasks; -1 when the read was
            not device-seeded (too long for the smem_L bucket)."""
            if (self._dev_reads is None or ridx >= self._dev_reads_n
                    or len(seqs[ridx]) > self.smem_L):
                return -1
            return ridx

        def advance(ridx, result):
            """Feed a result; pull the next device-sized task (running
            oversized ones on host inline). Returns False when done."""
            g = gens[ridx]
            res = result
            while True:
                try:
                    t = g.send(res)
                except StopIteration:
                    del gens[ridx]
                    del pending[ridx]
                    return False
                if self._fits(t, dev_idx(ridx)):
                    pending[ridx] = [t, 0, None]
                    return True
                self._stat("ext_tasks_host")
                res = regionops.run_task_host(opt, t)

        # bootstrap: oversized first tasks
        for ridx in list(pending):
            t = pending[ridx][0]
            if not self._fits(t, dev_idx(ridx)):
                self._stat("ext_tasks_host")
                advance(ridx, regionops.run_task_host(opt, t))

        W = opt.w
        RETRY_OFF = (W >> 1) + (W >> 2)   # max_off threshold at try 0

        def handle(ridx, row):
            """Apply one wave result: finish the task or re-enqueue a
            band-doubling retry (run_task_host's loops, spread over
            waves)."""
            entry = pending[ridx]
            t, stage, lpart = entry
            (ls, lq, lt_, lg, lgs, lmo,
             rs_, rq, rt, rg, rgs, rmo) = row
            has_left = len(t.q_left) > 0
            has_right = len(t.q_right) > 0
            if stage == 0 and has_left and lmo >= RETRY_OFF:
                entry[1] = 1      # redo left@2w (+right with new h0)
                self._stat("band_retries")
                return
            if stage in (0, 1):
                aw0 = (W << 1) if (stage == 1 and has_left) else W
                lfinal = (ls, lq, lt_, lg, lgs, aw0)
                sc0 = ls
                if has_right and rs_ != sc0 and rmo >= RETRY_OFF:
                    entry[1] = 2  # right-only retry @2w, h0 = sc0
                    entry[2] = lfinal
                    self._stat("band_retries")
                    return
                rfinal = (rs_, rq, rt, rg, rgs, W)
            else:  # stage 2: right half from this row, left half saved
                lfinal = lpart
                rfinal = (rs_, rq, rt, rg, rgs, W << 1)
            advance(ridx, lfinal + rfinal)

        from ..utils.trace import GLOBAL as tracer
        # Two wave streams ping-ponged over disjoint reads (the SWTask
        # double buffer, SWTask.cpp:106-244): while stream A's results
        # are copied back and its next wave is packed, stream B computes.
        busy: set = set()

        def pack_and_run(buf):
            with tracer.span("wave.pack"):
                buf.reset()
                slots = []
                for ridx, (t, stage, lpart) in pending.items():
                    if ridx in busy:
                        continue
                    if stage == 0:
                        i = buf.add(t, dev_idx(ridx), W, W)
                    elif stage == 1:
                        i = buf.add(t, dev_idx(ridx), W << 1, W)
                    else:
                        i = buf.add(t, dev_idx(ridx), W, W << 1,
                                    skip_left=True, h0=lpart[0])
                    if i < 0:
                        break  # buffer full: next wave picks the rest up
                    slots.append(ridx)
            if not slots:
                return None
            busy.update(slots)
            with tracer.span("wave.dispatch"):
                out = buf.run_async(opt, self.dfm, self._dev_reads,
                                    self.smem_L)
            self._stat("waves")
            self._stat("ext_tasks_device", len(slots))
            return slots, out

        def apply(entry):
            slots, out = entry
            with tracer.span("wave.fetch"):
                rows = self.fetch(out).T.tolist()
            with tracer.span("wave.apply"):
                for i, ridx in enumerate(slots):
                    busy.discard(ridx)
                    handle(ridx, rows[i])

        streams = [pack_and_run(self.bufs[0]), pack_and_run(self.bufs[1])]
        if on_started is not None:
            on_started()
        s = 0
        while streams[0] is not None or streams[1] is not None:
            if streams[s] is not None:
                apply(streams[s])
                streams[s] = None
                streams[s] = pack_and_run(self.bufs[s])
            o = 1 - s
            if streams[o] is None:
                streams[o] = pack_and_run(self.bufs[o])
            s = o

        return all_regs

    def _fits(self, t, read_idx: int) -> bool:
        """Device-shape check for a descriptor task (packReadData's
        oversize filter analog). Target spans count CLAMPED to
        qlen_side + 2w + 1 — the max any band-doubling retry can reach
        (exactness note in ops/chain2aln_jax.py); using the max retry
        band here means a task that fits at try 0 also fits every
        retry."""
        W2 = (self.opt.w << 1) + 1
        qr = t.l_query - (t.qbeg + t.slen)
        return (read_idx >= 0
                and t.qbeg <= self.buf.qmax
                and qr <= self.buf.qmax
                and min(t.rbeg - t.rmax0, t.qbeg + W2) <= self.buf.tmax
                and min(t.rmax1 - (t.rbeg + t.slen),
                        qr + W2) <= self.buf.tmax)

    # ------------------------------------------------------------------
    def align_se(self, reads: list[Read], n_processed: int = 0,
                 rg_id: str = "") -> None:
        """Batched single-end alignment: fills each read's .sam."""
        opt, fm = self.opt, self.fm
        all_regs = self.align_regs([s.seq for s in reads])
        for i, (s, regs) in enumerate(zip(reads, all_regs)):
            regionops.mem_mark_primary_se(opt, regs, n_processed + i)
            if opt.flag & MEM_F_PRIMARY5:
                regionops.mem_reorder_primary5(opt.T, regs)
            s.sam = ""
            mem_reg2sam(opt, fm, s, regs, 0, None, rg_id)

    def align_pe(self, reads: list[Read], n_processed: int = 0,
                 pes0=None, rg_id: str = "") -> None:
        """Batched paired-end alignment over interleaved reads."""
        from ..ops import pe as peops
        opt, fm = self.opt, self.fm
        all_regs = self.align_regs([s.seq for s in reads])
        pes = pes0 if pes0 is not None else peops.mem_pestat(
            opt, fm.bns.l_pac, all_regs)
        for i in range(len(reads) >> 1):
            j = i << 1
            peops.mem_sam_pe(opt, fm, pes, (n_processed >> 1) + i,
                             reads[j:j + 2], all_regs[j:j + 2], rg_id)
