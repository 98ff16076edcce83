"""Golden straight-line aligner: the single-read oracle model.

Mirrors mem_align1_core + worker2 (bwa/bwamem.c:1066-1218) as a simple
sequential pipeline. Every batched/device path is diffed against this model,
the same golden-diff strategy the reference uses (test/src/TestCommon.h:51-136
bwa_mem)."""

from __future__ import annotations

import numpy as np

from ..index.fmindex import FMIndex
from ..io.sam import Read, mem_reg2sam
from ..ops import chain as chainops
from ..ops import region as regionops
from ..ops import smem as smemops
from ..ops.align import gen_cigar2
from ..utils.opts import MEM_F_PRIMARY5, MemOpt


def make_patch_scorer(opt: MemOpt, fm: FMIndex, query: np.ndarray):
    def gen_cigar_score(w, qb, qe, rb, re):
        score, _, _, _ = gen_cigar2(opt.mat, opt.o_del, opt.e_del, opt.o_ins,
                                    opt.e_ins, w, fm, qe - qb,
                                    query[qb:qe].copy(), rb, re,
                                    want_cigar=False)
        return score
    return gen_cigar_score


def mem_align1_core(opt: MemOpt, fm: FMIndex, seq: np.ndarray
                    ) -> list[regionops.AlnReg]:
    """Seed -> chain -> extend -> dedup for one read (bwamem.c:1066-1102)."""
    l_seq = len(seq)
    intvs = smemops.collect_intv(opt, fm, seq)
    chains = chainops.mem_chain(opt, fm, l_seq, intvs)
    chains = chainops.mem_chain_flt(opt, chains)
    chainops.mem_flt_chained_seeds(opt, fm, l_seq, seq, chains)
    regs: list[regionops.AlnReg] = []
    for c in chains:
        regionops.mem_chain2aln(opt, fm, l_seq, seq, c, regs)
    regs = regionops.mem_sort_dedup_patch(opt, fm, seq, regs,
                                          make_patch_scorer(opt, fm, seq))
    for p in regs:
        if p.rid >= 0 and fm.bns.anns[p.rid].is_alt:
            p.is_alt = 1
    return regs


def align_se(opt: MemOpt, fm: FMIndex, reads: list[Read],
             n_processed: int = 0, rg_id: str = "") -> None:
    """Single-end: fill each read's .sam (worker1+worker2 SE path)."""
    for i, s in enumerate(reads):
        regs = mem_align1_core(opt, fm, s.seq)
        regionops.mem_mark_primary_se(opt, regs, n_processed + i)
        if opt.flag & MEM_F_PRIMARY5:
            regionops.mem_reorder_primary5(opt.T, regs)
        s.sam = ""
        mem_reg2sam(opt, fm, s, regs, 0, None, rg_id)


def align_pe(opt: MemOpt, fm: FMIndex, reads: list[Read],
             n_processed: int = 0, pes0=None, rg_id: str = "") -> None:
    """Paired-end: interleaved reads; mirrors mem_process_seqs
    (bwamem.c:1220-1249): per-batch pestat inference, then pairing+SAM."""
    from ..ops import pe as peops
    regs = [mem_align1_core(opt, fm, s.seq) for s in reads]
    pes = pes0 if pes0 is not None else mem_pestat_batch(opt, fm, regs)
    for i in range(len(reads) >> 1):
        j = i << 1
        peops.mem_sam_pe(opt, fm, pes, (n_processed >> 1) + i,
                         reads[j:j + 2], regs[j:j + 2], rg_id)


def mem_pestat_batch(opt: MemOpt, fm: FMIndex, regs):
    from ..ops import pe as peops
    return peops.mem_pestat(opt, fm.bns.l_pac, regs)
