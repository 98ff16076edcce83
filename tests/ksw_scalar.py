"""Scalar-loop oracles for the SW kernels (test-only).

Direct, loop-for-loop restatements of the reference recurrences (cited per
function) used to validate the vectorized golden implementations in
bwa_flow_tpu.ops.ksw, which in turn validate the device kernels."""


def extend2_scalar(qlen, query, tlen, target, mat, o_del, e_del, o_ins,
                   e_ins, w, end_bonus, zdrop, h0):
    """Transliteration of ksw_extend2 (bwa/ksw.c:380-479)."""
    m = mat.shape[0]
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qp = [[int(mat[k, query[j]]) for j in range(qlen)] for k in range(m)]
    eh = [[0, 0] for _ in range(qlen + 1)]  # [h, e]
    eh[0][0] = h0
    eh[1][0] = h0 - oe_ins if h0 > oe_ins else 0
    j = 2
    while j <= qlen and eh[j - 1][0] > e_ins:
        eh[j][0] = eh[j - 1][0] - e_ins
        j += 1
    max_sc = int(mat.max())
    max_ins = int((qlen * max_sc + end_bonus - o_ins) / e_ins + 1.0)
    w = min(w, max(max_ins, 1))
    max_del = int((qlen * max_sc + end_bonus - o_del) / e_del + 1.0)
    w = min(w, max(max_del, 1))
    maxv, max_i, max_j, max_ie, gscore, max_off = h0, -1, -1, -1, -1, 0
    beg, end = 0, qlen
    for i in range(tlen):
        f, mrow, mj = 0, 0, -1
        q = qp[int(target[i])]
        if beg < i - w:
            beg = i - w
        if end > i + w + 1:
            end = i + w + 1
        if end > qlen:
            end = qlen
        if beg == 0:
            h1 = h0 - (o_del + e_del * (i + 1))
            if h1 < 0:
                h1 = 0
        else:
            h1 = 0
        for j in range(beg, end):
            M, e = eh[j]
            eh[j][0] = h1
            M = M + q[j] if M else 0
            h = M if M > e else e
            h = h if h > f else f
            h1 = h
            mj = mj if mrow > h else j
            mrow = mrow if mrow > h else h
            t = M - oe_del
            t = t if t > 0 else 0
            e -= e_del
            e = e if e > t else t
            eh[j][1] = e
            t = M - oe_ins
            t = t if t > 0 else 0
            f -= e_ins
            f = f if f > t else t
        eh[end][0] = h1
        eh[end][1] = 0
        if end == qlen:
            max_ie = max_ie if gscore > h1 else i
            gscore = gscore if gscore > h1 else h1
        if mrow == 0:
            break
        if mrow > maxv:
            maxv, max_i, max_j = mrow, i, mj
            max_off = max(max_off, abs(mj - i))
        elif zdrop > 0:
            if i - max_i > mj - max_j:
                if maxv - mrow - ((i - max_i) - (mj - max_j)) * e_del > zdrop:
                    break
            else:
                if maxv - mrow - ((mj - max_j) - (i - max_i)) * e_ins > zdrop:
                    break
        j = beg
        while j < end and eh[j][0] == 0 and eh[j][1] == 0:
            j += 1
        beg = j
        j = end
        while j >= beg and eh[j][0] == 0 and eh[j][1] == 0:
            j -= 1
        end = min(j + 2, qlen)
    return maxv, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off


def global2_scalar(qlen, query, tlen, target, mat, o_del, e_del,
                   o_ins, e_ins, w):
    """Transliteration of ksw_global2 without traceback
    (bwa/ksw.c:504-587), returns the score."""
    NEG = -0x40000000
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    eh = [[NEG, NEG] for _ in range(qlen + 1)]
    eh[0] = [0, NEG]
    j = 1
    while j <= qlen and j <= w:
        eh[j] = [-(o_ins + e_ins * j), NEG]
        j += 1
    for i in range(tlen):
        f = NEG
        beg = i - w if i > w else 0
        end = i + w + 1 if i + w + 1 < qlen else qlen
        h1 = -(o_del + e_del * (i + 1)) if beg == 0 else NEG
        for j in range(beg, end):
            m, e = eh[j]
            eh[j][0] = h1
            m += int(mat[int(target[i]), int(query[j])])
            h = m if m >= e else e
            h = h if h >= f else f
            h1 = h
            t = m - oe_del
            e -= e_del
            e = e if e > t else t
            eh[j][1] = e
            t = m - oe_ins
            f -= e_ins
            f = f if f > t else t
        eh[end][0] = h1
        eh[end][1] = NEG
    return eh[qlen][0]


def exhaustive_global(query, target, mat, o_del, e_del, o_ins, e_ins):
    """Truly independent oracle for tiny inputs: enumerate every alignment
    path under the ksw restriction that a gap opens only from the M state
    (no D directly after I or I after D), return the best global score."""
    from functools import lru_cache

    q, t = list(query), list(target)

    @lru_cache(maxsize=None)
    def best(i, j, state):
        # i target consumed, j query consumed; state: 0=M,1=D(target gap? no:
        # deletion consumes target), 2=I (consumes query)
        if i == len(t) and j == len(q):
            return 0
        cands = []
        if i < len(t) and j < len(q):  # match/mismatch (any state -> M)
            cands.append(int(mat[t[i], q[j]]) + best(i + 1, j + 1, 0))
        if i < len(t):  # deletion (consumes target)
            if state == 0:
                cands.append(-(o_del + e_del) + best(i + 1, j, 1))
            elif state == 1:
                cands.append(-e_del + best(i + 1, j, 1))
        if j < len(q):  # insertion (consumes query)
            if state == 0:
                cands.append(-(o_ins + e_ins) + best(i, j + 1, 2))
            elif state == 2:
                cands.append(-e_ins + best(i, j + 1, 2))
        return max(cands) if cands else -(1 << 30)

    return best(0, 0, 0)
