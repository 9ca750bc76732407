"""Exact (bit-parity) tree engines: dnj / nj / hnj / upgma / cf / ff / mn / frank.

This module reproduces the reference join engines cell-for-cell in
numpy float64, including scan orders, tie-breaking and the float
accumulation order of every running sum, so that Newick output is
byte-identical to the C binary.  Parity sources:

- Q criterion & full scans:  nj.c:182-247 (initQ), nj.c:297-362 (initQ_MN),
  nj.c:524-688 (minD/maxD)
- sD/N bookkeeping:          nj.c:111-180 (initSummaD)
- D update after a join:     nj.c:836-1044 (updateD), nj.c:1391-1558
  (updateD_CF)
- limb lengths:              nj.c:42-109 (limbLength / limbLengthNeg)
- DNJ row-cache engine:      dnj.c:43-128 (minQpair), dnj.c:217-293
  (UPGMApair), dnj.c:607-710 (updateDNJ), dnj.c:817-975 (DNJ_popArrange),
  dnj.c:977-983 (minPos), dnj.c:985-1052 (dnj)
- heuristic/UPGMA family:    hclust.c:56-130 (initHNJ), hclust.c:205-277
  (initDmin), hclust.c:353-381 (minQ), hclust.c:413-450 (updatePrevQ),
  hclust.c:452-561 (updateHNJ), hclust.c:665-1306 (updateUPGMA/FF/CF),
  hclust.c:1308-1432 (HNJ_popArrange), hclust.c:1559-1669
  (UPGMA_popArrange), hclust.c:1671-1720 (hclust)
- row compaction:            matrix.c:518-602 (ltdMatrix_popArrange)

Running sums that the reference accumulates left-to-right are computed
with ``np.cumsum`` (a sequential scan) rather than ``np.sum`` (pairwise),
so float results match to the last ulp.

Known divergence: updateD_CF/updateCF advance the *base* N pointer
(`++N`) instead of the walker in their one-sided-missing branches
(nj.c:1473, hclust.c:1188) — a reference bug reachable only with missing
distances under the cf/frank methods; we apply the evidently intended
no-op instead.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from ..io.qseqs import Name
from .newick_build import (form_node, form_last_node, form_last_bi_node,
                           byteshift_fix)

DBL_MAX = np.finfo(np.float64).max


def off(i: int) -> int:
    return i * (i - 1) // 2


# ---------------------------------------------------------------------------
# lower-triangular matrix storage with the reference's dtype semantics
# (matrix.h:23-33: double / float / u16 / u8, quantized via bytescale.h)


class LtdMatrix:
    """Flat lower-triangular cell storage; row i occupies
    flat[i(i-1)/2 : i(i-1)/2 + i].

    dtype 'd': float64, 'f': float32 (stored f32, computed f64),
    's': uint16, 'b': uint8 (quantized: store=trunc(v*ByteScale+rnd),
    load=v/ByteScale — bytescale.h:22-23).
    """

    NPD = {"d": np.float64, "f": np.float32, "s": np.uint16, "b": np.uint8}

    # set by the CLI -H/--mmap (+ -T tmp dir): out-of-core cell storage
    # over an unlinked temp file, the reference's ltdMatrixMinit/tmpF
    # design (matrix.c:116-231, tmp.c:27)
    mmap_dir: str | None = None

    def __init__(self, flat64: np.ndarray, n: int, dtype: str = "d",
                 bytescale: float = 128.0, load_round: float = 0.5):
        self.n = n
        self.dtype = dtype
        self.bs = float(bytescale)
        if dtype in ("s", "b"):
            # loadPhy quantizes with round 0.5 (phy.c:473-475)
            flat = (np.asarray(flat64, np.float64) * self.bs
                    + load_round).astype(self.NPD[dtype])
        else:
            flat = np.asarray(flat64, np.float64).astype(self.NPD[dtype])
        if self.mmap_dir is not None and flat.nbytes:
            fd, path = tempfile.mkstemp(dir=self.mmap_dir,
                                        prefix="ccphylo_ltd_")
            os.unlink(path)  # unlinked backing store survives as mmap
            with os.fdopen(fd, "r+b") as fh:
                fh.truncate(flat.nbytes)
                mm = np.memmap(fh, dtype=flat.dtype, mode="r+",
                               shape=flat.shape)
            mm[:] = flat
            flat = mm
        self.flat = flat

    @property
    def quantized(self) -> bool:
        return self.dtype in ("s", "b")

    def get(self, idx):
        """Logical (float64) values at flat indices (uctod for quantized)."""
        v = self.flat[idx]
        if self.quantized:
            return v.astype(np.float64) / self.bs
        return v.astype(np.float64)

    def row(self, i: int, upto: int | None = None):
        o = off(i)
        end = o + (i if upto is None else upto)
        return self.get(slice(o, end))

    def store(self, idx, vals, rnd: float):
        """Write logical values with the C conversion (dtouc(v, rnd) for
        quantized, float rounding for 'f').  Returns the post-storage
        logical values (what a subsequent read yields)."""
        if self.quantized:
            self.flat[idx] = (np.asarray(vals, np.float64) * self.bs
                              + rnd).astype(self.NPD[self.dtype])
        else:
            self.flat[idx] = vals
        return self.get(idx)

    def isub(self, idx, L: float):
        """In-place ``cell -= L`` (integer wrap-around subtraction of
        dtouc(L, 0) for quantized dtypes, nj.c:936-939).  Returns the
        post-op logical values."""
        if self.quantized:
            dec = self.NPD[self.dtype](np.float64(L) * self.bs)
            self.flat[idx] = self.flat[idx] - dec  # uint wraps like C
        else:
            self.flat[idx] = (self.flat[idx].astype(np.float64) - L
                              ).astype(self.NPD[self.dtype])
        return self.get(idx)

    def raw_copy(self, dst_idx, src_idx):
        self.flat[dst_idx] = self.flat[src_idx]


# ---------------------------------------------------------------------------


class TreeState:
    """D (LtdMatrix) + sD/N/Q/P vectors (nj.h:26-40, tree.c:52-60)."""

    def __init__(self, flat64, n, dtype="d", bytescale=128.0):
        self.D = LtdMatrix(flat64, n, dtype, bytescale)
        self.sD = np.zeros(n, np.float64)
        self.N = np.ones(n, np.int64)
        self.Q = np.full(n, DBL_MAX, np.float64)
        self.P = np.zeros(n, np.int64)
        # worker threads for the batched Q scan (`tree -t`, dnj.c:505-
        # 605); results are trajectory-identical at any count
        self.threads = 1

    @property
    def n(self):
        return self.D.n

    @n.setter
    def n(self, v):
        self.D.n = v

    def col_idx(self, j, ks):
        """flat indices of cells (k, j) for k > j."""
        return ks * (ks - 1) // 2 + j

    def pair_idx(self, i, ks):
        """flat indices of cells (i, k)/(k, i) for arbitrary k != i."""
        lo = np.minimum(ks, i)
        hi = np.maximum(ks, i)
        return hi * (hi - 1) // 2 + lo


def seq_sum(vals: np.ndarray) -> float:
    """Left-to-right float64 sum (C accumulation order)."""
    if len(vals) == 0:
        return 0.0
    return float(np.cumsum(vals)[-1])


def init_summa_d(st: TreeState) -> None:
    """initSummaD (nj.c:111-180): per-node distance sums and pair counts,
    skipping negative (missing) cells.  sD[k] accumulates row-k cells
    left-to-right, then column-k cells top-to-bottom — reproduced via a
    sequential cumsum in that exact order."""
    n = st.n
    sD = np.zeros(n, np.float64)
    N = np.ones(n, np.int64)
    for k in range(n):
        o = off(k)
        rowv = st.D.get(slice(o, o + k))
        ks = np.arange(k + 1, n)
        colv = st.D.get(st.col_idx(k, ks)) if len(ks) else np.empty(0)
        vals = np.concatenate([rowv, colv])
        valid = vals >= 0
        sD[k] = seq_sum(vals[valid])
        N[k] = 1 + int(valid.sum())
    st.sD, st.N = sD, N


def _row_q(st: TreeState, i: int):
    """Q values of row i against current sD/N; invalid cells -> +inf."""
    rowv = st.D.row(i)
    valid = rowv >= 0
    coef = ((st.N[i] + st.N[:i] - 4) >> 1).astype(np.float64)
    q = coef * rowv - st.sD[i] - st.sD[:i]
    q = np.where(valid, q, np.inf)
    return q, rowv, valid


def _recompute_row_min(st: TreeState, i: int):
    """minQrow/minQpair inner row pass (dnj.c:99-112): row minimum with
    ``q <= min`` last-wins tie; (DBL_MAX, 0) when the row has no valid
    cell."""
    q, _, valid = _row_q(st, i)
    if not valid.any():
        return DBL_MAX, 0
    m = q.min()
    mj = int(np.flatnonzero(q == m)[-1])
    return float(m), mj


def init_hnj(st: TreeState) -> None:
    """initHNJ (hclust.c:56-130): sD/N + per-row cached (Q, partner).

    Row tie rule (hclust.c:110-116): accept when q < min, or q == min and
    the raw distance d is <= the distance of the incumbent."""
    init_summa_d(st)
    n = st.n
    Q = np.full(n, DBL_MAX, np.float64)
    P = np.zeros(n, np.int64)
    for i in range(1, n):
        q, rowv, valid = _row_q(st, i)
        if valid.any():
            m = q.min()
            cand = np.flatnonzero(q == m)
            pos = int(cand[0])
            minD = rowv[pos]
            for c in cand[1:]:
                if rowv[c] <= minD:
                    minD = rowv[c]
                    pos = int(c)
            Q[i] = m
            P[i] = pos
    st.Q, st.P = Q, P


def init_dmin(st: TreeState) -> None:
    """initDmin (hclust.c:205-277): sD/N plus per-row raw-distance minimum
    (``dist <= min`` last-wins)."""
    init_summa_d(st)
    n = st.n
    Q = np.full(n, DBL_MAX, np.float64)
    P = np.zeros(n, np.int64)
    for i in range(1, n):
        rowv = st.D.row(i)
        valid = rowv >= 0
        if valid.any():
            dv = np.where(valid, rowv, np.inf)
            m = dv.min()
            Q[i] = m
            P[i] = int(np.flatnonzero(dv == m)[-1])
    st.Q, st.P = Q, P


def min_q(st: TreeState):
    """minQ (hclust.c:353-381): global best from row caches, ``<=``
    last-wins over rows 1..n-1."""
    if st.n < 2:
        return 0, 0
    q = st.Q[1:st.n]
    m = q.min()
    mi = int(np.flatnonzero(q == m)[-1]) + 1
    return mi, int(st.P[mi])


def min_q_pair_seq(st: TreeState, seed: int):
    """minQpair (dnj.c:43-128): revalidate rows whose cached Q beats the
    current minimum, scanning i descending, tightening as it goes.
    One-row-at-a-time replica (kept as the semantics reference for
    min_q_pair's batched form)."""
    pos = (0, 0)
    minv = DBL_MAX
    if seed and st.Q[seed] != DBL_MAX:
        minv = st.Q[seed]
        pos = (seed, int(st.P[seed]))
    i = st.n - 1
    Q = st.Q
    while i >= 1:
        sub = Q[1:i + 1]
        mask = sub < minv
        if not mask.any():
            break
        i = 1 + int(np.flatnonzero(mask)[-1])
        newq, mj = _recompute_row_min(st, i)
        Q[i] = newq
        st.P[i] = mj
        if newq < minv:
            minv = newq
            pos = (i, mj)
        i -= 1
    return pos


_QPAIR_KB = 128

_POOLS: dict = {}


def _scan_pool(t: int):
    """Persistent thread pool for the batched Q scan (numpy releases
    the GIL in the gather/arithmetic, so 2 workers ~halve the pass on a
    2-CPU host).  Keyed by size and never shut down explicitly: the
    workers are not daemon threads, so the interpreter joins the idle
    workers at exit."""
    import concurrent.futures as cf
    p = _POOLS.get(t)
    if p is None:
        p = cf.ThreadPoolExecutor(max_workers=t)
        _POOLS[t] = p
    return p


def _qpair_rows(st: TreeState, rows: np.ndarray, nflat: int):
    """One batched row-recompute pass over `rows` (descending): the
    reference's minQrow per row, vectorized.  Read-only on st — safe
    to run chunks concurrently.  Returns (rminv with DBL_MAX for
    empty rows, last-wins rarg with -1 for empty rows)."""
    K = rows.size
    width = int(rows[0])
    idx = np.arange(width)
    gidx = (rows * (rows - 1) // 2)[:, None] + idx[None, :]
    vals = st.D.get(np.minimum(gidx, nflat - 1).reshape(-1)) \
        .reshape(K, width)
    ok = (idx[None, :] < rows[:, None]) & (vals >= 0)
    coef = ((st.N[rows][:, None] + st.N[None, :width] - 4) >> 1) \
        .astype(np.float64)
    q = np.where(ok, coef * vals - st.sD[rows][:, None]
                 - st.sD[None, :width], np.inf)
    rmin = q.min(axis=1)
    rarg = np.where(q == rmin[:, None], idx[None, :], -1) \
        .max(axis=1)                        # `<=` last-wins argmin
    rminv = np.where(np.isfinite(rmin), rmin, DBL_MAX)
    return rminv, rarg


def min_q_pair(st: TreeState, seed: int):
    """minQpair, batched: candidate rows (cached Q < running min) are
    recomputed _QPAIR_KB at a time as one (K, width) vectorized pass —
    trajectory-exact vs min_q_pair_seq including every tie rule: the
    shifted prefix-min `rm` recovers the C's running min at each row's
    visit, so exactly the rows minQpair would recompute get fresh
    caches, and pos updates use the same strict-< / largest-row-wins
    ordering (the same gating as the device engines' batch_scan;
    dnj.c:43-128)."""
    pos = (0, 0)
    minv = DBL_MAX
    if seed and st.Q[seed] != DBL_MAX:
        minv = st.Q[seed]
        pos = (seed, int(st.P[seed]))
    Q, P = st.Q, st.P
    n = st.n
    sD, N = st.sD, st.N
    nflat = st.D.flat.shape[0]
    while True:
        cand = np.flatnonzero(Q[1:n] < minv) + 1
        if cand.size == 0:
            break
        rows = cand[::-1][:_QPAIR_KB]          # descending visit order
        t = st.threads
        if t > 1 and rows.size >= 2 * t and int(rows[0]) >= 1024:
            # split rows across workers; each chunk's pass is
            # independent and read-only, and the merged arrays are in
            # the original order — the sequential gating below sees
            # exactly the single-thread values (the reference's own
            # guarantee, nj.c:492-510)
            chunks = [c for c in np.array_split(rows, t) if c.size]
            parts = list(_scan_pool(t).map(
                lambda c: _qpair_rows(st, c, nflat), chunks))
            rminv = np.concatenate([p[0] for p in parts])
            rarg = np.concatenate([p[1] for p in parts])
        else:
            rminv, rarg = _qpair_rows(st, rows, nflat)
        rm = np.minimum.accumulate(
            np.concatenate([[minv], rminv[:-1]]))
        reval = Q[rows] < rm
        Q[rows[reval]] = rminv[reval]
        P[rows[reval]] = np.maximum(rarg[reval], 0)
        bmin = rminv.min()
        if bmin < minv:
            k = int(np.flatnonzero(rminv == bmin)[0])  # largest row
            minv = bmin
            pos = (int(rows[k]), int(max(rarg[k], 0)))
    return pos


def upgma_pair(st: TreeState, seed: int):
    """UPGMApair (dnj.c:217-293): like minQpair but caches are exact raw
    distances; only rows marked stale (P < 0) are recomputed."""
    pos = (0, 0)
    minv = DBL_MAX
    if seed and st.Q[seed] != DBL_MAX:
        minv = st.Q[seed]
        pos = (seed, int(st.P[seed]))
    i = st.n - 1
    Q, P = st.Q, st.P
    while i >= 1:
        sub = Q[1:i + 1]
        mask = sub < minv
        if not mask.any():
            break
        i = 1 + int(np.flatnonzero(mask)[-1])
        if P[i] < 0:
            rowv = st.D.row(i)
            valid = rowv >= 0
            if valid.any():
                dv = np.where(valid, rowv, np.inf)
                m = float(dv.min())
                mj = int(np.flatnonzero(dv == m)[-1])
            else:
                m, mj = DBL_MAX, 0
            Q[i] = m
            P[i] = mj
            if m < minv:
                minv = m
                pos = (i, mj)
        else:
            minv = Q[i]
            pos = (i, int(P[i]))
        i -= 1
    return pos


def limb_length(i, j, sD, N, D_ij, neg=False):
    """limbLength / limbLengthNeg (nj.c:42-109)."""
    Ni = int(N[i]) - 2
    Nj = int(N[j]) - 2
    if Ni > 0 and Nj > 0:
        delta = (sD[i] - D_ij) / Ni - (sD[j] - D_ij) / Nj
        Li = (D_ij + delta) / 2
        Lj = (D_ij - delta) / 2
        if not neg:
            if Li < 0:
                Lj = D_ij
                Li = 0.0
            elif Lj < 0:
                Li = D_ij
                Lj = 0.0
    elif Ni > 0:
        Li, Lj = 0.0, D_ij
    elif Nj > 0:
        Li, Lj = D_ij, 0.0
    else:
        Li = Lj = D_ij / 2
    return float(Li), float(Lj)


# ---------------------------------------------------------------------------
# updateD family


def _column_ks(st: TreeState, i: int, j: int):
    """k = j+1 .. n-1 skipping i (updateD's two column segments)."""
    return np.concatenate([np.arange(j + 1, i), np.arange(i + 1, st.n)])


def update_d(st: TreeState, i: int, j: int, Li: float, Lj: float) -> None:
    """updateD (nj.c:836-1044): fold node i into slot j.

    D(k,new) = (D_ik + D_kj - D_ij)/2 clamped at 0; one-sided fallbacks
    D_ik - Li / D_kj - Lj when the other side is missing; sD and N are
    maintained incrementally, and sD[j]/N[j] are rebuilt from the new row
    in C accumulation order."""
    D, sD, N = st.D, st.sD, st.N
    D_ij = float(D.get(off(i) + j))
    sd_parts = []

    # --- row part: k < j (nj.c:893-948).  The sD/N walker pointers do
    # NOT advance past both-missing cells (no else branch in the C), so
    # the update targets shift down: the t-th advancing cell writes slot
    # t-1, not slot k.  Reproduced via the walker-position mapping.
    base = 0
    if j > 0:
        row_i = D.row(i, j)
        oj = off(j)
        row_j = D.get(slice(oj, oj + j))
        vi = row_i >= 0
        vj = row_j >= 0
        both = vi & vj
        only_i = vi & ~vj
        only_j = ~vi & vj
        adv = both | only_i | only_j
        wpos = np.cumsum(adv) - 1  # walker slot per advancing cell
        new = row_j.copy()
        if both.any():
            d2 = (row_i + row_j - D_ij) / 2
            d2 = np.where(d2 < 0, 0.0, d2)
            new[both] = d2[both]
            D.store(np.flatnonzero(both) + oj, d2[both], 0.25)
            sD[wpos[both]] -= (row_i + row_j - d2)[both]
            N[wpos[both]] -= 1
        if only_i.any():
            d1 = row_i - Li
            new[only_i] = d1[only_i]
            D.store(np.flatnonzero(only_i) + oj, d1[only_i], 0.0)
            sD[wpos[only_i]] -= Li
        if only_j.any():
            post = D.isub(np.flatnonzero(only_j) + oj, Lj)
            new[only_j] = post
            sD[wpos[only_j]] += post - row_j[only_j]
            N[wpos[only_j]] -= 1
        contrib = np.where(adv, new, np.nan)
        sd_parts.append(contrib[~np.isnan(contrib)])
        base = int(adv.sum())

    # --- column part: k in (j, n) \ {i} (nj.c:950-1039)
    ks = _column_ks(st, i, j)
    if len(ks):
        cidx = st.col_idx(j, ks)
        D_kj = D.get(cidx)
        D_ik = D.get(st.pair_idx(i, ks))
        vi = D_ik >= 0
        vj = D_kj >= 0
        only_j = ~vi & vj
        if only_j.any():
            # the one-sided D_kj branch reads D->mat[j][k] (nj.c:1022) —
            # an out-of-row cell that may alias cells updated earlier in
            # this very loop; replicate sequentially.
            _update_d_column_scalar(st, i, j, ks, D_ij, Li, Lj,
                                    sd_parts, base)
        else:
            both = vi & vj
            only_i = vi & ~vj
            adv = both | only_i
            # column walker: resumes at `base` (after the skip-j
            # advance), +1 extra when crossing the removed row i
            tgt = base + 1 + (ks > i).astype(np.int64) \
                + np.concatenate([[0], np.cumsum(adv)[:-1]])
            if both.any():
                d2 = (D_kj + D_ik - D_ij) / 2
                d2 = np.where(d2 < 0, 0.0, d2)
                D.store(cidx[both], d2[both], 0.25)
                sD[tgt[both]] -= (D_ik + D_kj - d2)[both]
                N[tgt[both]] -= 1
            if only_i.any():
                d1 = D_ik - Li
                D.store(cidx[only_i], d1[only_i], 0.0)
                sD[tgt[only_i]] -= Li
            newv = np.where(both, np.where((D_kj + D_ik - D_ij) / 2 < 0,
                                           0.0, (D_kj + D_ik - D_ij) / 2),
                            np.where(only_i, D_ik - Li, np.nan))
            sd_parts.append(newv[~np.isnan(newv)])

    # every counted k contributed exactly one entry in visit order
    N[j] = 1 + sum(len(p) for p in sd_parts)
    sD[j] = seq_sum(np.concatenate(sd_parts)) if sd_parts else 0.0


def _update_d_column_scalar(st, i, j, ks, D_ij, Li, Lj, sd_parts, base):
    """Sequential replica of updateD's column loop for the missing-data
    path, including the out-of-row D->mat[j][k] read (nj.c:1020-1037)
    and the non-advancing walker for both-missing cells."""
    D, sD, N = st.D, st.sD, st.N
    contribs = []
    pos = base  # walker slot after the skip-j advance
    crossed = False
    for k in ks:
        k = int(k)
        if k > i and not crossed:
            pos += 1  # skip-i advance (nj.c:964-969)
            crossed = True
        cidx = off(k) + j
        D_kj = float(D.get(cidx))
        D_ik = float(D.get(off(k) + i if k > i else off(i) + k))
        if D_ik >= 0 and D_kj >= 0:
            dist = (D_kj + D_ik - D_ij) / 2
            if dist < 0:
                dist = 0.0
            D.store(cidx, dist, 0.25)
            pos += 1
            sD[pos] -= (D_ik + D_kj - dist)
            N[pos] -= 1
            contribs.append(dist)
        elif D_ik >= 0:
            dist = D_ik - Li
            D.store(cidx, dist, 0.0)
            pos += 1
            sD[pos] -= Li
            contribs.append(dist)
        elif D_kj >= 0:
            post = float(D.isub(cidx, Lj))
            garbage = float(D.get(off(j) + k))
            dist = post - garbage
            pos += 1
            sD[pos] += dist
            N[pos] -= 1
            contribs.append(dist)
    sd_parts.append(np.asarray(contribs, np.float64))


def update_d_cf(st: TreeState, i: int, j: int, Li: float, Lj: float) -> None:
    """updateD_CF (nj.c:1391-1558): closest-first D update (min of the
    two distances); used by the 'frank' method."""
    D, sD, N = st.D, st.sD, st.N
    sd_parts = []
    base = 0

    if j > 0:
        row_i = D.row(i, j)
        oj = off(j)
        row_j = D.get(slice(oj, oj + j))
        vi = row_i >= 0
        vj = row_j >= 0
        both = vi & vj
        only_i = vi & ~vj
        only_j = ~vi & vj
        adv = both | only_i | only_j
        wpos = np.cumsum(adv) - 1
        if both.any():
            d2 = np.minimum(row_i, row_j)
            D.store(np.flatnonzero(both) + oj, d2[both], 0.0)
            sD[wpos[both]] -= (row_i + row_j - d2)[both]
            N[wpos[both]] -= 1
        if only_i.any():
            D.store(np.flatnonzero(only_i) + oj, row_i[only_i], 0.0)
        if only_j.any():
            N[wpos[only_j]] -= 1
        contrib = np.where(both, np.minimum(row_i, row_j),
                           np.where(only_i, row_i,
                                    np.where(only_j, row_j, np.nan)))
        sd_parts.append(contrib[~np.isnan(contrib)])
        base = int(adv.sum())

    ks = _column_ks(st, i, j)
    if len(ks):
        cidx = st.col_idx(j, ks)
        D_kj = D.get(cidx)
        D_ik = D.get(st.pair_idx(i, ks))
        vi = D_ik >= 0
        vj = D_kj >= 0
        both = vi & vj
        only_i = vi & ~vj
        only_j = ~vi & vj
        adv = both | only_i | only_j
        tgt = base + 1 + (ks > i).astype(np.int64) \
            + np.concatenate([[0], np.cumsum(adv)[:-1]])
        if both.any():
            d2 = np.minimum(D_ik, D_kj)
            d2 = np.where(d2 < 0, 0.0, d2)
            D.store(cidx[both], d2[both], 0.0)
            sD[tgt[both]] -= (D_ik + D_kj - d2)[both]
            N[tgt[both]] -= 1
        if only_i.any():
            D.store(cidx[only_i], D_ik[only_i], 0.0)
        if only_j.any():
            N[tgt[only_j]] -= 1
        contrib = np.where(both, np.where(np.minimum(D_ik, D_kj) < 0, 0.0,
                                          np.minimum(D_ik, D_kj)),
                           np.where(only_i, D_ik,
                                    np.where(only_j, D_kj, np.nan)))
        sd_parts.append(contrib[~np.isnan(contrib)])

    allparts = (np.concatenate(sd_parts) if sd_parts
                else np.empty(0, np.float64))
    N[j] = 1 + len(allparts)
    sD[j] = seq_sum(allparts)


# ---------------------------------------------------------------------------
# DNJ / HNJ cache maintenance


def _refresh_row_j_q(st: TreeState, j: int):
    """Row-j cache rebuild after a join (dnj.c:619-660): ``q <= Q``
    last-wins; (DBL_MAX, 0) for an empty row."""
    if j == 0:
        st.Q[0] = DBL_MAX
        st.P[0] = 0
        return
    q, _, valid = _row_q(st, j)
    if valid.any():
        m = q.min()
        st.Q[j] = float(m)
        st.P[j] = int(np.flatnonzero(q == m)[-1])
    else:
        st.Q[j] = DBL_MAX
        st.P[j] = 0


def _column_q(st: TreeState, j: int, ks: np.ndarray):
    """Q of cells (k, j) for k in ks against current sD/N."""
    dkj = st.D.get(st.col_idx(j, ks))
    valid = dkj >= 0
    coef = ((st.N[j] + st.N[ks] - 4) >> 1).astype(np.float64)
    q = coef * dkj - st.sD[j] - st.sD[ks]
    return q, dkj, valid


def update_dnj(st: TreeState, i: int, j: int, Li: float, Lj: float) -> int:
    """updateDNJ (dnj.c:607-710): updateD + Q/P repair for row/column j.
    Returns the row index of the best new candidate (seed ``mi``)."""
    update_d(st, i, j, Li, Lj)
    _refresh_row_j_q(st, j)
    min0 = st.Q[j]
    p = j
    ks = _column_ks(st, i, j)
    if len(ks):
        q, _, valid = _column_q(st, j, ks)
        Qold = st.Q[ks]
        upd = valid & (q <= Qold)
        if upd.any():
            st.Q[ks[upd]] = q[upd]
            st.P[ks[upd]] = j
            mq = q[upd].min()
            if mq <= min0:
                p = int(ks[upd & (q == mq)][-1])
    return p


def update_prev_q(st: TreeState) -> None:
    """updatePrevQ (hclust.c:413-450): refresh each row's cached Q via its
    cached partner under the updated sD/N."""
    n = st.n
    if n < 2:
        return
    idx = np.arange(1, n)
    prt = st.P[1:n]
    d = st.D.get(off_vec(idx) + prt)
    valid = d >= 0
    coef = ((st.N[idx] + st.N[prt] - 4) >> 1).astype(np.float64)
    qn = coef * d - st.sD[idx] - st.sD[prt]
    st.Q[idx[valid]] = qn[valid]


def off_vec(i: np.ndarray) -> np.ndarray:
    return i * (i - 1) // 2


def update_hnj(st: TreeState, i: int, j: int, Li: float, Lj: float) -> int:
    """updateHNJ (hclust.c:452-561): heuristic cache maintenance.  The
    candidate tracker compares against the constant row-j minimum
    (hclust.c:536-538 assigns ``q = min``, never ``min = q``)."""
    update_d(st, i, j, Li, Lj)
    update_prev_q(st)
    _refresh_row_j_q(st, j)
    min0 = st.Q[j]
    p = j
    ks = _column_ks(st, i, j)
    if len(ks):
        q, _, valid = _column_q(st, j, ks)
        Qold = st.Q[ks].copy()
        Pold = st.P[ks].copy()
        brA = valid & ((Pold == i) | (Pold == j))
        brB = valid & ~brA & (q <= Qold)
        st.Q[ks[brA | brB]] = q[brA | brB]
        st.P[ks[brA]] = j
        setP = brB & (Pold < j)
        st.P[ks[setP]] = j
        hits = (brA | brB) & (q <= min0)
        if hits.any():
            p = int(ks[hits][-1])
    return p


def _upgma_family_update(st: TreeState, i: int, j: int, combine: str):
    """Shared D/sD/N update + new-distance vectors for updateUPGMA /
    updateFF / updateCF (hclust.c:665-1306).  Returns (row_dists,
    col_dists, ks) where dists are the new distances (or -1 for missing
    pairs) in C visit order."""
    D, sD, N = st.D, st.sD, st.N

    def comb(a, b):
        if combine == "avg":
            return (a + b) / 2
        if combine == "max":
            return np.maximum(a, b)
        return np.minimum(a, b)

    sd_parts = []
    row_dists = np.empty(0, np.float64)
    base = 0
    if j > 0:
        row_i = D.row(i, j)
        oj = off(j)
        row_j = D.get(slice(oj, oj + j))
        vi = row_i >= 0
        vj = row_j >= 0
        both = vi & vj
        only_i = vi & ~vj
        only_j = ~vi & vj
        # walker targets: pointers don't advance on both-missing cells
        # (hclust.c:719-770 has no else branch for them)
        adv = both | only_i | only_j
        wpos = np.cumsum(adv) - 1
        dist = np.full(j, -1.0)
        if both.any():
            d2 = comb(row_i, row_j)
            dist[both] = d2[both]
            D.store(np.flatnonzero(both) + oj, d2[both], 0.0)
            sD[wpos[both]] -= (row_i + row_j - d2)[both]
            N[wpos[both]] -= 1
        if only_i.any():
            dist[only_i] = row_i[only_i]
            D.store(np.flatnonzero(only_i) + oj, row_i[only_i], 0.0)
        if only_j.any():
            dist[only_j] = row_j[only_j]
            N[wpos[only_j]] -= 1
        row_dists = dist
        sd_parts.append(dist[dist >= 0])
        base = int(adv.sum())

    ks = _column_ks(st, i, j)
    col_dists = np.empty(0, np.float64)
    if len(ks):
        cidx = st.col_idx(j, ks)
        D_kj = D.get(cidx)
        D_ik = D.get(st.pair_idx(i, ks))
        vi = D_ik >= 0
        vj = D_kj >= 0
        both = vi & vj
        only_i = vi & ~vj
        only_j = ~vi & vj
        adv = both | only_i | only_j
        tgt = base + 1 + (ks > i).astype(np.int64) \
            + np.concatenate([[0], np.cumsum(adv)[:-1]])
        dist = np.full(len(ks), -1.0)
        if both.any():
            d2 = comb(D_ik, D_kj)
            dist[both] = d2[both]
            D.store(cidx[both], d2[both], 0.0)
            sD[tgt[both]] -= (D_ik + D_kj - d2)[both]
            N[tgt[both]] -= 1
        if only_i.any():
            dist[only_i] = D_ik[only_i]
            D.store(cidx[only_i], D_ik[only_i], 0.0)
        if only_j.any():
            dist[only_j] = D_kj[only_j]
            N[tgt[only_j]] -= 1
        col_dists = dist
        sd_parts.append(dist[dist >= 0])

    allparts = (np.concatenate(sd_parts) if sd_parts
                else np.empty(0, np.float64))
    N[j] = 1 + len(allparts)
    sD[j] = seq_sum(allparts)
    return row_dists, col_dists, ks


def _upgma_row_qp(st, j, row_dists, strict_ff=False):
    """Row-j raw-distance cache rebuild.  UPGMA/CF use ``0<=d && d<=Q``
    last-wins (hclust.c:766, 1203); FF uses plain ``d < Q`` first-wins
    with no validity check (hclust.c:984)."""
    st.Q[j] = DBL_MAX
    st.P[j] = 0
    if len(row_dists) == 0:
        return
    if strict_ff:
        m = row_dists.min()
        st.Q[j] = float(m)
        st.P[j] = int(np.flatnonzero(row_dists == m)[0])
    else:
        valid = row_dists >= 0
        if valid.any():
            dv = np.where(valid, row_dists, np.inf)
            m = dv.min()
            st.Q[j] = float(m)
            st.P[j] = int(np.flatnonzero(dv == m)[-1])


def _running_max_p(events_ks, events_d, min0, p0):
    """The ``if(min <= dist) { min = dist; p = k; }`` tracker shared by
    updateUPGMA/FF/CF: p ends at the last event whose distance equals the
    maximum of (min0, all event distances)."""
    if len(events_ks) == 0:
        return p0
    M = events_d.max()
    if M >= min0:
        return int(events_ks[events_d == M][-1])
    return p0


def update_upgma(st, i, j, Li, Lj) -> int:
    """updateUPGMA (hclust.c:665-882)."""
    row_d, col_d, ks = _upgma_family_update(st, i, j, "avg")
    _upgma_row_qp(st, j, row_d)
    min0 = st.Q[j]
    p = j
    if len(ks):
        Qold = st.Q[ks].copy()
        Pold = st.P[ks].copy()
        valid = col_d >= 0
        brA = valid & (col_d < Qold)
        brEq = valid & ~brA & ((Pold == i) | (Pold == j)) & (col_d == Qold)
        brStale = valid & ~brA & ((Pold == i) | (Pold == j)) & (col_d != Qold)
        st.Q[ks[brA]] = col_d[brA]
        st.P[ks[brA | brEq]] = j
        st.P[ks[brStale]] = -1
        ev = brA | brEq
        p = _running_max_p(ks[ev], col_d[ev], min0, p)
    return p


def update_ff(st, i, j, Li, Lj) -> int:
    """updateFF (hclust.c:884-1100)."""
    row_d, col_d, ks = _upgma_family_update(st, i, j, "max")
    _upgma_row_qp(st, j, row_d, strict_ff=True)
    min0 = st.Q[j]
    p = j
    if len(ks):
        Qold = st.Q[ks].copy()
        Pold = st.P[ks].copy()
        valid = col_d >= 0
        brA = valid & (col_d < Qold)
        brEq = valid & ~brA & ((Pold == i) | (Pold == j)) & (col_d == Qold)
        brStale = valid & ~brA & ((Pold == i) | (Pold == j)) & (col_d != Qold)
        st.Q[ks[brA]] = col_d[brA]
        st.P[ks[brA | brEq]] = j
        st.P[ks[brStale]] = -1
        ev = brA | brEq
        p = _running_max_p(ks[ev], col_d[ev], min0, p)
    return p


def update_cf(st, i, j, Li, Lj) -> int:
    """updateCF (hclust.c:1102-1306)."""
    row_d, col_d, ks = _upgma_family_update(st, i, j, "min")
    _upgma_row_qp(st, j, row_d)
    min0 = st.Q[j]
    p = j
    if len(ks):
        Qold = st.Q[ks].copy()
        Pold = st.P[ks].copy()
        valid = (col_d >= 0) & (col_d <= Qold)
        acc = valid & ((col_d < Qold) | (Pold == i) | (Pold == ks)
                       | (Pold < j))
        st.Q[ks[acc]] = col_d[acc]
        st.P[ks[acc]] = j
        p = _running_max_p(ks[acc], col_d[acc], min0, p)
    return p


# ---------------------------------------------------------------------------
# pop-arrange family (move last row into freed slot)


def _move_last_row(st: TreeState, pos: int):
    """ltdMatrix_popArrange's data movement (matrix.c:518-602): copy last
    row into row pos, tilt its tail into column pos.  Caller has already
    decremented n.  Returns (row_vals, ks, col_vals) as post-move logical
    values."""
    n = st.n  # already decremented: last row index == n
    D = st.D
    osrc = off(n)
    opos = off(pos)
    D.raw_copy(slice(opos, opos + pos), slice(osrc, osrc + pos))
    ks = np.arange(pos + 1, n)
    if len(ks):
        D.raw_copy(st.col_idx(pos, ks), osrc + ks)
    row_vals = D.get(slice(opos, opos + pos))
    col_vals = D.get(st.col_idx(pos, ks)) if len(ks) else np.empty(0)
    return row_vals, ks, col_vals


def ltd_pop_arrange(st: TreeState, pos: int) -> None:
    """Plain compaction for the 'e' engines (matrix.c:518-602)."""
    st.n -= 1
    if pos != st.n:
        _move_last_row(st, pos)


def dnj_pop_arrange(st: TreeState, pos: int) -> int:
    """DNJ_popArrange (dnj.c:817-975)."""
    st.n -= 1
    n = st.n
    if pos == n:
        return 0
    st.sD[pos] = st.sD[n]
    st.N[pos] = st.N[n]
    row_vals, ks, col_vals = _move_last_row(st, pos)
    # row pass: Q[pos]/P[pos] from the moved row, q <= Q last-wins
    st.Q[pos] = DBL_MAX
    st.P[pos] = 0
    valid = row_vals >= 0
    if valid.any():
        coef = ((st.N[pos] + st.N[:pos] - 4) >> 1).astype(np.float64)
        q = coef * row_vals - st.sD[pos] - st.sD[:pos]
        q = np.where(valid, q, np.inf)
        m = q.min()
        st.Q[pos] = float(m)
        st.P[pos] = int(np.flatnonzero(q == m)[-1])
    min0 = st.Q[pos]
    p = pos
    if len(ks):
        valid = col_vals >= 0
        coef = ((st.N[pos] + st.N[ks] - 4) >> 1).astype(np.float64)
        q = coef * col_vals - st.sD[pos] - st.sD[ks]
        Qold = st.Q[ks]
        upd = valid & (q <= Qold)
        if upd.any():
            st.Q[ks[upd]] = q[upd]
            st.P[ks[upd]] = pos
            mq = q[upd].min()
            if mq <= min0:
                p = int(ks[upd & (q == mq)][-1])
    return p


def hnj_pop_arrange(st: TreeState, pos: int) -> int:
    """HNJ_popArrange (hclust.c:1308-1432): as DNJ but the column update
    requires P[k] < pos or a strict improvement."""
    st.n -= 1
    n = st.n
    if pos == n:
        return 0
    st.sD[pos] = st.sD[n]
    st.N[pos] = st.N[n]
    row_vals, ks, col_vals = _move_last_row(st, pos)
    st.Q[pos] = DBL_MAX
    st.P[pos] = 0
    valid = row_vals >= 0
    if valid.any():
        coef = ((st.N[pos] + st.N[:pos] - 4) >> 1).astype(np.float64)
        q = coef * row_vals - st.sD[pos] - st.sD[:pos]
        q = np.where(valid, q, np.inf)
        m = q.min()
        st.Q[pos] = float(m)
        st.P[pos] = int(np.flatnonzero(q == m)[-1])
    min0 = st.Q[pos]
    p = pos
    if len(ks):
        valid = col_vals >= 0
        coef = ((st.N[pos] + st.N[ks] - 4) >> 1).astype(np.float64)
        q = coef * col_vals - st.sD[pos] - st.sD[ks]
        Qold = st.Q[ks].copy()
        Pold = st.P[ks].copy()
        upd = valid & (q <= Qold) & ((Pold < pos) | (q < Qold))
        if upd.any():
            st.Q[ks[upd]] = q[upd]
            st.P[ks[upd]] = pos
            mq = q[upd].min()
            if mq <= min0:
                p = int(ks[upd & (q == mq)][-1])
    return p


def upgma_pop_arrange(st: TreeState, pos: int) -> int:
    """UPGMA_popArrange (hclust.c:1559-1669): raw-distance caches."""
    st.n -= 1
    n = st.n
    if pos == n:
        return 0
    st.sD[pos] = st.sD[n]
    st.N[pos] = st.N[n]
    row_vals, ks, col_vals = _move_last_row(st, pos)
    st.Q[pos] = DBL_MAX
    st.P[pos] = 0
    valid = row_vals >= 0
    if valid.any():
        dv = np.where(valid, row_vals, np.inf)
        m = dv.min()
        st.Q[pos] = float(m)
        st.P[pos] = int(np.flatnonzero(dv == m)[-1])
    min0 = st.Q[pos]
    p = pos
    if len(ks):
        valid = col_vals >= 0
        Qold = st.Q[ks].copy()
        Pold = st.P[ks].copy()
        upd = valid & (col_vals <= Qold) & ((Pold < pos)
                                            | (col_vals < Qold))
        if upd.any():
            st.Q[ks[upd]] = col_vals[upd]
            st.P[ks[upd]] = pos
            mq = col_vals[upd].min()
            if mq <= min0:
                p = int(ks[upd & (col_vals == mq)][-1])
    return p


# ---------------------------------------------------------------------------
# 'e'-mode full scans


def _flat_ij(n: int):
    """Per-cell (i, j) index arrays for an n-taxa ltd matrix."""
    I = np.repeat(np.arange(n), np.arange(n))
    J = np.concatenate([np.arange(i) for i in range(n)]) if n else np.empty(0, int)
    return I, J


def init_q_scan(st: TreeState):
    """initQ (nj.c:182-247): full Q scan, min starts at 1, ``<=``
    last-wins."""
    n = st.n
    vals = st.D.get(slice(0, off(n)))
    I, J = _flat_ij(n)
    valid = vals >= 0
    coef = ((st.N[I] + st.N[J] - 4) >> 1).astype(np.float64)
    q = np.where(valid, coef * vals - st.sD[I] - st.sD[J], np.inf)
    if not valid.any():
        return 0, 0
    m = q.min()
    if m > 1.0:
        return 0, 0
    idx = int(np.flatnonzero(q == m)[-1])
    return int(I[idx]), int(J[idx])


def init_q_mn_scan(st: TreeState):
    """initQ_MN (nj.c:297-362): maximum Q, ``max <=`` last-wins."""
    n = st.n
    vals = st.D.get(slice(0, off(n)))
    I, J = _flat_ij(n)
    valid = vals >= 0
    if not valid.any():
        return 0, 0
    coef = ((st.N[I] + st.N[J] - 4) >> 1).astype(np.float64)
    q = np.where(valid, coef * vals - st.sD[I] - st.sD[J], -np.inf)
    m = q.max()
    idx = int(np.flatnonzero(q == m)[-1])
    return int(I[idx]), int(J[idx])


def max_d_scan(st: TreeState):
    """maxD (nj.c:607-650): maximum raw distance, last-wins."""
    n = st.n
    vals = st.D.get(slice(0, off(n)))
    I, J = _flat_ij(n)
    valid = vals >= 0
    if not valid.any():
        return 0, 0
    dv = np.where(valid, vals, -np.inf)
    m = dv.max()
    idx = int(np.flatnonzero(dv == m)[-1])
    return int(I[idx]), int(J[idx])


def min_d_scan(st: TreeState):
    """minD (nj.c:524-567): minimum raw distance, last-wins."""
    n = st.n
    vals = st.D.get(slice(0, off(n)))
    I, J = _flat_ij(n)
    valid = vals >= 0
    if not valid.any():
        return 0, 0
    dv = np.where(valid, vals, np.inf)
    m = dv.min()
    idx = int(np.flatnonzero(dv == m)[-1])
    return int(I[idx]), int(J[idx])


def min_pos(Q, i, j):
    """minPos (dnj.c:977-979)."""
    return j if (Q[j] < Q[i] or (i < j and Q[j] == Q[i])) else i


# ---------------------------------------------------------------------------
# method registry & engine loops (tree.c:324-464)

METHODS = {
    "dnj":   dict(mode="d", init=init_hnj, qpair=min_q_pair,
                  update=update_dnj, pop=dnj_pop_arrange),
    "upgma": dict(mode="d", init=init_dmin, qpair=upgma_pair,
                  update=update_upgma, pop=upgma_pop_arrange),
    "ff":    dict(mode="d", init=init_dmin, qpair=upgma_pair,
                  update=update_ff, pop=upgma_pop_arrange),
    "cf":    dict(mode="h", init=init_dmin, pair=min_q,
                  update=update_cf, pop=upgma_pop_arrange),
    "hnj":   dict(mode="h", init=init_hnj, pair=min_q,
                  update=update_hnj, pop=hnj_pop_arrange),
    "nj":    dict(mode="e", mindist=init_q_scan, update=update_d),
    "mn":    dict(mode="e", mindist=init_q_mn_scan, update=update_d),
    "frank": dict(mode="e", mindist=max_d_scan, update=update_d_cf),
}


def _d_ij(st: TreeState, i: int, j: int) -> float:
    return float(st.D.get(off(i) + j))


def _finish(st: TreeState, names, flag: int, precision: int):
    """Close out the root (nj.c:1594-1607 and twins)."""
    last = form_last_bi_node if (flag & 1) else form_last_node
    if st.n == 2:
        last(names[0], names[1], float(st.D.get(0)), precision)
    else:
        while st.n != 1:
            st.n -= 1
            last(names[0], names[st.n], -1.0, precision)
    byteshift_fix(names[0])


def build_tree(flat64, n, names, method="dnj", flag=0, precision=9,
               dtype="d", bytescale=128.0, threads=1) -> bytes:
    """Run one join engine over a loaded matrix; returns the Newick bytes
    (without trailing ';').  ``names`` is a list of Name objects that is
    mutated (swap-with-last ordering) exactly as the reference does.
    ``threads`` parallelizes the dnj batch Q scan (`tree -t`,
    dnj.c:505-605) with identical output at any count."""
    cfg = METHODS[method]
    st = TreeState(flat64, n, dtype, bytescale)
    st.threads = max(1, int(threads))
    neg = bool(flag & 2)
    mode = cfg["mode"]

    if mode == "e":
        init_summa_d(st)
        mindist = cfg["mindist"]
        update = cfg["update"]
        while st.n != 2:
            i, j = mindist(st)
            if i == 0 and j == 0:
                break
            Li, Lj = limb_length(i, j, st.sD, st.N, _d_ij(st, i, j), neg)
            form_node(names[j], names[i], Lj, Li, precision)
            update(st, i, j, Li, Lj)
            ltd_pop_arrange(st, i)
            st.sD[i] = st.sD[st.n]
            st.N[i] = st.N[st.n]
            names[i], names[st.n] = names[st.n], names[i]
    elif mode == "d":
        cfg["init"](st)
        qpair = cfg["qpair"]
        update = cfg["update"]
        pop = cfg["pop"]
        mi0, _ = min_q(st)
        j = mi0
        while st.n != 2:
            i, j = qpair(st, j)
            if i == 0 and j == 0:
                break
            Li, Lj = limb_length(i, j, st.sD, st.N, _d_ij(st, i, j), neg)
            form_node(names[j], names[i], Lj, Li, precision)
            mi = update(st, i, j, Li, Lj)
            mj = pop(st, i)
            names[i], names[st.n] = names[st.n], names[i]
            if mj == st.n:
                j = mi
            elif mi == st.n:
                j = mj
            else:
                j = min_pos(st.Q, mi, mj)
    else:  # 'h'
        cfg["init"](st)
        pair = cfg["pair"]
        update = cfg["update"]
        pop = cfg["pop"]
        while st.n != 2:
            i, j = pair(st)
            if i == 0 and j == 0:
                break
            Li, Lj = limb_length(i, j, st.sD, st.N, _d_ij(st, i, j), neg)
            form_node(names[j], names[i], Lj, Li, precision)
            update(st, i, j, Li, Lj)
            pop(st, i)
            names[i], names[st.n] = names[st.n], names[i]

    _finish(st, names, flag, precision)
    return names[0].data
