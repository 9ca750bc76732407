"""Device engines for the heuristic/UPGMA join family.

Device-resident counterparts of the reference's hclust machinery
(hclust.c:56-1720, dnj.c:217-293, nj.c:297-362), sharing the segmented
host-dispatch skeleton of tree/jax_engine.py:

  mode 'd' (upgma, ff)  — per-row raw-distance caches (initDmin,
      hclust.c:205-277) revalidated by UPGMApair's descending scan
      (dnj.c:217-293; only rows marked stale P < 0 recompute), update
      rules updateUPGMA / updateFF (hclust.c:665-1100),
      UPGMA_popArrange (hclust.c:1559-1669), DNJ-style seed chaining.
  mode 'h' (cf, hnj)    — global cache pick minQ (hclust.c:353-381),
      update rules updateCF (hclust.c:1102-1306) / updateHNJ
      (hclust.c:452-561, incl. updatePrevQ hclust.c:413-450),
      UPGMA_/HNJ_popArrange.
  mode 'e' (nj, mn)     — full masked Q scan per join (initQ
      nj.c:182-247 with its ``min > 1.0`` early-out; initQ_MN
      nj.c:297-362 max variant), updateD (nj.c:836-1044), plain
      compaction (matrix.c:518-602).

All tie rules ("last-wins" ``<=`` scans, UPGMApair's running min, the
update trackers' ``min <= dist`` running max) reproduce the host exact
engine (tree/exact.py) — with float64 compute the join records are
bit-identical to it on integer (SNP-pipeline) distances, which is how
this file is tested; missing cells (D < 0) are fully supported,
including the non-advancing sD/N walker and nj.c:1022 garbage-read
quirks (via jax_engine._update_d_exact).

Float-data scope: device reductions (cumsum) are not bitwise C
sequential summation, so on non-integer matrices sD carries ulp
differences that can flip exact Q ties.  upgma/cf/mn pick on raw
distances and match the reference byte-for-byte even on float data
(verified on test.phy.gz); ff can differ in a limb's last printed
digit; hnj/nj can flip tied picks — same caveat as the device DNJ
engine.  The default host engine remains the byte-parity path for
arbitrary float inputs.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..io.qseqs import Name  # noqa: F401 (API type)
from ..ops.select import topk_mask_indices
from .jax_engine import _common, _last_min, _pad, _records_to_newick, \
    _update_d_exact
from .segmenting import run_segmented

KBATCH = 128


def _last_eq(mask, vals, target, idx):
    """LAST index where mask & (vals == target), -1 if none."""
    return jnp.where(mask & (vals == target), idx, -1).max() \
        .astype(jnp.int32)


def _raw_row_min(D, i, idx, big, last_wins=True):
    """Row-i raw-distance cache: min over partners k < i with d >= 0
    (initDmin, hclust.c:205-277; last-wins).  (big, 0) for empty."""
    drow = D[i]
    ok = (idx < i) & (drow >= 0)
    dv = jnp.where(ok, drow, big)
    m = dv.min()
    if last_wins:
        p = jnp.where(ok & (dv == m), idx, -1).max().astype(jnp.int32)
    else:
        n = D.shape[0]
        p = jnp.where(ok & (dv == m), idx, n).min().astype(jnp.int32)
    has = ok.any()
    return (jnp.where(has, m, big),
            jnp.where(has, jnp.maximum(p, 0), 0))


def _ff_row_min(newD, j, idx, big):
    """FF row-j rebuild (hclust.c:984): plain ``d < Q`` first-wins with
    NO validity check — missing (-1) cells participate."""
    dv = jnp.where(idx < j, newD, big)
    m = dv.min()
    p = jnp.where(dv == m, idx, newD.shape[0]).min().astype(jnp.int32)
    has = j > 0
    return jnp.where(has, m, big), jnp.where(has, p, 0)


def _limbs(sD, N, i, j, D_ij, neg_limbs):
    """limbLength / limbLengthNeg (nj.c:42-109)."""
    Ni = N[i] - 2
    Nj = N[j] - 2
    delta = jnp.where(
        (Ni > 0) & (Nj > 0),
        (sD[i] - D_ij) / jnp.maximum(Ni, 1)
        - (sD[j] - D_ij) / jnp.maximum(Nj, 1), 0.0)
    Li = jnp.where((Ni > 0) & (Nj > 0), (D_ij + delta) / 2,
                   jnp.where(Ni > 0, 0.0,
                             jnp.where(Nj > 0, D_ij, D_ij / 2)))
    Lj = jnp.where((Ni > 0) & (Nj > 0), (D_ij - delta) / 2,
                   jnp.where(Ni > 0, D_ij,
                             jnp.where(Nj > 0, 0.0, D_ij / 2)))
    if not neg_limbs:
        Li_c = jnp.where(Li < 0, 0.0, jnp.where(Lj < 0, D_ij, Li))
        Lj_c = jnp.where(Li < 0, D_ij, jnp.where(Lj < 0, 0.0, Lj))
        Li, Lj = Li_c, Lj_c
    return Li, Lj


def _update_d_comb(D, sD, N, i, j, hp, idx, m_t, dtype, combine):
    """Shared D/sD/N update for updateUPGMA/FF/CF (hclust.c:665-1306):
    D(k,new) = combine(D_ik, D_kj); one-sided cells keep the surviving
    value with no sD adjustment; N drops for both/only_j.  sD/N deltas
    target WALKER slots — the C pointer walkers do not advance past
    both-missing cells (see tree/exact.py _upgma_family_update)."""
    n = D.shape[0]
    active = idx < m_t
    D_ik = D[i]
    D_kj = D[j]
    valid_k = active & (idx != i) & (idx != j) & hp
    vi = D_ik >= 0
    vj = D_kj >= 0
    both = valid_k & vi & vj
    only_i = valid_k & vi & ~vj
    only_j = valid_k & ~vi & vj
    if combine == "avg":
        d2 = (D_ik + D_kj) / 2
    elif combine == "max":
        d2 = jnp.maximum(D_ik, D_kj)
    else:
        d2 = jnp.minimum(D_ik, D_kj)
    newD = jnp.where(both, d2,
                     jnp.where(only_i, D_ik,
                               jnp.where(only_j, D_kj, -1.0)))
    adv = both | only_i | only_j
    adv_r = adv & (idx < j)
    adv_c = adv & (idx > j)
    wpos = jnp.cumsum(adv_r.astype(jnp.int32)) - 1
    base = adv_r.sum(dtype=jnp.int32)
    prevc = jnp.cumsum(adv_c.astype(jnp.int32)) - adv_c
    tgt = jnp.where(adv_r, wpos,
                    base + 1 + (idx > i).astype(jnp.int32) + prevc)
    tgt = jnp.where(adv, tgt, n)
    sD = sD.at[tgt].add(
        jnp.where(both, -(D_ik + D_kj - d2), 0.0), mode="drop")
    N = N.at[tgt].add(jnp.where(both | only_j, -1, 0), mode="drop")
    sD = sD.at[j].set(jnp.where(
        hp, jnp.cumsum(jnp.where(adv, newD, 0), dtype=dtype)[-1],
        sD[j]))
    N = N.at[j].set(jnp.where(hp, 1 + adv.sum(dtype=jnp.int32),
                              N[j]))
    newD = jnp.where(valid_k, newD, -1.0)
    D = D.at[j, :].set(jnp.where(valid_k, newD, D[j]))
    D = D.at[:, j].set(jnp.where(valid_k, newD, D[:, j]))
    return D, sD, N, valid_k, newD


def _running_max_p(ev, d, min0, p0, idx):
    """The ``if (min <= dist) { min = dist; p = k; }`` tracker shared by
    the update rules (hclust.c:835-880 and twins): p ends at the LAST
    event whose distance equals max(min0, all event distances)."""
    M = jnp.where(ev, d, -jnp.inf).max()
    hit = ev.any() & (M >= min0)
    pk = jnp.where(ev & (d == M), idx, -1).max().astype(jnp.int32)
    return jnp.where(hit, pk, p0)


def _move_last(D, sD, N, i, m_t, hp, idx):
    """popArrange data movement (matrix.c:518-602): last row -> slot i;
    returns (D, sD, N, g, last)."""
    m_new = m_t - 1
    last = m_new
    g = hp & (i != last)
    moverow = D[last]
    newrow_i = jnp.where(idx == i, 0.0, moverow)
    D = D.at[i, :].set(jnp.where(g, newrow_i, D[i]))
    D = D.at[:, i].set(jnp.where(g, newrow_i, D[:, i]))
    D = D.at[i, last].set(jnp.where(g, -1.0, D[i, last]))
    D = D.at[last, i].set(jnp.where(g, -1.0, D[last, i]))
    sD = sD.at[i].set(jnp.where(g, sD[last], sD[i]))
    N = N.at[i].set(jnp.where(g, N[last], N[i]))
    return D, sD, N, g, last


def _upgma_scan(D, Q, P, minv0, pi0, pj0, m_t, idx, big):
    """UPGMApair (dnj.c:217-293) as fused batches: candidate rows
    (cached Q < running min, descending) either accept their exact
    cache (P >= 0) or recompute the raw row minimum (P < 0).  The
    shifted prefix-min recovers the C's running min at every visit
    (see jax_engine.dnj_joins batch_scan: post-visit values can never
    undercut their cached lower bounds)."""
    n = D.shape[0]

    def cand_mask(Q, minv):
        return (idx >= 1) & (idx < m_t) & (Q < minv)

    def bcond(c):
        return cand_mask(c[3], c[0]).any()

    def bbody(c):
        minv, pi, pj, Q, P = c
        cm = cand_mask(Q, minv)
        rows = topk_mask_indices(cm, idx, KBATCH)     # descending
        valid = rows >= 1
        r = jnp.where(valid, rows, 0)
        stale = P[r] < 0
        Drows = D[r]                                   # (K, n)
        ok = (idx[None, :] < r[:, None]) & (Drows >= 0)
        dv = jnp.where(ok, Drows, big)
        rmin = dv.min(axis=1)
        rarg = jnp.where(dv == rmin[:, None], idx[None, :], -1) \
            .max(axis=1).astype(jnp.int32)
        has = ok.any(axis=1)
        rmin = jnp.where(has, rmin, big)
        rarg = jnp.where(has, jnp.maximum(rarg, 0), 0)
        # post-visit value: fresh min for stale rows, cache otherwise
        v = jnp.where(stale, rmin, Q[r])
        varg = jnp.where(stale, rarg, P[r])
        vv = jnp.where(valid, v, big)
        rm = jax.lax.cummin(jnp.concatenate([minv[None], vv[:-1]]))
        visit = valid & (Q[r] < rm)
        wr = visit & stale
        tgt = jnp.where(wr, rows, n)
        Q = Q.at[tgt].set(jnp.where(wr, rmin, big), mode="drop")
        P = P.at[tgt].set(jnp.where(wr, rarg, 0), mode="drop")
        bvals = jnp.where(visit, v, big)
        bmin = bvals.min()
        bi = jnp.where(bvals == bmin, rows, -1).max().astype(jnp.int32)
        karg = jnp.where((bvals == bmin) & (rows == bi), varg, 0) \
            .max().astype(jnp.int32)
        better = bmin < minv
        return (jnp.where(better, bmin, minv),
                jnp.where(better, bi, pi),
                jnp.where(better, karg, pj), Q, P)

    return jax.lax.while_loop(bcond, bbody, (minv0, pi0, pj0, Q, P))


def _mk_one_join_h(n, dtype, m, neg_limbs, method):
    """one_join body for upgma/ff (mode 'd') and cf/hnj (mode 'h')."""
    big, idx = _common(n, dtype)
    mode_d = method in ("upgma", "ff")

    def one_join(t, carry):
        D, sD, N, Q, P, seed, I, J, LI, LJ = carry
        m_t = m - t

        if mode_d:
            # ---- UPGMApair(seed) (dnj.c:217-293)
            seed_ok = (seed != 0) & (Q[seed] != big)
            minv0 = jnp.where(seed_ok, Q[seed], big)
            pi0 = jnp.where(seed_ok, seed, 0)
            pj0 = jnp.where(seed_ok, P[seed], 0)
            minv, pi, pj, Q, P = _upgma_scan(D, Q, P, minv0, pi0, pj0,
                                             m_t, idx, big)
            hp = (pi != 0) | (pj != 0)
        else:
            # ---- minQ (hclust.c:353-381): global cache pick, ``<=``
            # last-wins over rows 1..m_t-1
            act = (idx >= 1) & (idx < m_t)
            qrows = jnp.where(act, Q, big)
            mn = qrows.min()
            pi = jnp.where(act & (qrows == mn), idx, -1).max() \
                .astype(jnp.int32)
            pi = jnp.maximum(pi, 0)
            pj = P[pi]
            hp = (pi != 0) | (pj != 0)
        i, j = pi, pj

        # ---- limbs (shared with every engine, nj.c:42-109)
        D_ij = D[i, j]
        Li, Lj = _limbs(sD, N, i, j, D_ij, neg_limbs)

        # ---- update (method-specific)
        Pold = P
        if method == "hnj":
            D, sD, N, valid_k, newD = _update_d_exact(
                D, sD, N, i, j, Li, Lj, hp, idx, m_t, dtype)
            # updatePrevQ (hclust.c:413-450): refresh every cached Q
            # via its cached partner under the updated sD/N
            prt = jnp.maximum(P, 0)
            dprev = jnp.take_along_axis(D, prt[:, None], axis=1)[:, 0]
            rows_ok = (idx >= 1) & (idx < m_t) & (dprev >= 0) & hp
            coefp = ((N + N[prt] - 4) >> 1).astype(dtype)
            Q = jnp.where(rows_ok, coefp * dprev - sD - sD[prt], Q)
        else:
            comb = {"upgma": "avg", "ff": "max", "cf": "min"}[method]
            D, sD, N, valid_k, newD = _update_d_comb(
                D, sD, N, i, j, hp, idx, m_t, dtype, comb)

        # ---- row-j cache rebuild
        if method == "hnj":
            drow = D[j]
            okj = (idx < j) & (drow >= 0)
            coefj = ((N[j] + N - 4) >> 1).astype(dtype)
            qj = jnp.where(okj, coefj * drow - sD[j] - sD, big)
            Qj, Pj = _last_min(qj, idx)
            Pj = jnp.where(Qj == big, 0, Pj)
        elif method == "ff":
            Qj, Pj = _ff_row_min(newD, j, idx, big)
        else:
            dvj = jnp.where((idx < j) & (newD >= 0), newD, big)
            mj_ = dvj.min()
            has = ((idx < j) & (newD >= 0)).any()
            Qj = jnp.where(has, mj_, big)
            Pj = jnp.where(has, jnp.where(dvj == mj_, idx, -1).max(),
                           0).astype(jnp.int32)
        Q = Q.at[j].set(jnp.where(hp, Qj, Q[j]))
        P = P.at[j].set(jnp.where(hp, Pj, P[j]))
        min0 = Q[j]

        # ---- column-j cache pass (k > j, k != i, active)
        colk = valid_k & (idx > j)
        col_d = newD
        vc = colk & (col_d >= 0)
        Qold = Q
        if method == "hnj":
            # updateHNJ (hclust.c:452-561)
            coefc = ((N[j] + N - 4) >> 1).astype(dtype)
            qcol = coefc * col_d - sD[j] - sD
            brA = vc & ((Pold == i) | (Pold == j))
            brB = vc & ~brA & (qcol <= Qold)
            Q = jnp.where(brA | brB, qcol, Q)
            P = jnp.where(brA | (brB & (Pold < j)), j, P)
            hits = (brA | brB) & (qcol <= min0)
            mi_cand = jnp.where(hits.any(),
                                jnp.where(hits, idx, -1).max(),
                                j).astype(jnp.int32)
        elif method == "cf":
            # updateCF (hclust.c:1102-1306)
            acc = vc & (col_d <= Qold) & ((col_d < Qold) | (Pold == i)
                                          | (Pold == idx) | (Pold < j))
            Q = jnp.where(acc, col_d, Q)
            P = jnp.where(acc, j, P)
            mi_cand = _running_max_p(acc, col_d, min0, j, idx)
        else:
            # updateUPGMA / updateFF (hclust.c:665-1100)
            brA = vc & (col_d < Qold)
            stale_p = (Pold == i) | (Pold == j)
            brEq = vc & ~brA & stale_p & (col_d == Qold)
            brStale = vc & ~brA & stale_p & (col_d != Qold)
            Q = jnp.where(brA, col_d, Q)
            P = jnp.where(brA | brEq, j, P)
            P = jnp.where(brStale, -1, P)
            mi_cand = _running_max_p(brA | brEq, col_d, min0, j, idx)

        # ---- popArrange (UPGMA_ hclust.c:1559-1669 / HNJ_ :1308-1432)
        D, sD, N, g, last = _move_last(D, sD, N, i, m_t, hp, idx)
        if method == "hnj":
            drow = D[i]
            oki = (idx < i) & (drow >= 0)
            coefi = ((N[i] + N - 4) >> 1).astype(dtype)
            qi = jnp.where(oki, coefi * drow - sD[i] - sD, big)
            Qi, Pi = _last_min(qi, idx)
            Pi = jnp.where(Qi == big, 0, Pi)
        else:
            Qi, Pi = _raw_row_min(D, i, idx, big)
        Q = Q.at[i].set(jnp.where(g, Qi, Q[i]))
        P = P.at[i].set(jnp.where(g, Pi, P[i]))
        ck = (idx > i) & (idx < last) & g
        if method == "hnj":
            coefi2 = ((N[i] + N - 4) >> 1).astype(dtype)
            colv = coefi2 * D[:, i] - sD[i] - sD
        else:
            colv = D[:, i]
        vcol = ck & (D[:, i] >= 0)
        Pold2 = P
        u2 = vcol & (colv <= Q) & ((Pold2 < i) | (colv < Q))
        Q = jnp.where(u2, colv, Q)
        P = jnp.where(u2, i, P)
        mq2 = jnp.where(u2, colv, big).min()
        p2 = jnp.where(u2.any() & (mq2 <= Qi),
                       jnp.where(u2 & (colv == mq2), idx, -1).max(), i) \
            .astype(jnp.int32)
        mj_cand = jnp.where(g, p2, 0)
        Q = Q.at[last].set(big)

        if mode_d:
            # ---- seed chaining (dnj.c:1026-1032)
            m_new = m_t - 1
            seed_new = jnp.where(
                mj_cand == m_new, mi_cand,
                jnp.where(mi_cand == m_new, mj_cand,
                          jnp.where((Q[mj_cand] < Q[mi_cand])
                                    | ((mi_cand < mj_cand)
                                       & (Q[mj_cand] == Q[mi_cand])),
                                    mj_cand, mi_cand)))
            seed = jnp.where(hp, seed_new, 0)

        I = I.at[t].set(jnp.where(hp, i, 0))
        J = J.at[t].set(jnp.where(hp, j, 0))
        LI = LI.at[t].set(jnp.where(hp, Li, -1.0))
        LJ = LJ.at[t].set(jnp.where(hp, Lj, -1.0))
        return D, sD, N, Q, P, seed, I, J, LI, LJ

    return one_join


def _mk_one_join_e(n, dtype, m, neg_limbs, method):
    """one_join body for the 'e'-mode full-scan engines (nj, mn)."""
    big, idx = _common(n, dtype)

    def scan_pair(D, sD, N, m_t):
        """Full masked Q scan (initQ nj.c:182-247 / initQ_MN :297-362):
        last-wins in ltd flat order = largest i, then largest j."""
        CH = next(c for c in (512, 256, 128) if n % c == 0)

        def chunk(_, c):
            rows = c * CH + jnp.arange(CH)
            Drows = jax.lax.dynamic_slice(D, (c * CH, 0), (CH, n))
            lv = ((rows[:, None] < m_t) & (idx[None, :] < rows[:, None])
                  & (Drows >= 0))
            coef = ((N[rows][:, None] + N[None, :] - 4) >> 1) \
                .astype(dtype)
            q = coef * Drows - sD[rows][:, None] - sD[None, :]
            if method == "mn":
                qm = jnp.where(lv, q, -big)
                rbest = qm.max(axis=1)
                rarg = jnp.where(qm == rbest[:, None], idx[None, :],
                                 -1).max(axis=1).astype(jnp.int32)
            else:
                qm = jnp.where(lv, q, big)
                rbest = qm.min(axis=1)
                rarg = jnp.where(qm == rbest[:, None], idx[None, :],
                                 -1).max(axis=1).astype(jnp.int32)
            return None, (rbest, rarg, lv.any(axis=1))

        _, (rb, ra, rh) = jax.lax.scan(chunk, None, jnp.arange(n // CH))
        rb = rb.reshape(n)
        ra = ra.reshape(n)
        rh = rh.reshape(n)
        if method == "mn":
            gb = jnp.where(rh, rb, -big).max()
            gi = jnp.where(rh & (rb == gb), idx, -1).max() \
                .astype(jnp.int32)
            found = rh.any()
        else:
            gb = jnp.where(rh, rb, big).min()
            gi = jnp.where(rh & (rb == gb), idx, -1).max() \
                .astype(jnp.int32)
            # initQ early-out (nj.c:232-235): no pair when min > 1.0
            found = rh.any() & (gb <= 1.0)
        gi = jnp.where(found, gi, 0)
        gj = jnp.where(found, ra[gi], 0)
        return gi, gj

    def one_join(t, carry):
        D, sD, N, I, J, LI, LJ = carry
        m_t = m - t
        i, j = scan_pair(D, sD, N, m_t)
        hp = (i != 0) | (j != 0)

        D_ij = D[i, j]
        Li, Lj = _limbs(sD, N, i, j, D_ij, neg_limbs)
        D, sD, N, valid_k, newD = _update_d_exact(
            D, sD, N, i, j, Li, Lj, hp, idx, m_t, dtype)
        D, sD, N, g, last = _move_last(D, sD, N, i, m_t, hp, idx)

        I = I.at[t].set(jnp.where(hp, i, 0))
        J = J.at[t].set(jnp.where(hp, j, 0))
        LI = LI.at[t].set(jnp.where(hp, Li, -1.0))
        LJ = LJ.at[t].set(jnp.where(hp, Lj, -1.0))
        return D, sD, N, I, J, LI, LJ

    return one_join


@functools.partial(jax.jit, static_argnames=("method",))
def _hclust_init(D, m, method="upgma"):
    """sD/N (initSummaD, nj.c:111-180) + per-row caches: raw-distance
    minima (initDmin, hclust.c:205-277) for upgma/ff/cf, Q minima with
    the initHNJ tie rule (hclust.c:56-130) for hnj; plus the mode-'d'
    seed (the host loop's initial min_q pick).  D is read-only and not
    donated (donated pass-through buffers get defensive copies — see
    jax_engine._dnj_init)."""
    n = D.shape[0]
    dtype = D.dtype
    big, idx = _common(n, dtype)
    active0 = idx < m
    CH = next(c for c in (512, 256, 128) if n % c == 0)
    nch = n // CH

    def _sdn_chunk(_, c):
        rows = c * CH + jnp.arange(CH)
        Drows = jax.lax.dynamic_slice(D, (c * CH, 0), (CH, n))
        v = (active0[rows][:, None] & active0[None, :] & (Drows >= 0)
             & (rows[:, None] != idx[None, :]))
        return None, (jnp.where(v, Drows, 0).sum(axis=1, dtype=dtype),
                      1 + v.sum(axis=1, dtype=jnp.int32))

    _, (sD, N) = jax.lax.scan(_sdn_chunk, None, jnp.arange(nch))
    sD = sD.reshape(n)
    N = N.reshape(n)

    def _qp_chunk(_, c):
        rows = c * CH + jnp.arange(CH)
        Drows = jax.lax.dynamic_slice(D, (c * CH, 0), (CH, n))
        lv = (active0[rows][:, None] & active0[None, :] & (Drows >= 0)
              & (idx[None, :] < rows[:, None]))
        if method == "hnj":
            coef = ((N[rows][:, None] + N[None, :] - 4) >> 1) \
                .astype(dtype)
            Qm = jnp.where(lv, coef * Drows - sD[rows][:, None]
                           - sD[None, :], big)
            Qc = Qm.min(axis=1)
            cand = lv & (Qm == Qc[:, None])
            dmask = jnp.where(cand, Drows, big)
            prefmin = jax.lax.cummin(dmask, axis=1)
            sel = cand & (dmask == prefmin)
            Pc = jnp.where(sel, idx[None, :], -1).max(axis=1) \
                .astype(jnp.int32)
        else:
            dv = jnp.where(lv, Drows, big)
            Qc = dv.min(axis=1)
            Pc = jnp.where(lv & (dv == Qc[:, None]), idx[None, :], -1) \
                .max(axis=1).astype(jnp.int32)
        return None, (Qc, jnp.maximum(Pc, 0))

    _, (Q, P) = jax.lax.scan(_qp_chunk, None, jnp.arange(nch))
    Q = jnp.where(active0, Q.reshape(n), big)
    P = P.reshape(n)

    qrows = jnp.where((idx >= 1) & active0, Q, big)
    mn0 = qrows.min()
    seed0 = jnp.where(active0.sum() > 1,
                      jnp.where(qrows == mn0, idx, -1).max(), 0) \
        .astype(jnp.int32)
    return sD, N, Q, P, seed0


@functools.partial(jax.jit, static_argnames=("neg_limbs", "method"),
                   donate_argnums=tuple(range(10)))
def _h_segment(D, sD, N, Q, P, seed, I, J, LI, LJ, t0, t1, m,
               neg_limbs=False, method="upgma"):
    one_join = _mk_one_join_h(D.shape[0], D.dtype, m, neg_limbs, method)
    return jax.lax.fori_loop(t0, t1, one_join,
                             (D, sD, N, Q, P, seed, I, J, LI, LJ))


@functools.partial(jax.jit, static_argnames=("neg_limbs", "method"),
                   donate_argnums=tuple(range(7)))
def _e_segment(D, sD, N, I, J, LI, LJ, t0, t1, m,
               neg_limbs=False, method="nj"):
    one_join = _mk_one_join_e(D.shape[0], D.dtype, m, neg_limbs, method)
    return jax.lax.fori_loop(t0, t1, one_join, (D, sD, N, I, J, LI, LJ))


@jax.jit
def _init_sdn_only(D, m):
    """'e'-mode init: sD/N only (D read-only, not donated)."""
    sD, N, _, _, _ = _hclust_init(D, m, method="upgma")
    return sD, N


def hclust_joins(D, m, method="upgma", neg_limbs=False):
    """Run all m-2 joins of one heuristic-family method on device
    (host-segmented dispatch; see tree/segmenting.py).

    D: (N, N) square distance matrix (missing < 0, diagonal 0), padded;
    m: active count.  method in {upgma, ff, cf, hnj, nj, mn}.  Returns
    (I, J, LI, LJ, d_last, D); records with I == J == 0 mean "no
    joinable pair left".  D is donated.
    """
    n = D.shape[0]
    dtype = D.dtype
    m_host = int(m)
    mj = jnp.int32(m_host)
    I = jnp.zeros(n, jnp.int32)
    J = jnp.zeros(n, jnp.int32)
    LI = jnp.zeros(n, dtype)
    LJ = jnp.zeros(n, dtype)

    if method in ("nj", "mn"):
        sD, N = _init_sdn_only(D, mj)
        state = (D, sD, N, I, J, LI, LJ)

        def seg_call(state, t0, t1):
            return _e_segment(*state, jnp.int32(t0), jnp.int32(t1), mj,
                              neg_limbs=neg_limbs, method=method)

        state = run_segmented(seg_call, state, max(m_host - 2, 0))
        D, sD, N, I, J, LI, LJ = state
    else:
        sD, N, Q, P, seed = _hclust_init(D, mj, method=method)
        state = (D, sD, N, Q, P, seed, I, J, LI, LJ)

        def seg_call(state, t0, t1):
            return _h_segment(*state, jnp.int32(t0), jnp.int32(t1), mj,
                              neg_limbs=neg_limbs, method=method)

        state = run_segmented(seg_call, state, max(m_host - 2, 0))
        D, sD, N, Q, P, seed, I, J, LI, LJ = state
    return I, J, LI, LJ, D[1, 0], D


def build_tree_hclust(flat64: np.ndarray, n: int, names: list,
                      method: str = "upgma", flag: int = 0,
                      precision: int = 9, dtype=jnp.float32) -> bytes:
    """Device join loop for the heuristic/UPGMA family; Newick bytes
    (no ';').  Missing cells supported."""
    npad = _pad(n)
    Dm = np.full((npad, npad), -1.0, np.float64)
    iu = np.tril_indices(n, -1)
    Dm[(iu[0], iu[1])] = flat64
    Dm[(iu[1], iu[0])] = flat64
    np.fill_diagonal(Dm[:n, :n], 0.0)
    I, J, LI, LJ, d_last, _ = hclust_joins(
        jnp.asarray(Dm, dtype), jnp.int32(n), method=method,
        neg_limbs=bool(flag & 2))
    return _records_to_newick(I, J, LI, LJ, d_last, n, names, flag,
                              precision)
