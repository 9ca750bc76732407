"""Device-resident Dynamic Neighbor-Joining engine (JAX).

Cycle-accurate DNJ (reference dnj.c:985-1052) on device:

- state: square distance matrix D (missing < 0), row sums sD, pair
  counts N, and the reference's asymmetric row caches — Q[i]/P[i] cover
  partners j < i only, exactly like the lower-triangular C engine
  (dnj.c:43-128).
- the join loop runs as **host-dispatched device segments** (see
  tree/segmenting.py): each segment is one `lax.fori_loop` over a slice
  of the joins, all state stays on device and is donated between
  segments, so the math is bit-identical to a single monolithic loop.
- pair selection replicates minQpair's seeded descending scan with
  strict-< tightening (a nested ``lax.while_loop`` revalidates only the
  rows the C would); updateDNJ / DNJ_popArrange cache repair, including
  their mi/mj candidate returns and the qPos seed chaining
  (dnj.c:1009-1034), are masked O(n) vector ops with the reference's
  last-wins tie rules.
- the host receives all (i, j, Li, Lj) join records in one transfer and
  assembles the Newick string.

With float64 state this reproduces the exact engine's join trajectory
(and therefore the reference's Newick bytes) whenever summation-order
ulp differences don't flip a strict comparison; ties — including the
guaranteed three-way tie at the final join — resolve identically by
construction.  float32 halves the state of float64 for large runs.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..io.qseqs import Name
from ..ops.select import topk_mask_indices
from .newick_build import form_node, form_last_node, form_last_bi_node, \
    byteshift_fix
from .segmenting import run_segmented

BIG = np.finfo(np.float64).max  # stands in for the reference's DBL_MAX


def _pad(n: int, mult: int = 128) -> int:
    return max(-(-n // mult) * mult, mult)


def _common(n, dtype):
    big = jnp.asarray(np.finfo(np.dtype(dtype)).max, dtype)
    idx = jnp.arange(n)
    return big, idx


def _last_min(q, idx):
    """value + LAST index of the minimum (the `<=` scan rule)."""
    mn = q.min()
    return mn, jnp.where(q == mn, idx, -1).max().astype(jnp.int32)


@jax.jit
def _dnj_init(D, m):
    """initSummaD + initHNJ + initial minQ seed (nj.c:111-180,
    hclust.c:56-130,353-381).  D is READ-ONLY here and deliberately not
    donated: XLA materializes defensive copies of donated pass-through
    buffers (a whole-matrix temp), which runs out of device memory at
    exactly the sizes the engine exists for."""
    n = D.shape[0]
    dtype = D.dtype
    big, idx = _common(n, dtype)
    active0 = idx < m
    # computed in row chunks — full (n, n) intermediates (Qm, cummin
    # masks) would triple peak HBM and OOM large runs
    CH = next(c for c in (512, 256, 128) if n % c == 0)
    nch = n // CH

    def _sdn_chunk(_, c):
        rows = c * CH + jnp.arange(CH)
        Drows = jax.lax.dynamic_slice(D, (c * CH, 0), (CH, n))
        v = (active0[rows][:, None] & active0[None, :] & (Drows >= 0)
             & (rows[:, None] != idx[None, :]))
        # sequential accumulation order (initSummaD, nj.c:111-180):
        # float ties downstream depend on these exact ulps
        return None, (jnp.cumsum(jnp.where(v, Drows, 0), axis=1,
                                 dtype=dtype)[:, -1],
                      1 + v.sum(axis=1, dtype=jnp.int32))

    _, (sD, N) = jax.lax.scan(_sdn_chunk, None, jnp.arange(nch))
    sD = sD.reshape(n)
    N = N.reshape(n)

    def _qp_chunk(_, c):
        rows = c * CH + jnp.arange(CH)
        Drows = jax.lax.dynamic_slice(D, (c * CH, 0), (CH, n))
        lv = (active0[rows][:, None] & active0[None, :] & (Drows >= 0)
              & (idx[None, :] < rows[:, None]))
        coef = ((N[rows][:, None] + N[None, :] - 4) >> 1).astype(dtype)
        Qm = jnp.where(lv, coef * Drows - sD[rows][:, None]
                       - sD[None, :], big)
        Qc = Qm.min(axis=1)
        # initHNJ tie rule (hclust.c:110-116): among equal-Q candidates
        # ascending, accept while the raw distance is a running minimum
        cand = lv & (Qm == Qc[:, None])
        dmask = jnp.where(cand, Drows, big)
        prefmin = jax.lax.cummin(dmask, axis=1)
        sel = cand & (dmask == prefmin)
        Pc = jnp.where(sel, idx[None, :], -1).max(axis=1) \
            .astype(jnp.int32)
        return None, (Qc, jnp.maximum(Pc, 0))

    _, (Q, P) = jax.lax.scan(_qp_chunk, None, jnp.arange(nch))
    Q = Q.reshape(n)
    P = P.reshape(n)
    Q = jnp.where(active0, Q, big)

    qrows = jnp.where((idx >= 1) & active0, Q, big)
    mn0 = qrows.min()
    seed0 = jnp.where(
        active0.sum() > 1,
        jnp.where(qrows == mn0, idx, -1).max(), 0).astype(jnp.int32)
    return sD, N, Q, P, seed0


def _ltd_row_of(k, j, idx_dtype=jnp.int32):
    """Row r of the ltd flat cell f = off(j) + k (k > j): the largest r
    with r(r-1)/2 <= f.  Overflow-safe for any padded n: the float32
    sqrt estimate is fixed up with the division-form predicate
    (r-j) <= 2k // (r+j-1), which never forms the O(n^2) product."""
    f_f = (j.astype(jnp.float32) * (j - 1).astype(jnp.float32) / 2
           + k.astype(jnp.float32))
    r0 = jnp.floor((1.0 + jnp.sqrt(8.0 * f_f + 1.0)) / 2.0) \
        .astype(idx_dtype)
    two_k = 2 * k
    best = j + 1  # off(j+1) <= off(j)+k always (k > j)
    for d in range(5):
        cand = jnp.maximum(j + 1, r0 - 2 + d)
        ok = (cand - j) <= two_k // jnp.maximum(cand + j - 1, 1)
        best = jnp.where(ok, jnp.maximum(best, cand), best)
    return best


def _update_d_exact(D, sD, N, i, j, Li, Lj, hp, idx, m_t, dtype):
    """updateD (nj.c:836-1044) with the reference's exact bookkeeping:

    * the sD/N walker pointers do NOT advance past both-missing cells,
      so their update targets are walker slots (shifted down), not k
      (see tree/exact.py update_d and the nj.c loop's missing else);
    * the column-part one-sided D_kj branch reads the out-of-row ltd
      cell D->mat[j][k] (nj.c:1022) — "garbage" that may alias a cell
      stored earlier in the same sweep; its sD[j] contribution is
      (stored - garbage), not the stored value.

    Returns (D, sD, N, valid_k, newD) where newD is the updated row j.
    """
    n = D.shape[0]
    D_ij = D[i, j]
    D_ik = D[i]
    D_kj = D[j]
    active = idx < m_t
    valid_k = active & (idx != i) & (idx != j) & hp
    vi = D_ik >= 0
    vj = D_kj >= 0
    both = valid_k & vi & vj
    only_i = valid_k & vi & ~vj
    only_j = valid_k & ~vi & vj
    d2 = jnp.maximum((D_ik + D_kj - D_ij) / 2, 0.0)
    stored = jnp.where(both, d2,
                       jnp.where(only_i, D_ik - Li,
                                 jnp.where(only_j, D_kj - Lj, D_kj)))

    krow = idx < j
    kcol = idx > j
    adv = both | only_i | only_j
    adv_r = adv & krow
    adv_c = adv & kcol

    # --- walker targets: row slots 0.. (skipping both-missing), then
    # the skip-j advance, the skip-i advance, column slots
    wpos = jnp.cumsum(adv_r.astype(jnp.int32)) - 1
    base = adv_r.sum(dtype=jnp.int32)
    prevc = jnp.cumsum(adv_c.astype(jnp.int32)) - adv_c
    tgt = jnp.where(adv_r, wpos,
                    base + 1 + (idx > i).astype(jnp.int32) + prevc)
    tgt = jnp.where(adv_r | adv_c, tgt, n)  # drop elsewhere

    # --- out-of-row garbage read for column only_j (nj.c:1020-1037)
    kk = jnp.maximum(idx, j + 1)
    r = _ltd_row_of(kk, j)
    c = kk - (r - j) * (r + j - 1) // 2
    in_colj = c == j
    seen = (r < idx) & (r != i)  # stored earlier in this column sweep
    adv_at_r = adv_c[r] & seen
    garb_cj = jnp.where(r == idx, stored,
                        jnp.where(adv_at_r, stored[r], D[r, j]))
    garb = jnp.where(in_colj, garb_cj, D[r, c])
    contrib = jnp.where(only_j & kcol, stored - garb, stored)

    # --- scatter the walker updates
    sd_delta = jnp.where(both, -(D_ik + D_kj - d2),
                         jnp.where(only_i, -Li,
                                   jnp.where(only_j & krow, -Lj,
                                             contrib)))
    sD = sD.at[tgt].add(jnp.where(adv, sd_delta, 0.0), mode="drop")
    N = N.at[tgt].add(jnp.where(both | only_j, -1, 0), mode="drop")

    # --- row/col j rebuild (C accumulation order = ascending k, kept
    # sequential via cumsum so float ulps match the host engine)
    sD = sD.at[j].set(jnp.where(
        hp, jnp.cumsum(jnp.where(adv, contrib, 0), dtype=dtype)[-1],
        sD[j]))
    N = N.at[j].set(jnp.where(hp, 1 + adv.sum(dtype=jnp.int32), N[j]))
    # both-missing valid cells fall through stored's innermost else to
    # D_kj — unchanged, exactly the C's no-store
    newD = jnp.where(valid_k, stored, -1.0)
    D = D.at[j, :].set(jnp.where(valid_k, newD, D[j]))
    D = D.at[:, j].set(jnp.where(valid_k, newD, D[:, j]))
    return D, sD, N, valid_k, newD


def _mk_one_join(n, dtype, m, neg_limbs, scan):
    """Build the traced one_join body for dnj segments; m is a traced
    scalar closed over."""
    big, idx = _common(n, dtype)

    def row_q(D, sD, N, i):
        """Q over row i's smaller partners; +BIG where invalid."""
        drow = D[i]
        c = ((N[i] + N - 4) >> 1).astype(dtype)
        q = c * drow - sD[i] - sD
        ok = (idx < i) & (drow >= 0)
        return jnp.where(ok, q, big)

    KBATCH = 128  # rows revalidated per fused block in scan="batch"

    def seq_scan(D, sD, N, Q, P, minv0, pi0, pj0, m_t):
        """minQpair's descending one-row-at-a-time revalidation."""
        def scond(c):
            return c[0] >= 1

        def sbody(c):
            cur, minv, pi, pj, Q, P = c
            candm = (idx >= 1) & (idx <= cur) & (idx < m_t) & (Q < minv)
            i = jnp.where(candm, idx, -1).max().astype(jnp.int32)

            def recompute(args):
                i, minv, pi, pj, Q, P = args
                q = row_q(D, sD, N, i)
                newq, newp = _last_min(q, idx)
                Q = Q.at[i].set(newq)
                P = P.at[i].set(newp)
                better = newq < minv
                return (jnp.where(better, newq, minv),
                        jnp.where(better, i, pi),
                        jnp.where(better, newp, pj), Q, P)

            minv, pi, pj, Q, P = jax.lax.cond(
                i >= 1, recompute,
                lambda a: (a[1], a[2], a[3], a[4], a[5]),
                (i, minv, pi, pj, Q, P))
            return i - 1, minv, pi, pj, Q, P

        cur0 = m_t - 1
        _, minv, pi, pj, Q, P = jax.lax.while_loop(
            scond, sbody, (cur0, minv0, pi0, pj0, Q, P))
        return minv, pi, pj, Q, P

    def batch_scan(D, sD, N, Q, P, minv0, pi0, pj0, m_t):
        """Fused candidate-row revalidation: all rows whose cached bound
        beats the running min are recomputed KBATCH at a time as one
        (K, n) vector op; the set shrinks every pass (fresh rows can't
        re-qualify: the running min absorbs their new row minima)."""
        def cand_mask(Q, minv):
            return (idx >= 1) & (idx < m_t) & (Q < minv)

        def bcond(c):
            minv, pi, pj, Q, P = c
            return cand_mask(Q, minv).any()

        def bbody(c):
            minv, pi, pj, Q, P = c
            cm = cand_mask(Q, minv)
            rows = topk_mask_indices(cm, idx, KBATCH)  # descending
            valid = rows >= 1
            r = jnp.where(valid, rows, 0)
            Drows = D[r]                                    # (K, n)
            c_ = ((N[r][:, None] + N[None, :] - 4) >> 1).astype(dtype)
            q = c_ * Drows - sD[r][:, None] - sD[None, :]
            ok = (idx[None, :] < r[:, None]) & (Drows >= 0)
            q = jnp.where(ok, q, big)
            rmin = q.min(axis=1)
            rarg = jnp.where(q == rmin[:, None], idx[None, :], -1) \
                .max(axis=1).astype(jnp.int32)
            # C-exact cache gating: minQpair's descending sweep
            # (dnj.c:43-128) recomputes row i iff its cached Q beats
            # the running min rm at the visit.  Because a fresh row
            # minimum can never be below its cached lower bound,
            # min(rm, newQ[i]) is a no-op exactly when the C skips
            # row i — so rm threads through skipped rows as a plain
            # shifted prefix-min of (minv, fresh minima of larger
            # rows), and the C's revalidated set is recovered in one
            # fused pass.  Rows outside it keep their stale caches.
            rminv = jnp.where(valid, rmin, big)
            rm = jax.lax.cummin(
                jnp.concatenate([minv[None], rminv[:-1]]))
            reval = valid & (Q[r] < rm)
            tgt = jnp.where(reval, rows, n)
            Q = Q.at[tgt].set(jnp.where(reval, rmin, big),
                              mode="drop")
            P = P.at[tgt].set(jnp.where(reval, rarg, 0), mode="drop")
            # pair update: strict improvement, largest row wins a tie
            # (the C scan visits rows descending and requires newq <
            # running min, so the largest row locks an equal min first)
            bvals = jnp.where(valid, rmin, big)
            bmin = bvals.min()
            bi = jnp.where(bvals == bmin, rows, -1).max().astype(jnp.int32)
            better = bmin < minv
            karg = jnp.where((bvals == bmin) & (rows == bi), rarg, 0) \
                .max().astype(jnp.int32)
            minv = jnp.where(better, bmin, minv)
            pi = jnp.where(better, bi, pi)
            pj = jnp.where(better, karg, pj)
            return minv, pi, pj, Q, P

        return jax.lax.while_loop(
            bcond, bbody, (minv0, pi0, pj0, Q, P))

    scan_fn = seq_scan if scan == "seq" else batch_scan

    def one_join(t, carry):
        D, sD, N, Q, P, seed, I, J, LI, LJ = carry
        m_t = m - t

        # ---- minQpair(seed) (dnj.c:43-128)
        seed_ok = (seed != 0) & (Q[seed] != big)
        minv0 = jnp.where(seed_ok, Q[seed], big)
        pi0 = jnp.where(seed_ok, seed, 0)
        pj0 = jnp.where(seed_ok, P[seed], 0)

        minv, pi, pj, Q, P = scan_fn(D, sD, N, Q, P, minv0, pi0, pj0,
                                     m_t)
        have_pair = (pi != 0) | (pj != 0)
        i = pi
        j = pj

        # The join application runs unconditionally with masked no-op
        # semantics when no pair was found (have_pair False -> i = j =
        # 0, every write gated to identity).  A lax.cond here would
        # force XLA to materialize both branch results of the full
        # (n, n) matrix — one O(n²) copy per join.
        hp = have_pair
        # ---- limbs (nj.c:42-79)
        D_ij = D[i, j]
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
            Li_c = jnp.where(Li < 0, 0.0,
                             jnp.where(Lj < 0, D_ij, Li))
            Lj_c = jnp.where(Li < 0, D_ij,
                             jnp.where(Lj < 0, 0.0, Lj))
            Li, Lj = Li_c, Lj_c

        # ---- updateD (nj.c:836-1044), exact walker/garbage semantics
        D, sD, N, valid_k, newD = _update_d_exact(
            D, sD, N, i, j, Li, Lj, hp, idx, m_t, dtype)

        # ---- updateDNJ cache repair + mi candidate (dnj.c:607-710)
        qj = row_q(D, sD, N, j)
        Qj, Pj = _last_min(qj, idx)
        Q = Q.at[j].set(jnp.where(hp, Qj, Q[j]))
        P = P.at[j].set(jnp.where(
            hp, jnp.where(Qj == big, 0, Pj), P[j]))
        coefj = ((N[j] + N - 4) >> 1).astype(dtype)
        qcol = coefj * D[:, j] - sD[j] - sD
        colk = valid_k & (idx > j) & (D[:, j] >= 0)
        upd = colk & (qcol <= Q)
        Q = jnp.where(upd, qcol, Q)
        P = jnp.where(upd, j, P)
        mq = jnp.where(upd, qcol, big).min()
        anyupd = upd.any()
        mi_cand = jnp.where(
            anyupd & (mq <= Qj),
            jnp.where(upd & (qcol == mq), idx, -1).max(), j
        ).astype(jnp.int32)

        # ---- DNJ_popArrange (dnj.c:817-975): move last into slot i
        # (gated no-op when i == last or no pair)
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
        # row pass: Q[i] over partners < i from moved values
        qi = row_q(D, sD, N, i)
        Qi, Pi = _last_min(qi, idx)
        Q = Q.at[i].set(jnp.where(g, Qi, Q[i]))
        P = P.at[i].set(jnp.where(
            g, jnp.where(Qi == big, 0, Pi), P[i]))
        # column pass: rows i < k < last see cell (k, i)
        coefi = ((N[i] + N - 4) >> 1).astype(dtype)
        qc = coefi * D[:, i] - sD[i] - sD
        ck = (idx > i) & (idx < last) & (D[:, i] >= 0) & g
        u2 = ck & (qc <= Q)
        Q = jnp.where(u2, qc, Q)
        P = jnp.where(u2, i, P)
        mq2 = jnp.where(u2, qc, big).min()
        p2 = jnp.where(
            u2.any() & (mq2 <= Qi),
            jnp.where(u2 & (qc == mq2), idx, -1).max(), i
        ).astype(jnp.int32)
        mj_cand = jnp.where(g, p2, 0)
        Q = Q.at[last].set(big)

        # ---- seed chaining (dnj.c:1026-1032)
        seed_new = jnp.where(
            mj_cand == m_new, mi_cand,
            jnp.where(
                mi_cand == m_new, mj_cand,
                jnp.where((Q[mj_cand] < Q[mi_cand])
                          | ((mi_cand < mj_cand)
                             & (Q[mj_cand] == Q[mi_cand])),
                          mj_cand, mi_cand)))
        seed = jnp.where(hp, seed_new, 0)

        I = I.at[t].set(jnp.where(have_pair, i, 0))
        J = J.at[t].set(jnp.where(have_pair, j, 0))
        LI = LI.at[t].set(jnp.where(hp, Li, -1.0))
        LJ = LJ.at[t].set(jnp.where(hp, Lj, -1.0))
        return D, sD, N, Q, P, seed, I, J, LI, LJ

    return one_join


@functools.partial(jax.jit, static_argnames=("neg_limbs", "scan"),
                   donate_argnums=tuple(range(10)))
def _dnj_segment(D, sD, N, Q, P, seed, I, J, LI, LJ, t0, t1, m,
                 neg_limbs=False, scan="seq"):
    """Joins [t0, t1) of the DNJ loop; all state donated so segments
    alias in place.  t0/t1/m are traced scalars — one compile serves
    every segment size."""
    one_join = _mk_one_join(D.shape[0], D.dtype, m, neg_limbs, scan)
    return jax.lax.fori_loop(t0, t1, one_join,
                             (D, sD, N, Q, P, seed, I, J, LI, LJ))


def dnj_joins(D, m, neg_limbs=False, scan="seq"):
    """Run all m-2 DNJ joins on device (host-segmented dispatch).

    D: (N, N) square distance matrix (missing < 0, diagonal 0), padded;
    m: active count.  Returns (I, J, LI, LJ, d_last, D); records with
    I == J == 0 mean "no joinable pair left" (missing-data early stop,
    dnj.c:1009).  D is donated.

    scan="seq" replicates minQpair's sequential descending row
    revalidation cycle-for-cycle.  scan="batch" recomputes candidate
    rows (cached Q < running min) in fused (K, n) blocks — the
    data-parallel formulation — and is ALSO trajectory-exact, ties
    included: a shifted prefix-min recovers the C's running min at
    every row visit, so exactly the rows minQpair would recompute get
    fresh caches (see the gating comment in batch_scan), and batches
    are taken in the C's descending row order.
    """
    n = D.shape[0]
    dtype = D.dtype
    m_host = int(m)
    mj = jnp.int32(m_host)
    sD, N, Q, P, seed = _dnj_init(D, mj)
    I = jnp.zeros(n, jnp.int32)
    J = jnp.zeros(n, jnp.int32)
    LI = jnp.zeros(n, dtype)
    LJ = jnp.zeros(n, dtype)
    state = (D, sD, N, Q, P, seed, I, J, LI, LJ)

    def seg_call(state, t0, t1):
        return _dnj_segment(*state, jnp.int32(t0), jnp.int32(t1), mj,
                            neg_limbs=neg_limbs, scan=scan)

    state = run_segmented(seg_call, state, max(m_host - 2, 0))
    D, sD, N, Q, P, seed, I, J, LI, LJ = state
    d_last = D[1, 0]
    return I, J, LI, LJ, d_last, D


def _mk_one_join_q(n, m, bytescale, store_dtype, compute_dtype,
                   neg_limbs):
    """one_join body for the quantized engine; m/bytescale traced."""
    dtype = jnp.dtype(compute_dtype)
    big, idx = _common(n, dtype)
    bs = jnp.asarray(bytescale, dtype)
    inv = jnp.asarray(1.0, dtype) / bs
    qmax = jnp.asarray(np.iinfo(np.dtype(store_dtype)).max, dtype)

    def deq(q):
        return q.astype(dtype) * inv

    def quant(d, rnd):
        # dtouc(d, rnd) = (uint)(d*ByteScale + rnd) — C float->uint
        # truncation; clamp instead of wrapping (complete matrices
        # with sane ByteScale never reach the cap)
        return jnp.clip(jnp.floor(d * bs + rnd), 0, qmax) \
            .astype(store_dtype)

    def row_qc(Dq, sD, i, coef):
        """Q over row i's partners k < i with an explicit coefficient
        ((N_i + N_k - 4) >> 1 — pre-join: m_t - 2; after updateD's N
        decrement: m_t - 3, matching updateDNJ, dnj.c:607+)."""
        drow = deq(Dq[i])
        q = coef * drow - sD[i] - sD
        return jnp.where(idx < i, q, big)

    KB = 128

    def one_join(t, carry):
        Dq, sD, Q, P, seed, I, J, LI, LJ = carry
        m_t = m - t
        mt = (m_t - 2).astype(dtype)

        seed_ok = (seed != 0) & (Q[seed] != big)
        minv0 = jnp.where(seed_ok, Q[seed], big)
        pi0 = jnp.where(seed_ok, seed, 0)
        pj0 = jnp.where(seed_ok, P[seed], 0)

        def cand_mask(Q, minv):
            return (idx >= 1) & (idx < m_t) & (Q < minv)

        def bcond(c):
            return cand_mask(c[3], c[0]).any()

        def bbody(c):
            minv, pi, pj, Q, P = c
            cm = cand_mask(Q, minv)
            rows = topk_mask_indices(cm, idx, KB)
            valid = rows >= 1
            r = jnp.where(valid, rows, 0)
            Drows = deq(Dq[r])
            q = mt * Drows - sD[r][:, None] - sD[None, :]
            ok = idx[None, :] < r[:, None]
            q = jnp.where(ok, q, big)
            rmin = q.min(axis=1)
            rarg = jnp.where(q == rmin[:, None], idx[None, :], -1) \
                .max(axis=1).astype(jnp.int32)
            # C-exact cache gating (see dnj_joins batch_scan)
            rminv = jnp.where(valid, rmin, big)
            rm = jax.lax.cummin(
                jnp.concatenate([minv[None], rminv[:-1]]))
            reval = valid & (Q[r] < rm)
            tgt = jnp.where(reval, rows, n)
            Q = Q.at[tgt].set(jnp.where(reval, rmin, big), mode="drop")
            P = P.at[tgt].set(jnp.where(reval, rarg, 0), mode="drop")
            bvals = jnp.where(valid, rmin, big)
            bmin = bvals.min()
            bi = jnp.where(bvals == bmin, rows, -1).max() \
                .astype(jnp.int32)
            karg = jnp.where((bvals == bmin) & (rows == bi), rarg, 0) \
                .max().astype(jnp.int32)
            better = bmin < minv
            return (jnp.where(better, bmin, minv),
                    jnp.where(better, bi, pi),
                    jnp.where(better, karg, pj), Q, P)

        minv, pi, pj, Q, P = jax.lax.while_loop(
            bcond, bbody, (minv0, pi0, pj0, Q, P))
        hp = (pi != 0) | (pj != 0)
        i, j = pi, pj

        D_ij = deq(Dq[i, j])
        Ni = (m_t - 2).astype(dtype)  # complete: N_k = m_t
        delta = jnp.where(Ni > 0, (sD[i] - D_ij) / jnp.maximum(Ni, 1)
                          - (sD[j] - D_ij) / jnp.maximum(Ni, 1), 0.0)
        Li = jnp.where(Ni > 0, (D_ij + delta) / 2, D_ij / 2)
        Lj = jnp.where(Ni > 0, (D_ij - delta) / 2, D_ij / 2)
        if not neg_limbs:
            Li_c = jnp.where(Li < 0, 0.0, jnp.where(Lj < 0, D_ij, Li))
            Lj_c = jnp.where(Li < 0, D_ij, jnp.where(Lj < 0, 0.0, Lj))
            Li, Lj = Li_c, Lj_c

        # updateD, complete-matrix both-path only (nj.c:893-948)
        active = idx < m_t
        rowi = deq(Dq[i])
        rowj = deq(Dq[j])
        valid_k = active & (idx != i) & (idx != j) & hp
        d_new = jnp.maximum((rowi + rowj - D_ij) / 2, 0.0)
        sD = jnp.where(valid_k, sD - (rowi + rowj - d_new), sD)
        sD = sD.at[j].set(jnp.where(
            hp, jnp.cumsum(jnp.where(valid_k, d_new, 0),
                           dtype=dtype)[-1], sD[j]))
        q_new = quant(d_new, 0.25)
        Dq = Dq.at[j, :].set(jnp.where(valid_k, q_new, Dq[j]))
        Dq = Dq.at[:, j].set(jnp.where(valid_k, q_new, Dq[:, j]))

        # cache repair for column j + fresh row j (reads see quantized;
        # the repair coefficient uses the post-updateD N = m_t - 1, so
        # (N_j + N_k - 4) >> 1 = m_t - 3)
        mt_post = (m_t - 3).astype(dtype)
        qj = row_qc(Dq, sD, j, mt_post)
        Qj, Pj = _last_min(qj, idx)
        Q = Q.at[j].set(jnp.where(hp, Qj, Q[j]))
        P = P.at[j].set(jnp.where(hp, jnp.where(Qj == big, 0, Pj),
                                  P[j]))
        colj = deq(Dq[:, j])
        qcol = mt_post * colj - sD[j] - sD
        colk = valid_k & (idx > j)
        upd = colk & (qcol <= Q)
        Q = jnp.where(upd, qcol, Q)
        P = jnp.where(upd, j, P)
        mq = jnp.where(upd, qcol, big).min()
        mi_cand = jnp.where(upd.any() & (mq <= Qj),
                            jnp.where(upd & (qcol == mq), idx, -1).max(),
                            j).astype(jnp.int32)

        # popArrange: move last into slot i
        m_new = m_t - 1
        last = m_new
        g = hp & (i != last)
        moveq = Dq[last]
        newrow_i = jnp.where(idx == i, jnp.asarray(0, store_dtype),
                             moveq)
        Dq = Dq.at[i, :].set(jnp.where(g, newrow_i, Dq[i]))
        Dq = Dq.at[:, i].set(jnp.where(g, newrow_i, Dq[:, i]))
        sD = sD.at[i].set(jnp.where(g, sD[last], sD[i]))
        qi = row_qc(Dq, sD, i, mt_post)
        Qi, Pi = _last_min(qi, idx)
        Q = Q.at[i].set(jnp.where(g, Qi, Q[i]))
        P = P.at[i].set(jnp.where(g, jnp.where(Qi == big, 0, Pi),
                                  P[i]))
        coli = deq(Dq[:, i])
        qc = mt_post * coli - sD[i] - sD
        ck = (idx > i) & (idx < last) & g
        u2 = ck & (qc <= Q)
        Q = jnp.where(u2, qc, Q)
        P = jnp.where(u2, i, P)
        mq2 = jnp.where(u2, qc, big).min()
        p2 = jnp.where(u2.any() & (mq2 <= Qi),
                       jnp.where(u2 & (qc == mq2), idx, -1).max(), i) \
            .astype(jnp.int32)
        mj_cand = jnp.where(g, p2, 0)
        Q = Q.at[last].set(big)

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
        return Dq, sD, Q, P, seed, I, J, LI, LJ

    return one_join


@functools.partial(jax.jit, static_argnames=("compute_dtype",))
def _dnj_init_q(Dq, m, bytescale, compute_dtype=jnp.float32):
    """Quantized-engine init (complete matrix: N_k = m every row).
    Dq is read-only and not donated (see _dnj_init)."""
    n = Dq.shape[0]
    dtype = jnp.dtype(compute_dtype)
    big, idx = _common(n, dtype)
    bs = jnp.asarray(bytescale, dtype)
    inv = jnp.asarray(1.0, dtype) / bs
    active0 = idx < m
    CH = next(c for c in (512, 256, 128) if n % c == 0)
    nch = n // CH
    mt0 = (m - 2).astype(dtype)

    def deq(q):
        return q.astype(dtype) * inv

    def _sd_chunk(_, c):
        Drows = deq(jax.lax.dynamic_slice(Dq, (c * CH, 0), (CH, n)))
        v = active0[None, :] & (c * CH + jnp.arange(CH)[:, None]
                                != idx[None, :])
        # sequential accumulation order (initSummaD, nj.c:111-180)
        return None, jnp.cumsum(jnp.where(v, Drows, 0),
                                axis=1, dtype=dtype)[:, -1]

    _, sD = jax.lax.scan(_sd_chunk, None, jnp.arange(nch))
    sD = sD.reshape(n)

    def _qp_chunk(_, c):
        rows = c * CH + jnp.arange(CH)
        Drows = deq(jax.lax.dynamic_slice(Dq, (c * CH, 0), (CH, n)))
        lv = (active0[rows][:, None] & active0[None, :]
              & (idx[None, :] < rows[:, None]))
        Qm = jnp.where(lv, mt0 * Drows - sD[rows][:, None]
                       - sD[None, :], big)
        Qc = Qm.min(axis=1)
        cand = lv & (Qm == Qc[:, None])
        dmask = jnp.where(cand, Drows, big)
        prefmin = jax.lax.cummin(dmask, axis=1)
        sel = cand & (dmask == prefmin)
        Pc = jnp.where(sel, idx[None, :], -1).max(axis=1) \
            .astype(jnp.int32)
        return None, (Qc, jnp.maximum(Pc, 0))

    _, (Q, P) = jax.lax.scan(_qp_chunk, None, jnp.arange(nch))
    Q = jnp.where(active0, Q.reshape(n), big)
    P = P.reshape(n)

    qrows = jnp.where((idx >= 1) & active0, Q, big)
    mn0 = qrows.min()
    seed0 = jnp.where(active0.sum() > 1,
                      jnp.where(qrows == mn0, idx, -1).max(), 0) \
        .astype(jnp.int32)
    return sD, Q, P, seed0


@functools.partial(jax.jit,
                   static_argnames=("neg_limbs", "store_dtype",
                                    "compute_dtype"),
                   donate_argnums=tuple(range(9)))
def _dnj_segment_q(Dq, sD, Q, P, seed, I, J, LI, LJ, t0, t1, m,
                   bytescale, neg_limbs=False, store_dtype=jnp.uint16,
                   compute_dtype=jnp.float32):
    one_join = _mk_one_join_q(Dq.shape[0], m, bytescale, store_dtype,
                              compute_dtype, neg_limbs)
    return jax.lax.fori_loop(t0, t1, one_join,
                             (Dq, sD, Q, P, seed, I, J, LI, LJ))


def dnj_joins_q(Dq, m, bytescale, neg_limbs=False,
                store_dtype=jnp.uint16, compute_dtype=jnp.float32):
    """Quantized-storage DNJ: D lives on device as uint16/uint8 with
    the reference's ByteScale quantization (bytescale.h:22-23), compute
    in float32 — halves/quarters device memory per cell vs float32
    state.  Host-segmented like
    dnj_joins.

    Matrix must be complete (the reference's quantized modes cannot
    represent missing cells either: dtouc of a negative wraps,
    matrix.h:23-33 storage + bytescale.h macros).  Updates quantize
    exactly like the C: the both-sides updateD path stores
    trunc(d*scale + 0.25) (nj.c:905); sD bookkeeping uses the
    *unquantized* update values (nj.c:907-911), later reads see the
    quantized cells.  Scan semantics = scan="batch" of dnj_joins.
    """
    n = Dq.shape[0]
    dtype = jnp.dtype(compute_dtype)
    m_host = int(m)
    mj = jnp.int32(m_host)
    bsj = jnp.asarray(bytescale, dtype)
    sD, Q, P, seed = _dnj_init_q(Dq, mj, bsj,
                                 compute_dtype=compute_dtype)
    I = jnp.zeros(n, jnp.int32)
    J = jnp.zeros(n, jnp.int32)
    LI = jnp.zeros(n, dtype)
    LJ = jnp.zeros(n, dtype)
    state = (Dq, sD, Q, P, seed, I, J, LI, LJ)

    def seg_call(state, t0, t1):
        return _dnj_segment_q(*state, jnp.int32(t0), jnp.int32(t1), mj,
                              bsj, neg_limbs=neg_limbs,
                              store_dtype=store_dtype,
                              compute_dtype=compute_dtype)

    state = run_segmented(seg_call, state, max(m_host - 2, 0))
    Dq, sD, Q, P, seed, I, J, LI, LJ = state
    inv = jnp.asarray(1.0, dtype) / bsj
    return I, J, LI, LJ, Dq[1, 0].astype(dtype) * inv, Dq


def _records_to_newick(I, J, LI, LJ, d_last, n, names, flag, precision):
    """Shared host-side Newick assembly from device join records."""
    I = np.asarray(I)
    J = np.asarray(J)
    LI = np.asarray(LI, np.float64)
    LJ = np.asarray(LJ, np.float64)
    m = n
    for t in range(max(n - 2, 0)):
        i, j = int(I[t]), int(J[t])
        if i == 0 and j == 0:
            break  # no joinable pair left (missing data)
        form_node(names[j], names[i], float(LJ[t]), float(LI[t]),
                  precision)
        m -= 1
        names[i], names[m] = names[m], names[i]
    last = form_last_bi_node if (flag & 1) else form_last_node
    if m == 2:
        last(names[0], names[1], float(np.asarray(d_last)), precision)
    else:
        while m > 1:
            m -= 1
            last(names[0], names[m], -1.0, precision)
    byteshift_fix(names[0])
    return names[0].data


def build_tree_jax_q(flat64: np.ndarray, n: int, names: list[Name],
                     flag: int = 0, precision: int = 9,
                     bytescale: float = 1.0,
                     store_dtype=jnp.uint16,
                     compute_dtype=jnp.float32) -> bytes:
    """Device DNJ with quantized (u16/u8 ByteScale) matrix storage.

    Loads quantize like loadPhy -s/-b (round 0.5, phy.c:473-475);
    requires a complete matrix (no negative cells)."""
    npad = _pad(n)
    Dq = np.zeros((npad, npad), np.dtype(store_dtype))
    iu = np.tril_indices(n, -1)
    qv = np.floor(np.asarray(flat64, np.float64) * bytescale + 0.5)
    qv = np.clip(qv, 0, np.iinfo(np.dtype(store_dtype)).max) \
        .astype(np.dtype(store_dtype))
    Dq[(iu[0], iu[1])] = qv
    Dq[(iu[1], iu[0])] = qv
    I, J, LI, LJ, d_last, _ = dnj_joins_q(
        jnp.asarray(Dq), jnp.int32(n),
        jnp.asarray(bytescale, compute_dtype),
        neg_limbs=bool(flag & 2), store_dtype=store_dtype,
        compute_dtype=compute_dtype)
    return _records_to_newick(I, J, LI, LJ, d_last, n, names, flag,
                              precision)


def build_tree_jax(flat64: np.ndarray, n: int, names: list[Name],
                   flag: int = 0, precision: int = 9,
                   dtype=jnp.float32, scan: str = "seq") -> bytes:
    """Device DNJ over a loaded ltd matrix; Newick bytes (no ';')."""
    npad = _pad(n)
    D = np.full((npad, npad), -1.0, np.float64)
    iu = np.tril_indices(n, -1)
    D[(iu[0], iu[1])] = flat64
    D[(iu[1], iu[0])] = flat64
    np.fill_diagonal(D[:n, :n], 0.0)
    I, J, LI, LJ, d_last, _ = dnj_joins(jnp.asarray(D, dtype),
                                        jnp.int32(n),
                                        neg_limbs=bool(flag & 2),
                                        scan=scan)
    return _records_to_newick(I, J, LI, LJ, d_last, n, names, flag,
                              precision)
