"""Host-streamed packed DNJ — the beyond-HBM (mmap-analog) engine.

The reference reaches one million taxa on a single node by keeping the
quantized lower-triangular matrix on disk behind mmap and letting the
OS page the hot rows (matrix.c:116-231, bytescale.h:20-23; dnj.c:985-
1162 runs unchanged on top).  The device equivalent built here: the
canonical u8 matrix lives in HOST memory (optionally a numpy memmap on
disk — the literal mmap analog), and the device holds a row CACHE of X
rows, (X, W) uint32 words (4 cells/word), addressed through slot
indirection `slotof[row] -> slot`, `rowof[slot] -> row`.

Resident rows are kept CURRENT IN PLACE: every join writes its two
changed rows in full (write_row), and — by the engine's row/column
symmetry — writes the matching column into every resident slot with
one word-column read-modify-write (col_write, X*4 bytes per column).
The first design iteration instead recorded columns in a patch ring
overlaid on read, with per-slot epochs and a rising floor; that made
every resident row expire every ~F/2 joins, and the periodic
whole-working-set re-upload (~2 GB per F window at n=49k) dominated
the run.  Direct column writes cost X*512 bytes/join of device-memory
traffic and
make residency permanent: a cached row is simply always current, so
scans are pure reads and the only aborts left are genuinely absent
rows.

A segment (tree/segmenting.py) executes joins while every row it needs
— the scan candidate set {r: Q[r] < minv0}, the pair rows (i, j =
P[i]), and the popArrange source row `last` — is fetchable.  The first
join that would touch a non-fetchable row ABORTS the segment before
mutating join state; the device reports the missing rows and the host
(1) replays the completed join records onto the canonical host matrix
(exact-integer replay, bit-identical bytes by construction), (2)
uploads the missing rows plus a bottom-Q prefetch set, evicting the
highest-Q residents, and (3) re-dispatches.  All trajectory arithmetic
is the same int32 u-unit arithmetic as tree/packed_engine.py, so the
join records are bit-identical to the in-HBM engine (and to the C
reference) at any cache size — the cache only decides WHEN a row is
read, never what it contains.

Scaling: device memory holds X*n bytes of cache + O(n) state instead
of the n^2 matrix; host RAM (or disk via --mmap) holds the n^2 bytes.
At n = 212992 that is ~45 GB host-side against ~10 GB on the device
(X = 49152).
"""

from __future__ import annotations

import functools
import os
import time as _time

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.select import topk_mask_indices
from .packed_engine import IBIG, _pack_bytes, _unpack_words

MMAX = 2048  # missing-row report capacity per abort


def _pad512(n: int) -> int:
    """512-multiple, then the packed engine's compile-cache bucket
    (packed_engine._bucket512; CCPHYLO_TPU_BUCKET=0 disables)."""
    from .packed_engine import _bucket512
    return _bucket512(max(-(-n // 512) * 512, 512))


# ---------------------------------------------------------------------
# device programs


def _mk_one_join_streamed(n, W, X, m, kbatch):
    """one_join over the (X, W) slot cache.  Mirrors
    packed_engine._mk_one_join_packed cell for cell; only row access
    goes through slots and column writes go to every resident slot."""
    big = jnp.int32(IBIG)
    idx = jnp.asarray(np.arange(n, dtype=np.int32))

    def st(c, k, v):
        c = dict(c)
        c[k] = v
        return c

    def fetchable(c, r):
        return c["slotof"][r] >= 0

    def fetch_one(c, r):
        """(n,) int32 cells of row r (caller ensures fetchable)."""
        s = jnp.maximum(c["slotof"][r], 0)
        return _unpack_words(c["cache"][s]).astype(jnp.int32)

    def fetch_batch(c, rs, valid):
        """(K, W) u32 words for rows rs — pure reads (residents are
        always current; see module doc).

        Per-row dynamic slices, NOT cache[s]: a flat gather on the
        > 2^31-element cache trips XLA's mini-gather lowering, which
        materializes the table as two half-width COPIES (5.23 GiB
        temp at n=212992) on every scan pass."""
        W_ = c["cache"].shape[1]
        s = jnp.where(valid, c["slotof"][jnp.where(valid, rs, 0)], 0)
        K_ = rs.shape[0]

        def _grow(i, out):
            row = jax.lax.dynamic_slice(
                c["cache"], (s[i], jnp.int32(0)), (1, W_))
            return jax.lax.dynamic_update_slice(
                out, row, (jnp.int32(i), jnp.int32(0)))

        return jax.lax.fori_loop(
            0, K_, _grow,
            jnp.zeros((K_, W_), jnp.uint32))                # (K, W) u32

    def col_write(c, col, vals_bytes, on):
        """Write column `col` = `vals_bytes` (n u32 byte values) into
        every resident slot.  The RMW covers the aligned 128-word tile
        stripe containing the column ((X, 128), X*512 bytes ~ 25 MB at
        n=212992): a (X, 1) single-word-column slice makes XLA's
        layout assignment materialize a TRANSPOSED copy of the whole
        cache (9.75 GiB temp, compile-time OOM at n=212992), while
        full-tile access keeps the native layout.  Empty
        slots receive garbage lanes — harmless, their content is dead
        until a full-row upload rebinds them."""
        wi = col // 4
        w0 = (wi // 128) * 128                  # aligned tile stripe
        lane = wi - w0
        sh = 8 * (col % 4).astype(jnp.uint32)
        pv = vals_bytes[jnp.maximum(c["rowof"], 0)]         # (X,)
        tile = jax.lax.dynamic_slice(
            c["cache"], (jnp.int32(0), w0), (X, 128))       # (X, 128)
        lidx = jnp.asarray(np.arange(128, dtype=np.int32))
        hit = (lidx[None, :] == lane) & on
        wnew = (tile & ~(jnp.uint32(0xFF) << sh)) \
            | (pv[:, None] << sh)
        tile = jnp.where(hit, wnew, tile)
        return st(c, "cache", jax.lax.dynamic_update_slice(
            c["cache"], tile, (jnp.int32(0), w0)))

    def write_row(c, r, bytes_u32):
        """Store row r's content (u32 byte values) into its slot."""
        s = jnp.maximum(c["slotof"][r], 0)
        return st(c, "cache", jax.lax.dynamic_update_slice(
            c["cache"], _pack_bytes(bytes_u32)[None, :],
            (s, jnp.int32(0))))

    def last_min(q):
        mn = q.min()
        return mn, jnp.where(q == mn, idx, -1).max().astype(jnp.int32)

    def one_join(c):
        t = c["t"]
        m_t = m - t
        co = 2 * (m_t - 2)
        Q, P, sD2 = c["Q"], c["P"], c["sD2"]
        seed = c["seed"]

        seed_ok = (seed != 0) & (Q[seed] != big)
        minv0 = jnp.where(seed_ok, Q[seed], big)
        pi0 = jnp.where(seed_ok, seed, 0)
        pj0 = jnp.where(seed_ok, P[seed], 0)
        last = m_t - 1

        # ---- pre-check: the fixed rows this join always touches -----
        # (scan candidates are checked batch-by-batch inside the scan:
        # the C's cummin gating visits only the descending prefix whose
        # bounds beat the running min — typically passes*kbatch rows —
        # so demanding the whole {Q < minv0} superset be resident would
        # force X >= |cand| for nothing)
        fetch_ok = c["slotof"] >= 0
        need = (idx == last) \
            | (seed_ok & ((idx == pi0) | (idx == pj0)))
        missing = need & ~fetch_ok
        ok_pre = ~missing.any()

        def abort(c, missing_mask, extra0, extra1):
            mm = topk_mask_indices(missing_mask, idx, MMAX - 2)
            miss = jnp.concatenate(
                [jnp.stack([extra0, extra1]), mm])
            c = st(c, "miss", miss)
            c = st(c, "ok", jnp.bool_(False))
            c = st(c, "stats", c["stats"].at[2].add(1))
            return c

        def do_scan(c):
            def cand_mask(Q, minv):
                return (idx >= 1) & (idx < m_t) & (Q < minv)

            def bcond(s_):
                return s_[7] & cand_mask(s_[3], s_[0]).any()

            def bbody(s_):
                minv, pi, pj, Q, P, np_, c, sok = s_
                cm = cand_mask(Q, minv)
                rows = topk_mask_indices(cm, idx, kbatch)
                valid = rows >= 1
                r = jnp.where(valid, rows, 0)
                # abort the scan on the first actually-unfetchable
                # gather (redo-safe: revalidation writes exact values
                # the C would write at this join, so re-running the
                # scan after a host refresh picks the same pair)
                row_ok = ~valid | (c["slotof"][r] >= 0)
                allok = row_ok.all()
                miss_rows = jnp.where(valid & ~row_ok, rows, -1)
                c = st(c, "miss", jax.lax.dynamic_update_slice(
                    jnp.full(MMAX, -1, jnp.int32), miss_rows,
                    (jnp.int32(2),)) if kbatch <= MMAX - 2 else c["miss"])
                blk = fetch_batch(c, r, valid & row_ok & allok)
                # plane-major Q row: per byte lane b, column 4*wi+b —
                # no (K, n) unpack, ~same bytes as the words themselves
                W_ = blk.shape[1]
                wi4 = jnp.asarray(np.arange(0, n, 4, dtype=np.int32))
                rmin = jnp.full(r.shape, big)
                rarg = jnp.zeros(r.shape, jnp.int32)
                for b in range(4):
                    cell = ((blk >> jnp.uint32(8 * b))
                            & jnp.uint32(0xFF)).astype(jnp.int32)
                    col = wi4 + b                           # (W,)
                    qb = co * cell - sD2[r][:, None] \
                        - sD2[col][None, :]
                    qb = jnp.where(col[None, :] < r[:, None], qb, big)
                    bmn = qb.min(axis=1)
                    bar = jnp.where(qb == bmn[:, None], col[None, :],
                                    -1).max(axis=1).astype(jnp.int32)
                    take = (bmn < rmin) | ((bmn == rmin)
                                           & (bar > rarg))
                    rmin = jnp.where(take, bmn, rmin)
                    rarg = jnp.where(take, bar, rarg)
                rminv = jnp.where(valid, rmin, big)
                rm = jax.lax.cummin(
                    jnp.concatenate([minv[None], rminv[:-1]]))
                reval = valid & (Q[r] < rm) & allok
                tgt = jnp.where(reval, rows, n)
                Q = Q.at[tgt].set(jnp.where(reval, rmin, big),
                                  mode="drop")
                P = P.at[tgt].set(jnp.where(reval, rarg, 0),
                                  mode="drop")
                bvals = jnp.where(valid, rmin, big)
                bmin = bvals.min()
                bi = jnp.where(bvals == bmin, rows, -1).max() \
                    .astype(jnp.int32)
                karg = jnp.where((bvals == bmin) & (rows == bi),
                                 rarg, 0).max().astype(jnp.int32)
                better = (bmin < minv) & allok
                return (jnp.where(better, bmin, minv),
                        jnp.where(better, bi, pi),
                        jnp.where(better, karg, pj), Q, P,
                        np_ + 1, c, allok)

            minv, pi, pj, Qf, Pf, np_, c, sok = jax.lax.while_loop(
                bcond, bbody,
                (minv0, pi0, pj0, Q, P, jnp.int32(0), c,
                 jnp.bool_(True)))
            c = st(c, "stats", c["stats"].at[0].add(np_))
            # commit the scan's revalidations ONLY on full completion:
            # a partial reval set redone later runs the cummin gating
            # against different bounds than the C's single pristine
            # scan, and cached values feed every future join's gating
            # (measured: Q[266] over-revalidated at n=600 join 81)
            c = st(c, "Q", jnp.where(sok, Qf, Q))
            c = st(c, "P", jnp.where(sok, Pf, P))
            return c, minv, pi, pj, sok

        def do_join(c, pi, pj):
            i, j = pi, pj
            hp = (pi != 0) | (pj != 0)
            sD2 = c["sD2"]
            ci = fetch_one(c, i)
            cj = fetch_one(c, j)
            cij = ci[j]
            # fetch the popArrange source BEFORE this join's writes
            # land (the only cell of `last` this join changes is
            # column j = q_new, re-applied below via move_bytes)
            last_pre = fetch_one(c, m_t - 1).astype(jnp.uint32)
            c = st(c, "DIJ2", c["DIJ2"].at[t].set(
                jnp.where(hp, 2 * cij, 0)))
            c = st(c, "SDI2", c["SDI2"].at[t].set(
                jnp.where(hp, sD2[i], 0)))
            c = st(c, "SDJ2", c["SDJ2"].at[t].set(
                jnp.where(hp, sD2[j], 0)))

            active = idx < m_t
            valid_k = active & (idx != i) & (idx != j) & hp
            d_new_u = jnp.maximum(ci + cj - cij, 0)
            sD2 = jnp.where(valid_k,
                            sD2 - (2 * ci + 2 * cj - d_new_u), sD2)
            sD2 = sD2.at[j].set(jnp.where(
                hp, jnp.where(valid_k, d_new_u, 0)
                .sum(dtype=jnp.int32), sD2[j]))
            c = st(c, "sD2", sD2)
            q_new = jnp.minimum((2 * d_new_u + 1) >> 2, 255) \
                .astype(jnp.uint32)
            rowj_bytes = jnp.where(valid_k, q_new,
                                   cj.astype(jnp.uint32))
            c = write_row(c, j, rowj_bytes)
            c = col_write(c, j, rowj_bytes, hp)

            Q, P = c["Q"], c["P"]
            co_post = 2 * (m_t - 3)
            cj_post = rowj_bytes.astype(jnp.int32)
            qj = co_post * cj_post - sD2[j] - sD2
            qj = jnp.where(idx < j, qj, big)
            Qj, Pj = last_min(qj)
            Q = Q.at[j].set(jnp.where(hp, Qj, Q[j]))
            P = P.at[j].set(jnp.where(hp, jnp.where(Qj == big, 0, Pj),
                                      P[j]))
            colj = rowj_bytes.astype(jnp.int32)
            qcol = co_post * colj - sD2[j] - sD2
            colk = valid_k & (idx > j)
            upd = colk & (qcol <= Q)
            Q = jnp.where(upd, qcol, Q)
            P = jnp.where(upd, j, P)
            mq = jnp.where(upd, qcol, big).min()
            mi_cand = jnp.where(
                upd.any() & (mq <= Qj),
                jnp.where(upd & (qcol == mq), idx, -1).max(), j) \
                .astype(jnp.int32)

            # popArrange: move row `last` into slot i
            m_new = m_t - 1
            g = hp & (i != last)
            move_bytes = last_pre.at[j].set(
                jnp.where(hp, q_new[m_t - 1], last_pre[j]))
            old_i = ci.astype(jnp.uint32)
            newrow_i = jnp.where(idx == i, jnp.uint32(0), move_bytes)
            rowi_bytes = jnp.where(g, newrow_i, old_i)
            c = write_row(c, i, rowi_bytes)
            c = col_write(c, i, rowi_bytes, hp)
            # free the vacated slot
            slot_last = c["slotof"][last]
            sl_w = jnp.where(g, jnp.maximum(slot_last, 0), X)
            c = st(c, "rowof", c["rowof"].at[sl_w].set(-1, mode="drop"))
            c = st(c, "slotof", c["slotof"]
                   .at[jnp.where(g, last, n)].set(-1, mode="drop"))

            sD2 = sD2.at[i].set(jnp.where(g, sD2[last], sD2[i]))
            c = st(c, "sD2", sD2)
            ci_post = rowi_bytes.astype(jnp.int32)
            qi = co_post * ci_post - sD2[i] - sD2
            qi = jnp.where(idx < i, qi, big)
            Qi, Pi = last_min(qi)
            Q = Q.at[i].set(jnp.where(g, Qi, Q[i]))
            P = P.at[i].set(jnp.where(g, jnp.where(Qi == big, 0, Pi),
                                      P[i]))
            coli = rowi_bytes.astype(jnp.int32)
            qc = co_post * coli - sD2[i] - sD2
            ck = (idx > i) & (idx < last) & g
            u2 = ck & (qc <= Q)
            Q = jnp.where(u2, qc, Q)
            P = jnp.where(u2, i, P)
            mq2 = jnp.where(u2, qc, big).min()
            p2 = jnp.where(u2.any() & (mq2 <= Qi),
                           jnp.where(u2 & (qc == mq2), idx, -1).max(),
                           i).astype(jnp.int32)
            mj_cand = jnp.where(g, p2, 0)
            Q = Q.at[last].set(big)
            c = st(c, "Q", Q)
            c = st(c, "P", P)

            seed_new = jnp.where(
                mj_cand == m_new, mi_cand,
                jnp.where(mi_cand == m_new, mj_cand,
                          jnp.where((Q[mj_cand] < Q[mi_cand])
                                    | ((mi_cand < mj_cand)
                                       & (Q[mj_cand] == Q[mi_cand])),
                                    mj_cand, mi_cand)))
            c = st(c, "seed", jnp.where(hp, seed_new, 0))
            c = st(c, "I", c["I"].at[t].set(jnp.where(hp, i, 0)))
            c = st(c, "J", c["J"].at[t].set(jnp.where(hp, j, 0)))
            c = st(c, "t", t + 1)
            return c

        def go(c):
            c, minv, pi, pj, sok = do_scan(c)
            # post-check: the scan must have completed (no gather miss)
            # and its pick rows must be fetchable
            ok_post = sok & fetchable(c, pi) & fetchable(c, pj)

            def scan_abort(c):
                # c["miss"] already carries the failing batch rows
                # (written in bbody); add the pick rows if unfetchable
                c = st(c, "miss", c["miss"].at[0].set(
                    jnp.where(fetchable(c, pi), -1, pi)))
                c = st(c, "miss", c["miss"].at[1].set(
                    jnp.where(fetchable(c, pj), -1, pj)))
                c = st(c, "ok", jnp.bool_(False))
                c = st(c, "stats", c["stats"].at[2].add(1))
                return c

            return jax.lax.cond(
                ok_post, lambda c: do_join(c, pi, pj), scan_abort, c)

        return jax.lax.cond(
            ok_pre, go,
            lambda c: abort(c, missing, jnp.int32(-1), jnp.int32(-1)),
            c)

    return one_join


_STATE_KEYS = ("cache", "slotof", "rowof", "sD2", "Q", "P", "seed",
               "I", "J", "DIJ2", "SDI2", "SDJ2", "stats", "t", "ok",
               "miss")


@functools.partial(jax.jit,
                   static_argnames=("n", "X", "kbatch"),
                   donate_argnums=tuple(range(16)))
def _streamed_segment(cache, slotof, rowof, sD2, Q, P, seed, I, J,
                      DIJ2, SDI2, SDJ2, stats, t, ok, miss,
                      up_words, up_slots, up_rows, t1, m,
                      n, X, kbatch):
    """Apply the pending upload batch, then run joins until t1 or the
    first abort.  Folding the upload into the segment program makes an
    abort round-trip ONE dispatch instead of two serialized ones
    (upload, then redispatch); the batch shapes are
    host-bucketed (8 * 4^k) so only a few variants ever compile."""
    W = cache.shape[1]
    n_ = slotof.shape[0]
    valid = up_rows >= 0
    # padded lanes (up_rows == -1) carry slot X: clamp the rowof
    # gather and mask its result so a padded lane can never read slot
    # X-1's tenant and unbind a legitimate resident
    old_rows = jnp.where(valid,
                         rowof[jnp.minimum(up_slots, X - 1)], -1)
    # drop-mode out-of-range targets for the no-op lanes: an in-range
    # dummy index (e.g. 0) races nondeterministically with a genuine
    # eviction of that row in the same scatter
    slotof = slotof.at[jnp.where(old_rows >= 0, old_rows, n_)].set(
        -1, mode="drop")
    sw = jnp.where(valid, up_slots, X)
    # per-row DUS loop, NOT a batch scatter: a top-level scatter on
    # the > 2^31-element cache gets a fresh output buffer (a full
    # 9.75 GiB cache copy at n=212992 — compile-time OOM); the DUS
    # chain updates the donated buffer in place
    W_ = cache.shape[1]

    def _put(k, cch):
        s = jnp.where(up_rows[k] >= 0, up_slots[k], 0)
        old = jax.lax.dynamic_slice(cch, (s, jnp.int32(0)), (1, W_))
        new = jnp.where(up_rows[k] >= 0, up_words[k][None, :], old)
        return jax.lax.dynamic_update_slice(cch, new,
                                            (s, jnp.int32(0)))

    cache = jax.lax.fori_loop(0, up_rows.shape[0], _put, cache)
    rowof = rowof.at[sw].set(up_rows, mode="drop")
    slotof = slotof.at[jnp.where(valid, up_rows, n_)].set(
        jnp.where(valid, up_slots, -1), mode="drop")

    one_join = _mk_one_join_streamed(n, W, X, m, kbatch)
    c0 = dict(zip(_STATE_KEYS, (cache, slotof, rowof, sD2, Q, P, seed,
                                I, J, DIJ2, SDI2, SDJ2, stats, t,
                                jnp.bool_(True), miss)))

    def cond(c):
        return (c["t"] < t1) & c["ok"]

    c = jax.lax.while_loop(cond, one_join, c0)
    return tuple(c[k] for k in _STATE_KEYS)


# ---------------------------------------------------------------------
# host side


def _host_init(Dq: np.ndarray, m: int, chunk: int = 4096):
    """sD2 / Q / P / seed in exact int32 u-units from the host matrix
    (the numpy twin of packed_engine._packed_init).

    Prefers the native single-pass kernel (init_hnj_u8, one sequential
    read of the matrix — the numpy two-pass formulation took 4859 s
    at n=212992 on a 2-CPU host); bit-exact either way
    (tests/test_streamed_engine.py)."""
    n = Dq.shape[0]
    if Dq.flags["C_CONTIGUOUS"]:
        from ..native import get_lib
        lib = get_lib()
        if lib is not None:
            import ctypes
            sD2 = np.zeros(n, np.int32)
            Q = np.zeros(n, np.int32)
            P = np.zeros(n, np.int32)
            p_i32 = ctypes.POINTER(ctypes.c_int32)
            seed = lib.init_hnj_u8(
                Dq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                n, int(m),
                sD2.ctypes.data_as(p_i32), Q.ctypes.data_as(p_i32),
                P.ctypes.data_as(p_i32))
            return sD2, Q, P, max(int(seed), 0)
    return _host_init_np(Dq, m, chunk)


def _host_init_np(Dq: np.ndarray, m: int, chunk: int = 4096):
    """Pure-numpy fallback (and the native kernel's parity oracle)."""
    n = Dq.shape[0]
    big = np.int32(np.iinfo(np.int32).max)
    idx = np.arange(n, dtype=np.int64)
    act = idx < m
    sD2 = np.zeros(n, np.int32)
    for r0 in range(0, m, chunk):
        r1 = min(r0 + chunk, m)
        blk = Dq[r0:r1].astype(np.int32)
        v = act[None, :] & (idx[r0:r1, None] != idx[None, :])
        sD2[r0:r1] = 2 * np.where(v, blk, 0).sum(axis=1,
                                                 dtype=np.int32)
    Q = np.full(n, big, np.int32)
    P = np.zeros(n, np.int32)
    co0 = 2 * (m - 2)
    for r0 in range(0, m, chunk):
        r1 = min(r0 + chunk, m)
        blk = Dq[r0:r1].astype(np.int32)
        rows = idx[r0:r1]
        lv = act[None, :] & (idx[None, :] < rows[:, None])
        Qm = np.where(lv, co0 * blk - sD2[r0:r1, None] - sD2[None, :],
                      big)
        Qc = Qm.min(axis=1)
        cand = lv & (Qm == Qc[:, None])
        dmask = np.where(cand, blk, big)
        prefmin = np.minimum.accumulate(dmask, axis=1)
        sel = cand & (dmask == prefmin)
        Pc = np.where(sel, idx[None, :], -1).max(axis=1)
        Q[r0:r1] = Qc
        P[r0:r1] = np.maximum(Pc, 0)
    qrows = np.where((idx >= 1) & act, Q, big)
    mn0 = qrows.min()
    seed0 = int(np.where(qrows == mn0, idx, -1).max()) if m > 1 else 0
    return sD2, Q, P, max(seed0, 0)


class StreamedDNJ:
    """Host driver for the beyond-HBM packed DNJ.

    Parameters
    ----------
    Dq : (npad, npad) uint8 host matrix (ndarray or np.memmap), padded
         with zero rows/cols beyond `m` (use `_pad512`).
    m  : active taxa.
    X  : cache rows (device HBM budget ~ X * npad bytes).
    F  : accepted for API compatibility; unused since the patch ring
         was replaced by direct column writes (see module doc).
    """

    def __init__(self, Dq: np.ndarray, m: int, X: int = 4096,
                 F: int = 512, kbatch: int = 128,
                 prefetch: int = 1024, horizon: int = 2048,
                 verbose: bool = False):
        n = Dq.shape[0]
        assert Dq.shape == (n, n) and Dq.dtype == np.uint8
        assert n % 512 == 0 and X % 8 == 0 and X <= n
        # a scan-batch gather miss reports at most MMAX-2 rows; a
        # larger kbatch would silently skip the miss write and the
        # host refresh would loop on a stale list until the livelock
        # guard fires
        assert kbatch <= MMAX - 2, (kbatch, MMAX)
        self.Dq = Dq
        self.n, self.m = n, int(m)
        self.X, self.F = X, F
        self.kbatch = kbatch
        # optional (non-protected) residency headroom, clamped so the
        # policy rows can never crowd out the required working set
        self.prefetch = min(prefetch, X // 4)
        self.horizon = min(horizon, X // 2)
        self.verbose = verbose
        self.W = n // 4
        self.uploaded_rows = 0
        self.aborts = 0
        self.replayed_to = 0
        # host mirrors of the device residency maps: _plan_upload and the
        # replay loop keep them exact, so the abort path never fetches
        # slotof/rowof from the device (each device->host read costs a
        # round trip, and an abort would otherwise need six or more)
        self.slotof_h = np.full(n, -1, np.int64)
        self.rowof_h = np.full(X, -1, np.int64)
        # cached Q snapshot: POLICY ONLY (eviction order, prefetch
        # slabs) — staleness cannot affect correctness, the device's
        # own miss reports are the authoritative working set
        self.Qh = np.zeros(n, np.int32)
        # recently-missed rows (eviction-protected): uploading ONLY the
        # current miss report can evict rows the redone scan's earlier
        # passes still need — measured ping-pong livelock at X=384
        self._recent = []
        # P mirror (repair-updated; resynced at policy refreshes) and
        # the speculative push queue fed by _replay_mirror
        self.Ph = np.zeros(n, np.int32)
        self.sD2h = None
        self._spec = []

    # -- residency ----------------------------------------------------
    def _policy_refresh(self, state, t_now):
        """Fetch a fresh Q snapshot (one transfer) and return the
        speculative residency set: the scan candidate prefix for the
        next join, a bottom-Q slab (late-pass candidates + likely
        seeds), and the popArrange horizon."""
        Q_h, P_h, seed = jax.device_get(
            (state[4], state[5], state[6]))
        self.Qh = Q_h.copy()
        self.Ph = P_h.copy()
        seed = int(seed)
        big = np.int32(np.iinfo(np.int32).max)
        m_t = self.m - t_now
        idx = np.arange(self.n)
        seed_ok = (seed != 0) and (Q_h[seed] != big)
        minv0 = Q_h[seed] if seed_ok else big
        rows = [m_t - 1]
        if seed_ok:
            rows += [seed, int(P_h[seed])]
        # candidate prefix, CAPPED: the full {Q < minv0} superset can
        # rival X and its transfer (~580 MB spikes at n=49k) costs more
        # than the per-miss aborts it would prevent now that a miss is
        # a single fused dispatch
        cand = np.nonzero((idx >= 1) & (idx < m_t)
                          & (Q_h < minv0))[0]
        cap = min(max(self.X // 8 - len(rows), 0), 2048)
        rows.extend(int(r) for r in cand[::-1][:cap])
        act = np.arange(1, m_t)
        order = act[np.argsort(Q_h[1:m_t], kind="stable")]
        slab = order[:self.prefetch]
        rows.extend(int(r) for r in slab)
        # the partners of the bottom-Q slab: the next joins' seeds come
        # from the slab and each join pre-checks (seed, P[seed]) — the
        # partner is unpredictable from Q alone but IS P_h[seed], and P
        # only changes via cache repair, so the refresh-time snapshot
        # covers most of the window
        rows.extend(int(r) for r in np.unique(P_h[slab]) if r >= 1)
        h0 = max(m_t - self.horizon, 0)
        rows.extend(range(h0, m_t))
        return rows

    def _plan_upload(self, rows_needed, protect=None, max_new=None):
        """Plan installing `rows_needed` (list of global rows) into
        cache slots, evicting highest-Q residents outside `protect`
        (default: outside `rows_needed`).  Rows that cannot be
        installed once every evictable slot is gone are dropped —
        callers order `rows_needed` required-first.  `max_new` bounds
        the installs per call (a transfer budget: a candidate-set
        turnover can be thousands of rows).
        Residency comes from the host mirrors — no device reads.
        Returns the (up_words, up_slots, up_rows) batch for the next
        segment dispatch, and the install count."""
        rowof_h = self.rowof_h
        slotof_h = self.slotof_h
        rows_needed = list(dict.fromkeys(rows_needed))
        want = [r for r in rows_needed
                if r < self.m and slotof_h[r] < 0]
        if not want:
            return self._empty_up(), 0
        # new rows take free slots, then evict the highest-Q residents
        slots = []
        free = np.nonzero(rowof_h < 0)[0]
        fi = 0
        if max_new is not None and len(want) > max_new:
            want = want[:max_new]
        # eviction must spare the caller's protect set plus every row
        # installed by this upload.  NOT all of rows_needed: when the
        # needed list rivals X, protecting every listed row leaves
        # nothing evictable and a missing row can never install
        # (measured livelock at n=49k, X=12288)
        needed_set = (set(protect) if protect is not None
                      else set(rows_needed))
        needed_set.update(want)
        evict_order = None
        rows = []
        for r in want:
            if fi < len(free):
                slots.append(int(free[fi]))
                fi += 1
            else:
                if evict_order is None:
                    res_rows = rowof_h[rowof_h >= 0]
                    keep = np.array([rr for rr in res_rows
                                     if rr not in needed_set],
                                    dtype=np.int64)
                    evict_order = keep[np.argsort(
                        self.Qh[keep])].tolist()
                if not evict_order:
                    break  # cache full of needed rows; install what fits
                slots.append(int(slotof_h[evict_order.pop()]))
            rows.append(r)
        U = len(rows)
        if U == 0:
            return self._empty_up(), 0
        # mirror the installs/evictions
        for r, s_ in zip(rows, slots):
            old = rowof_h[s_]
            if old >= 0:
                slotof_h[old] = -1
            rowof_h[s_] = r
            slotof_h[r] = s_
        # bucket the batch size: every distinct (U, W) shape is a
        # fresh segment-program compile;
        # padded lanes carry row=-1 / slot=X and are dropped on device
        Ub = 8
        while Ub < U:
            Ub *= 4
        up = np.zeros((Ub, self.W), np.uint32)
        for k, r in enumerate(rows):
            up[k] = self.Dq[r].view(np.uint32)
        slots_a = np.full(Ub, self.X, np.int32)
        slots_a[:U] = slots
        rows_a = np.full(Ub, -1, np.int32)
        rows_a[:U] = rows
        self.uploaded_rows += U
        return (jnp.asarray(up), jnp.asarray(slots_a),
                jnp.asarray(rows_a)), U

    def _empty_up(self):
        """A no-op upload batch (all lanes dropped on device)."""
        return (jnp.zeros((8, self.W), jnp.uint32),
                jnp.full(8, self.X, jnp.int32),
                jnp.full(8, -1, jnp.int32))

    def run(self):
        n, m, X, F, W = self.n, self.m, self.X, self.F, self.W
        t0 = _time.perf_counter()
        sD2, Q, P, seed = _host_init(self.Dq, m)
        if self.verbose:
            print(f"host init {_time.perf_counter() - t0:.1f}s",
                  flush=True)
        self.sD2h = sD2.copy()
        self.Qh = Q.copy()
        self.Ph = P.copy()
        self._idx = np.arange(n)
        state = (
            jnp.zeros((X, W), jnp.uint32),                  # cache
            jnp.full(n, -1, jnp.int32),                     # slotof
            jnp.full(X, -1, jnp.int32),                     # rowof
            jnp.asarray(sD2), jnp.asarray(Q), jnp.asarray(P),
            jnp.int32(seed),
            jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
            jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
            jnp.zeros(n, jnp.int32),
            jnp.zeros(8, jnp.int32),                        # stats
            jnp.int32(0), jnp.bool_(True),                  # t, ok
            jnp.full(MMAX, -1, jnp.int32),                  # miss
        )
        total = max(m - 2, 0)
        mj = jnp.int32(m)

        def seg_call(state, up3, s1):
            out = _streamed_segment(*state, *up3, jnp.int32(s1), mj,
                                    n=n, X=X, kbatch=self.kbatch)
            return out

        # initial fill in bounded chunks (one unbounded batch would
        # stage up to X rows on device — ~28 GB at n=212992): each
        # chunk rides a zero-join segment dispatch (t1 == t applies
        # the upload and runs nothing)
        req0 = self._policy_refresh(state, 0)
        while True:
            fill3, u = self._plan_upload(req0, protect=req0[:3],
                                         max_new=2048)
            if u == 0:
                break
            state = seg_call(state, fill3, 0)
        up3 = self._empty_up()

        done = 0
        seg = int(os.environ.get("CCPHYLO_TPU_SEG", "512") or 512)
        target_s = float(os.environ.get("CCPHYLO_TPU_SEG_TARGET_S",
                                        "4.0") or 4.0)
        while done < total:
            k = min(seg, total - done)
            tseg = _time.perf_counter()
            state = seg_call(state, up3, done + k)
            up3 = self._empty_up()
            # ONE device->host round trip per segment: loop scalars,
            # miss report, and the full I/J record arrays (fixed
            # shapes — a t-bounded slice would stamp out a fresh
            # device program per segment)
            t_now, ok, miss, I_w, J_w = (
                int(x) if x.ndim == 0 else x for x in jax.device_get(
                    (state[13], state[14], state[15],
                     state[7], state[8])))
            ok = bool(ok)
            dt = _time.perf_counter() - tseg
            # host replay of the newly completed joins: matrix +
            # sD2/Q/P cache mirrors + speculative set (repair-lowered
            # rows = the next joins' scan candidates and seeds), and
            # the popArrange slot frees the device performed
            if t_now > self.replayed_to:
                nrep = t_now - self.replayed_to
                I_h = I_w[self.replayed_to:t_now]
                J_h = J_w[self.replayed_to:t_now]
                bigi = np.int32(np.iinfo(np.int32).max)
                idxv = self._idx
                for kk in range(nrep):
                    tt = self.replayed_to + kk
                    i_, j_ = int(I_h[kk]), int(J_h[kk])
                    if i_ == 0 and j_ == 0:
                        continue
                    hot = _replay_join_mirrored(
                        self.Dq, self.sD2h, self.Qh, self.Ph,
                        i_, j_, m - tt, idxv, bigi)
                    self._spec.extend(hot)
                    last_ = m - tt - 1
                    if i_ != last_:
                        s_ = self.slotof_h[last_]
                        if s_ >= 0:
                            self.rowof_h[s_] = -1
                        self.slotof_h[last_] = -1
                self.replayed_to = t_now
            prog = t_now - done
            done = t_now
            if not ok:
                self.aborts += 1
                rows = [int(r) for r in miss if r >= 0]
                state = state[:14] + (jnp.bool_(True), state[15])
                # the device's miss report is the authoritative working
                # set: upload exactly those rows (tiny transfer), plus
                # a THROTTLED speculative refresh (full Q fetch +
                # slabs): each refresh is a multi-hundred-MB transfer
                # (~2-3 s), so it must amortize over many aborts
                req = list(rows)
                spec = [r for r in dict.fromkeys(self._spec)
                        if self.slotof_h[r] < 0]
                self._spec = []
                req += spec[:1024]
                if self.aborts % 64 == 1:
                    req += self._policy_refresh(state, done)
                win = min(4 * self.kbatch, self.X // 2)
                self._recent = (self._recent + rows)[-win:]
                # protect the next popArrange sources: zombie/idle rows
                # carry Q=big so highest-Q-first eviction would target
                # exactly the rows every upcoming join must touch
                m_t = self.m - done
                hz = list(range(max(m_t - min(512, self.X // 8), 0),
                                m_t))
                up3, u = self._plan_upload(
                    req, protect=rows + self._recent + hz,
                    max_new=2048)
                if prog == 0:
                    # u == 0: nothing progressed and nothing could be
                    # installed — the working set genuinely exceeds
                    # the cache.  u > 0 but a long zero-progress
                    # streak: the installs themselves ping-pong the
                    # set (same conclusion, slower to prove)
                    self._zero_streak = getattr(self, "_zero_streak",
                                                0) + 1
                    if (self._zero_streak > 4 and u == 0) \
                            or self._zero_streak > 256:
                        raise RuntimeError(
                            "streamed DNJ livelock: candidate set "
                            f"exceeds the cache (X={self.X}); rerun "
                            "with a larger X")
                else:
                    self._zero_streak = 0
                if self.verbose:
                    m_t = self.m - done
                    tags = ", ".join(str(r) for r in rows[:6])
                    print(f"  abort@{done}: {len(rows)} missing "
                          f"(last={m_t - 1}), uploaded {u}  [{tags}]",
                          flush=True)
            elif self._spec and done < total:
                # push the repair-lowered rows speculatively on the
                # next dispatch even without an abort
                spec = [r for r in dict.fromkeys(self._spec)
                        if self.slotof_h[r] < 0]
                self._spec = []
                if spec:
                    m_t = self.m - done
                    hz = list(range(
                        max(m_t - min(512, self.X // 8), 0), m_t))
                    up3, _ = self._plan_upload(
                        spec[:1024], protect=self._recent + hz,
                        max_new=1024)
            if prog > 0 and done < total:
                seg = int(max(64, min(131072,
                                      seg * target_s / max(dt, 1e-3))))
            if self.verbose and prog:
                print(f"  seg {done}/{total} ({prog} joins, "
                      f"{dt:.1f}s, {prog / max(dt, 1e-9):,.0f}/s)",
                      flush=True)
        I = np.asarray(state[7])
        J = np.asarray(state[8])
        DIJ2 = np.asarray(state[9])
        SDI2 = np.asarray(state[10])
        SDJ2 = np.asarray(state[11])
        self.stats = np.asarray(state[12])
        d_last2 = 2 * int(self.Dq[1, 0])
        return I, J, DIJ2, SDI2, SDJ2, d_last2


def _replay_join_mirrored(Dq, sD2, Q, P, i, j, m_t, idx, big):
    """Replay ONE join on the host matrix and mirror the device
    do_join's exact int32 cache updates in the device's order: sD2
    deltas from the pre-join rows, the matrix row/column writes, the
    fresh row-j / moved-row-i minima, and the column repair tests.
    Returns the rows whose bound the repairs LOWERED — the next joins'
    scan candidates/seeds, i.e. the speculative upload set.  Q drifts
    low vs the device (scan revalidations, which only raise bounds,
    are not mirrored) — policy-only, resynced at refreshes."""
    with np.errstate(over="ignore"):
        co = np.int32(2 * (m_t - 3))
        last = m_t - 1
        ci = Dq[i].astype(np.int32)
        cj = Dq[j].astype(np.int32)
        cij = np.int32(ci[j])
        valid_k = (idx < m_t) & (idx != i) & (idx != j)
        d_new = np.maximum(ci + cj - cij, 0).astype(np.int32)
        sD2 -= np.where(valid_k,
                        (2 * ci + 2 * cj - d_new).astype(np.int32), 0)
        sD2[j] = np.where(valid_k, d_new, 0).sum(dtype=np.int32)
        q_new = np.minimum((2 * d_new + 1) >> 2, 255).astype(np.uint8)
        rowj8 = np.where(valid_k, q_new, Dq[j])
        Dq[j, :] = rowj8
        Dq[:, j] = rowj8
        rowj = rowj8.astype(np.int32)
        qj = co * rowj - sD2[j] - sD2
        qj = np.where(idx < j, qj, big)
        Qj = qj.min()
        Pj = int(np.where(qj == Qj, idx, -1).max())
        Q[j] = Qj
        P[j] = 0 if Qj == big else Pj
        qcol = co * rowj - sD2[j] - sD2
        upd = valid_k & (idx > j) & (qcol <= Q)
        Q[upd] = qcol[upd]
        P[upd] = j
        hot = [int(r) for r in np.nonzero(upd)[0]]
        if i != last:
            moved = Dq[last].copy()
            moved[i] = 0
            Dq[i, :] = moved
            Dq[:, i] = moved
            sD2[i] = sD2[last]
            rowi = moved.astype(np.int32)
            qi = co * rowi - sD2[i] - sD2
            qi = np.where(idx < i, qi, big)
            Qi = qi.min()
            Pi = int(np.where(qi == Qi, idx, -1).max())
            Q[i] = Qi
            P[i] = 0 if Qi == big else Pi
            qc = co * rowi - sD2[i] - sD2
            u2 = (idx > i) & (idx < last) & (qc <= Q)
            Q[u2] = qc[u2]
            P[u2] = i
            hot += [int(r) for r in np.nonzero(u2)[0]]
        Q[last] = big
    return hot


def _host_replay_shift(Dq, I_h, J_h, off, t1, m):
    """Replay records I_h/J_h (joins off..t1) with correct m_t."""
    n = Dq.shape[0]
    idx = np.arange(n)
    for k in range(t1 - off):
        t = off + k
        i, j = int(I_h[k]), int(J_h[k])
        if i == 0 and j == 0:
            continue
        m_t = m - t
        ci = Dq[i].astype(np.int32)
        cj = Dq[j].astype(np.int32)
        cij = int(ci[j])
        active = idx < m_t
        valid_k = active & (idx != i) & (idx != j)
        d_new = np.maximum(ci + cj - cij, 0)
        q_new = np.minimum((2 * d_new + 1) >> 2, 255).astype(np.uint8)
        rowj = np.where(valid_k, q_new, Dq[j])
        Dq[j, :] = rowj
        Dq[:, j] = rowj
        last = m_t - 1
        if i != last:
            moved = Dq[last].copy()
            moved[i] = 0
            Dq[i, :] = moved
            Dq[:, i] = moved
    return Dq


def dnj_joins_streamed(Dq: np.ndarray, m: int, X: int = 4096,
                       F: int = 512, kbatch: int = 128,
                       verbose: bool = False, **kw):
    """Run all m-2 joins with the host-streamed engine; returns
    (I, J, DIJ2, SDI2, SDJ2, d_last2) — the same exact-int32 records as
    packed_engine.dnj_joins_packed (bit-identical by construction)."""
    eng = StreamedDNJ(Dq, m, X=X, F=F, kbatch=kbatch, verbose=verbose,
                      **kw)
    out = eng.run()
    dnj_joins_streamed.last = eng
    return out
