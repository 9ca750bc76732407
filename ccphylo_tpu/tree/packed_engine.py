"""Single-buffer, u32-packed, exact-integer DNJ — the 100k+-taxa
single-device engine.

Reference scaling tools for huge runs are u8/u16 ByteScale matrices and
mmap out-of-core storage (matrix.c:116, bytescale.h:22-23, dnj.c:1054).
The device equivalent: the quantized (u8) distance matrix lives in
device memory as one **uint32 buffer, four cells per word** (n^2 bytes
in all: 10.1 GB at n=100352, 45.4 GB at n=212992).

Why one buffer: one u32 buffer serves row gathers, row writes and
column slice-updates directly, where a row-blocked layout pays a
gather over-read plus per-block select/slice work on every join.

Why integer arithmetic: every quantity of the quantized engine is an
exact multiple of u = 1/(2*ByteScale) — cells are c/bs, updateD's
(D_ik+D_kj-D_ij)/2 is (ci+cj-cij)*u, row sums and Q-criterion values
are integer combinations of those.  Computing the whole trajectory in
int32 "u units" makes every comparison EXACT on any backend: CPU and
GPU produce bit-identical join records by construction, with no
summation-order ulp exposure (a float engine can flip a Q tie on one
ulp; integers cannot).  The reference's own f64 engine performs the
same arithmetic exactly whenever cells/bs is f64-exact (any dyadic
ByteScale, incl. the default 1.0) — so join records match the C
bit-for-bit at any n, provably, not statistically.  int32 bounds:
|Q_u| <= 2*n*255 + 2*(2*n*255) ~ 1.53e9 < 2^31 at n = 1M.

Limb lengths involve divisions and are NOT integers; the device
returns, per join, the exact integer observables (i, j, 2*D_ij, 2*sD_i,
2*sD_j in u units) and the host replays limbLength (nj.c:42-79) in
float64 — the identical op sequence on identical exact inputs as the C,
hence bit-identical printed limbs.

Join semantics are identical to tree/jax_engine.dnj_joins_q (complete
matrix, dtouc(d, 0.25) update quantization per nj.c:905, unquantized sD
bookkeeping per nj.c:907-911, scan="batch" revalidation with the
reference's last-wins tie rules).
"""

from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp

from ..io.qseqs import Name  # noqa: F401 (API type)
from ..ops.select import topk_mask_indices
from .jax_engine import _records_to_newick
from .segmenting import run_segmented

IBIG = np.int32(np.iinfo(np.int32).max)


def _bucket512(base: int) -> int:
    """Round a 512-multiple up to the next canonical size: above 16384
    rows, eighth-steps of powers of two (<= 12.5% row overhead).  The
    persistent compile cache only matches exact shapes, so bucketing
    lets one compile serve every n in the bucket (join records are
    npad-invariant — padding rows are inactive by the m_t masks — so
    results are unchanged, tested).  Whether the saved compiles are
    worth the padded rows every scan reads is not measured yet.
    Disable with CCPHYLO_TPU_BUCKET=0."""
    import os
    if base <= 16384 or os.environ.get("CCPHYLO_TPU_BUCKET",
                                       "1") == "0":
        return base
    step = 1 << ((base - 1).bit_length() - 4)
    return -(-base // step) * step


def _pad_packed(n: int, nb: int = 1) -> int:
    """Rows padded to a multiple of 512 (word width W = npad/4 is then
    a multiple of 128), then to a canonical compile-cache bucket.  `nb`
    is accepted for API compatibility with the old blocked layout and
    ignored."""
    return _bucket512(max(-(-n // 512) * 512, 512))


def _unpack_words(w):
    """(..., W) uint32 -> (..., 4W) uint32 byte values (little-endian
    lanes: cell 4k+b is byte b of word k)."""
    ff = jnp.uint32(0xFF)
    b = jnp.stack([(w >> jnp.uint32(s)) & ff for s in (0, 8, 16, 24)],
                  axis=-1)
    return b.reshape(*w.shape[:-1], w.shape[-1] * 4)


def _pack_bytes(v):
    """(..., 4W) uint32 byte values -> (..., W) uint32 words."""
    r = v.reshape(*v.shape[:-1], v.shape[-1] // 4, 4)
    return (r[..., 0] | (r[..., 1] << jnp.uint32(8))
            | (r[..., 2] << jnp.uint32(16))
            | (r[..., 3] << jnp.uint32(24)))


def qrow_mins(words, sD2, rows, co, idx):
    """Q-row minima of the DNJ batch scan: gather the K rows `rows` of
    the packed matrix, unpack, form the integer Q row
    q[c] = co*cell[r, c] - sD2[r] - sD2[c] over c < r, and reduce.

    words: (n, W) uint32; sD2: (n,) int32 row sums in u units; rows:
    (K,) int32 (entries may repeat; 0 marks padding, whose lanes the
    caller masks); co: int32 scalar; idx: (n,) int32 column indices.
    Returns (rmin, rarg) int32 (K,): the row minimum and the LARGEST
    column achieving it (the engine's last-wins tie rule)."""
    big = jnp.int32(IBIG)
    cells = _unpack_words(words[rows]).astype(jnp.int32)    # (K, n)
    q = co * cells - sD2[rows][:, None] - sD2[None, :]
    q = jnp.where(idx[None, :] < rows[:, None], q, big)
    rmin = q.min(axis=1)
    rarg = jnp.where(q == rmin[:, None], idx[None, :], -1) \
        .max(axis=1).astype(jnp.int32)
    return rmin, rarg


def _mk_one_join_packed(n, W, m, kbatch):
    """one_join body over the single u32-packed buffer; m is a traced
    scalar closed over.  All arithmetic int32 in u = 1/(2*ByteScale)
    units; cells read as c (quantized byte), Q as 2*(m_t-2)*c - 2sD_i -
    2sD_k."""
    big = jnp.int32(IBIG)
    # materialized constant, not an iota: with the iota form XLA's
    # buffer assignment has copied the whole words buffer into the
    # scan-while state (an n^2-byte temp); the constant keeps it
    # aliased.  Not yet checked on the GPU compiler.
    idx = jnp.asarray(np.arange(n, dtype=np.int32))
    ff = jnp.uint32(0xFF)

    def cells_of(words_vals):
        return _unpack_words(words_vals).astype(jnp.int32)

    def read_row(words, r):
        return jax.lax.dynamic_slice(words, (r, jnp.int32(0)),
                                     (1, W))[0]

    def last_min(q):
        mn = q.min()
        return mn, jnp.where(q == mn, idx, -1).max().astype(jnp.int32)

    def one_join(t, carry):
        (words, sD2, Q, P, seed, I, J, DIJ2, SDI2, SDJ2,
         stats) = carry
        m_t = m - t
        co = 2 * (m_t - 2)  # Q row coefficient on raw cells

        seed_ok = (seed != 0) & (Q[seed] != big)
        minv0 = jnp.where(seed_ok, Q[seed], big)
        pi0 = jnp.where(seed_ok, seed, 0)
        pj0 = jnp.where(seed_ok, P[seed], 0)

        def cand_mask(Q, minv):
            return (idx >= 1) & (idx < m_t) & (Q < minv)

        def bcond(c):
            return cand_mask(c[3], c[0]).any()

        # `words` rides the while carry as an explicit pass-through:
        # a buffer merely CLOSED OVER by the loop body gets threaded
        # into the while state as a defensive copy (an n^2-byte HLO
        # temp), while an explicit carry leaf aliases in place.
        def bbody(c):
            minv, pi, pj, Q, P, np_, words = c
            cm = cand_mask(Q, minv)
            rows = topk_mask_indices(cm, idx, kbatch)
            valid = rows >= 1
            r = jnp.where(valid, rows, 0)
            rmin, rarg = qrow_mins(words, sD2, r, co, idx)
            # C-exact cache gating (see jax_engine.dnj_joins batch_scan)
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
                    jnp.where(better, karg, pj), Q, P, np_ + 1, words)

        Q_pre = Q
        minv, pi, pj, Q, P, np_, words = jax.lax.while_loop(
            bcond, bbody, (minv0, pi0, pj0, Q, P, jnp.int32(0), words))
        # stats: [0] scan passes, [1] rows whose cache changed (~reval)
        stats = stats.at[0].add(np_)
        stats = stats.at[1].add((Q != Q_pre).sum(dtype=jnp.int32))
        hp = (pi != 0) | (pj != 0)
        i, j = pi, pj

        rowi_w = read_row(words, i)
        rowj_w = read_row(words, j)
        ci = cells_of(rowi_w)                               # (n,)
        cj = cells_of(rowj_w)
        cij = ci[j]

        # limb observables (limbLength runs on PRE-update sD, nj.c:42)
        DIJ2 = DIJ2.at[t].set(jnp.where(hp, 2 * cij, 0))
        SDI2 = SDI2.at[t].set(jnp.where(hp, sD2[i], 0))
        SDJ2 = SDJ2.at[t].set(jnp.where(hp, sD2[j], 0))

        # updateD, complete-matrix both-path only (nj.c:893-948):
        # d_new = max((D_ik + D_kj - D_ij)/2, 0) = (ci+cj-cij)*u
        active = idx < m_t
        valid_k = active & (idx != i) & (idx != j) & hp
        d_new_u = jnp.maximum(ci + cj - cij, 0)
        # sD bookkeeping on UNQUANTIZED updates (nj.c:907-911)
        sD2 = jnp.where(valid_k, sD2 - (2 * ci + 2 * cj - d_new_u),
                        sD2)
        sD2 = sD2.at[j].set(jnp.where(
            hp, jnp.where(valid_k, d_new_u, 0).sum(dtype=jnp.int32),
            sD2[j]))
        # dtouc(d, 0.25) (bytescale.h:22): floor(d_u/2 + 1/4)
        q_new = jnp.minimum((2 * d_new_u + 1) >> 2, 255) \
            .astype(jnp.uint32)
        # gating note: when !hp (or for rows outside valid_k) the
        # written values equal the existing bytes, so the unconditional
        # dynamic_update_slice writes are no-ops — no index games (DUS
        # clamps out-of-range starts, which would corrupt real rows)
        rowj_bytes = jnp.where(valid_k, q_new, _unpack_words(rowj_w))
        words = jax.lax.dynamic_update_slice(
            words, _pack_bytes(rowj_bytes)[None, :], (j, jnp.int32(0)))
        # column maintenance WITHOUT a column read-modify-write: rows
        # and columns are symmetric at all times, so word column jw's
        # four byte lanes equal the four sibling rows 4jw..4jw+3 (row
        # j freshly written above).  Rebuild the word column from
        # post-write row reads — patching each sibling lane at the
        # just-rewritten row's index, whose fresh cells the stale
        # sibling rows don't reflect yet — and write it
        # unconditionally.  No dynamic lane shifts, no RMW dependency
        # on the big buffer: the RMW formulation made XLA assign the
        # scan loop a {1,0} layout for `words` and insert a full
        # layout-conversion copy of it per join (an n^2-byte copy in
        # the optimized HLO).
        def write_word_col(words, wcol, srow, srow_bytes):
            lanes = []
            for la in range(4):
                lane = _unpack_words(read_row(words, 4 * wcol + la))
                lanes.append(lane.at[srow].set(
                    srow_bytes[4 * wcol + la]))
            colw = (lanes[0] | (lanes[1] << jnp.uint32(8))
                    | (lanes[2] << jnp.uint32(16))
                    | (lanes[3] << jnp.uint32(24)))
            return jax.lax.dynamic_update_slice(
                words, colw[:, None], (jnp.int32(0), wcol))

        words = write_word_col(words, j // 4, j, rowj_bytes)

        # cache repair for column j + fresh row j (reads see quantized;
        # post-updateD N = m_t - 1 -> (N_j + N_k - 4) >> 1 = m_t - 3)
        co_post = 2 * (m_t - 3)
        cj_post = rowj_bytes.astype(jnp.int32)
        qj = co_post * cj_post - sD2[j] - sD2
        qj = jnp.where(idx < j, qj, big)
        Qj, Pj = last_min(qj)
        Q = Q.at[j].set(jnp.where(hp, Qj, Q[j]))
        P = P.at[j].set(jnp.where(hp, jnp.where(Qj == big, 0, Pj),
                                  P[j]))
        # column j's post-update cells == the freshly written row j
        colj = rowj_bytes.astype(jnp.int32)
        qcol = co_post * colj - sD2[j] - sD2
        colk = valid_k & (idx > j)
        upd = colk & (qcol <= Q)
        Q = jnp.where(upd, qcol, Q)
        P = jnp.where(upd, j, P)
        mq = jnp.where(upd, qcol, big).min()
        mi_cand = jnp.where(upd.any() & (mq <= Qj),
                            jnp.where(upd & (qcol == mq), idx, -1).max(),
                            j).astype(jnp.int32)

        # popArrange: move row `last` into slot i (dnj.c:817-975)
        m_new = m_t - 1
        last = m_new
        g = hp & (i != last)
        move_bytes = _unpack_words(read_row(words, last))
        rowi_old_bytes = _unpack_words(rowi_w)
        newrow_i = jnp.where(idx == i, jnp.uint32(0), move_bytes)
        rowi_bytes = jnp.where(g, newrow_i, rowi_old_bytes)
        words = jax.lax.dynamic_update_slice(
            words, _pack_bytes(rowi_bytes)[None, :], (i, jnp.int32(0)))
        words = write_word_col(words, i // 4, i, rowi_bytes)
        sD2 = sD2.at[i].set(jnp.where(g, sD2[last], sD2[i]))
        ci_post = rowi_bytes.astype(jnp.int32)
        qi = co_post * ci_post - sD2[i] - sD2
        qi = jnp.where(idx < i, qi, big)
        Qi, Pi = last_min(qi)
        Q = Q.at[i].set(jnp.where(g, Qi, Q[i]))
        P = P.at[i].set(jnp.where(g, jnp.where(Qi == big, 0, Pi),
                                  P[i]))
        # column i's post-move cells == the freshly written row i
        coli = rowi_bytes.astype(jnp.int32)
        qc = co_post * coli - sD2[i] - sD2
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

        # seed chaining (dnj.c:1026-1032)
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
        return (words, sD2, Q, P, seed, I, J, DIJ2, SDI2, SDJ2,
                stats)

    return one_join


# ---------------------------------------------------------------------
# init: chunked device programs over a non-donated input buffer.  The
# buffer must NOT be threaded through lax.scan/while state (defensive
# copy of the whole matrix) nor donated-and-returned (same copy);
# instead each group call takes `words` as a plain input
# and unrolls static-shaped dynamic slices from a traced row offset —
# one compile serves every group.

_GROUP_ROWS = 8192
_CH = 512


@functools.partial(jax.jit, static_argnames=("gr", "n"))
def _sd2_group(words, r0, m, gr, n):
    W = words.shape[1]
    idx = jnp.arange(n)
    active0 = idx < m
    parts = []
    for k in range(gr // _CH):
        rows = r0 + k * _CH + jnp.arange(_CH)
        blk = jax.lax.dynamic_slice(
            words, (r0 + jnp.int32(k * _CH), jnp.int32(0)), (_CH, W))
        cells = _unpack_words(blk).astype(jnp.int32)
        v = active0[None, :] & (rows[:, None] != idx[None, :])
        # integer sums are order-exact; no cumsum needed
        parts.append(
            2 * jnp.where(v, cells, 0).sum(axis=1, dtype=jnp.int32))
    return jnp.concatenate(parts)


@functools.partial(jax.jit, static_argnames=("gr", "n"))
def _qp_group(words, sD2, r0, m, gr, n):
    W = words.shape[1]
    big = jnp.int32(IBIG)
    idx = jnp.arange(n)
    active0 = idx < m
    co0 = 2 * (m - 2)
    qs, ps = [], []
    for k in range(gr // _CH):
        rows = r0 + k * _CH + jnp.arange(_CH)
        blk = jax.lax.dynamic_slice(
            words, (r0 + jnp.int32(k * _CH), jnp.int32(0)), (_CH, W))
        cells = _unpack_words(blk).astype(jnp.int32)
        lv = (active0[rows][:, None] & active0[None, :]
              & (idx[None, :] < rows[:, None]))
        Qm = jnp.where(lv, co0 * cells - sD2[rows][:, None]
                       - sD2[None, :], big)
        Qc = Qm.min(axis=1)
        # initHNJ tie rule (hclust.c:110-116): among equal-Q candidates
        # ascending, accept while the raw distance is a running minimum
        cand = lv & (Qm == Qc[:, None])
        dmask = jnp.where(cand, cells, big)
        prefmin = jax.lax.cummin(dmask, axis=1)
        sel = cand & (dmask == prefmin)
        Pc = jnp.where(sel, idx[None, :], -1).max(axis=1) \
            .astype(jnp.int32)
        qs.append(Qc)
        ps.append(jnp.maximum(Pc, 0))
    return jnp.concatenate(qs), jnp.concatenate(ps)


@functools.partial(jax.jit, static_argnames=("n",))
def _seed_init(Q, P, m, n):
    big = jnp.int32(IBIG)
    idx = jnp.arange(n)
    active0 = idx < m
    Qa = jnp.where(active0, Q, big)
    qrows = jnp.where((idx >= 1) & active0, Qa, big)
    mn0 = qrows.min()
    seed0 = jnp.where(active0.sum() > 1,
                      jnp.where(qrows == mn0, idx, -1).max(), 0) \
        .astype(jnp.int32)
    return Qa, seed0


def _packed_init(words, m):
    """initSummaD + initHNJ + seed over the packed buffer (complete
    matrix: N_k = m for every row).  Returns int32 (sD2, Q, P, seed)."""
    n = words.shape[0]
    sd_parts, qp_parts = [], []
    r0 = 0
    while r0 < n:
        gr = min(_GROUP_ROWS, n - r0)
        sd_parts.append(_sd2_group(words, jnp.int32(r0), m, gr=gr, n=n))
        r0 += gr
    sD2 = jnp.concatenate(sd_parts) if len(sd_parts) > 1 else sd_parts[0]
    r0 = 0
    while r0 < n:
        gr = min(_GROUP_ROWS, n - r0)
        qp_parts.append(_qp_group(words, sD2, jnp.int32(r0), m, gr=gr,
                                  n=n))
        r0 += gr
    Q = jnp.concatenate([q for q, _ in qp_parts]) \
        if len(qp_parts) > 1 else qp_parts[0][0]
    P = jnp.concatenate([p for _, p in qp_parts]) \
        if len(qp_parts) > 1 else qp_parts[0][1]
    Q, seed0 = _seed_init(Q, P, m, n=n)
    return sD2, Q, P, seed0


@functools.partial(jax.jit, static_argnames=("kbatch",),
                   donate_argnums=tuple(range(11)))
def _packed_segment(words, sD2, Q, P, seed, I, J, DIJ2, SDI2, SDJ2,
                    stats, t0, t1, m, kbatch=128):
    n, W = words.shape
    one_join = _mk_one_join_packed(n, W, m, kbatch)
    return jax.lax.fori_loop(
        t0, t1, one_join,
        (words, sD2, Q, P, seed, I, J, DIJ2, SDI2, SDJ2, stats))


_STATE_KEYS = ("words", "sD2", "Q", "P", "seed", "I", "J", "DIJ2",
               "SDI2", "SDJ2", "stats")


def _ckpt_config():
    import os
    d = os.environ.get("CCPHYLO_TPU_CKPT", "")
    if not d:
        return None, 0.0
    try:
        every = float(os.environ.get("CCPHYLO_TPU_CKPT_EVERY_S", "300"))
    except ValueError:
        every = 300.0
    return d, every


def _ckpt_save(path, state, done, n, m, kbatch):
    import os
    import time as _t
    t0 = _t.perf_counter()
    payload = {k: np.asarray(v) for k, v in zip(_STATE_KEYS, state)}
    payload["meta"] = np.array([done, n, m, kbatch], np.int64)
    tmp = path + ".tmp.npz"  # .npz suffix: savez must not append one
    np.savez(tmp, **payload)
    os.replace(tmp, path)
    return _t.perf_counter() - t0


def _ckpt_load(path, n, m, kbatch):
    try:
        d = np.load(path)
    except (OSError, ValueError):
        return None, 0
    meta = d["meta"]
    if int(meta[1]) != n or int(meta[2]) != m or int(meta[3]) != kbatch:
        return None, 0
    state = tuple(jnp.asarray(d[k]) for k in _STATE_KEYS)
    return state, int(meta[0])


def dnj_joins_packed(words, m, kbatch: int = 128, hooks=None):
    """All m-2 DNJ joins over the single u32-packed u8 matrix
    (host-segmented dispatch, see tree/segmenting.py).

    words: (npad, W) uint32 with npad == 4W (use `pack_words`); m:
    active taxa.  Returns (I, J, DIJ2, SDI2, SDJ2, d_last2, words) —
    int32 join records in u = 1/(2*ByteScale) units (see module doc;
    convert limbs with `limbs_host`).  words is donated and returned so
    XLA aliases it in place.  `hooks`, if given, is passed through to
    run_segmented (extra instrumentation callbacks).

    Checkpoint/resume (reference analog: printphyUpdate's resumable
    growth, phy.c:201-249): set CCPHYLO_TPU_CKPT=/path/file.npz to
    snapshot the full device state every CCPHYLO_TPU_CKPT_EVERY_S
    seconds (default 300) at a fenced segment boundary — atomic
    replace, so a kill mid-write keeps the previous snapshot.  On the
    next call with matching (n, m, kbatch) the run resumes from the
    snapshot and, because the engine is exact-integer, produces
    byte-identical records to an uninterrupted run.
    """
    import os
    import time as _t
    n, W = words.shape
    assert 4 * W == n, "words must tile a square byte matrix"
    m_host = int(m)
    mj = jnp.int32(m_host)

    ckpt_path, ckpt_every = _ckpt_config()
    state, start = (None, 0)
    if ckpt_path and os.path.exists(ckpt_path):
        state, start = _ckpt_load(ckpt_path, n, m_host, kbatch)
    if state is None:
        sD2, Q, P, seed = _packed_init(words, mj)
        state = (words, sD2, Q, P, seed,
                 jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
                 jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
                 jnp.zeros(n, jnp.int32), jnp.zeros(4, jnp.int32))
        start = 0

    def seg_call(state, t0, t1):
        return _packed_segment(*state, jnp.int32(t0), jnp.int32(t1),
                               mj, kbatch=kbatch)

    last_ckpt = [_t.perf_counter()]

    def _hooks(state, done, total):
        if ckpt_path and done < total \
                and _t.perf_counter() - last_ckpt[0] >= ckpt_every:
            _ckpt_save(ckpt_path, state, done, n, m_host, kbatch)
            last_ckpt[0] = _t.perf_counter()
        if hooks is not None:
            hooks(state, done, total)

    state = run_segmented(seg_call, state, max(m_host - 2, 0),
                          hooks=_hooks, start=start)
    words, sD2, Q, P, seed, I, J, DIJ2, SDI2, SDJ2, stats = state
    d_last2 = 2 * (words[1, 0] & jnp.uint32(0xFF)).astype(jnp.int32)
    dnj_joins_packed.last_stats = np.asarray(stats)
    if ckpt_path and os.path.exists(ckpt_path):
        try:
            os.remove(ckpt_path)  # completed: snapshot no longer valid
        except OSError:
            pass
    return I, J, DIJ2, SDI2, SDJ2, d_last2, words


def limbs_host(I, J, DIJ2, SDI2, SDJ2, m: int, bytescale: float,
               neg_limbs: bool = False):
    """Replay limbLength (nj.c:42-79) in float64 from the exact integer
    join observables.  Complete matrices: N_i = N_j = m_t at join t.
    Identical op sequence on identical (f64-exact for dyadic ByteScale)
    inputs as the C — bit-identical limbs."""
    T = max(m - 2, 0)
    inv = 1.0 / (2.0 * float(bytescale))
    Dij = np.asarray(DIJ2[:T], np.float64) * inv
    sDi = np.asarray(SDI2[:T], np.float64) * inv
    sDj = np.asarray(SDJ2[:T], np.float64) * inv
    m_t = float(m) - np.arange(T, dtype=np.float64)
    Ni = m_t - 2.0
    pos = Ni > 0
    delta = np.where(pos, (sDi - Dij) / np.maximum(Ni, 1.0)
                     - (sDj - Dij) / np.maximum(Ni, 1.0), 0.0)
    Li = np.where(pos, (Dij + delta) / 2.0, Dij / 2.0)
    Lj = np.where(pos, (Dij - delta) / 2.0, Dij / 2.0)
    if not neg_limbs:
        Li_c = np.where(Li < 0, 0.0, np.where(Lj < 0, Dij, Li))
        Lj_c = np.where(Li < 0, Dij, np.where(Lj < 0, 0.0, Lj))
        Li, Lj = Li_c, Lj_c
    return Li, Lj


def pack_words(Dq_bytes: np.ndarray):
    """(npad, npad) uint8 host matrix -> (npad, W) uint32 words."""
    npad = Dq_bytes.shape[0]
    assert npad % 4 == 0 and Dq_bytes.dtype == np.uint8
    words = Dq_bytes.reshape(npad, npad // 4, 4).view(np.uint32) \
        .reshape(npad, npad // 4)  # little-endian byte lanes
    return jnp.asarray(words)


def pack_blocks(Dq_bytes: np.ndarray, nb: int):
    """Round-3 compatibility shim: the blocked layout is gone; returns
    the single words buffer regardless of `nb`."""
    return pack_words(Dq_bytes)


def build_tree_jax_packed(flat64: np.ndarray, n: int, names: list[Name],
                          flag: int = 0, precision: int = 9,
                          bytescale: float = 1.0, nb: int = 1,
                          compute_dtype=None) -> bytes:
    """Device DNJ over packed-u8 storage; Newick bytes (no ';').

    Loads quantize like loadPhy -b (round 0.5, phy.c:473-475); complete
    matrices only (quantized storage cannot represent missing cells,
    matrix.h:23-33).  `nb`/`compute_dtype` are accepted for API
    compatibility and ignored — the engine is exact-integer on device
    (bit-identical records on every backend)."""
    npad = _pad_packed(n)
    Dq = np.zeros((npad, npad), np.uint8)
    iu = np.tril_indices(n, -1)
    qv = np.floor(np.asarray(flat64, np.float64) * bytescale + 0.5)
    qv = np.clip(qv, 0, 255).astype(np.uint8)
    Dq[(iu[0], iu[1])] = qv
    Dq[(iu[1], iu[0])] = qv
    words = pack_words(Dq)
    I, J, DIJ2, SDI2, SDJ2, d_last2, _ = dnj_joins_packed(
        words, jnp.int32(n))
    LI, LJ = limbs_host(I, J, DIJ2, SDI2, SDJ2, n, bytescale,
                        neg_limbs=bool(flag & 2))
    LI_full = np.zeros(npad, np.float64)
    LJ_full = np.zeros(npad, np.float64)
    LI_full[:max(n - 2, 0)] = LI
    LJ_full[:max(n - 2, 0)] = LJ
    d_last = float(np.asarray(d_last2)) / (2.0 * float(bytescale))
    return _records_to_newick(I, J, LI_full, LJ_full, d_last, n, names,
                              flag, precision)
