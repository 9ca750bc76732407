"""Mesh-sharded Dynamic Neighbor-Joining (the 100k-1M-taxa engine).

The reference scales DNJ with pthread row scans over shared memory and
mmap out-of-core matrices (dnj.c:505-605, matrix.c:116).  Device
redesign: the square distance matrix is row-block sharded over a device
mesh (device memory is the pool; a 1M-taxa f32 matrix is 4 TB), and
every join runs as

  1. *sharded candidate revalidation*: each device keeps the DNJ row
     caches (Q[i], P[i]) for its own row block and recomputes only rows
     whose cached bound beats the running global minimum, in fused
     (K, n) blocks (the sharded version of tree/jax_engine.py's
     scan="batch"); candidate picks merge with a deterministic
     allreduce-argmin (value min, larger global row wins a
     tie — the same rule as the single-chip batch engine).
  2. *join application*: the two merged rows are psum-broadcast
     (O(n) each); every device updates its own rows' column entries and
     sD/N/Q/P locally; the owners of the merged and moved slots rebuild
     their full rows from the broadcasts; swap-with-last compaction and
     the updateDNJ cache-repair rules (`qcol <= Q` refresh + mi/mj
     seed chaining, dnj.c:607-975) follow the reference exactly.

The join records equal tree/jax_engine.py's scan="batch" engine (and
therefore the C reference's trajectory, ties included) for any device
count: batches are selected in global descending row order via a
shared row threshold, and the C's running-min gating threads across
devices through the all-gathered batch minima (see bbody).

Missing data (negative cells) follows nj.c:836-1044: per-pair N
bookkeeping, one-sided update fallbacks, and the early stop when no
joinable pair remains.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..io.qseqs import Name
from ..ops.select import topk_mask_indices
from ..tree.jax_engine import _ltd_row_of
from ..tree.newick_build import (byteshift_fix, form_last_bi_node,
                                 form_last_node, form_node)

shard_map = jax.shard_map

KBATCH = 32  # candidate rows revalidated per device per pass


def _pad_to(n: int, mult: int) -> int:
    return max(-(-n // mult) * mult, mult)


@functools.lru_cache(maxsize=None)
def _dnj_programs(mesh: Mesh, axis: str, npad: int, n: int,
                  dtype_name: str, neg: bool):
    """(init, segment) jitted shard_map programs.

    The join loop dispatches as host-driven segments
    (tree/segmenting.py) exactly like the single-device engines."""
    dtype = jnp.dtype(dtype_name)
    ndev = mesh.shape[axis]
    R = npad // ndev
    big = jnp.asarray(np.finfo(np.dtype(dtype)).max, dtype)
    cols = jnp.arange(npad)
    lidx = jnp.arange(R)

    def body_init(Dl):
        dev = jax.lax.axis_index(axis)
        gi = dev * R + lidx  # global indices of my rows

        # --- init: sD, N (initSummaD) + row caches (initHNJ) ---------
        act0 = cols < n
        actl0 = act0[gi]
        validl = (actl0[:, None] & act0[None, :] & (Dl >= 0)
                  & (gi[:, None] != cols[None, :]))
        sDl = jnp.where(validl, Dl, 0).sum(axis=1, dtype=dtype)
        Nl = 1 + validl.sum(axis=1, dtype=jnp.int32)
        sDg = jax.lax.all_gather(sDl, axis, tiled=True)
        Ng = jax.lax.all_gather(Nl, axis, tiled=True)
        coef = ((Nl[:, None] + Ng[None, :] - 4) >> 1).astype(dtype)
        lvalid = validl & (cols[None, :] < gi[:, None])
        Qm = jnp.where(lvalid, coef * Dl - sDl[:, None] - sDg[None, :],
                       big)
        Ql = Qm.min(axis=1)
        # initHNJ tie rule: among equal-Q ascending, running-min raw D
        candm = lvalid & (Qm == Ql[:, None])
        dmask = jnp.where(candm, Dl, big)
        prefmin = jax.lax.cummin(dmask, axis=1)
        sel = candm & (dmask == prefmin)
        Pl = jnp.where(sel, cols[None, :], -1).max(axis=1) \
            .astype(jnp.int32)
        Pl = jnp.maximum(Pl, 0)
        Ql = jnp.where(actl0, Ql, big)

        # initial seed: global last-wins min over caches
        q0 = jnp.where((gi >= 1) & actl0, Ql, big)
        lmin = q0.min()
        lrow = jnp.where(q0 == lmin, gi, -1).max()
        cands0 = jax.lax.all_gather(
            jnp.stack([lmin, lrow.astype(dtype)]), axis)
        gmin0 = cands0[:, 0].min()
        seed0 = jnp.where(cands0[:, 0] == gmin0, cands0[:, 1],
                          -1.0).max().astype(jnp.int32)
        seed0 = jnp.maximum(seed0, 0)
        return sDl, Nl, Ql, Pl, seed0

    def body_seg(Dl, sDl, Nl, Ql, Pl, seed, I, J, LI, LJ, t0, t1):
        dev = jax.lax.axis_index(axis)
        gi = dev * R + lidx  # global indices of my rows

        def own_row(r):
            """(is_mine, local_index) for global row r."""
            return (r // R) == dev, r % R

        def bcast_row(Dl, r):
            """psum-broadcast global row r of the live local block
            (O(n) across devices)."""
            own, lr = own_row(r)
            return jax.lax.psum(
                jnp.where(own, Dl[lr], jnp.zeros(npad, dtype)), axis)

        def get_scalar(vec_l, r, fill):
            own, lr = own_row(r)
            return jax.lax.psum(
                jnp.where(own, vec_l[lr].astype(dtype), fill), axis)

        def col_set(Dl, col, vals_l, on_l):
            """Column write as an aligned 128-column tile RMW: a
            traced-column scatter has materialized a fresh (R, npad)
            output every join (a whole-shard copy), while full-tile
            DS/DUS updates the loop carry in place.  Not measured on
            the GPU yet."""
            w0 = ((col // 128) * 128).astype(jnp.int32)
            tile = jax.lax.dynamic_slice(
                Dl, (jnp.int32(0), w0), (R, 128))
            l128 = jnp.arange(128)
            hit = (l128[None, :] == (col - w0)) & on_l[:, None]
            tile = jnp.where(hit, vals_l[:, None].astype(dtype), tile)
            return jax.lax.dynamic_update_slice(
                Dl, tile, (jnp.int32(0), w0))

        def row_set(Dl, lr_w, vals_f):
            """Row write with drop semantics via clamped DUS (same
            copy hazard as col_set for the row scatter)."""
            s = jnp.minimum(lr_w, R - 1).astype(jnp.int32)
            old = jax.lax.dynamic_slice(
                Dl, (s, jnp.int32(0)), (1, npad))
            new = jnp.where(lr_w < R, vals_f.astype(dtype), old[0])
            return jax.lax.dynamic_update_slice(
                Dl, new[None, :], (s, jnp.int32(0)))

        def one_join(t, carry):
            Dl, sDl, Nl, Ql, Pl, seed, I, J, LI, LJ = carry
            m_t = n - t

            # fresh global sD / N views (updated locally last join)
            sDg = jax.lax.all_gather(sDl, axis, tiled=True)
            Ng = jax.lax.all_gather(Nl, axis, tiled=True)

            # ---- seeded minimum + sharded batch revalidation --------
            seed_q = get_scalar(Ql, seed, jnp.asarray(0, dtype))
            seed_p = get_scalar(Pl, seed, jnp.asarray(0, dtype)) \
                .astype(jnp.int32)
            seed_ok = (seed != 0) & (seed_q != big)
            minv0 = jnp.where(seed_ok, seed_q, big)
            pi0 = jnp.where(seed_ok, seed, 0)
            pj0 = jnp.where(seed_ok, seed_p, 0)

            def cand_mask(Ql, minv):
                return (gi >= 1) & (gi < m_t) & (Ql < minv)

            def bcond(c):
                minv, pi, pj, Ql, Pl = c
                anyc = jax.lax.psum(
                    cand_mask(Ql, minv).sum(dtype=jnp.int32), axis)
                return anyc > 0

            def bbody(c):
                minv, pi, pj, Ql, Pl = c
                cm = cand_mask(Ql, minv)
                rows = topk_mask_indices(cm, lidx, KBATCH)  # local desc
                valid = rows >= 0
                # global-descending batch selection: agree on a row
                # threshold T = max over devices of each device's
                # KBATCH-th largest candidate row, and only process
                # candidates >= T this pass.  Every row processed in
                # pass p then globally precedes every row of pass p+1,
                # so folding pass minima into minv keeps the running
                # min in the C's exact descending visit order
                # (dnj.c:43-128); without this, a later pass's rm seed
                # would absorb minima of LOWER devices' rows that the C
                # visits only afterwards.
                kth = jnp.where(valid[KBATCH - 1],
                                dev * R + rows[KBATCH - 1], -1)
                thr = jax.lax.pmax(kth, axis)
                valid = valid & (gi[jnp.where(valid, rows, 0)] >= thr)
                r = jnp.where(valid, rows, 0)
                Drows = Dl[r]                                  # (K, npad)
                grow = gi[r]                                   # global
                c_ = ((Nl[r][:, None] + Ng[None, :] - 4) >> 1) \
                    .astype(dtype)
                q = c_ * Drows - sDl[r][:, None] - sDg[None, :]
                ok = (cols[None, :] < grow[:, None]) & (Drows >= 0)
                q = jnp.where(ok, q, big)
                rmin = q.min(axis=1)
                rarg = jnp.where(q == rmin[:, None], cols[None, :], -1) \
                    .max(axis=1).astype(jnp.int32)
                # local best (value min, larger global row wins ties)
                bvals = jnp.where(valid, rmin, big)
                bmin = bvals.min()
                bi = jnp.where(bvals == bmin, grow, -1).max()
                bj = jnp.where((bvals == bmin) & (grow == bi), rarg, 0) \
                    .max()
                # allreduce-argmin over devices, same tie rule
                cand = jnp.stack([bmin, bi.astype(dtype),
                                  bj.astype(dtype)])
                cs = jax.lax.all_gather(cand, axis)           # (ndev, 3)
                # C-exact cache gating (jax_engine.dnj_joins batch_scan)
                # across the global descending sweep: every row of a
                # higher device precedes this device's rows, so the rm
                # seed is min(minv, higher devices' batch minima); a
                # shifted cummin threads rm within the batch.
                rm_seed = jnp.minimum(minv, jnp.where(
                    jnp.arange(ndev) > dev, cs[:, 0], big).min())
                rm = jax.lax.cummin(
                    jnp.concatenate([rm_seed[None], bvals[:-1]]))
                qold = Ql[jnp.where(valid, rows, 0)]
                reval = valid & (qold < rm)
                tgt = jnp.where(reval, rows, R)
                Ql = Ql.at[tgt].set(jnp.where(reval, rmin, big),
                                    mode="drop")
                Pl = Pl.at[tgt].set(jnp.where(reval, rarg, 0),
                                    mode="drop")
                gmin = cs[:, 0].min()
                gim = jnp.where(cs[:, 0] == gmin, cs[:, 1], -1.0).max()
                gjm = jnp.where((cs[:, 0] == gmin) & (cs[:, 1] == gim),
                                cs[:, 2], 0.0).max()
                better = gmin < minv
                minv = jnp.where(better, gmin, minv)
                pi = jnp.where(better, gim.astype(jnp.int32), pi)
                pj = jnp.where(better, gjm.astype(jnp.int32), pj)
                return minv, pi, pj, Ql, Pl

            minv, pi, pj, Ql, Pl = jax.lax.while_loop(
                bcond, bbody, (minv0, pi0, pj0, Ql, Pl))
            have_pair = (pi != 0) | (pj != 0)
            hp = have_pair
            i, j = pi, pj

            # ---- join application (masked no-ops when no pair) ------
            rowi = bcast_row(Dl, i)
            rowj = bcast_row(Dl, j)
            D_ij = rowi[j]
            sD_i = sDg[i]
            sD_j = sDg[j]
            N_i = Ng[i]
            N_j = Ng[j]

            # limbs (nj.c:42-79)
            Ni = N_i - 2
            Nj = N_j - 2
            delta = jnp.where(
                (Ni > 0) & (Nj > 0),
                (sD_i - D_ij) / jnp.maximum(Ni, 1)
                - (sD_j - D_ij) / jnp.maximum(Nj, 1), 0.0)
            Li = jnp.where((Ni > 0) & (Nj > 0), (D_ij + delta) / 2,
                           jnp.where(Ni > 0, 0.0,
                                     jnp.where(Nj > 0, D_ij, D_ij / 2)))
            Lj = jnp.where((Ni > 0) & (Nj > 0), (D_ij - delta) / 2,
                           jnp.where(Ni > 0, D_ij,
                                     jnp.where(Nj > 0, 0.0, D_ij / 2)))
            if not neg:
                Li_c = jnp.where(Li < 0, 0.0, jnp.where(Lj < 0, D_ij, Li))
                Lj_c = jnp.where(Li < 0, D_ij, jnp.where(Lj < 0, 0.0, Lj))
                Li, Lj = Li_c, Lj_c

            # updateD (nj.c:836-1044) — replicated full-row view with
            # the reference's exact bookkeeping (walker-slot targets +
            # the nj.c:1022 out-of-row garbage read; see
            # jax_engine._update_d_exact for the single-chip twin)
            act = cols < m_t
            vi_f = rowi >= 0
            vj_f = rowj >= 0
            validk_f = act & (cols != i) & (cols != j) & hp
            both_f = validk_f & vi_f & vj_f
            oi_f = validk_f & vi_f & ~vj_f
            oj_f = validk_f & ~vi_f & vj_f
            dboth_f = jnp.maximum((rowi + rowj - D_ij) / 2, 0.0)
            stored_f = jnp.where(both_f, dboth_f,
                                 jnp.where(oi_f, rowi - Li,
                                           jnp.where(oj_f, rowj - Lj,
                                                     rowj)))
            adv_f = both_f | oi_f | oj_f
            adv_r = adv_f & (cols < j)
            adv_c = adv_f & (cols > j)
            wpos = jnp.cumsum(adv_r.astype(jnp.int32)) - 1
            wbase = adv_r.sum(dtype=jnp.int32)
            prevc = jnp.cumsum(adv_c.astype(jnp.int32)) - adv_c
            tgt = jnp.where(adv_r, wpos,
                            wbase + 1 + (cols > i).astype(jnp.int32)
                            + prevc)
            tgt = jnp.where(adv_f, tgt, npad)
            # out-of-row garbage for column-part only_j: ltd flat cell
            # off(j)+k, which may alias a column-j cell stored earlier
            # this sweep, or an arbitrary old cell (psum-gathered from
            # its owner)
            kk = jnp.maximum(cols, j + 1)
            r_g = _ltd_row_of(kk, j)
            c_g = kk - (r_g - j) * (r_g + j - 1) // 2
            colj_old_g = jax.lax.all_gather(Dl[:, j], axis, tiled=True)
            seen_g = (r_g < cols) & (r_g != i) & adv_c[r_g]
            garb_cj = jnp.where(r_g == cols, stored_f,
                                jnp.where(seen_g, stored_f[r_g],
                                          colj_old_g[r_g]))
            own_rg = (r_g // R) == dev
            other_l = Dl[r_g % R, c_g]
            garb_other = jax.lax.psum(
                jnp.where(own_rg, other_l, jnp.asarray(0, dtype)), axis)
            garb = jnp.where(c_g == j, garb_cj, garb_other)
            contrib_f = jnp.where(oj_f & (cols > j), stored_f - garb,
                                  stored_f)
            sd_src = jnp.where(both_f, -(rowi + rowj - dboth_f),
                               jnp.where(oi_f, -Li,
                                         jnp.where(oj_f & (cols < j),
                                                   -Lj, contrib_f)))
            sd_delta_g = jnp.zeros(npad, dtype).at[tgt].add(
                jnp.where(adv_f, sd_src, 0.0), mode="drop")
            n_delta_g = jnp.zeros(npad, jnp.int32).at[tgt].add(
                jnp.where(both_f | oj_f, -1, 0), mode="drop")
            sDj_new = jnp.cumsum(jnp.where(adv_f, contrib_f, 0),
                                 dtype=dtype)[-1]
            Nj_new = 1 + adv_f.sum(dtype=jnp.int32)
            newd_masked = jnp.where(validk_f, stored_f, -1.0)

            # my rows' local view
            validk_l = validk_f[gi]
            newd_l = stored_f[gi]
            sDl = sDl + sd_delta_g[gi]
            Nl = Nl + n_delta_g[gi]
            # owner writes go through drop-mode scatters (out-of-range
            # index when not mine / no pair) — a jnp.where over the
            # whole local block would cost O(R*n) per join
            ownj, lj = own_row(j)
            lj_w = jnp.where(ownj & hp, lj, R)
            sDl = sDl.at[lj_w].set(sDj_new, mode="drop")
            Nl = Nl.at[lj_w].set(Nj_new, mode="drop")
            # column j for my rows; row j for its owner
            Dl = col_set(Dl, j, newd_l, validk_l)
            rowj_new = jnp.where(validk_f, newd_masked, rowj)
            Dl = row_set(Dl, lj_w, rowj_new)

            # replicated new global sD / N (avoids a second all-gather)
            sDg2 = sDg + sd_delta_g
            sDg2 = sDg2.at[j].set(jnp.where(hp, sDj_new, sDg[j]))
            Ng2 = Ng + n_delta_g
            Ng2 = Ng2.at[j].set(jnp.where(hp, Nj_new, Ng[j]))

            # updateDNJ cache repair for column j + fresh row j cache
            qj_f = ((Ng2[j] + Ng2 - 4) >> 1).astype(dtype) * rowj_new \
                - sDg2[j] - sDg2
            okj = (cols < j) & (rowj_new >= 0)
            qj_f = jnp.where(okj, qj_f, big)
            Qj = qj_f.min()
            Pj = jnp.where(qj_f == Qj, cols, -1).max().astype(jnp.int32)
            Ql = Ql.at[lj_w].set(Qj, mode="drop")
            Pl = Pl.at[lj_w].set(jnp.where(Qj == big, 0, Pj),
                                 mode="drop")
            coefj_l = ((Ng2[j] + Nl - 4) >> 1).astype(dtype)
            qcol_l = coefj_l * Dl[:, j] - sDg2[j] - sDl
            colk_l = validk_l & (gi > j) & (Dl[:, j] >= 0)
            upd_l = colk_l & (qcol_l <= Ql)
            Ql = jnp.where(upd_l, qcol_l, Ql)
            Pl = jnp.where(upd_l, j, Pl)
            # mi candidate: global last-wins argmin over updated rows
            mql = jnp.where(upd_l, qcol_l, big)
            lmq = mql.min()
            lmi = jnp.where(mql == lmq, gi, -1).max()
            cu = jax.lax.all_gather(
                jnp.stack([lmq, lmi.astype(dtype)]), axis)
            gmq = cu[:, 0].min()
            gmi = jnp.where(cu[:, 0] == gmq, cu[:, 1], -1.0).max() \
                .astype(jnp.int32)
            anyu = gmq < big
            mi_cand = jnp.where(anyu & (gmq <= Qj), gmi, j)

            # ---- DNJ_popArrange: move row `last` into slot i --------
            m_new = m_t - 1
            last = m_new
            g = hp & (i != last)
            rowlast = bcast_row(Dl, last)
            # moved row, with its self-cell zero and old slot poisoned
            moved_f = rowlast.at[i].set(0.0).at[last].set(-1.0)
            owni, li = own_row(i)
            ownl, ll = own_row(last)
            li_w = jnp.where(g & owni, li, R)
            Dl = row_set(Dl, li_w, moved_f)
            Dl = col_set(Dl, i, moved_f[gi],
                         jnp.broadcast_to(g, (R,)))
            sD_last = sDg2[last]
            N_last = Ng2[last]
            sDl = sDl.at[li_w].set(sD_last, mode="drop")
            Nl = Nl.at[li_w].set(N_last, mode="drop")
            sDg2 = sDg2.at[i].set(jnp.where(g, sD_last, sDg2[i]))
            Ng2 = Ng2.at[i].set(jnp.where(g, N_last, Ng2[i]))
            # fresh cache for the moved slot (replicated compute)
            qi_f = ((Ng2[i] + Ng2 - 4) >> 1).astype(dtype) * moved_f \
                - sDg2[i] - sDg2
            oki = (cols < i) & (moved_f >= 0)
            qi_f = jnp.where(oki, qi_f, big)
            Qi = qi_f.min()
            Pi = jnp.where(qi_f == Qi, cols, -1).max().astype(jnp.int32)
            Ql = Ql.at[li_w].set(Qi, mode="drop")
            Pl = Pl.at[li_w].set(jnp.where(Qi == big, 0, Pi),
                                 mode="drop")
            # column pass: rows i < k < last see cell (k, i)
            coefi_l = ((Ng2[i] + Nl - 4) >> 1).astype(dtype)
            qc_l = coefi_l * Dl[:, i] - sDg2[i] - sDl
            ck_l = (gi > i) & (gi < last) & (Dl[:, i] >= 0) & g
            u2_l = ck_l & (qc_l <= Ql)
            Ql = jnp.where(u2_l, qc_l, Ql)
            Pl = jnp.where(u2_l, i, Pl)
            mq2l = jnp.where(u2_l, qc_l, big)
            lmq2 = mq2l.min()
            lmi2 = jnp.where(mq2l == lmq2, gi, -1).max()
            cu2 = jax.lax.all_gather(
                jnp.stack([lmq2, lmi2.astype(dtype)]), axis)
            gmq2 = cu2[:, 0].min()
            gmi2 = jnp.where(cu2[:, 0] == gmq2, cu2[:, 1], -1.0).max() \
                .astype(jnp.int32)
            p2 = jnp.where((gmq2 < big) & (gmq2 <= Qi), gmi2, i)
            mj_cand = jnp.where(g, p2, 0)
            # retire the vacated slot
            ll_w = jnp.where(ownl, ll, R)
            Ql = Ql.at[ll_w].set(big, mode="drop")

            # seed chaining (dnj.c:1026-1032)
            Qmi = get_scalar(Ql, mi_cand, jnp.asarray(0, dtype))
            Qmj = get_scalar(Ql, mj_cand, jnp.asarray(0, dtype))
            seed_new = jnp.where(
                mj_cand == m_new, mi_cand,
                jnp.where(mi_cand == m_new, mj_cand,
                          jnp.where((Qmj < Qmi)
                                    | ((mi_cand < mj_cand)
                                       & (Qmj == Qmi)),
                                    mj_cand, mi_cand)))
            seed = jnp.where(hp, seed_new, 0)

            I = I.at[t].set(jnp.where(hp, i, 0))
            J = J.at[t].set(jnp.where(hp, j, 0))
            LI = LI.at[t].set(jnp.where(hp, Li, -1.0))
            LJ = LJ.at[t].set(jnp.where(hp, Lj, -1.0))
            return Dl, sDl, Nl, Ql, Pl, seed, I, J, LI, LJ

        carry = (Dl, sDl, Nl, Ql, Pl, seed, I, J, LI, LJ)
        return jax.lax.fori_loop(t0, t1, one_join, carry)

    init_fn = jax.jit(shard_map(
        body_init, mesh=mesh, in_specs=(P(axis, None),),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P()),
        check_vma=False))
    seg_fn = jax.jit(
        shard_map(body_seg, mesh=mesh,
                  in_specs=(P(axis, None),) + (P(axis),) * 4
                  + (P(),) * 7,
                  out_specs=(P(axis, None),) + (P(axis),) * 4
                  + (P(),) * 5,
                  check_vma=False),
        donate_argnums=tuple(range(10)))
    return init_fn, seg_fn


def sharded_dnj_records(D: np.ndarray, n: int, mesh: Mesh,
                        axis: str = "d", dtype=jnp.float32,
                        neg: bool = False):
    """Run the sharded DNJ loop; returns host (I, J, LI, LJ, d_last).

    D: (n, n) square distance matrix (missing < 0, diag 0).  Join
    records use the engine's swap-with-last slot convention (the same
    as tree/jax_engine.py).
    """
    if n < 3:
        raise ValueError("need at least 3 taxa")
    ndev = mesh.shape[axis]
    npad = _pad_to(n, 128 * ndev)
    dt = jnp.dtype(dtype)
    Dp = np.full((npad, npad), -1.0, dt)
    Dp[:n, :n] = D[:n, :n]
    np.fill_diagonal(Dp[:n, :n], 0.0)
    # every process holds the full host matrix; each contributes its
    # addressable shards (multi-process safe, unlike a plain
    # device_put onto a global sharding)
    Dd = jax.make_array_from_callback(
        Dp.shape, NamedSharding(mesh, P(axis, None)),
        lambda idx: Dp[idx])
    init_fn, seg_fn = _dnj_programs(mesh, axis, npad, n, dt.name, neg)
    sDd, Nd, Qd, Pd, seed = init_fn(Dd)
    rep = NamedSharding(mesh, P())
    T = max(n - 2, 1)
    zi = jax.device_put(np.zeros(T, np.int32), rep)
    zj = jax.device_put(np.zeros(T, np.int32), rep)
    zli = jax.device_put(np.zeros(T, dt), rep)
    zlj = jax.device_put(np.zeros(T, dt), rep)
    state = (Dd, sDd, Nd, Qd, Pd, seed, zi, zj, zli, zlj)

    def seg_call(state, t0, t1):
        return seg_fn(*state, jnp.int32(t0), jnp.int32(t1))

    from ..tree.segmenting import run_segmented
    state = run_segmented(seg_call, state, max(n - 2, 0))
    Dd, sDd, Nd, Qd, Pd, seed, I, J, LI, LJ = state
    d_last = Dd[1, 0]
    return tuple(np.asarray(x) for x in (I, J, LI, LJ, d_last))


def build_tree_sharded_dnj(flat64: np.ndarray, n: int, names: list[Name],
                           mesh: Mesh, axis: str = "d", flag: int = 0,
                           precision: int = 9,
                           dtype=jnp.float32) -> bytes:
    """Newick bytes (no ';') via the sharded DNJ engine."""
    D = np.full((n, n), -1.0, np.float64)
    iu = np.tril_indices(n, -1)
    D[(iu[0], iu[1])] = flat64
    D[(iu[1], iu[0])] = flat64
    np.fill_diagonal(D, 0.0)
    I, J, LI, LJ, d_last = sharded_dnj_records(D, n, mesh, axis, dtype,
                                               neg=bool(flag & 2))
    m = n
    for t in range(max(n - 2, 0)):
        i, j = int(I[t]), int(J[t])
        if i == 0 and j == 0:
            break
        form_node(names[j], names[i], float(LJ[t]), float(LI[t]),
                  precision)
        m -= 1
        names[i], names[m] = names[m], names[i]
    last = form_last_bi_node if (flag & 1) else form_last_node
    if m == 2:
        last(names[0], names[1], float(d_last), precision)
    else:
        while m > 1:
            m -= 1
            last(names[0], names[m], -1.0, precision)
    byteshift_fix(names[0])
    return names[0].data
