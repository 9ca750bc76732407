"""Mesh-sharded neighbor-joining / UPGMA join loops.

The scale path for huge matrices (reference: pthread row scans over a
shared-memory ltd matrix, nj.c:412-522 / dnj.c:505-605, with mmap
out-of-core at matrix.c:116).  Device redesign: the full square
distance matrix is row-block sharded over a device mesh; every join
iteration does

  1. a local masked argmin over each device's row block,
  2. an allreduce-argmin (``lax.all_gather`` of the per-device
     candidates — the reference's shared global (Min, Pos) under a
     spinlock, dnj.c:497-503, becomes a deterministic collective),
  3. a rank-1 update of the sharded matrix: every device refreshes the
     joined column for its own rows; the owner of the merged row
     rebuilds it from an all-gathered column.

Everything runs inside one jitted ``shard_map``/``fori_loop`` program;
the host receives only the (n-2) join records.  Tie-breaking is
first-wins on the flat (i, j) index and is device-count invariant, so
the same matrix gives the same tree on 1 chip or a pod slice.

For complete matrices the criterion matches the reference exactly:
Q(i,j) = (m-2)·D_ij − sD_i − sD_j (nj.c:192-195 with N_i = m), limbs
L_i = D_ij/2 + (sD_i − sD_j)/(2(m−2)) (nj.c:42-79), update
D'(k) = (D_ik + D_jk − D_ij)/2 (nj.c:836+) — so away from exact Q
ties the join sequence equals ``ccphylo tree -m nj``.  The byte-parity
engines (tree/exact.py, tree/jax_engine.py) replicate the reference's
tie-break chains; this module targets scale.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..io.qseqs import Name
from ..tree.newick_build import (byteshift_fix, form_last_bi_node,
                                 form_last_node, form_node)

shard_map = jax.shard_map


def _pad_to(n: int, mult: int) -> int:
    return max(-(-n // mult) * mult, mult)


@functools.lru_cache(maxsize=None)
def _join_program(mesh: Mesh, axis: str, npad: int, n: int,
                  method: str, dtype_name: str, neg: bool):
    """Compile the n-2-join loop for a (mesh, size, method) combo."""
    dtype = jnp.dtype(dtype_name)
    ndev = mesh.shape[axis]
    R = npad // ndev
    BIG = jnp.asarray(np.finfo(dtype).max / 4, dtype)
    cols = jnp.arange(npad)

    def body(Dl, sDl):
        # Dl: (R, npad) local row block; sDl: (R,) local row sums
        dev = jax.lax.axis_index(axis)
        gi = dev * R + jnp.arange(R)

        def step(t, carry):
            Dl, sDl, act, m, I, J, LI, LJ = carry
            actl = act[gi]
            m2 = jnp.maximum(m - 2, 1).astype(dtype)

            sD = jax.lax.all_gather(sDl, axis, tiled=True)
            if method == "nj":
                Q = m2 * Dl - sDl[:, None] - sD[None, :]
            else:  # upgma family: plain distance criterion
                Q = Dl
            valid = (actl[:, None] & act[None, :]
                     & (gi[:, None] > cols[None, :]))
            Qm = jnp.where(valid, Q, BIG)

            # local first-wins argmin, then allreduce-argmin
            flat = Qm.reshape(-1)
            k = jnp.argmin(flat)
            li, lj = k // npad, k % npad
            cand = jnp.stack([flat[k],
                              gi[li].astype(dtype),
                              lj.astype(dtype)])
            cands = jax.lax.all_gather(cand, axis)        # (ndev, 3)
            b = jnp.argmin(cands[:, 0])
            i = cands[b, 1].astype(jnp.int32)
            j = cands[b, 2].astype(jnp.int32)

            colI = Dl[:, i]
            colJ = Dl[:, j]
            if method == "nj":
                Dij = (cands[b, 0] + sD[i] + sD[j]) / m2
                # updateD clamps new distances at >= 0 (nj.c:836+)
                dnew_l = jnp.maximum((colI + colJ - Dij) / 2, 0.0)
            else:
                Dij = cands[b, 0]
                # updateUPGMA: unweighted average (hclust.c:665+)
                dnew_l = (colI + colJ) / 2
            # limbLength with its clamps (nj.c:42-79) — the reference
            # uses the same limb formula for every method
            delta = (sD[i] - sD[j]) / m2
            Li = (Dij + delta) / 2
            Lj = (Dij - delta) / 2
            if not neg:
                Li, Lj = (jnp.where(Li < 0, 0.0,
                                    jnp.where(Lj < 0, Dij, Li)),
                          jnp.where(Li < 0, Dij,
                                    jnp.where(Lj < 0, 0.0, Lj)))

            dnew = jax.lax.all_gather(dnew_l, axis, tiled=True)
            act2 = act.at[j].set(False)

            # column i refresh for my rows; dead column j is masked by act
            upd = actl & (gi != i) & (gi != j)
            Dl = Dl.at[:, i].set(jnp.where(upd, dnew_l, Dl[:, i]))
            # owner of row i rebuilds it from the gathered column
            own = (i // R) == dev
            lrow = i % R
            newrow = jnp.where(act2, dnew, 0.0) \
                .at[i].set(0.0).at[j].set(0.0)
            Dl = jnp.where(own,
                           Dl.at[lrow, :].set(newrow),
                           Dl)

            sDl = sDl + jnp.where(upd, dnew_l - colI - colJ, 0.0)
            sDi = jnp.sum(jnp.where(act2 & (cols != i), dnew, 0.0))
            sDl = jnp.where(own, sDl.at[lrow].set(sDi), sDl)

            I = I.at[t].set(i)
            J = J.at[t].set(j)
            LI = LI.at[t].set(Li)
            LJ = LJ.at[t].set(Lj)
            return (Dl, sDl, act2, m - 1, I, J, LI, LJ)

        # replicated carry components become device-varying after the
        # first collective-derived update; mark them varying up front
        vary = lambda x: jax.lax.pvary(x, (axis,))
        act = vary(jnp.arange(npad) < n)
        I = vary(jnp.zeros(n - 2, jnp.int32))
        J = vary(jnp.zeros(n - 2, jnp.int32))
        LI = vary(jnp.zeros(n - 2, dtype))
        LJ = vary(jnp.zeros(n - 2, dtype))
        carry = (Dl, sDl, act, vary(jnp.int32(n)), I, J, LI, LJ)
        Dl, sDl, act, m, I, J, LI, LJ = \
            jax.lax.fori_loop(0, n - 2, step, carry)

        # the two survivors and their distance (psum-reduced scalar)
        surv = jnp.where(act, jnp.arange(npad), npad)
        a = surv.min().astype(jnp.int32)
        b = jnp.where(act & (jnp.arange(npad) != a),
                      jnp.arange(npad), npad).min().astype(jnp.int32)
        own = (b // R) == dev
        d_loc = jnp.where(own, Dl[b % R, a], 0.0)
        d_last = jax.lax.psum(d_loc, axis)
        return I, J, LI, LJ, a, b, d_last

    spec_rows = P(axis, None)
    spec_row = P(axis)
    rep = P()
    # outputs are replicated by construction (derived from collectives);
    # the static vma checker can't prove it through the fori_loop
    fn = shard_map(body, mesh=mesh,
                   in_specs=(spec_rows, spec_row),
                   out_specs=(rep,) * 7, check_vma=False)
    return jax.jit(fn)


def sharded_join_records(D: np.ndarray, n: int, mesh: Mesh,
                         axis: str = "d", method: str = "nj",
                         dtype=jnp.float32, neg: bool = False):
    """Run the sharded join loop on a full square distance matrix.

    Returns host arrays (I, J, LI, LJ, a, b, d_last): n-2 join records
    (cluster j merged into slot i) and the two surviving slots with
    their distance.
    """
    if n < 3:
        raise ValueError("need at least 3 taxa")
    ndev = mesh.shape[axis]
    npad = _pad_to(n, ndev)
    dt = jnp.dtype(dtype)
    Dp = np.zeros((npad, npad), dt)
    Dp[:n, :n] = D[:n, :n]
    sD = Dp[:, :n].sum(axis=1, dtype=np.float64).astype(dt)

    sharding = NamedSharding(mesh, P(axis, None))
    rowsh = NamedSharding(mesh, P(axis))
    Dd = jax.device_put(jnp.asarray(Dp), sharding)
    sDd = jax.device_put(jnp.asarray(sD), rowsh)

    prog = _join_program(mesh, axis, npad, n, method, dt.name, neg)
    out = prog(Dd, sDd)
    return tuple(np.asarray(x) for x in out)


def build_tree_sharded(D: np.ndarray, n: int, names: list[Name],
                       mesh: Mesh, axis: str = "d", method: str = "nj",
                       flag: int = 0, precision: int = 9,
                       dtype=jnp.float32) -> bytes:
    """Newick bytes (no ';') from the sharded join loop.

    Join records address original matrix slots (no compaction), so the
    host just merges Name buffers in record order.
    """
    I, J, LI, LJ, a, b, d_last = sharded_join_records(
        D, n, mesh, axis, method, dtype, neg=bool(flag & 2))
    for t in range(n - 2):
        i, j = int(I[t]), int(J[t])
        form_node(names[i], names[j], float(LI[t]), float(LJ[t]),
                  precision)
    a, b = int(a), int(b)
    last = form_last_bi_node if (flag & 1) else form_last_node
    last(names[a], names[b], float(d_last), precision)
    root = names[a]
    byteshift_fix(root)
    return root.data
