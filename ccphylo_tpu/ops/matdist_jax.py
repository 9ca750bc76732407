"""Device (JAX) all-pairs count-matrix distances — the `dist` .mat path.

The reference computes `.mat` distances per pair by re-streaming files
(cmpMats, matcmp.c:448-494) — IO-bound by design.  Here all included
samples' count matrices live as one (k, L, 6) tensor and every pair's
per-position metric reduces on the VPU, chunked over positions
(genome axis = lane axis; position chunks stream host->device, so the
kernel works on matrices far larger than device memory).

Implemented metric: cos (the default, coscmp matcmp.c:420-446):

    res(p) = 1 - a.b / (|a||b|)   over the 5 non-N channels,
    clamped at 0; position excluded when either vector is all-zero or
    either total < minDepth.

Exactness: inclusion gates (depth, zero-vector, position < length) are
integer-exact; the metric value and the per-pair sum are computed in
float32 on device with float64 accumulation of chunk partials on the
host, so sums can differ from the C's sequential float64 by ~1e-6
relative — this path is opt-in (CCPHYLO_TPU_DIST=device) and NOT
byte-parity; the host engine (ops/veccmp.cmp_mats) remains the
default.

Returns the same (dist, rows_inc) contract as cmp_mats for every pair,
including the -1.0/-2.0 sentinels and `norm` scaling, so the CLI's
message/exit behavior is unchanged.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

PCHUNK = 8192  # positions per streamed chunk (~10 MB at k=100)


# --- per-position metric kernels --------------------------------------------
# Each takes per-pair channel slices a, b: (..., 5) float32 (exact for
# counts < 2^24) and totals t1, t2: (...) float32, and returns
# (vals (...), valid (...)) — valid False where the host metric yields
# -1 or NaN (exclusion from rows_inc; the conditions below are
# integer-exact).  Citations are the matching matcmp.c metrics.


def _frac(a, t, nn):
    # normalized fractions over tot - N (matcmp.c _norm idiom)
    tt = t - nn
    return a / tt[..., None], tt


def _m_cos(a, b, t1, t2, n1, n2):
    d = (a * b).sum(-1)
    q1 = (a * a).sum(-1)
    q2 = (b * b).sum(-1)
    rs1 = jax.lax.rsqrt(jnp.where(q1 > 0, q1, 1.0))
    rs2 = jax.lax.rsqrt(jnp.where(q2 > 0, q2, 1.0))
    res = jnp.maximum(1.0 - d * rs1 * rs2, 0.0)
    return res, (q1 > 0) & (q2 > 0)


def _m_l1(a, b, t1, t2, n1, n2):
    return jnp.abs(a - b).sum(-1), jnp.full(a.shape[:-1], True)


def _m_l2(a, b, t1, t2, n1, n2):
    return jnp.sqrt(((a - b) ** 2).sum(-1)), jnp.full(a.shape[:-1], True)


def _m_linf(a, b, t1, t2, n1, n2):
    return jnp.abs(a - b).max(-1), jnp.full(a.shape[:-1], True)


def _m_chi2(a, b, t1, t2, n1, n2):
    T = a - b
    s = a + b
    terms = jnp.where(T != 0, T * T / jnp.where(s > 0, s, 1.0), 0.0)
    return jnp.sqrt(terms.sum(-1)), jnp.full(a.shape[:-1], True)


def _m_c(a, b, t1, t2, n1, n2):
    lo = jnp.minimum(a, b).sum(-1)
    hi = jnp.maximum(a, b).sum(-1)
    d = jnp.maximum(1.0 - lo / jnp.where(hi > 0, hi, 1.0), 0.0)
    return d, hi > 0


def _m_bc(a, b, t1, t2, n1, n2):
    lo = jnp.minimum(a, b).sum(-1)
    den = (t1 - n1) + (t2 - n2)
    d = jnp.maximum(1.0 - 2.0 * lo / jnp.where(den > 0, den, 1.0), 0.0)
    return d, den > 0


def _m_nl1(a, b, t1, t2, n1, n2):
    f1, tt1 = _frac(a, t1, n1)
    f2, tt2 = _frac(b, t2, n2)
    return (jnp.abs(f1 - f2).sum(-1),
            (tt1 > 0) & (tt2 > 0))


def _m_nl2(a, b, t1, t2, n1, n2):
    f1, tt1 = _frac(a, t1, n1)
    f2, tt2 = _frac(b, t2, n2)
    return (jnp.sqrt(((f1 - f2) ** 2).sum(-1)),
            (tt1 > 0) & (tt2 > 0))


def _m_nlinf(a, b, t1, t2, n1, n2):
    # the reference re-reads column 0 every iteration (matcmp.c:135)
    f1, tt1 = _frac(a, t1, n1)
    f2, tt2 = _frac(b, t2, n2)
    return (jnp.abs(f1[..., 0] - f2[..., 0]),
            (tt1 > 0) & (tt2 > 0))


def _m_nbc(a, b, t1, t2, n1, n2):
    f1, tt1 = _frac(a, t1, n1)
    f2, tt2 = _frac(b, t2, n2)
    d = jnp.maximum(1.0 - jnp.minimum(f1, f2).sum(-1), 0.0)
    return d, (tt1 > 0) & (tt2 > 0)


def _m_nchi2(a, b, t1, t2, n1, n2):
    f1, tt1 = _frac(a, t1, n1)
    f2, tt2 = _frac(b, t2, n2)
    diff = f1 - f2
    s = f1 + f2
    terms = jnp.where(diff != 0, diff * diff / jnp.where(s > 0, s, 1.0),
                      0.0)
    return jnp.sqrt(terms.sum(-1)), (tt1 > 0) & (tt2 > 0)


def _m_nc(a, b, t1, t2, n1, n2):
    # nccmp's T resets per iteration: denominator is 1 + max-frac of
    # the LAST column (matcmp.c:267)
    f1, tt1 = _frac(a, t1, n1)
    f2, tt2 = _frac(b, t2, n2)
    lo = jnp.minimum(f1, f2).sum(-1)
    T = 1.0 + jnp.maximum(f1[..., 4], f2[..., 4])
    return (jnp.maximum(1.0 - lo / T, 0.0),
            (tt1 > 0) & (tt2 > 0))


_FASTP_EDGES_F32 = None


def _p_chisqr(q):
    """p_chisqr (stdstat.c:132-142) on device: the exact erf branch in
    float32 plus the fastp table chain (stdstat.c:33-129) for q > 49.
    Float32 p-values can differ from the host's float64 in the last
    ulps — threshold comparisons (z's alpha gate) can flip only for
    borderline columns; the device .mat path is opt-in and documented
    non-byte-parity."""
    from ..ops.veccmp import _FASTP_EDGES, SQRT_PI
    p = jnp.ones_like(q)
    for edge, val in reversed(_FASTP_EDGES):
        p = jnp.where(q > edge, jnp.float32(val), p)
    exact = 1.0 - jnp.float32(1.772453850) \
        * jax.scipy.special.erf(jnp.sqrt(0.5 * jnp.abs(q))) \
        / jnp.float32(SQRT_PI)
    return jnp.where(q < 0, jnp.float32(1e-26),
                     jnp.where(q > 49, p, exact))


def _m_z_factory(alpha: float):
    def _m_z(a, b, t1, t2, n1, n2):
        """zcmp (matcmp.c:311-344): consensus comparison gated on the
        chi-square majority test; the reference's second majority check
        reuses tot1/max1 (matcmp.c:338) — reproduced.  Note a/b/t here
        are the RAW counts/totals (z uses totals incl. N)."""
        max1 = a.max(-1)
        max2 = b.max(-1)
        q1 = jnp.where(t1 > 0, (t1 - 2 * max1) ** 2
                       / jnp.where(t1 > 0, t1, 1.0), jnp.inf)
        q2 = jnp.where(t2 > 0, (t2 - 2 * max2) ** 2
                       / jnp.where(t2 > 0, t2, 1.0), jnp.inf)
        maj1 = t1 < 2 * max1
        x1 = (_p_chisqr(q1) <= alpha) & maj1
        x2 = (_p_chisqr(q2) <= alpha) & maj1
        ok = x1 & x2
        return jnp.zeros(ok.shape, jnp.float32), ok
    return _m_z


def _m_p(a, b, t1, t2, n1, n2):
    """pcmp (matcmp.c:346-359): 1 - p of the chi2 column test."""
    T = a - b
    s = a + b
    terms = jnp.where(T != 0, T * T / jnp.where(s > 0, s, 1.0), 0.0)
    d = 1.0 - _p_chisqr(terms.sum(-1))
    return d, jnp.full(d.shape, True)


def _m_np(a, b, t1, t2, n1, n2):
    f1, tt1 = _frac(a, t1, n1)
    f2, tt2 = _frac(b, t2, n2)
    diff = f1 - f2
    s = f1 + f2
    terms = jnp.where(diff != 0, diff * diff / jnp.where(s != 0, s, 1.0),
                      0.0)
    d = 1.0 - _p_chisqr(terms.sum(-1))
    return d, (tt1 > 0) & (tt2 > 0)


def _m_ln_factory(nn: int):
    def _m_ln(a, b, t1, t2, n1, n2):
        d = (jnp.abs(a - b) ** nn).sum(-1) ** jnp.float32(1.0 / nn)
        return jnp.maximum(d, 0.0), jnp.full(d.shape[:], True)
    return _m_ln


def _m_nln_factory(nn: int):
    def _m_nln(a, b, t1, t2, n1, n2):
        f1, tt1 = _frac(a, t1, n1)
        f2, tt2 = _frac(b, t2, n2)
        diff = jnp.abs(f1 - f2)
        # first term is pow() of the SIGNED difference (matcmp.c:112)
        first = (f1[..., 0] - f2[..., 0]) ** nn
        base = first + (diff[..., 1:] ** nn).sum(-1)
        d = jnp.where(base >= 0, base, 0.0) ** jnp.float32(1.0 / nn)
        # negative base -> NaN on host -> excluded upstream
        return d, (tt1 > 0) & (tt2 > 0) & (base >= 0)
    return _m_nln


METRICS = {
    "cos": _m_cos, "l1": _m_l1, "l2": _m_l2, "linf": _m_linf,
    "chi2": _m_chi2, "c": _m_c, "bc": _m_bc, "nl1": _m_nl1,
    "nl2": _m_nl2, "nlinf": _m_nlinf, "nbc": _m_nbc,
    "nchi2": _m_nchi2, "nc": _m_nc, "p": _m_p, "np": _m_np,
}


def resolve_metric(method: str, alpha: float = 0.05):
    """Device-metric spec for a dist -d method (None if unsupported).
    The spec is a static jit key; parameterized metrics encode their
    parameter ("z@0.05", "l3", "nl4")."""
    if method == "z":
        return f"z@{alpha!r}"
    if method in METRICS:
        return method
    for pre in ("nl", "l"):
        if method.startswith(pre):
            try:
                int(method[len(pre):])
            except ValueError:
                return None
            return method
    return None


def _metric_fn(spec: str):
    if spec.startswith("z@"):
        return _m_z_factory(float(spec[2:]))
    if spec in METRICS:
        return METRICS[spec]
    if spec.startswith("nl"):
        return _m_nln_factory(int(spec[2:]))
    return _m_ln_factory(int(spec[1:]))


@functools.partial(jax.jit,
                   static_argnames=("metric", "min_depth", "bi"))
def _metric_chunk(counts, totals, plens, metric, min_depth, bi):
    """One position chunk: counts (k, P, 6) int32, totals (k, P) int32,
    plens (k,) int32 = remaining valid positions per sample.

    Returns (sums (k, k) f32, incs (k, k) int32): per-pair masked sums
    of the metric over this chunk.  Pairs are gated per position on
    depth, per-sample length, and the metric's own exclusion.  The i
    axis is processed `bi` rows at a time so the explicit (bi, k, P, 5)
    pair differences stay bounded.

    The full ordered table is computed although callers read only the
    strict lower triangle — a deliberate 2x FLOP trade for a single
    static-shape dispatch per chunk (triangle-only blocks would need
    per-block column extents and recompilation)."""
    fn = _metric_fn(metric)
    k, P, _ = counts.shape
    a_all = counts[:, :, :5].astype(jnp.float32)     # exact < 2^24
    t_all = totals.astype(jnp.float32)
    n_all = counts[:, :, 5].astype(jnp.float32)
    pos = jnp.arange(P, dtype=jnp.int32)
    inlen = pos[None, :] < plens[:, None]
    deep = (totals >= min_depth) & inlen             # (k, P)

    nb = -(-k // bi)
    kpad = nb * bi
    # pad the ROW views so every i-block is full height; column views
    # stay at k (padded rows' gates are all-False, results dropped)
    a_rows = jnp.pad(a_all, ((0, kpad - k), (0, 0), (0, 0)))
    t_rows = jnp.pad(t_all, ((0, kpad - k), (0, 0)))
    n_rows = jnp.pad(n_all, ((0, kpad - k), (0, 0)))
    deep_rows = jnp.pad(deep, ((0, kpad - k), (0, 0)))

    def body(ib, acc):
        sums, incs = acc
        i0 = ib * bi
        a = jax.lax.dynamic_slice(a_rows, (i0, 0, 0), (bi, P, 5))
        t1 = jax.lax.dynamic_slice(t_rows, (i0, 0), (bi, P))
        n1 = jax.lax.dynamic_slice(n_rows, (i0, 0), (bi, P))
        d1 = jax.lax.dynamic_slice(deep_rows, (i0, 0), (bi, P))
        vals, valid = fn(a[:, None], a_all[None, :],
                         t1[:, None], t_all[None, :],
                         n1[:, None], n_all[None, :])   # (bi, k, P)
        use = d1[:, None, :] & deep[None, :, :] & valid
        s = jnp.where(use, vals, 0.0).sum(axis=2)
        r = use.sum(axis=2, dtype=jnp.int32)
        sums = jax.lax.dynamic_update_slice(sums, s, (i0, 0))
        incs = jax.lax.dynamic_update_slice(incs, r, (i0, 0))
        return sums, incs

    sums0 = jnp.zeros((kpad, k), jnp.float32)
    incs0 = jnp.zeros((kpad, k), jnp.int32)
    sums, incs = jax.lax.fori_loop(0, nb, body, (sums0, incs0))
    return sums[:k], incs[:k]


def pair_table(metric: str, counts_list, totals_list, min_depth: int):
    """All-pairs (sum, rows_inc) over stripped samples for a metric in
    METRICS.

    counts_list[i]: (L_i, 6) uint16; totals_list[i]: (L_i,) int64.
    Positions beyond min(L_i, L_j) are excluded per pair (cmpMats
    truncates at sample2's length; the longer-than-sample1 case is the
    caller's -1 sentinel).  Returns (S float64 (k, k), R int64 (k, k)).
    """
    k = len(counts_list)
    lens = np.array([len(c) for c in counts_list], np.int32)
    Lmax = int(lens.max()) if k else 0
    S = np.zeros((k, k), np.float64)
    R = np.zeros((k, k), np.int64)
    # block height: keep the (bi, k, P, 5) f32 diff tensor ~256 MB
    bi = max(1, min(k, (256 << 20) // max(1, k * PCHUNK * 5 * 4)))
    for p0 in range(0, Lmax, PCHUNK):
        P = min(PCHUNK, Lmax - p0)
        cc = np.zeros((k, P, 6), np.int32)
        tt = np.zeros((k, P), np.int32)
        for i in range(k):
            hi = min(len(counts_list[i]), p0 + P)
            if hi > p0:
                cc[i, :hi - p0] = counts_list[i][p0:hi]
                tt[i, :hi - p0] = totals_list[i][p0:hi]
        plens = np.clip(lens - p0, 0, P).astype(np.int32)
        s, r = _metric_chunk(jnp.asarray(cc), jnp.asarray(tt),
                             jnp.asarray(plens), metric, min_depth, bi)
        S += np.asarray(s, np.float64)
        R += np.asarray(r, np.int64)
    return S, R


def cos_pair_table(counts_list, totals_list, min_depth: int):
    return pair_table("cos", counts_list, totals_list, min_depth)


def cmp_mats_from_table(S, R, i, j, len_i, len_j, n_nucs_j, norm,
                        min_depth, min_length, min_cov):
    """cmpMats' gate/sentinel logic (matcmp.c:448-494) from the batched
    table — same (dist, rows_inc) results as ops/veccmp.cmp_mats up to
    the documented float32 summation difference."""
    if len_j > len_i:
        return -1.0, 0  # caller maps to the 'longer than' sentinel
    rows_inc = int(R[i, j])
    if n_nucs_j < min_length or n_nucs_j < min_cov * len_j:
        return -2.0, rows_inc
    if rows_inc < min_length or rows_inc < min_cov * len_j:
        return -1.0, 0
    dist = float(S[i, j])
    return (dist / rows_inc * norm if norm else dist), rows_inc
