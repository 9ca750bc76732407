"""Device (JAX) pairwise SNP-distance kernels over packed 2-bit sequences.

Host semantics (ops/snp.py; reference fsacmp.c:552-633) are reproduced
as int8 Gram matrix products, the formulation that puts the O(n² L)
pair outer product on the tensor cores (elementwise XOR/popcount
formulations materialize (n, n, W) intermediates and are bound by
device-memory traffic):

    matches(i,j) = X_i · X_j      X = one-hot (4 planes per base), masked
    shared(i,j)  = M_i · M_j      M = include-mask plane
    D(i,j)       = shared − matches

Both are int8 dots with int32 accumulation, which XLA hands to cuBLAS's
int8 GEMM on the GPU.  Counts are exact: matches ≤ L < 2^31.

The genome axis is processed in chunks (``lax.scan`` accumulating the
(n, n) Gram matrix), so peak memory is one (n, 64·WCHUNK) int8
expansion; the full one-hot matrix never materializes.

A ±1 three-plane code (0.75x the multiply-accumulates) with
lower-triangular row-block dots was timed against this formulation on
an H100 and lost at both n=1024, L=5 Mbp and n=4096, L=1 Mbp: the
block slices and the stacked expansion cost more device-memory traffic
than the smaller GEMMs saved.

Multi-device: `sharded_snp_matrix` shards sample rows over a mesh axis;
jit/GSPMD inserts the all-gather of the opposing block.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

WCHUNK = 2048  # u32 words (32768 bases) per accumulation chunk


def u64_to_u32(words64: np.ndarray) -> np.ndarray:
    """(W,) u64 -> (2W,) u32 preserving base order (hi first)."""
    hi = (words64 >> np.uint64(32)).astype(np.uint32)
    lo = (words64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out = np.empty(2 * len(words64), np.uint32)
    out[0::2] = hi
    out[1::2] = lo
    return out


def inc32_to_pairmask(inc32: np.ndarray) -> np.ndarray:
    """Host: u32 include words (32 positions) -> u32 pair masks aligned
    with the u32 sequence words (16 positions each, bit 2k = include)."""
    hi = (inc32 >> np.uint32(16)).astype(np.uint32)
    lo = (inc32 & np.uint32(0xFFFF)).astype(np.uint32)
    out = np.empty(2 * len(inc32), np.uint32)
    out[0::2] = hi
    out[1::2] = lo
    x = out
    x = (x | (x << 8)) & np.uint32(0x00FF00FF)
    x = (x | (x << 4)) & np.uint32(0x0F0F0F0F)
    x = (x | (x << 2)) & np.uint32(0x33333333)
    x = (x | (x << 1)) & np.uint32(0x55555555)
    return x


_SHIFTS = np.arange(15, -1, -1, dtype=np.uint32) * 2  # base k at 30-2k


def _onehot_planes(seqs, masks):
    """(n, W) u32 packed words + (n|1, W) u32 pair masks ->
    (n, 64W) int8 one-hot X (4 planes per base, zeroed where the
    include bit is clear) and (n|1, 16W) int8 include plane M.

    Word layout (qseq2nibble, qseqs.c:60-88): base k of a word sits at
    bits (30-2k, 31-2k); its include bit is pair-mask bit (30-2k)."""
    sh = jnp.asarray(_SHIFTS)
    b = (seqs[..., None] >> sh) & jnp.uint32(3)
    inc = (masks[..., None] >> sh) & jnp.uint32(1)
    planes = (b[..., None] == jnp.arange(4, dtype=jnp.uint32)) \
        & (inc[..., None] != 0)
    X = planes.astype(jnp.int8).reshape(seqs.shape[0], -1)
    M = inc.astype(jnp.int8).reshape(masks.shape[0], -1)
    return X, M


def _gram(X):
    """X X^T as one int8 dot with int32 accumulation."""
    return jax.lax.dot_general(X, X, (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.int32)


def _npos(pm):
    """Included positions of u32 pair-mask words (include bits sit at
    the even bit positions)."""
    return jax.lax.population_count(
        pm & jnp.uint32(0x55555555)).sum(dtype=jnp.int32)


def _pad_w(a, wchunk):
    W = a.shape[-1]
    pad = (-W) % wchunk
    if pad:
        a = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
    return a, (W + pad) // wchunk


@functools.partial(jax.jit, static_argnames=("wchunk",))
def snp_matrix(seqs: jnp.ndarray, paircmask: jnp.ndarray,
               wchunk: int = WCHUNK) -> jnp.ndarray:
    """All-pairs SNP counts under a shared include mask (fsacmp).

    seqs: (n, W) uint32; paircmask: (W,) uint32 pair mask.  Returns
    (n, n) int32 distances.
    """
    n, _ = seqs.shape
    seqs, nc = _pad_w(seqs, wchunk)
    pm, _ = _pad_w(paircmask[None, :], wchunk)

    def body(c, w):
        blk = jax.lax.dynamic_slice(seqs, (0, w * wchunk), (n, wchunk))
        mblk = jax.lax.dynamic_slice(pm, (0, w * wchunk), (1, wchunk))
        X, _ = _onehot_planes(blk, mblk)
        return (c[0] + _gram(X), c[1] + _npos(mblk)), None

    (matches, npos), _ = jax.lax.scan(
        body, (jnp.zeros((n, n), jnp.int32), jnp.int32(0)),
        jnp.arange(nc))
    return npos - matches


@functools.partial(jax.jit, static_argnames=("wchunk",))
def snp_matrix_pairwise(seqs: jnp.ndarray, incmasks: jnp.ndarray,
                        wchunk: int = WCHUNK):
    """All-pairs (dist, shared) with per-sample include masks
    (pairwise-mask mode, proxi == 0: pair mask = AND of both masks,
    fsacmpthrd.c:409-416).

    seqs: (n, W) u32; incmasks: (n, W) u32 pair-expanded masks.
    Returns (D, N) int32 matrices.
    """
    n, _ = seqs.shape
    seqs, nc = _pad_w(seqs, wchunk)
    incmasks, _ = _pad_w(incmasks, wchunk)

    def body(c, w):
        blk = jax.lax.dynamic_slice(seqs, (0, w * wchunk), (n, wchunk))
        mblk = jax.lax.dynamic_slice(incmasks, (0, w * wchunk),
                                     (n, wchunk))
        X, M = _onehot_planes(blk, mblk)
        return (c[0] + _gram(X), c[1] + _gram(M)), None

    (matches, shared), _ = jax.lax.scan(
        body, (jnp.zeros((n, n), jnp.int32),
               jnp.zeros((n, n), jnp.int32)), jnp.arange(nc))
    return shared - matches, shared


def sharded_snp_matrix(seqs: np.ndarray, paircmask: np.ndarray,
                       mesh: Mesh, axis: str = "d") -> np.ndarray:
    """Multi-device all-pairs SNP counts: sample rows sharded over
    `axis`; XLA all-gathers the opposing operand block."""
    n, W = seqs.shape
    ndev = mesh.shape[axis]
    npad = -(-n // ndev) * ndev
    seqs_p = np.zeros((npad, W), np.uint32)
    seqs_p[:n] = seqs
    sharding = NamedSharding(mesh, P(axis, None))
    rep = NamedSharding(mesh, P())
    sd = jax.device_put(seqs_p, sharding)
    pm = jax.device_put(paircmask, rep)

    @functools.partial(jax.jit,
                       out_shardings=NamedSharding(mesh, P(axis, None)))
    def compute(sd, pm):
        X, _ = _onehot_planes(sd, pm[None, :])
        return _npos(pm) - _gram(X)

    return np.asarray(compute(sd, pm))[:n, :n]
