"""Device SNP fill (ops/snp_jax) parity vs the host XOR-popcount kernels
(ops/snp.py), fed through the same u64 -> u32 word and include-mask
conversions that `dist` uses.  Integer counts must match exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from ccphylo_tpu.ops import snp, snp_jax  # noqa: E402


@pytest.fixture(scope="module")
def data():
    n, W64 = 128, 256  # 16384 bases: two 512-word chunks at wchunk=512
    rng = np.random.default_rng(3)
    seqs = rng.integers(0, 2 ** 64, (n, W64), dtype=np.uint64)
    inc = rng.integers(0, 2 ** 32, W64, dtype=np.uint32)
    incs = rng.integers(0, 2 ** 32, (n, W64), dtype=np.uint32)
    s32 = np.stack([snp_jax.u64_to_u32(s) for s in seqs])
    return seqs, inc, incs, s32


def test_shared_counts_match(data):
    seqs, inc, _, s32 = data
    pm = snp_jax.inc32_to_pairmask(inc)
    got = np.asarray(snp_jax.snp_matrix(s32, pm, wchunk=512))
    np.testing.assert_array_equal(got, snp.pairwise_shared(seqs, inc))


def test_pairwise_counts_match(data):
    seqs, _, incs, s32 = data
    masks = np.stack([snp_jax.inc32_to_pairmask(m) for m in incs])
    d, nsh = snp_jax.snp_matrix_pairwise(s32, masks, wchunk=512)
    ed, en = snp.pairwise_masked(seqs, incs)
    # the host kernel leaves the diagonal at 0; `dist` reads only i > j
    off = ~np.eye(len(seqs), dtype=bool)
    np.testing.assert_array_equal(np.asarray(d)[off], ed[off])
    np.testing.assert_array_equal(np.asarray(nsh)[off], en[off])


def test_row_padding(data):
    """Sample counts that don't divide the block height are padded."""
    seqs, inc, _, s32 = data
    pm = snp_jax.inc32_to_pairmask(inc)
    got = np.asarray(snp_jax.snp_matrix(s32[:100], pm, wchunk=512))
    assert got.shape == (100, 100)
    np.testing.assert_array_equal(got,
                                  snp.pairwise_shared(seqs[:100], inc))
