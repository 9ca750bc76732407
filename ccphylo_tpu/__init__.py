"""ccphylo_tpu — a GPU-accelerated phylogenetic distance + tree-building
framework.

A from-scratch reimplementation of the capabilities of CCPhylo
(genomicepidemiology/ccphylo, C99 reference) on JAX:

- Pairwise SNP/Hamming distances over packed 2-bit nucleotide tensors are
  computed as XOR/popcount on the host or as int8 Gram matrix products on
  the device (JAX/XLA).
- Count-matrix (KMA ``.mat``) distances are vectorized column-metric
  reductions (cos/chi2/bc/... families).
- Neighbor-joining tree construction (dnj/nj/hnj/upgma/cf/ff/mn) runs as
  vectorized Q-criterion maintenance with masked row-min reductions; the join
  loop is the only host-side control flow.
- The exact engine (numpy, float64) reproduces the reference byte-for-byte
  (Phylip matrices and Newick trees); the device engines scale the same
  semantics onto one or several GPUs.

Reference layout is documented in SURVEY.md; parity points are cited per
function as ``reference-file:line``.

Reference L0 components with no direct counterpart (absorbed by the
runtime/platform rather than reimplemented):

- pherror.c (smalloc/sfopen/ERROR): checked allocation/IO become Python
  exceptions; CLI modules reproduce the reference's stderr messages and
  exit codes at their call sites.
- threader.h (spin locks, atomic work cursors): single-node pthread
  work-sharing is replaced by XLA collectives (allreduce-argmin picks in
  parallel/) and batched device kernels — determinism comes from
  index-packed reductions, not lock ordering.
- vector.c / ulist.c / qseqs.c growth: Python lists + numpy arrays;
  qseqs capacity semantics kept where they affect output
  (io/qseqs.py Name.grow_for).
- stdnuc.c (nibble2base, 2-bit k-mer helpers): io/kmadb.py unpacks KMA
  DB sequences with the same 2-bit layout (seq2fasta.c:50-170).
"""

__version__ = "0.1.0"
