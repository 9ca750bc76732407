"""`tree` subcommand: Phylip matrices -> Newick trees (reference tree.c).

Matches the reference CLI surface (tree.c:122-470) and its output byte
for byte: one Newick line per input matrix, '>'-prefixed header when the
matrix carried a '#'-comment, timings on stderr.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

from ..io import fileio
from ..io.phylip import PhylipStream
from ..io.qseqs import Name
from ..tree.exact import METHODS, build_tree
from ..tree.newick_build import form_last_bi_node
from .args import Args, ArgError

HELP = """\
#CCPhylo forms tree(s) in newick format given a set of phylip distance matrices.
#   Options are:            \tDesc:                           \tDefault:
#    -i, --input           \tInput file                      \tstdin
#    -o, --output          \tOutput file                     \tstdout
#    -S, --separator       \tSeparator                       \t\\t
#    -q, --quotes          \tQuote taxa                      \t\\0
#    -x, --print_precision \tFloating point print precision  \t9
#    -m, --method          \tTree construction method.       \tdnj
#    -M, --method_help     \tHelp on option "-m"             \t
#    -f, --flag            \tOutput flags                    \t0
#    -F, --flag_help       \tHelp on option "-f"             \t
#    -p, --float_precision \tFloat precision on distance matrix\tFalse / double
#    -s, --short_precision \tShort precision on distance matrix\tFalse / double / 1e0
#    -b, --byte_precision  \tByte precision on distance matrix\tFalse / double / 1e0
#    -g, --free            \tGradually free up D             \tFalse
#    -H, --mmap            \tAllocate matrix on the disk     \tFalse
#    -T, --tmp             \tSet directory for temporary files\t
#    -t, --threads         \tNumber of threads               \t1
#    -h, --help            \tShows this helpmessage          \t
"""

METHOD_HELP = """\
# Tree construction methods:
#
# nj      \tNeighbor-Joining
# upgma   \tUPGMA
# cf      \tK-means Closest First
# ff      \tK-means Furthest First
# mn      \tMinimum Neighbors
# hnj     \tHeuristic Neighbor-Joining
# dnj     \tDynamic Neighbor-Joining
#
"""

FLAG_HELP = """\
# Format flags output, add them to combine them.
#
#   1:\tStrictly bifurcate the root
#   2:\tAllow negative branchlengths
#
"""


def main_tree(argv: list[str]) -> int:
    inputfile = "-"
    outputfile = "-"
    sep = "\t"
    quotes = "\0"
    precision = 9
    method = "dnj"
    flag = 0
    dtype = "d"
    bytescale = 1.0  # ByteScale default (bytescale.c:22)
    threads = 1  # -t parallelizes the host dnj batch scan; output is
    #              thread-count independent (as is the reference's)

    use_mmap = False
    tmpdir = None
    a = Args(argv)
    while a.i < len(a.argv):
        arg = a.argv[a.i]
        if arg.startswith("--"):
            name, eq, val = arg[2:].partition("=")
            if eq:
                a.argv.insert(a.i + 1, val)
            if name == "":
                break
            elif name == "input":
                inputfile = a.next_value("input")
            elif name == "output":
                outputfile = a.next_value("output")
            elif name == "separator":
                sep = a.next_char("separator")
            elif name == "quotes":
                quotes = a.next_char("quotes")
            elif name == "print_precision":
                precision = a.next_num("print_precision")
            elif name == "method":
                method = a.next_value("method")
            elif name == "method_help":
                method = "mh"
            elif name == "flag":
                flag = a.next_num("flag")
            elif name == "flag_help":
                flag = -1
            elif name == "threads":
                threads = a.next_num("threads")
            elif name == "float_precision":
                dtype = "f"
            elif name == "short_precision":
                dtype = "s"
                bytescale = a.opt_float(bytescale)
            elif name == "byte_precision":
                dtype = "b"
                bytescale = a.opt_float(bytescale)
            elif name == "free":
                pass  # shrink-as-you-go: no effect on output
            elif name == "mmap":
                use_mmap = True
            elif name == "tmp":
                tmpdir = a.next_value("tmp")
            elif name == "help":
                sys.stdout.write(HELP)
                return 0
            else:
                raise ArgError(f'Unknown argument or option: "{arg}"')
        elif arg.startswith("-") and arg != "-":
            for opt in arg[1:]:
                if opt == "i":
                    inputfile = a.next_value("i")
                elif opt == "o":
                    outputfile = a.next_value("o")
                elif opt == "S":
                    sep = a.next_char("S")
                elif opt == "q":
                    quotes = a.next_char("q")
                elif opt == "x":
                    precision = a.next_num("x")
                elif opt == "m":
                    method = a.next_value("m")
                elif opt == "M":
                    method = "mh"
                elif opt == "f":
                    flag = a.next_num("f")
                elif opt == "F":
                    flag = -1
                elif opt == "t":
                    threads = a.next_num("t")
                elif opt == "p":
                    dtype = "f"
                elif opt == "s":
                    dtype = "s"
                    bytescale = a.opt_float(bytescale)
                elif opt == "b":
                    dtype = "b"
                    bytescale = a.opt_float(bytescale)
                elif opt == "g":
                    pass
                elif opt == "H":
                    use_mmap = True
                elif opt == "T":
                    tmpdir = a.next_value("T")
                elif opt == "h":
                    sys.stdout.write(HELP)
                    return 0
                else:
                    raise ArgError(f'Unknown argument or option: "{opt}"')
        else:
            inputfile = arg
        a.i += 1

    if flag == -1:
        sys.stdout.write(FLAG_HELP)
        return 0
    if method == "mh":
        sys.stdout.write(METHOD_HELP)
        return 0
    if method not in METHODS:
        raise ArgError('Invalid value parsed at "-m".')

    if use_mmap:
        # -H: disk-backed matrix cells (ltdMatrixMinit, matrix.c:116);
        # -T sets the backing directory (tmpF, tmp.c:27)
        from ..tree.exact import LtdMatrix
        LtdMatrix.mmap_dir = tmpdir or tempfile.gettempdir()

    return form_tree(inputfile, outputfile, flag, sep, quotes, method,
                     precision, dtype, bytescale, threads)


def _dispatch_build(flat, n, names, method, flag, precision, dtype,
                    bytescale, threads=1):
    """Choose the join engine.

    Default: the host exact engine (byte parity with the reference for
    every method/dtype).  CCPHYLO_TPU_ENGINE selects a device engine:
      device    — float32 state (join order can differ from the
                  reference by summation ulps on float data)
      device64  — float64 state (bit-exact trajectory on integer data)
      sharded   — row-sharded over every device (parallel/), float32
      sharded64 — the same in float64 (byte parity on integer data)
      packed    — u32-packed u8 storage, exact int32 arithmetic (-b)
    """
    eng = os.environ.get("CCPHYLO_TPU_ENGINE", "exact")
    if eng in ("sharded", "sharded64") \
            and method in ("dnj", "nj", "upgma") and dtype == "d":
        from ..utils.jaxconfig import configure_jax
        jax = configure_jax()
        import jax.numpy as jnp
        if eng == "sharded64":
            jax.config.update("jax_enable_x64", True)
        sdt = jnp.float64 if eng == "sharded64" else jnp.float32
        from ..parallel.multihost import maybe_init_distributed, row_mesh
        maybe_init_distributed()
        mesh = row_mesh()
        if method == "dnj":
            from ..parallel.sharded_dnj import build_tree_sharded_dnj
            return build_tree_sharded_dnj(flat, n, names, mesh,
                                          flag=flag, precision=precision,
                                          dtype=sdt)
        import numpy as _np
        if (_np.asarray(flat) < 0).any():
            # the sharded nj/upgma engine assumes complete matrices
            # (no D >= 0 masking); missing cells go to the host engine
            return build_tree(flat, n, names, method, flag, precision,
                              dtype, bytescale, threads)
        from ..parallel.sharded_nj import build_tree_sharded
        D = _np.zeros((n, n), _np.float64)
        iu = _np.tril_indices(n, -1)
        D[(iu[0], iu[1])] = flat
        D[(iu[1], iu[0])] = flat
        return build_tree_sharded(D, n, names, mesh, method=method,
                                  flag=flag, precision=precision,
                                  dtype=sdt)
    if eng in ("packed", "packed64") and method == "dnj" \
            and dtype == "b":
        # single-buffer u32-packed u8 storage with exact-int32
        # arithmetic (tree/packed_engine.py) — the lowest-memory
        # single-device layout (n^2 bytes total), bit-identical records
        # on every backend by construction.  "packed64" is accepted as
        # an alias (the old f64-compute mode is superseded: integer
        # compute is exact, so there is nothing left for f64 to fix).
        import numpy as _np
        if (_np.asarray(flat) < 0).any():
            return build_tree(flat, n, names, method, flag, precision,
                              dtype, bytescale, threads)
        from ..utils.jaxconfig import configure_jax
        configure_jax()
        from ..tree.packed_engine import build_tree_jax_packed
        return build_tree_jax_packed(
            flat, n, names, flag, precision, bytescale=bytescale)
    if eng in ("device", "device64") \
            and method in ("upgma", "ff", "cf", "hnj", "nj", "mn") \
            and dtype == "d":
        # device heuristic/UPGMA family (tree/hclust_engine.py):
        # upgma/ff via UPGMApair cached scans, cf/hnj via minQ global
        # picks, nj/mn via full masked scans — reference
        # hclust.c:56-1720, dnj.c:217-293, nj.c:182-362
        if method in ("ff", "hnj", "nj"):
            # float-scope guard: for these three the device engine's
            # sD reductions are not bitwise C sequential sums, so
            # non-integer matrices can flip exact ties (engine
            # docstring, tree/hclust_engine.py).  Integer (SNP) data
            # is bit-exact; anything else falls back to the host
            # byte-parity engine with a note.
            import numpy as _np
            fl = _np.asarray(flat)
            if not _np.array_equal(fl, _np.floor(fl)):
                sys.stderr.write(
                    "# ccphylo_tpu: non-integer distances with "
                    f"CCPHYLO_TPU_ENGINE={eng} -m {method}: device "
                    "engine is not byte-parity on float data; using "
                    "the host engine.\n")
                return build_tree(flat, n, names, method, flag,
                                  precision, dtype, bytescale, threads)
        from ..utils.jaxconfig import configure_jax
        jax = configure_jax()
        import jax.numpy as jnp
        if eng == "device64":
            jax.config.update("jax_enable_x64", True)
        from ..tree.hclust_engine import build_tree_hclust
        return build_tree_hclust(
            flat, n, names, method=method, flag=flag,
            precision=precision,
            dtype=jnp.float64 if eng == "device64" else jnp.float32)
    if eng in ("device", "device64") and method == "dnj":
        from ..utils.jaxconfig import configure_jax
        jax = configure_jax()
        import jax.numpy as jnp
        if eng == "device64":
            jax.config.update("jax_enable_x64", True)
        if dtype in ("s", "b"):
            # quantized matrix storage on device (u16/u8 ByteScale,
            # 2/1 bytes per cell); complete matrices only
            import numpy as _np
            if (_np.asarray(flat) < 0).any():
                return build_tree(flat, n, names, method, flag,
                                  precision, dtype, bytescale, threads)
            from ..tree.jax_engine import build_tree_jax_q
            return build_tree_jax_q(
                flat, n, names, flag, precision, bytescale=bytescale,
                store_dtype=jnp.uint16 if dtype == "s" else jnp.uint8,
                compute_dtype=jnp.float64 if eng == "device64"
                else jnp.float32)
        if dtype != "d":
            return build_tree(flat, n, names, method, flag, precision,
                              dtype, bytescale, threads)
        from ..tree.jax_engine import build_tree_jax
        # the batch scan is trajectory-exact (ties included) since the
        # prefix-min cache gating; f64 state makes it bit-exact vs the
        # reference whenever the C's own f64 sums are reproduced
        jdt = jnp.float64 if eng == "device64" else jnp.float32
        return build_tree_jax(flat, n, names, flag, precision, dtype=jdt,
                              scan="batch")
    return build_tree(flat, n, names, method, flag, precision, dtype,
                      bytescale, threads)


def form_tree(inputfile, outputfile, flag, sep, quotes, method, precision,
              dtype, bytescale, threads=1) -> int:
    """formTree (tree.c:37-120)."""
    data = fileio.read_bytes(inputfile)
    stream = PhylipStream(data, sep=sep.encode(), quotes=quotes.encode())
    out = fileio.open_out(outputfile)
    t0 = time.process_time()
    while True:
        loaded = stream.load()
        if loaded is None or loaded[0] == 0:
            break
        n, flat, names, header = loaded
        t1 = time.process_time()
        print(f"# Total time used loading matrix: {t1 - t0:.2f} s.",
              file=sys.stderr)
        t0 = t1
        if n > 2:
            # pass the live name list: the engine's swap-with-last
            # reordering persists across matrices in a stream, exactly as
            # the reference's shared Qseqs* array does (tree.c:82-98)
            from ..utils import timing
            with timing.phase("tree/joins", items=max(n - 2, 0)):
                tree = _dispatch_build(flat, n, names, method, flag,
                                       precision, dtype, bytescale,
                                       threads)
        elif n == 2:
            root = names[0]
            form_last_bi_node(root, names[1], float(flat[0]), precision)
            tree = root.data
        else:
            tree = names[0].data
        if header:
            out.write(b">" + header + tree + b";\n")
        else:
            out.write(tree + b";\n")
        t1 = time.process_time()
        print(f"# Total time used Constructing tree: {t1 - t0:.2f} s.",
              file=sys.stderr)
        t0 = t1
    fileio.close_out(out)
    return 0
