"""Top-level dispatch (reference main.c:99-131).

Usage: ``python -m ccphylo_tpu <subcommand> [options]`` or the
``ccphylo-tpu`` console script.
"""

from __future__ import annotations

import sys

from .. import __version__


def _help(out) -> int:
    out.write(f"""\
# CCPhylo-TPU {__version__}: GPU-accelerated phylogenetic analyses on KMA alignments.
#
# Subcommands:\tDesc:
# dist\t\tMake distance matrices based on multiple alignments
# tree\t\tMake trees based on distance matrices
# dbscan\tMake DBSCAN based on distance matrices
# union\t\tFind union of templates between smaples
# merge\t\tMerge distance matrices
# nwck2phy\tConvert Newick files to phylip distance files
# tsv2phy\tConvert tsv files to phylip distance files
# tsv2nwck\tConvert tsv files to newick files
# rarify\tRarify kma matrices
# trim\t\tTrim multiple alignments
# phycmp\tCompare phylip distance matrices
# fullphy\tConvert phylip distance matrices to full matrices
# makespan\tCluster jobs into partitions
# seq2fasta\tExtract fastas from KMA databases
""")
    return 0 if out is sys.stdout else 1


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if not argv:
        return _help(sys.stderr)
    cmd, rest = argv[0], argv[1:]

    if cmd in ("-h", "--help", "help"):
        return _help(sys.stdout)
    if cmd in ("-v", "--version"):
        print(__version__)
        return 0

    if cmd == "tree":
        from .tree_cmd import main_tree
        return main_tree(rest)
    if cmd == "dist":
        from .dist_cmd import main_dist
        return main_dist(rest)
    if cmd == "dbscan":
        from .dbscan_cmd import main_dbscan
        return main_dbscan(rest)
    if cmd == "union":
        from .union_cmd import main_union
        return main_union(rest)
    if cmd == "merge":
        from .merge_cmd import main_merge
        return main_merge(rest)
    if cmd == "nwck2phy":
        from .nwck2phy_cmd import main_nwck2phy
        return main_nwck2phy(rest)
    if cmd == "tsv2phy":
        from .tsv2phy_cmd import main_tsv2phy
        return main_tsv2phy(rest)
    if cmd == "tsv2nwck":
        from .tsv2nwck_cmd import main_tsv2nwck
        return main_tsv2nwck(rest)
    if cmd == "rarify":
        from .rarify_cmd import main_rarify
        return main_rarify(rest)
    if cmd == "trim":
        from .trim_cmd import main_trim
        return main_trim(rest)
    if cmd == "phycmp":
        from .phycmp_cmd import main_phycmp
        return main_phycmp(rest)
    if cmd == "fullphy":
        from .fullphy_cmd import main_fullphy
        return main_fullphy(rest)
    if cmd == "makespan":
        from .makespan_cmd import main_makespan
        return main_makespan(rest)
    if cmd == "seq2fasta":
        from .seq2fasta_cmd import main_seq2fasta
        return main_seq2fasta(rest)

    print(f'Unknown subcommand:\t"{cmd}"', file=sys.stderr)
    return _help(sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
