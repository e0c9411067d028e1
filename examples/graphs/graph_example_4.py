#!/usr/bin/env python
"""Greedy coloring and the multicolor ordering (after graph_example_4.f90;
permutations.f90:83,167) — the seam that parallelizes triangular sweeps
and Metropolis dynamics."""

import os, sys
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import _common  # noqa: F401

import numpy as np

from sigma_tpu import greedy_color_ordering, greedy_coloring
from sigma_tpu.apps import torus


def main():
    g = torus(16, 16)
    colors, nc = greedy_coloring(g)
    print(f"colors: {nc} (a torus is 2-colorable: checkerboard)")

    p, ptr = greedy_color_ordering(g)
    print("color block sizes:", np.diff(ptr))

    # within a color block, no two vertices are adjacent
    rows, cols = g.edges_numpy()
    same_color = colors[rows] == colors[cols]
    off_diag = rows != cols
    print("conflicting edges:", int((same_color & off_diag).sum()))


if __name__ == "__main__":
    main()
