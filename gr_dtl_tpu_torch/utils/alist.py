"""alist parity-check matrix parser, MacKay format (numpy copy of
gr_dtl_tpu/utils/alist.py).

Format: line 1 "N M" (columns = variables, rows = checks), line 2 the
max column/row degree, lines 3-4 the per-column/per-row degrees, then
the per-column 1-indexed row lists (zero-padded), then the per-row
column lists.
"""

from __future__ import annotations

import numpy as np

__all__ = ["parse_alist", "load_alist"]


def parse_alist(text: str) -> np.ndarray:
    """Parse alist text -> dense H [M, N] uint8.

    Line-based: some alist writers pad each adjacency line to the max
    degree with zeros, others write exactly degree-many entries per
    line; parsing per line handles both.
    """
    lines = [ln for ln in text.splitlines() if ln.strip()]
    n, m = (int(x) for x in lines[0].split())
    col_deg = [int(x) for x in lines[2].split()]
    if len(col_deg) != n:
        raise ValueError("malformed alist: column degree count")
    H = np.zeros((m, n), dtype=np.uint8)
    for c in range(n):
        for tok in lines[4 + c].split():
            r = int(tok)
            if r > 0:
                H[r - 1, c] = 1
    for c, d in enumerate(col_deg):
        if H[:, c].sum() != d:
            raise ValueError(f"alist column {c} degree mismatch")
    return H


def load_alist(path: str) -> np.ndarray:
    with open(path) as f:
        return parse_alist(f.read())
