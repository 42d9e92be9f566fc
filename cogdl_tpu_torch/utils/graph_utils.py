"""Graph format conversions — the port of ``cogdl_tpu/utils/graph_utils.py``:
COO, CSR and CSC on the host in numpy, COO to CSR by the host library's
counting sort (``native.coo2csr``; a failed build raises), and two COO
helpers, the self loops and the symmetric normalisation of edge weights.

The JAX ``coo2csr`` takes the library when it loads and a stable numpy
sort otherwise; both give the same arrays, and so does
``native.coo2csr_reference``."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def coo2csr(row, col, num_nodes: int
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(indptr, indices, perm)``: ``perm`` maps the CSR slots back to the
    input edges; each row keeps its edges in input order."""
    from .. import native

    return native.coo2csr(row, col, num_nodes)


def csr2coo(indptr, indices) -> Tuple[np.ndarray, np.ndarray]:
    indptr = np.asarray(indptr)
    rows = np.repeat(np.arange(indptr.shape[0] - 1), np.diff(indptr))
    return rows, np.asarray(indices)


def coo2csc(row, col, num_nodes: int
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSC = CSR of the transpose."""
    return coo2csr(col, row, num_nodes)


def csr2csc(indptr, indices, num_nodes: int):
    rows, cols = csr2coo(indptr, indices)
    return coo2csc(rows, cols, num_nodes)


def add_remaining_self_loops(edge_index, num_nodes: int) -> np.ndarray:
    """The COO ``edge_index`` without its self loops, then one loop a
    node."""
    ei = np.asarray(edge_index)
    keep = ei[0] != ei[1]
    loops = np.arange(num_nodes)
    return np.concatenate([ei[:, keep], np.stack([loops, loops])], axis=1)


def symmetric_normalization(row, col, weight, num_nodes: int) -> np.ndarray:
    """The weights ``D^-1/2 A D^-1/2`` of the COO edges, ``D`` the rows'
    weighted degrees; a node without degree gets 0."""
    deg = np.bincount(row, weights=weight, minlength=num_nodes)
    dinv = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    return weight * dinv[row] * dinv[col]
