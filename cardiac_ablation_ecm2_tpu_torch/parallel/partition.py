"""Mesh partitioning (numpy copy of
``cardiac_ablation_ecm2_tpu/parallel/partition.py``).

Recursive coordinate bisection (RCB) over element centroids stands in for
METIS (``Mesh::GeneratePartitioning``): deterministic, exactly balanced,
and box-like parts on the hex meshes of the target workloads.  The part
ids are the JAX package's, bit for bit.
"""

from __future__ import annotations

import numpy as np


def element_centroids(mesh) -> np.ndarray:
    return mesh.vertices[mesh.elements].mean(axis=1)


def rcb(points: np.ndarray, nparts: int) -> np.ndarray:
    """Recursive coordinate bisection → (n,) part ids in [0, nparts).

    Part sizes differ by at most 1.  Splits along the longest extent, with
    element counts proportional to the part counts on each side, so every
    leaf stays balanced when ``nparts`` is not a power of two.
    """
    n = len(points)
    parts = np.zeros(n, dtype=np.int64)

    def rec(idx: np.ndarray, lo_part: int, np_parts: int):
        if np_parts == 1:
            parts[idx] = lo_part
            return
        nleft_parts = np_parts // 2
        nright_parts = np_parts - nleft_parts
        nleft = (len(idx) * nleft_parts) // np_parts
        pts = points[idx]
        extent = pts.max(axis=0) - pts.min(axis=0)
        axis = int(np.argmax(extent))
        order = np.argsort(pts[:, axis], kind="stable")
        rec(idx[order[:nleft]], lo_part, nleft_parts)
        rec(idx[order[nleft:]], lo_part + nleft_parts, nright_parts)

    rec(np.arange(n), 0, nparts)
    return parts


def partition_mesh(mesh, nparts: int) -> np.ndarray:
    """(ne,) part id per element."""
    return rcb(element_centroids(mesh), nparts)


def rcb_weighted(points: np.ndarray, weights: np.ndarray,
                 nparts: int) -> np.ndarray:
    """Weighted RCB: each split puts total *weight* on either side in
    proportion to its part count (the load-balance step of rebalancing,
    ParNCMesh::Rebalance; weights are per-element costs)."""
    n = len(points)
    weights = np.asarray(weights, dtype=np.float64)
    parts = np.zeros(n, dtype=np.int64)

    def rec(idx: np.ndarray, lo_part: int, np_parts: int):
        if np_parts == 1:
            parts[idx] = lo_part
            return
        nleft_parts = np_parts // 2
        nright_parts = np_parts - nleft_parts
        pts = points[idx]
        extent = pts.max(axis=0) - pts.min(axis=0)
        axis = int(np.argmax(extent))
        order = np.argsort(pts[:, axis], kind="stable")
        w = weights[idx][order]
        cum = np.cumsum(w)
        target = cum[-1] * nleft_parts / np_parts
        nleft = int(np.searchsorted(cum, target)) + 1
        nleft = min(max(nleft, 1), len(idx) - 1)
        rec(idx[order[:nleft]], lo_part, nleft_parts)
        rec(idx[order[nleft:]], lo_part + nleft_parts, nright_parts)

    rec(np.arange(n), 0, nparts)
    return parts
