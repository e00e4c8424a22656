"""Low-order-refined (LOR) sub-element connectivity (numpy copy of
``lor_corner_slots`` and ``lor_submesh_connectivity`` in
``cardiac_ablation_ecm2_tpu/ops/lor.py``; MFEM's ``LORDiscretization``).

The LOR mesh needs no new dof numbering: its vertices are the high-order
nodes (the Gauss-Lobatto lattice of every element), so each sub-element's
connectivity is a lattice slice of the space's gather map, in high-order
dof ids.  The host-factorized LOR solver of the JAX package
(``lor_matrix``, ``LORPreconditioner``) is not ported; the all-device
LOR multigrid is ``ops/lor_device.py``.
"""

from __future__ import annotations

import numpy as np

from ..fem.basis import lattice_multi_index
from ..fem.geometry import DIMENSION, Geometry


def lor_corner_slots(geom, p: int) -> np.ndarray:
    """(p^dim, 2^dim) per-element lattice slots of every LOR sub-element,
    corners in the LEX lattice order of ``make_dof_to_quad(geom, 1)`` (i
    fastest), matching the Q1 element matrices."""
    if geom not in (Geometry.SQUARE, Geometry.CUBE):
        raise ValueError("LOR: tensor meshes (squares, cubes)")
    dim = DIMENSION[geom]
    mi = lattice_multi_index(geom, p)
    lookup = {tuple(r): i for i, r in enumerate(mi)}
    corners = []
    rng = range(p)
    if dim == 2:
        for j in rng:
            for i in rng:
                corners.append([lookup[(i, j)], lookup[(i + 1, j)],
                                lookup[(i, j + 1)], lookup[(i + 1, j + 1)]])
    else:
        for k in rng:
            for j in rng:
                for i in rng:
                    corners.append([
                        lookup[(i, j, k)], lookup[(i + 1, j, k)],
                        lookup[(i, j + 1, k)], lookup[(i + 1, j + 1, k)],
                        lookup[(i, j, k + 1)], lookup[(i + 1, j, k + 1)],
                        lookup[(i, j + 1, k + 1)],
                        lookup[(i + 1, j + 1, k + 1)],
                    ])
    return np.array(corners, dtype=np.int64)


def lor_submesh_connectivity(fes) -> np.ndarray:
    """(ne·p^dim, 2^dim) sub-element connectivity in HIGH-ORDER dof ids."""
    corners = lor_corner_slots(fes.mesh.geom, fes.order)
    gm = fes.gather_map.astype(np.int64)                  # (ne, nd)
    return gm[:, corners].reshape(-1, corners.shape[1])
