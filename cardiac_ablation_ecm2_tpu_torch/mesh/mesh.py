"""Unstructured mesh as element-batched index arrays (numpy copy of ``Mesh``,
``make_cartesian_3d`` and ``make_cartesian_3d_tet`` from
``cardiac_ablation_ecm2_tpu/mesh/mesh.py``).

A mesh is a plain bag of numpy arrays, one geometry type per mesh, built on
the host; only dof-mapped arrays derived from it go to a device.  The
geometry is the multilinear map from ``vertices`` (no curved nodes).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..fem.geometry import DIMENSION, FACE_GEOM, NUM_VERTS, Geometry


@dataclasses.dataclass
class Mesh:
    geom: Geometry
    vertices: np.ndarray        # (nv, sdim) float64
    elements: np.ndarray        # (ne, nv_el) int64
    attributes: np.ndarray      # (ne,) int64
    boundary: np.ndarray        # (nbe, nv_face) int64
    bdr_attributes: np.ndarray  # (nbe,) int64

    @property
    def dim(self) -> int:
        return DIMENSION[self.geom]

    @property
    def sdim(self) -> int:
        return self.vertices.shape[1]

    @property
    def ne(self) -> int:
        return self.elements.shape[0]

    @property
    def nv(self) -> int:
        return self.vertices.shape[0]

    @property
    def nbe(self) -> int:
        return self.boundary.shape[0]

    @property
    def bdr_geom(self) -> Geometry:
        return FACE_GEOM[self.geom]

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, dtype=np.float64)
        self.elements = np.asarray(self.elements, dtype=np.int64)
        self.attributes = np.asarray(self.attributes, dtype=np.int64)
        self.boundary = np.asarray(self.boundary, dtype=np.int64).reshape(
            -1, NUM_VERTS[self.bdr_geom] if self.dim > 0 else 0
        )
        self.bdr_attributes = np.asarray(self.bdr_attributes, dtype=np.int64)


def make_cartesian_3d(
    nx: int, ny: int, nz: int, sx: float = 1.0, sy: float = 1.0, sz: float = 1.0
) -> Mesh:
    """Hexahedral grid on [0,sx]×[0,sy]×[0,sz].

    Boundary attributes: 1=z=0, 2=y=0, 3=x=sx, 4=y=sy, 5=x=0, 6=z=sz.
    """
    xs = np.linspace(0.0, sx, nx + 1)
    ys = np.linspace(0.0, sy, ny + 1)
    zs = np.linspace(0.0, sz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    verts = np.stack(
        [X.ravel(order="F"), Y.ravel(order="F"), Z.ravel(order="F")], axis=1
    )

    def vid(i, j, k):
        return i + (nx + 1) * (j + (ny + 1) * k)

    I, J, K = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    I, J, K = I.ravel(order="F"), J.ravel(order="F"), K.ravel(order="F")
    elems = np.stack(
        [
            vid(I, J, K),
            vid(I + 1, J, K),
            vid(I + 1, J + 1, K),
            vid(I, J + 1, K),
            vid(I, J, K + 1),
            vid(I + 1, J, K + 1),
            vid(I + 1, J + 1, K + 1),
            vid(I, J + 1, K + 1),
        ],
        axis=1,
    )

    bdr, battr = [], []
    for j in range(ny):
        for i in range(nx):
            bdr.append((vid(i, j + 1, 0), vid(i + 1, j + 1, 0),
                        vid(i + 1, j, 0), vid(i, j, 0))); battr.append(1)
            bdr.append((vid(i, j, nz), vid(i + 1, j, nz),
                        vid(i + 1, j + 1, nz), vid(i, j + 1, nz))); battr.append(6)
    for k in range(nz):
        for i in range(nx):
            bdr.append((vid(i, 0, k), vid(i + 1, 0, k),
                        vid(i + 1, 0, k + 1), vid(i, 0, k + 1))); battr.append(2)
            bdr.append((vid(i + 1, ny, k), vid(i, ny, k),
                        vid(i, ny, k + 1), vid(i + 1, ny, k + 1))); battr.append(4)
    for k in range(nz):
        for j in range(ny):
            bdr.append((vid(nx, j, k), vid(nx, j + 1, k),
                        vid(nx, j + 1, k + 1), vid(nx, j, k + 1))); battr.append(3)
            bdr.append((vid(0, j + 1, k), vid(0, j, k),
                        vid(0, j, k + 1), vid(0, j + 1, k + 1))); battr.append(5)

    return Mesh(
        geom=Geometry.CUBE,
        vertices=verts,
        elements=elems,
        attributes=np.ones(len(elems), dtype=np.int64),
        boundary=np.array(bdr, dtype=np.int64),
        bdr_attributes=np.array(battr, dtype=np.int64),
    )


#: the six tets of a hex around its (v0, v6) diagonal
_TET_PATHS = ((0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
              (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6))


def make_cartesian_3d_tet(
    nx: int, ny: int, nz: int, sx: float = 1.0, sy: float = 1.0, sz: float = 1.0
) -> Mesh:
    """Tetrahedral grid: each hex of :func:`make_cartesian_3d` split into six
    tets around its (v0, v6) diagonal; each boundary quad becomes the two
    triangles along the diagonal its tet cut.  The face-membership test
    runs on sorted face rows encoded as int64 keys (``np.isin``), so a
    million tets take seconds; the arrays equal the JAX package's."""
    h = make_cartesian_3d(nx, ny, nz, sx, sy, sz)
    e = h.elements
    tets = np.concatenate([e[:, list(p)] for p in _TET_PATHS], axis=0)
    nv = np.int64(h.nv)
    if float(h.nv) ** 3 >= 2.0 ** 63:
        raise ValueError(f"{h.nv} vertices overflow the int64 face keys")

    def keys(rows):
        r = np.sort(rows, axis=1)
        return (r[:, 0] * nv + r[:, 1]) * nv + r[:, 2]

    faces = [(1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1)]
    tet_keys = np.concatenate([keys(tets[:, list(f)]) for f in faces])
    q = h.boundary
    cut02 = np.isin(keys(q[:, [0, 1, 2]]), tet_keys)
    first = np.where(cut02[:, None], q[:, [0, 1, 2]], q[:, [0, 1, 3]])
    second = np.where(cut02[:, None], q[:, [0, 2, 3]], q[:, [1, 2, 3]])
    btris = np.stack([first, second], axis=1).reshape(-1, 3)
    return Mesh(
        geom=Geometry.TETRAHEDRON,
        vertices=h.vertices,
        elements=tets,
        attributes=np.tile(h.attributes, 6),
        boundary=btris,
        bdr_attributes=np.repeat(h.bdr_attributes, 2),
    )
