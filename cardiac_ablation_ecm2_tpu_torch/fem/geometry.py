"""Reference geometries (numpy copy of ``cardiac_ablation_ecm2_tpu/fem/geometry.py``).

The enum keeps the JAX package's values.  The tables cover the geometries
the port's hex and tet paths need (segment, triangle, square, tetrahedron,
cube), with the same local vertex, edge and face orderings:

* SEGMENT: v0=(0), v1=(1)
* TRIANGLE: (0,0), (1,0), (0,1)
* SQUARE:   (0,0), (1,0), (1,1), (0,1)
* TETRAHEDRON: (0,0,0), (1,0,0), (0,1,0), (0,0,1)
* CUBE: (0,0,0),(1,0,0),(1,1,0),(0,1,0),(0,0,1),(1,0,1),(1,1,1),(0,1,1)
"""

from __future__ import annotations

import enum

import numpy as np


class Geometry(enum.IntEnum):
    POINT = 0
    SEGMENT = 1
    TRIANGLE = 2
    SQUARE = 3
    TETRAHEDRON = 4
    CUBE = 5
    PRISM = 6
    PYRAMID = 7


NUM_VERTS = {
    Geometry.POINT: 1,
    Geometry.SEGMENT: 2,
    Geometry.TRIANGLE: 3,
    Geometry.SQUARE: 4,
    Geometry.TETRAHEDRON: 4,
    Geometry.CUBE: 8,
}

DIMENSION = {
    Geometry.POINT: 0,
    Geometry.SEGMENT: 1,
    Geometry.TRIANGLE: 2,
    Geometry.SQUARE: 2,
    Geometry.TETRAHEDRON: 3,
    Geometry.CUBE: 3,
}

#: tensor-product (sum-factorizable) geometries
IS_TENSOR = {
    Geometry.SEGMENT: True,
    Geometry.TRIANGLE: False,
    Geometry.SQUARE: True,
    Geometry.TETRAHEDRON: False,
    Geometry.CUBE: True,
}

#: reference vertices, shape (nv, dim)
REF_VERTS = {
    Geometry.SEGMENT: np.array([[0.0], [1.0]]),
    Geometry.TRIANGLE: np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
    Geometry.SQUARE: np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]),
    Geometry.TETRAHEDRON: np.array(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    ),
    Geometry.CUBE: np.array(
        [
            [0.0, 0.0, 0.0],
            [1.0, 0.0, 0.0],
            [1.0, 1.0, 0.0],
            [0.0, 1.0, 0.0],
            [0.0, 0.0, 1.0],
            [1.0, 0.0, 1.0],
            [1.0, 1.0, 1.0],
            [0.0, 1.0, 1.0],
        ]
    ),
}

#: local edges as vertex index pairs
EDGES = {
    Geometry.SEGMENT: [(0, 1)],
    Geometry.TRIANGLE: [(0, 1), (1, 2), (2, 0)],
    Geometry.SQUARE: [(0, 1), (1, 2), (2, 3), (3, 0)],
    Geometry.TETRAHEDRON: [(0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3)],
    Geometry.CUBE: [
        (0, 1), (1, 2), (2, 3), (3, 0),          # bottom
        (4, 5), (5, 6), (6, 7), (7, 4),          # top
        (0, 4), (1, 5), (2, 6), (3, 7),          # vertical
    ],
}

#: local faces as cyclic vertex index tuples
FACES = {
    Geometry.TETRAHEDRON: [(1, 2, 3), (0, 3, 2), (0, 1, 3), (0, 2, 1)],
    Geometry.CUBE: [
        (3, 2, 1, 0),  # z=0 (outward -z)
        (0, 1, 5, 4),  # y=0
        (1, 2, 6, 5),  # x=1
        (2, 3, 7, 6),  # y=1
        (3, 0, 4, 7),  # x=0
        (4, 5, 6, 7),  # z=1
    ],
    Geometry.SQUARE: [(0, 1), (1, 2), (2, 3), (3, 0)],
    Geometry.TRIANGLE: [(0, 1), (1, 2), (2, 0)],
    Geometry.SEGMENT: [(0,), (1,)],
}

#: geometry of each face
FACE_GEOM = {
    Geometry.TETRAHEDRON: Geometry.TRIANGLE,
    Geometry.CUBE: Geometry.SQUARE,
    Geometry.SQUARE: Geometry.SEGMENT,
    Geometry.TRIANGLE: Geometry.SEGMENT,
    Geometry.SEGMENT: Geometry.POINT,
}
