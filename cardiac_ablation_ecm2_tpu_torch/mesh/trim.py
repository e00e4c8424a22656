"""Mesh trimmer: remove elements by attribute, exposing new boundary
(numpy counterpart of ``cardiac_ablation_ecm2_tpu/mesh/trim.py``; MFEM's
``miniapps/meshing/trimmer.cpp``).

A boundary face created at the cut carries attribute ``bdr_max + a``, ``a``
the attribute of the trimmed neighbour (or a user map), so the trimmed
regions stay identifiable as boundary conditions.  The output is bitwise
the JAX package's: its ``Counter`` and dicts over (element, local face)
are whole-array counts and lookups here (``submesh.single_faces``,
``submesh.last_match``), with the same first-occurrence order and the same
last-writer-wins lookups.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..fem.geometry import FACES
from .mesh import Mesh
from .submesh import _local_faces, last_match, single_faces


def trim(mesh: Mesh, trim_attrs: Sequence[int],
         bdr_attr_map: Optional[Dict[int, int]] = None) -> Mesh:
    """New mesh with all elements whose attribute is NOT in ``trim_attrs``.

    Interface faces between kept and trimmed elements become boundary
    elements with attribute ``bdr_attr_map[a]`` (default ``bdr_max + a``)
    for trimmed-neighbour attribute ``a``; outer boundary faces of kept
    elements keep their original attributes, and a kept exterior face the
    original boundary does not list gets the first attribute above
    ``bdr_max`` that no interface attribute takes."""
    trim_set = set(int(a) for a in trim_attrs)
    keep = ~np.isin(mesh.attributes, np.asarray(sorted(trim_set)))
    if keep.all():
        return mesh
    bmax = int(mesh.bdr_attributes.max()) if mesh.nbe else 0
    amap = {a: bmax + a for a in trim_set}
    if bdr_attr_map:
        amap.update({int(k): int(v) for k, v in bdr_attr_map.items()})
    untagged = bmax + 1
    while untagged in amap.values():
        untagged += 1

    bdr, key = single_faces(mesh.elements[keep], mesh.geom)
    # the trimmed neighbour's attribute of each face (the last trimmed
    # element holding it), and the original boundary's attributes
    cut = _local_faces(mesh.elements[~keep], mesh.geom)
    nlf = len(FACES[mesh.geom])
    t_attr = last_match(np.sort(cut, axis=1),
                        np.repeat(mesh.attributes[~keep], nlf), key)
    o_attr = last_match(np.sort(mesh.boundary, axis=1), mesh.bdr_attributes, key)
    amap_of = np.zeros(max(trim_set) + 1, dtype=np.int64)
    for a in trim_set:
        amap_of[a] = amap[a]
    battr = np.where(t_attr >= 0, amap_of[np.maximum(t_attr, 0)],
                     np.where(o_attr >= 0, o_attr, untagged)).astype(np.int64)

    elems = mesh.elements[keep]
    used = np.unique(elems)
    remap = -np.ones(mesh.nv, dtype=np.int64)
    remap[used] = np.arange(len(used))
    return Mesh(
        geom=mesh.geom,
        vertices=mesh.vertices[used],
        elements=remap[elems],
        attributes=mesh.attributes[keep],
        boundary=remap[bdr],
        bdr_attributes=battr,
    )
