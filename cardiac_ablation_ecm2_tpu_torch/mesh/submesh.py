"""SubMesh extraction and parent↔sub field transfer (counterpart of
``cardiac_ablation_ecm2_tpu/mesh/submesh.py``; MFEM's
``SubMesh::CreateFromDomain`` / ``CreateFromBoundary`` and
``TransferMap::Transfer``, the coupling of ``miniapps/multidomain``).

A submesh is another element-batched ``Mesh``; its host tables are bitwise
the JAX package's.  The JAX package counts the faces of the extracted
elements with a ``Counter`` over every (element, local face); here the
faces are counted over whole arrays (``utils/native.encode_rows``, whose
ids are in order of first occurrence, the ``Counter``'s order), which fixes
the boundary rows, their cyclic orientation and their attributes alike.

A transfer map is the (ndof_sub,) parent dof of each sub dof.
``TransferMap.to_sub`` is one flat gather (``ops/gather_probes.take_flat``,
the one-plane ``gather_sum`` kernel on the card); ``to_parent`` writes the
sub values with ``index_copy_`` (the indices are unique, so no atomics).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..fem.geometry import FACES
from ..ops.gather_probes import take_flat
from ..utils.config import resolve_device
from ..utils.native import encode_rows
from .mesh import Mesh


@dataclasses.dataclass(eq=False)
class SubMesh:
    mesh: Mesh                   # the extracted submesh
    parent: Mesh
    parent_elems: np.ndarray     # (ne_sub,) parent element (or boundary face)
    from_boundary: bool = False  # True: parent_elems indexes parent.boundary


def _local_faces(elems: np.ndarray, geom) -> np.ndarray:
    """(ne·nlf, k) int64: every element's local faces as cyclic vertex rows,
    element-major (the JAX package's loop order)."""
    loc = FACES[geom]
    if len({len(f) for f in loc}) != 1:
        raise NotImplementedError(f"faces of mixed arity ({geom!r})")
    return np.stack([elems[:, list(f)] for f in loc], axis=1).reshape(
        -1, len(loc[0])).astype(np.int64)


def single_faces(elems: np.ndarray, geom):
    """The faces that occur once among ``elems``' local faces: (cyclic rows
    in order of first occurrence, their sorted rows)."""
    cyc = _local_faces(elems, geom)
    key = np.sort(cyc, axis=1)
    count, ids, _ = encode_rows(key)
    once = np.bincount(ids, minlength=count)[ids] == 1
    return cyc[once], key[once]


def last_match(table_keys: np.ndarray, values: np.ndarray,
               query: np.ndarray) -> np.ndarray:
    """For each row of ``query``, the value of the LAST equal row of
    ``table_keys`` (a dict built from the rows in order), −1 where none."""
    if not len(table_keys) or not len(query):
        return np.full(len(query), -1, dtype=np.int64)
    count, ids, q = encode_rows(table_keys, query)
    last = np.full(count, -1, dtype=np.int64)
    np.maximum.at(last, ids, np.arange(len(ids)))
    return np.where(q >= 0, values[last[np.maximum(q, 0)]], -1)


def create_from_domain(parent: Mesh, attributes: Sequence[int]) -> SubMesh:
    """Extract the subdomain with the given element attributes.  Its
    boundary is every face its elements hold once; a face that is also a
    parent boundary face keeps that attribute, the others (the interface)
    get the parent's largest boundary attribute + 1."""
    sel = np.isin(parent.attributes, np.asarray(list(attributes)))
    elems = parent.elements[sel]
    parent_ids = np.nonzero(sel)[0]
    used = np.unique(elems)
    remap = -np.ones(parent.nv, dtype=np.int64)
    remap[used] = np.arange(len(used))
    new_elems = remap[elems]
    bdr, bkey = single_faces(new_elems, parent.geom)

    # the parent's boundary faces whose vertices all lie in the submesh
    pb = remap[parent.boundary]
    inside = np.all(pb >= 0, axis=1)
    new_attr = int(parent.bdr_attributes.max()) + 1 if parent.nbe else 1
    battr = last_match(np.sort(pb[inside], axis=1),
                       parent.bdr_attributes[inside], bkey)
    battr = np.where(battr >= 0, battr, new_attr).astype(np.int64)

    sub = Mesh(
        geom=parent.geom,
        vertices=parent.vertices[used],
        elements=new_elems,
        attributes=parent.attributes[sel],
        boundary=bdr,
        bdr_attributes=battr,
    )
    return SubMesh(mesh=sub, parent=parent, parent_elems=parent_ids)


def create_from_boundary(parent: Mesh, attributes: Sequence[int]) -> SubMesh:
    """Extract the marked boundary faces as a lower-dimensional mesh."""
    sel = np.isin(parent.bdr_attributes, np.asarray(list(attributes)))
    faces = parent.boundary[sel]
    parent_ids = np.nonzero(sel)[0]
    used = np.unique(faces)
    remap = -np.ones(parent.nv, dtype=np.int64)
    remap[used] = np.arange(len(used))
    sub = Mesh(
        geom=parent.bdr_geom,
        vertices=parent.vertices[used],
        elements=remap[faces],
        attributes=parent.bdr_attributes[sel],
        boundary=np.zeros((0, 2), dtype=np.int64),
        bdr_attributes=np.zeros(0, dtype=np.int64),
    )
    return SubMesh(mesh=sub, parent=parent, parent_elems=parent_ids,
                   from_boundary=True)


class TransferMap:
    """Dof map between a parent space and a submesh space
    (``TransferMap::Transfer``), on ``device`` (``None``: the card).
    ``sub_to_parent`` is the host table, (ndof_sub,) int64, which may also
    be the JAX map's, as numpy."""

    def __init__(self, sub_to_parent: np.ndarray, device=None):
        device = resolve_device(device)
        self.sub_to_parent = np.asarray(sub_to_parent, dtype=np.int64)
        self.idx = torch.as_tensor(self.sub_to_parent.astype(np.int32),
                                   device=device)
        self.idx_long = self.idx.long()

    def to_sub(self, u_parent: torch.Tensor) -> torch.Tensor:
        """The sub field: u_parent[sub_to_parent], one gather."""
        return take_flat(u_parent, self.idx)

    def to_parent(self, u_sub: torch.Tensor, u_parent: torch.Tensor) -> torch.Tensor:
        """A copy of ``u_parent`` with the sub values written in (other dofs
        unchanged)."""
        return u_parent.clone().index_copy_(0, self.idx_long, u_sub)


def sub_to_parent_map(parent_fes, sub_fes, sm: SubMesh) -> np.ndarray:
    """(ndof_sub,) int64 parent dof of each sub dof.  Node n of a sub element
    is node n of its parent element (or face): the extraction copies the
    connectivity row-wise and renumbers the vertices monotonically, so the
    entity keys' canonical frames agree."""
    assert parent_fes.order == sub_fes.order
    if sm.from_boundary:
        pg = parent_fes.bdr_gather_map[sm.parent_elems]     # (ne_sub, ndf)
    else:
        pg = parent_fes.gather_map[sm.parent_elems]         # (ne_sub, nd)
    s2p = np.zeros(sub_fes.ndof_scalar, dtype=np.int64)
    s2p[sub_fes.gather_map.reshape(-1)] = pg.reshape(-1)
    return s2p


def create_transfer_map(parent_fes, sub_fes, sm: SubMesh, device=None) -> TransferMap:
    return TransferMap(sub_to_parent_map(parent_fes, sub_fes, sm), device)
