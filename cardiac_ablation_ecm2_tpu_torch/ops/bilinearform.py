"""FULL assembly of domain mass and diffusion forms to a scipy CSR matrix
(the ``assemble_matrix`` subset of ``BilinearForm`` in
``cardiac_ablation_ecm2_tpu/ops/bilinearform.py``).

The quadrature and precision are the JAX package's: the space's rule
(``fes.d2q``), geometric factors in the configured dtype, element matrices
contracted in float64 against the float64 basis, diffusion from the
unpacked ``diffusion.setup``.  The element matrices are computed with torch
on the operator's device, in chunks of elements; duplicate (row, column)
entries are summed there after a key sort, and the canonical CSR (sorted
columns, exact zeros dropped as scipy's sum ``0 + A`` drops them) comes back
to the host.  Only simplex (dense-basis) spaces are covered: they are the
ones the assembled-ELL path runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.coefficient import eval_coeff
from ..fem.fespace import element_node_coords
from ..fem.geom_factors import compute_geometric_factors
from ..utils.config import resolve_device
from . import diffusion, mass

_KINDS = ("mass", "diffusion")
#: elements per chunk of element matrices (bounds the einsum temporaries)
_CHUNK = 1 << 16


class BilinearForm:
    """Sum of domain integrators on one space; ``device=None`` is the card."""

    def __init__(self, fes, device=None):
        self.fes = fes
        self.device = resolve_device(device)
        self._terms = []

    def add_domain_integrator(self, kind: str, coeff=None) -> "BilinearForm":
        if kind not in _KINDS:
            raise NotImplementedError(f"integrator {kind!r}: the port "
                                      f"assembles {_KINDS}")
        self._terms.append((kind, coeff))
        return self

    def assemble_matrix(self, dtype=None):
        """FULL assembly to a scipy CSR matrix (float64 data)."""
        import scipy.sparse as sp

        fes = self.fes
        d2q = fes.d2q
        if d2q.tensor:
            raise NotImplementedError("FULL assembly covers simplex spaces")
        dev = self.device
        n = fes.ndof_scalar
        X = element_node_coords(fes.mesh, fes.order)
        B = torch.as_tensor(d2q.B, dtype=torch.float64, device=dev)
        G = torch.as_tensor(d2q.G, dtype=torch.float64, device=dev)
        ne, nd = fes.gather_map.shape
        Ae = torch.zeros(ne, nd, nd, dtype=torch.float64, device=dev)
        for e0 in range(0, ne, _CHUNK):
            gf = compute_geometric_factors(X[e0:e0 + _CHUNK], d2q, dtype, dev)
            for kind, coeff in self._terms:
                cq = eval_coeff(coeff, gf, dtype)
                if kind == "mass":
                    q = mass.setup(gf, cq).double()
                    Ae[e0:e0 + _CHUNK] += torch.einsum("qm,eq,qn->emn", B, q, B)
                else:
                    q = diffusion.setup(gf, cq).double()
                    Ae[e0:e0 + _CHUNK] += torch.einsum("qma,eqab,qnb->emn",
                                                       G, q, G)
        gm = torch.as_tensor(fes.gather_map, dtype=torch.int64, device=dev)
        keys = (gm[:, :, None] * n + gm[:, None, :]).reshape(-1)
        uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
        vals = torch.zeros(len(uniq), dtype=torch.float64, device=dev)
        vals.index_add_(0, inv, Ae.reshape(-1))
        indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        indptr[1:] = torch.cumsum(torch.bincount(uniq // n, minlength=n), 0)
        A = sp.csr_matrix((vals.cpu().numpy(), (uniq % n).int().cpu().numpy(),
                           indptr.cpu().numpy()), shape=(n, n))
        A.eliminate_zeros()
        return A
