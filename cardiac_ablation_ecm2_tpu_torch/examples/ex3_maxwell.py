"""Example 3: definite Maxwell, curl curl E + E = f on H(curl) (counterpart
of the root ``examples/ex3_maxwell.py``; MFEM's ex3): an arbitrary-order
Nédélec space on the n³ unit cube, E×n = 0 on the boundary, Jacobi-PCG and
the L2 error against the divergence-free E_i = sin(πx_j) sin(πx_k).
``--ams`` solves the order-1 problem with the AMS preconditioner
(``linalg/ams``) beside Jacobi over the 2³ → n³ refinement hierarchy, in
float64 (its 1e-10 tolerance is below what float32 inner products
resolve).

    python -m cardiac_ablation_ecm2_tpu_torch.examples.ex3_maxwell [-n 4] [-o 2] [--ams] [--cpu] [--x64]
"""

import numpy as np
import torch

from .common import setup, standard_parser


def exact_field(x):
    """E_i = sin(πx_j) sin(πx_k) of host points (..., 3)."""
    s = np.sin(np.pi * x)
    return np.stack([s[..., 1] * s[..., 2], s[..., 2] * s[..., 0],
                     s[..., 0] * s[..., 1]], axis=-1)


def ams_rhs(x):
    """The ``--ams`` load: the sine field, an exact discrete eigenmode of
    the uniform lattice, plus a generic part so that the counts mean
    something."""
    return (2 * np.pi ** 2 + 1) * exact_field(x) + 0.1 * np.stack(
        [1 + x[..., 0] * x[..., 1], x[..., 1] ** 2 - x[..., 2], np.exp(x[..., 0])],
        axis=-1)


def masked_system(op, ess, rhs):
    """(A, diag, b) with identity rows at the essential dofs."""
    m = torch.ones(op.ndof, dtype=op.terms[0][2].dtype, device=op.device)
    m[torch.as_tensor(ess, dtype=torch.int64, device=op.device)] = 0.0

    def A(v):
        return op.mult(v * m) * m + v * (1 - m)

    return A, op.diagonal() * m + (1 - m), rhs * m


def hierarchy(n):
    """make_cartesian_3d(2, 2, 2) refined up to n³ elements."""
    from ..mesh.mesh import make_cartesian_3d

    meshes = [make_cartesian_3d(2, 2, 2)]
    while meshes[-1].ne * 8 <= n ** 3:
        meshes.append(meshes[-1].uniform_refinement())
    return meshes


def l2_error(op, x):
    """‖E_h − E‖_L2 at the operator's quadrature points."""
    vals = op.values(x).detach().cpu().numpy()
    ex = exact_field(op.gf.x.detach().cpu().numpy())
    w = op.gf.wdet.detach().cpu().numpy()
    return float(np.sqrt(np.sum(w[..., None] * (vals - ex) ** 2)))


def main(argv=None):
    ap = standard_parser("Definite Maxwell on ND_k (ex3)")
    ap.add_argument("-n", type=int, default=4)
    ap.add_argument("--ams", action="store_true",
                    help="AMS preconditioner (order 1; n a power of 2 for the "
                         "h-MG hierarchy)")
    args = ap.parse_args(argv)
    kw = setup(args)
    if args.ams:
        return run_ams(args, kw["device"])

    from ..fem.fe_vector_ho import NDSpaceHO
    from ..linalg.solvers import cg
    from ..mesh.mesh import make_cartesian_3d
    from ..ops.vecfe import build_nd_operator, vecfe_linear_form

    order = max(args.order, 1)
    mesh = make_cartesian_3d(args.n, args.n, args.n)
    space = NDSpaceHO(mesh, order)
    print(f"ND_{order} on {mesh.ne} hexes: {space.ndof} dofs")
    op = build_nd_operator(space, mass_coeff=1.0, curlcurl_coeff=1.0,
                           nq1d=order + 2, **kw)
    b = vecfe_linear_form(op, lambda x: (2 * np.pi ** 2 + 1) * exact_field(x))
    A, dg, bm = masked_system(op, space.essential_dofs(None), b)
    x, info = cg(A, bm, M=lambda r: r / dg, rel_tol=1e-10, max_iter=4000)
    print(f"CG iters {info.iterations}; ||E_h − E||_L2 = {l2_error(op, x):.4e}")
    return info, x


def run_ams(args, device):
    """Order-1 solve with AMS against Jacobi; float64 whatever ``--x64``
    says.  Prints both CG counts."""
    from ..fem.fe_vector import NDSpace
    from ..fem.fespace import FESpace
    from ..linalg.ams import make_ams
    from ..linalg.solvers import cg
    from ..ops.vecfe import build_nd_operator, vecfe_linear_form

    kw = dict(dtype="float64", device=device)
    meshes = hierarchy(args.n)
    mesh = meshes[-1]
    nd, h1 = NDSpace(mesh), FESpace(mesh, 1)
    print(f"ND_1 on {mesh.ne} hexes: {nd.ndof} dofs "
          f"({len(meshes)}-level h-MG auxiliaries)")
    op = build_nd_operator(nd, mass_coeff=1.0, curlcurl_coeff=1.0, **kw)
    A, dg, bm = masked_system(op, nd.essential_dofs(None),
                              vecfe_linear_form(op, ams_rhs))
    _, ij = cg(A, bm, M=lambda r: r / dg, rel_tol=1e-10, max_iter=8000)
    bdr = sorted(set(mesh.bdr_attributes.tolist()))
    ams = make_ams(nd, h1, A, dg, ess_bdr=bdr, meshes=meshes, **kw)
    _, ia = cg(A, bm, M=ams, rel_tol=1e-10, max_iter=8000)
    print(f"CG iterations: Jacobi {ij.iterations}  AMS {ia.iterations}")
    return ij, ia


if __name__ == "__main__":
    main()
