"""Boundary-layer anisotropic AMR: resolve u = e^{-z/eps} on [0,1]^3 by
Z-only NC hex refinement (counterpart of the root
``examples/boundary_layer_amr.py``; MFEM's ref_type X/Y/Z bitmask splits,
``mesh/ncmesh.hpp:662``).

Each round marks elements by the interpolation-error indicator
h_z^3 * e^{-z_min/eps} and splits them in z only; the nonconforming
Poisson solve (PᵀAP on the restriction kernels, CG) then converges to the
manufactured layer solution.

    python -m cardiac_ablation_ecm2_tpu_torch.examples.boundary_layer_amr [-n 4] [-e 0.15] [-s 3] [-o 2] [--cpu] [--x64]
"""

import numpy as np

from .common import setup, standard_parser


def main(argv=None):
    ap = standard_parser("Anisotropic boundary-layer AMR (NC hex Z-splits)")
    ap.add_argument("-n", "--ncell", type=int, default=4)
    ap.add_argument("-e", "--eps", type=float, default=0.15)
    ap.add_argument("-s", "--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    kw = setup(args)

    import torch

    from ..fem.build import basis_for, geom_factors_for, restriction_for
    from ..fem.ncfespace import NCFESpace
    from ..fem.quadinterp import eval_values
    from ..linalg.solvers import cg
    from ..mesh.mesh import make_cartesian_3d
    from ..mesh.ncmesh import Z3, make_nc, refine_hexes_aniso
    from ..ops.bilinearform import BilinearForm
    from ..ops.linearform import domain_lf
    from ..utils.config import real_t

    eps = args.eps
    dev, rt = kw["device"], real_t(kw["dtype"])

    def u_ex(x):
        x = np.asarray(x)
        return np.exp(-x[..., 2] / eps)

    def rhs(x):
        return -torch.exp(-x[..., 2] / eps) / eps**2

    nc = make_nc(make_cartesian_3d(args.ncell, args.ncell, args.ncell))
    lines = []
    for rounds in range(args.rounds + 1):
        nc_r = nc
        for _ in range(rounds):
            v = nc_r.mesh.vertices[nc_r.mesh.elements][..., 2]
            zmin = v.min(axis=1)
            hz = v.max(axis=1) - zmin
            ind = hz**3 * np.exp(-zmin / eps)
            types = np.where(ind > 0.2 * ind.max(), Z3, 0)
            nc_r, _ = refine_hexes_aniso(nc_r, types)

        spc = NCFESpace(nc_r, args.order, device=dev)
        A_L = BilinearForm(spc.fes, dev).add_domain_integrator(
            "diffusion").assemble(dtype=rt)
        Ac = spc.constrained_operator(A_L.mult)
        b = spc.restrict_t(domain_lf(spc.fes, rhs, dtype=rt, device=dev))
        mask = torch.zeros(spc.ndof_conf, dtype=rt, device=dev)
        mask[torch.as_tensor(spc.essential_dofs(), dtype=torch.long, device=dev)] = 1.0
        xb = torch.as_tensor(u_ex(spc.dof_coords), dtype=rt, device=dev) * mask

        def Abc(v):
            z = v * (1 - mask)
            return Ac(z) * (1 - mask) + v * mask

        B = (b - Ac(xb)) * (1 - mask) + xb
        x, info = cg(Abc, B, M=lambda r: r, rel_tol=1e-10, max_iter=3000)
        uL = spc.prolongate(x)
        fes = spc.fes
        uq = eval_values(basis_for(fes, rt, dev), restriction_for(fes, dev).mult(uL))
        gf = geom_factors_for(fes, None, rt, dev)
        err = float(torch.sqrt(torch.sum(
            gf.wdet * (uq - torch.exp(-gf.x[..., 2] / eps)) ** 2)))
        lines.append(f"rounds={rounds}: elements={nc_r.mesh.ne} "
                     f"conforming dofs={spc.ndof_conf} "
                     f"hanging={nc_r.n_hanging} cg_iters={int(info.iterations)} "
                     f"L2 layer error={err:.3e}")
        print(lines[-1])
    return lines


if __name__ == "__main__":
    main()
