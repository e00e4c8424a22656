"""Example 9: DG advection of a Gaussian pulse with upwind fluxes and an
explicit RK solver (counterpart of the root ``examples/ex9_dg_advection.py``;
MFEM's ex9).

    python -m cardiac_ablation_ecm2_tpu_torch.examples.ex9_dg_advection [-o 2] [--steps 100] [--dt 0.002] [-s rk3_ssp] [--cpu] [--x64]
"""

import torch

from .common import load_mesh, setup, standard_parser


def main(argv=None):
    ap = standard_parser("DG advection of a Gaussian pulse, upwind fluxes")
    ap.add_argument("--dt", type=float, default=0.002)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("-s", "--solver", default="rk3_ssp")
    args = ap.parse_args(argv)
    kw = setup(args)

    from ..fem.fespace import L2FESpace
    from ..linalg import ode
    from ..ops.dg_advection import DGAdvection, project_l2

    mesh = load_mesh(args, "inline-quad-24")
    fes = L2FESpace(mesh, args.order)

    def vel(x):
        v = torch.zeros_like(x)
        v[..., 0] = 1.0
        v[..., 1] = 0.5
        return v

    op = DGAdvection(fes, vel, inflow=lambda x: torch.zeros(x.shape[:-1],
                                                            dtype=x.dtype), **kw)
    solver = ode.select(args.solver)

    def u0(x):
        return torch.exp(-((x[..., 0] - 0.3) ** 2 + (x[..., 1] - 0.3) ** 2) / 0.005)

    u = project_l2(fes, u0, **kw)
    t = 0.0
    for _ in range(args.steps):
        u, t = solver.step(op, u, t, args.dt)
    print(f"ndof={fes.ndof}  t={float(t):.4f}  "
          f"u in [{float(u.min()):.4f}, {float(u.max()):.4f}]")
    return u


if __name__ == "__main__":
    main()
