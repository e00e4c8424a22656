"""Example 16: implicit nonlinear heat conduction (counterpart of the root
``examples/ex16_heat.py``; MFEM's ex16).

    python -m cardiac_ablation_ecm2_tpu_torch.examples.ex16_heat [-s 23] [--cpu] [--x64]
"""

import torch

from .common import load_mesh, maybe_vtu, setup, standard_parser


def main(argv=None):
    ap = standard_parser("du/dt = div(kappa(u) grad u), kappa = k + alpha u")
    ap.add_argument("-s", "--solver", default="23",
                    help="ODE solver name or MFEM numeric id")
    ap.add_argument("--kappa", type=float, default=0.5)
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--t-final", type=float, default=0.1)
    args = ap.parse_args(argv)
    kw = setup(args)

    from ..fem.fespace import FESpace
    from ..fem.gridfunction import l2_norm, project
    from ..linalg import ode
    from ..models import heat

    mesh = load_mesh(args, "inline-quad-16")
    fes = FESpace(mesh, args.order)
    op = heat.ConductionOperator(fes, kappa=args.kappa, alpha=args.alpha, **kw)
    sid = int(args.solver) if args.solver.isdigit() else args.solver
    step = heat.make_stepper(op, ode.select(sid))

    def u0(x):
        r2 = sum((x[..., d] - 0.5) ** 2 for d in range(mesh.dim))
        return torch.exp(-20 * r2)

    u, t = project(fes, u0, **kw), 0.0
    n = int(round(args.t_final / args.dt))
    for k in range(n):
        u, t = step(u, t, args.dt)
        if (k + 1) % max(n // 10, 1) == 0:
            print(f"t={float(t):.4f}  "
                  f"|u|_L2={float(l2_norm(fes, u, dtype=kw['dtype'])):.6f}")
    maybe_vtu(args, mesh, fes, u)
    return op, u


if __name__ == "__main__":
    main()
