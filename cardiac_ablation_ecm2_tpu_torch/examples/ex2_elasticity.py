"""Example 2: linear-elastic cantilever (counterpart of the root
``examples/ex2_elasticity.py``; MFEM's ex2).

    python -m cardiac_ablation_ecm2_tpu_torch.examples.ex2_elasticity [-m inline-quad-4] [--cpu] [--x64]

Without ``-m`` the beam is MFEM's ``beam-quad.mesh`` layout built by
:func:`beam_quad`: 8 × 1 quads on [0, 8] × [0, 1], the x = 0 end fixed
(attribute 1), the load on the x = 8 end (attribute 2), the long sides
free (attribute 3).
"""

import numpy as np

from .common import load_mesh, setup, standard_parser


def beam_quad():
    """The 8 × 1 quad beam of length 8 with MFEM's ``beam-quad`` boundary
    attributes: 1 = x = 0 (fixed), 2 = x = 8 (loaded), 3 = y = 0 and y = 1."""
    from ..mesh.mesh import make_cartesian_2d

    mesh = make_cartesian_2d(8, 1, 8.0, 1.0)
    # make_cartesian_2d: 1 = bottom, 2 = right, 3 = top, 4 = left
    relabel = np.array([0, 3, 2, 3, 1])
    mesh.bdr_attributes = relabel[mesh.bdr_attributes]
    return mesh


def main(argv=None):
    ap = standard_parser("Elastic cantilever: fixed attr-1, load on attr-2")
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--mu", type=float, default=1.0)
    args = ap.parse_args(argv)
    kw = setup(args)

    from ..models import elasticity

    if args.mesh is None:
        mesh = beam_quad()
        if args.refine:
            mesh = mesh.uniform_refinement(args.refine)
    else:
        mesh = load_mesh(args)
    res = elasticity.solve(mesh, order=args.order, lam=args.lam, mu=args.mu,
                           **kw)
    d = res.displacement()
    print(f"ndof={res.fes.ndof}  CG iters={res.iterations}  "
          f"max |u_y| = {abs(d[:, 1]).max():.4e}")
    return res


if __name__ == "__main__":
    main()
