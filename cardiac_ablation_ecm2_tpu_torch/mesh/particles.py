"""Particle sets: locate / interpolate / advect (numpy copy of
``cardiac_ablation_ecm2_tpu/mesh/particles.py``).

Reference analog: ``Particle``/``ParticleSet`` (``fem/particleset.hpp``) with
gslib-based redistribution — SoA particle storage carried alongside the mesh,
fields interpolated at particle positions, typical use = tracers advected
through a velocity field.

Positions and per-particle fields are plain host arrays; location is the
kd-tree + Newton inverse map of ``point_eval``; advection is classic RK4
re-locating at each stage.  A field given as a tensor (on any device) is
read back to the host first.  ``assign_partitions`` maps particles to the rank
that owns their element (the redistribution analog — with array-based
partitions there is no migration protocol, just a partition-id relabel).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .point_eval import evaluate_at_points, locate_points


def _host(u) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    if hasattr(u, "detach"):
        return u.detach().cpu().numpy()
    return np.asarray(u)


@dataclasses.dataclass(eq=False)
class ParticleSet:
    """SoA particles: positions (npart, sdim) + named per-particle fields."""

    positions: np.ndarray
    fields: dict = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.positions)

    def locate(self, mesh):
        """(elem ids, reference coords); elem = -1 for escaped particles."""
        return locate_points(mesh, self.positions)

    def interpolate(self, fes, u, name: str = None) -> np.ndarray:
        """Sample an FE field at the particle positions (gslib FindPoints +
        Interpolate analog); optionally store as a particle field."""
        vals = np.asarray(evaluate_at_points(fes, _host(u),
                                             self.positions))
        if name is not None:
            self.fields[name] = vals
        return vals

    def advect(self, fes_vel, u_vel, dt: float, steps: int = 1,
               clamp=None) -> None:
        """RK4 tracer advection through a (vector) velocity field given as a
        vdim-component byNODES L-vector on ``fes_vel``."""
        sdim = self.positions.shape[1]
        nd = fes_vel.ndof_scalar
        u = _host(u_vel).reshape(sdim, nd)

        def vel(x):
            return np.stack(
                [np.asarray(evaluate_at_points(fes_vel, u[d], x))
                 for d in range(sdim)], axis=-1,
            )

        x = self.positions
        for _ in range(steps):
            k1 = vel(x)
            k2 = vel(x + 0.5 * dt * k1)
            k3 = vel(x + 0.5 * dt * k2)
            k4 = vel(x + dt * k3)
            x = x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            if clamp is not None:
                x = np.clip(x, clamp[0], clamp[1])
        self.positions = x

    def assign_partitions(self, mesh, parts: np.ndarray) -> np.ndarray:
        """Partition id per particle (redistribution analog): the partition
        owning the element containing each particle (-1 if escaped)."""
        elem, _ = self.locate(mesh)
        out = np.full(self.n, -1, dtype=np.int64)
        ok = elem >= 0
        out[ok] = np.asarray(parts)[elem[ok]]
        return out
