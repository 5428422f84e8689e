"""DEM-Engine co-simulation bridge behind the `CollisionSystem` interface.

The reference wraps projectchrono's DEM-Engine as an alternative collision
backend (`lib_src/collision/DemeMeshCollisionSystem.cu`): surface tri-meshes
are registered with the DEM solver, node positions are pushed each step,
`DoDynamics(dt)` runs, and the returned contact forces are spread to the K
nearest surface vertices by inverse-distance weights
(`DemeMeshCollisionSystem.cu:191-271, 548-620`).

DEM-Engine is an external CUDA project and is not available in this
environment; this bridge keeps the interface and the force-spreading logic
so a host-side DEME (or any point-contact producer) can slot in. The
`spread_point_forces` helper is implemented and tested; `DemMeshCollision`
raises a clear error when no backend is provided.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DemMeshCollision", "spread_point_forces"]


def spread_point_forces(
    points: np.ndarray,
    forces: np.ndarray,
    surface_nodes: np.ndarray,
    k: int = 4,
    eps: float = 1e-9,
) -> np.ndarray:
    """Spread contact-point forces to the K nearest surface vertices by
    inverse-distance weights (reference
    `AccumulatePointForcesToKNearestNodes`,
    `DemeMeshCollisionSystem.cu:191-271`).

    points: (C, 3) contact points; forces: (C, 3); surface_nodes: (S, 3).
    -> per-surface-node forces (S, 3).
    """
    out = np.zeros_like(surface_nodes)
    if len(points) == 0:
        return out
    d = np.linalg.norm(points[:, None, :] - surface_nodes[None, :, :], axis=-1)
    k = min(k, surface_nodes.shape[0])
    nearest = np.argpartition(d, k - 1, axis=1)[:, :k]  # (C, k)
    for c in range(points.shape[0]):
        idx = nearest[c]
        w = 1.0 / (d[c, idx] + eps)
        w = w / w.sum()
        out[idx] += w[:, None] * forces[c]
    return out


class DemMeshCollision:
    """CollisionSystem-compatible bridge for an external (host-side) DEM
    engine.

    Pass `backend` implementing
    `do_dynamics(meshes, x, v) -> (points, forces, mesh_ids)` where `mesh_ids`
    attributes each contact to one registered mesh (the reference retrieves
    forces per registered DEME mesh owner,
    `DemeMeshCollisionSystem.cu:607-615`); each contact is spread only onto
    its own mesh's surface nodes, so Newton's third law holds across meshes.
    Backends returning only (points, forces) are rejected.

    For a fully on-device DEM that needs no external engine, use
    `tlfea.collision.dem.NodeSphereDem` / `GranularDem`.
    """

    def __init__(self, mesh_manager, backend=None, k_nearest: int = 4):
        if backend is None:
            raise RuntimeError(
                "DemMeshCollision is the bridge for an EXTERNAL host-side "
                "DEM engine (the reference uses projectchrono/DEM-Engine, "
                "which is not installed here). Provide backend= "
                "with do_dynamics(meshes, x) -> (points, forces, mesh_ids), "
                "or use the native on-device backend: "
                "tlfea.collision.dem.NodeSphereDem."
            )
        self.mm = mesh_manager
        self.backend = backend
        self.k_nearest = k_nearest

    def step(self, x, v=None, params=None):
        """One co-sim exchange (reference loop `DemeMeshCollisionSystem.cu:
        548-620`): PRESCRIBE the current mesh state to the engine (positions
        + velocities — DEME family-prescribes mesh motion, so contacts see
        the correct relative velocity), let it DoDynamics internally, then
        RETRIEVE per-contact forces and spread them onto each contact's own
        mesh (K-nearest inverse-distance, exact third law per mesh)."""
        import jax.numpy as jnp

        x_np = np.asarray(x)
        # v=None contract: when the caller has no velocity state the backend
        # receives zeros (contacts then see zero relative mesh velocity —
        # purely elastic response, no contact damping), matching what DEME
        # would compute for a statically-prescribed mesh.
        v_np = np.zeros_like(x_np) if v is None else np.asarray(v)
        import inspect

        try:
            sig = inspect.signature(self.backend.do_dynamics)
            sig.bind(self.mm, x_np, v_np)
        except TypeError:
            # Legacy 2-arg backend (pre-velocity contract): name the new
            # contract instead of surfacing a bare arity TypeError from the
            # call site (internal backend TypeErrors still propagate).
            raise TypeError(
                "DEM backend do_dynamics must accept (meshes, x, v) — the "
                "bridge prescribes node velocities so contacts see the "
                "correct relative velocity (v is zeros when the caller has "
                "none). Update the backend signature."
            ) from None
        except ValueError:
            pass  # uninspectable callable (C extension): call as-is
        out = self.backend.do_dynamics(self.mm, x_np, v_np)
        if len(out) != 3:
            raise ValueError(
                "DEM backend must return (points, forces, mesh_ids): without "
                "per-contact mesh attribution the bridge cannot spread forces "
                "correctly across multiple meshes"
            )
        points, forces, mesh_ids = (np.asarray(a) for a in out)
        f = np.zeros_like(x_np)
        for mid, inst in enumerate(self.mm.instances):
            sel = mesh_ids == mid
            if not sel.any():
                continue
            tris = self.mm.surface_triangles(mid)
            surf_ids = np.unique(tris.reshape(-1))
            spread = spread_point_forces(
                points[sel], forces[sel], x_np[surf_ids], k=self.k_nearest
            )
            f[surf_ids] += spread
        return jnp.asarray(f), None, False
