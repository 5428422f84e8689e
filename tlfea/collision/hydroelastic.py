"""Hydroelastic contact-patch collision system (the `CollisionSystem`
backend-agnostic contract, reference `lib_src/collision/CollisionSystemBase.h:
36-47`: bind nodes -> Step(positions, velocities, dt) -> per-node f_ext).

One jitted `step`: broadphase window pairs -> vmapped narrowphase -> patch
forces. Everything stays on device; the per-step D2H/H2D copies of the
reference's legacy path (`test_sphere_drop_collision.cc:284-374`) have no
equivalent here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tlfea import struct
from tlfea.collision.broadphase import (
    BroadphaseSetup,
    compact_pairs,
    find_pairs,
    find_pairs_block,
    find_pairs_dense,
    setup_block_cross,
    setup_broadphase,
    setup_dense_cross,
)
from tlfea.collision.forces import patch_forces
from tlfea.collision.narrowphase import ContactPatches, compute_patches

__all__ = ["HydroelasticParams", "HydroelasticCollision"]


@struct.dataclass
class HydroelasticParams:
    """Step params (reference `CollisionSystemParams`,
    `CollisionSystemBase.h:17-24`)."""

    damping: jnp.ndarray = 0.0
    friction: jnp.ndarray = 0.0


class HydroelasticCollision:
    """Stateful orchestrator bound to a fixed multi-mesh scene topology.

    scene topology = (conn, mesh_ids, per-node pressures). Positions and
    velocities are passed per step.
    """

    def __init__(
        self,
        conn: np.ndarray,
        mesh_ids: np.ndarray,
        pressures: np.ndarray,
        window: int = 32,
        max_pairs: int = 4096,
        margin: float = 0.0,
        enable_self_collision: bool = False,
        dense_cross_cap: int = 262_144,
        broadphase: str = "auto",
        rest_nodes: np.ndarray | None = None,
        cell_cap: int | None = None,
        block: int = 64,
        block_pair_cap: int = 256,
    ):
        self._init_args = dict(
            conn=np.asarray(conn), mesh_ids=np.asarray(mesh_ids),
            pressures=np.asarray(pressures), window=window, max_pairs=max_pairs,
            margin=margin, enable_self_collision=enable_self_collision,
            dense_cross_cap=dense_cross_cap, broadphase=broadphase,
            rest_nodes=None if rest_nodes is None else np.asarray(rest_nodes),
            cell_cap=cell_cap, block=block, block_pair_cap=block_pair_cap,
        )
        self.bp: BroadphaseSetup = setup_broadphase(
            conn, mesh_ids, window=window, margin=margin
        )
        self.pressures = jnp.asarray(pressures)
        self.enable_self_collision = bool(enable_self_collision)

        # Broadphase strategy ("auto"):
        # - self-collision on  -> uniform grid hash when rest_nodes are
        #   given (exact 27-cell neighborhoods, static shapes; the sweep
        #   window degenerates on dense self-contact), else sweep-and-prune;
        # - self-collision off -> exact dense cross-mesh AABB test while
        #   the cross-pair count fits (robust to mixed element sizes); past
        #   `dense_cross_cap` the two-level block test (`find_pairs_block`)
        #   when rest_nodes are given (spatial element sort), else SAP.
        self.cross_pairs = None
        self.grid = None
        self.blk = None
        mode = broadphase
        if mode == "auto":
            if enable_self_collision:
                mode = "grid" if rest_nodes is not None else "sap"
            else:
                cp = setup_dense_cross(conn, mesh_ids)
                if cp is not None and cp.shape[0] <= dense_cross_cap:
                    self.cross_pairs = cp
                    mode = "dense"
                elif cp is not None and rest_nodes is not None:
                    mode = "block"
                else:
                    mode = "sap"
        elif mode == "dense":
            self.cross_pairs = setup_dense_cross(conn, mesh_ids)
            if self.cross_pairs is None:
                raise ValueError("broadphase='dense' needs >=2 meshes")
        if mode == "block":
            if rest_nodes is None:
                raise ValueError("broadphase='block' requires rest_nodes= for the spatial element sort")
            self.blk = setup_block_cross(
                conn, mesh_ids, rest_nodes, block=block, block_pair_cap=block_pair_cap
            )
            if self.blk is None:
                raise ValueError("broadphase='block' needs >=2 meshes")
        if mode == "grid":
            if rest_nodes is None:
                raise ValueError("broadphase='grid' requires rest_nodes= for cell sizing")
            from tlfea.collision.gridhash import setup_grid

            self.grid = setup_grid(rest_nodes, conn, cell_cap=cell_cap, margin=margin)
        self.mode = mode

        bp = self.bp
        self_col = self.enable_self_collision
        pressures_dev = self.pressures
        cross_pairs = self.cross_pairs
        grid = self.grid
        blk = self.blk

        # Phases are compiled SEPARATELY: one fused jit of the whole
        # pipeline once measured 2.6x slower than the phase programs (XLA
        # scheduling with the large masked intermediates). Not yet measured
        # on the GPU (ROADMAP S4/D7); the fused coupled rollout
        # (`newton.make_coupled_rollout`) fuses them anyway.
        @jax.jit
        def _broad(x):
            if cross_pairs is not None:
                pairs, valid, win_overflow = find_pairs_dense(bp, x, cross_pairs)
            elif blk is not None:
                pairs, valid, win_overflow = find_pairs_block(bp, blk, x)
            elif grid is not None:
                from tlfea.collision.gridhash import find_pairs_grid

                pairs, valid, win_overflow = find_pairs_grid(bp, grid, x, self_col)
            else:
                pairs, valid, win_overflow = find_pairs(bp, x, self_col)
            pairs, valid, cap_overflow = compact_pairs(pairs, valid, max_pairs)
            return pairs, valid, win_overflow | cap_overflow

        @jax.jit
        def _narrow(x, pairs, valid):
            return compute_patches(
                x, pressures_dev, bp.corners, pairs, valid, bp.mesh_ids, self_col
            )

        @jax.jit
        def _forces(patches, x, v, params: HydroelasticParams):
            return patch_forces(
                patches, x, v, bp.corners,
                damping=params.damping, friction=params.friction,
            )

        def _step(x, v, params: HydroelasticParams):
            pairs, valid, overflow = _broad(x)
            patches = _narrow(x, pairs, valid)
            f = _forces(patches, x, v, params)
            return f, patches, overflow

        self._step = _step
        # Exposed for per-phase profiling (the reference prints per-phase
        # averages, `test_sphere_drop_collision.cc:448-473`).
        self.broadphase_fn = _broad
        self.narrowphase_fn = _narrow
        self.forces_fn = _forces

    def step(self, x, v=None, params: HydroelasticParams | None = None):
        """-> (f_ext (n_nodes, 3), ContactPatches, window_overflow: bool)."""
        if params is None:
            params = HydroelasticParams()
        if v is None:
            v = jnp.zeros_like(x)
        return self._step(jnp.asarray(x), jnp.asarray(v), params)

    def patches(self, x) -> ContactPatches:
        """Narrowphase only (for inspection/visualization)."""
        _, patches, _ = self.step(x)
        return patches

    def grow(self, factor: int = 2) -> "HydroelasticCollision":
        """Return a rebuilt collision system with `factor`x the candidate
        capacity (both the sweep window and max_pairs — either can be the
        overflow source). Used by `Simulation` to auto-recover from capacity
        overflow instead of aborting."""
        args = dict(self._init_args)
        args["window"] = args["window"] * factor
        args["max_pairs"] = args["max_pairs"] * factor
        if self.grid is not None:
            args["cell_cap"] = self.grid.cell_cap * factor
        if self.blk is not None:
            args["block_pair_cap"] = self.blk.block_pair_cap * factor
        return HydroelasticCollision(**args)
