"""Simulation driver: couples a time-step solver with collision and external
forces, plus checkpoint/resume.

This is the library form of the reference's demo main loops
(`lib_bin/collision_system/test_sphere_drop_collision.cc:280-446`:
collision -> f_ext -> solver.Solve() -> export), with two upgrades the
reference lacks:
- everything stays on device between steps (the reference's legacy hydro
  path does D2H/H2D copies each step);
- state snapshots (`save_state` / `load_state`) — the reference has no
  checkpoint/resume at all (SURVEY §5).
"""

from __future__ import annotations

from typing import Any, Callable

import jax.numpy as jnp
import numpy as np

from tlfea.elements.assembly import lumped_mass
from tlfea.solvers.common import StepState, System

__all__ = ["Simulation", "gravity_force"]


def gravity_force(system: System, g=(0.0, 0.0, -9.81)) -> jnp.ndarray:
    """Consistent (lumped) gravity load for the whole system."""
    m = lumped_mass(system.elems)
    g = jnp.asarray(g, dtype=m.dtype)
    return m[:, None] * g[None, :]


class Simulation:
    """Composable stepping loop.

    solver_step: callable (system, state, f_ext) -> (state, diag) — e.g.
      `newton.stepper(params)` or `vbd.stepper(params, structures)`. Passing
      the system per call keeps constraint retargeting (prescribed motion)
      and material changes working without retracing.
    collision: optional `HydroelasticCollision` (or anything with
      `.step(x, v, params) -> (f_ext, patches, overflow)`).
    """

    def __init__(
        self,
        system: System,
        state: StepState,
        solver_step: Callable,
        base_f_ext: jnp.ndarray | None = None,
        collision: Any = None,
        collision_params: Any = None,
    ):
        self.system = system
        self.state = state
        self.solver_step = solver_step
        n = system.n_coef
        self.base_f_ext = (
            jnp.zeros((n, 3), dtype=state.x.dtype) if base_f_ext is None else jnp.asarray(base_f_ext)
        )
        self.collision = collision
        self.collision_params = collision_params
        self.step_count = 0
        self.last_patches = None
        self.last_diag: dict = {}
        # Deferred (one-step-delayed) collision-capacity check: checking the
        # overflow flag synchronously would block the host on the device
        # every step; by the next step the flag has long materialized, so
        # reading it costs nothing. On overflow the capacity is auto-regrown
        # (collision.grow()) instead of aborting the run; the overflowed
        # step itself ran with dropped candidate pairs (logged).
        self._pending_overflow = None
        self.overflow_events = 0

    def _check_overflow(self) -> None:
        if self._pending_overflow is None:
            return
        flag, step_no = self._pending_overflow
        self._pending_overflow = None
        if not bool(flag):
            return
        self.overflow_events += 1
        if hasattr(self.collision, "grow"):
            self.collision = self.collision.grow()
            import warnings

            warnings.warn(
                f"collision capacity overflow at step {step_no} (candidate pairs "
                "exceeded the broadphase window or max_pairs); capacity regrown "
                "automatically — that step ran with dropped pairs",
                stacklevel=3,
            )
        else:
            raise RuntimeError(
                f"collision capacity overflow at step {step_no} — increase "
                "HydroelasticCollision(window=...) or max_pairs=..."
            )

    def step(self) -> dict:
        f_ext = self.base_f_ext
        overflow = None
        if self.collision is not None:
            self._check_overflow()
            f_col, patches, overflow = self.collision.step(
                self.state.x, self.state.v, self.collision_params
            )
            f_ext = f_ext + f_col
            self.last_patches = patches
            self._pending_overflow = (overflow, self.step_count)
        self.state, diag = self.solver_step(self.system, self.state, f_ext)
        if overflow is not None:
            # Device-side flag, no host sync: an overflowed step ran with
            # dropped candidate pairs, so its physics is suspect — tests and
            # benches assert zero-overflow runs via this key (the deferred
            # `_check_overflow` warning alone was write-only telemetry).
            diag["collision_overflow"] = overflow
        self.step_count += 1
        self.last_diag = diag
        return diag

    def run(self, n_steps: int, callback: Callable | None = None):
        for k in range(n_steps):
            diag = self.step()
            if callback is not None:
                callback(self, k, diag)
        return self.state

    # -- state injection (reference `UpdatePositions` /
    # `UpdateConstraintTargets`, `FEAT10Data.cuh:671-701`) ----------------
    def set_positions(self, x) -> None:
        # u=None: solvers re-derive displacements from the injected absolute
        # positions on the next step (see StepState.u).
        self.state = StepState(x=jnp.asarray(x), v=self.state.v, lam=self.state.lam)

    def set_constraint_targets(self, target) -> None:
        cons = self.system.constraints
        if cons is None or not hasattr(cons, "with_targets"):
            raise ValueError("system has no retargetable constraints")
        # .replace keeps every other field (the static options such as
        # fused_grad / accum_dtype) — rebuilding System would drop them.
        self.system = self.system.replace(
            constraints=cons.with_targets(jnp.asarray(target))
        )

    def set_pinned(self, idx, pinned: bool = True) -> None:
        """Change WHICH coefficients are pinned mid-run (the reference's
        `UpdateNodalFixed`, `FEAT10Data.cu:751-832`). Requires `DensePins`
        constraints (dense mask => fixed shapes => no retrace); newly pinned
        coefficients hold their CURRENT positions. The matching duals are
        zeroed so stale multipliers from a previous pinning epoch don't
        kick the node (dense lam shares the mask's indexing)."""
        from tlfea.constraints import DensePins

        cons = self.system.constraints
        if not isinstance(cons, DensePins):
            raise ValueError(
                "set_pinned requires DensePins constraints (FixedCoefs has "
                "static membership — rebuild the system, or switch to "
                "DensePins.from_indices)"
            )
        self.system = self.system.replace(
            constraints=cons.pinning(idx, pinned, x0=self.state.x)
        )
        idx = np.asarray(idx)
        self.state = self.state.replace(lam=self.state.lam.at[idx].set(0.0))

    # -- checkpoint / resume ---------------------------------------------
    def save_state(self, path: str) -> None:
        fields = dict(
            x=np.asarray(self.state.x),
            v=np.asarray(self.state.v),
            lam=np.asarray(self.state.lam),
            step_count=self.step_count,
        )
        if self.state.u is not None:
            fields["u"] = np.asarray(self.state.u)
        if self.state.dv is not None:
            fields["dv"] = np.asarray(self.state.dv)
        np.savez(path, **fields)

    def load_state(self, path: str) -> None:
        data = np.load(path)
        self.state = StepState(
            x=jnp.asarray(data["x"]),
            v=jnp.asarray(data["v"]),
            lam=jnp.asarray(data["lam"]),
            u=jnp.asarray(data["u"]) if "u" in data else None,
            dv=jnp.asarray(data["dv"]) if "dv" in data else None,
        )
        self.step_count = int(data["step_count"])
