"""Colored Vertex Block Descent implicit solver.

Nonlinear block Gauss-Seidel over graph-colored coefficients: per color,
every coefficient independently takes a damped Newton step on its local 3x3
system

  H_a dv_a = -g_a,

with g the exact ALM gradient and H_a the per-coefficient diagonal tangent
block (reference: `lib_src/solvers/SyncedVBD.cu:162-377`).

Round-2 design (SURVEY P7/P8): the round-1 port gathered each color's
padded (element, qp) incidence lists (~6 gathers per color). The FUSED
full-mesh residual (one gather + one scatter) measured cheaper than two
incidence gathers, so instead:

- the residual is refreshed as the full ALM gradient once per color GROUP
  (the reference's `color_group_size` staleness/throughput trade,
  `SyncedVBD.cu:950-996`; within a group colors see the group-start
  residual — the reference similarly caches P within a group);
- the 3x3 blocks H_a are the solver-shared `precond_blocks` (SPD-shifted
  diagonal tangents), frozen per outer iteration — the reference extracts
  the same blocks per sweep from cached F;
- each color update is then: one M-row gather of g, one batched 3x3 solve,
  one M-row scatter of dv. No incidence structures at all.

A consequence of using `grad_L`/`precond_blocks` wholesale: this VBD
supports every constraint family the other solvers do (including general
LinearConstraints, which the reference's VBD does not — it handles pins
only, `SyncedVBD.cu:1089-1118`).

POSITIONING: a correctness/parity path until measured otherwise. Its sweep
is a serial chain of ~n_colors small ops; whether the H100 runs that fast
enough for a bench cell is open (ROADMAP R11, `benchmarks/vbd_converged.py`).
Keep group_size small (default 4): staler group residuals diverge at
omega=1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tlfea import struct
from tlfea.ops.linalg import solve3x3
from tlfea.solvers.common import (
    StepState, System, grad_L, precond_blocks, flat_norm, constraint_values,
)
from tlfea.utils.coloring import colors_and_incidence, pad_colors

__all__ = ["VBDParams", "VBDStructures", "prepare", "make_step", "stepper"]


@struct.dataclass
class VBDParams:
    """Reference: `SyncedVBD.cuh:28-36`."""

    dt: jnp.ndarray = 1e-3
    rho: jnp.ndarray = 1e6
    omega: jnp.ndarray = 1.0  # relaxation
    hess_eps: jnp.ndarray = 1e-9  # trace-scaled regularization
    inner_tol: jnp.ndarray = 1e-6  # residual-norm tolerance
    outer_tol: jnp.ndarray = 1e-8
    max_outer: int = struct.field(pytree_node=False, default=4)
    max_sweeps: int = struct.field(pytree_node=False, default=50)
    color_group_size: int = struct.field(pytree_node=False, default=4)
    convergence_check_interval: int = struct.field(pytree_node=False, default=4)


@struct.dataclass
class VBDStructures:
    """Static coloring data (host-precomputed; the reference's lazy
    `InitializeColoring`, `SyncedVBD.cu:764-1017`)."""

    color_nodes: jnp.ndarray  # (G, gs, M) int32
    color_mask: jnp.ndarray  # (G, gs, M) bool
    n_groups: int = struct.field(pytree_node=False)
    group_size: int = struct.field(pytree_node=False)


def prepare(system: System, group_size: int = 4, dtype=None) -> VBDStructures:
    """Host-side greedy coloring packed into conflict-free groups."""
    conn = np.asarray(system.elems.conn)
    n_coef = system.elems.n_coef
    colors, _inc, _inc_mask = colors_and_incidence(conn, n_coef)
    nodes, mask = pad_colors(colors, group_size)
    return VBDStructures(
        color_nodes=jnp.asarray(nodes),
        color_mask=jnp.asarray(mask),
        n_groups=int(nodes.shape[0]),
        group_size=int(nodes.shape[1]),
    )


def _step_impl(system: System, structures: VBDStructures, params: VBDParams, state: StepState, f_ext):
    cons = system.constraints
    dt = params.dt
    eye = jnp.eye(3, dtype=state.v.dtype)

    def g_of(v, x_prev, v_prev, lam, u_prev=None):
        return grad_L(v, x_prev, v_prev, lam, f_ext, dt, params.rho, system, u_prev=u_prev)

    def sweep(v, x_prev, v_prev, lam, blocks, u_prev):
        """One full inner sweep over all color groups."""

        def group_body(g, v):
            # Residual refreshed once per group (stress + mass + constraint
            # terms all current as of group start).
            grad = g_of(v, x_prev, v_prev, lam, u_prev=u_prev)

            def color_body(s, v):
                nodes = structures.color_nodes[g, s]
                nmask = structures.color_mask[g, s]
                r = grad[nodes]  # (M, 3)
                H = blocks[nodes]
                tr = H[..., 0, 0] + H[..., 1, 1] + H[..., 2, 2]
                H = H + (params.hess_eps * jnp.maximum(1.0, tr))[:, None, None] * eye
                dv = -params.omega * solve3x3(H, r, eps=1e-30)
                dv = jnp.where(nmask[:, None], dv, 0.0)
                return v.at[nodes].add(dv)

            return jax.lax.fori_loop(0, structures.group_size, color_body, v)

        return jax.lax.fori_loop(0, structures.n_groups, group_body, v)

    def inner(v0, x_prev, v_prev, lam, u_prev):
        # Frozen SPD diagonal blocks for the whole inner solve (the
        # reference re-extracts them from cached F per sweep; freshness
        # barely affects the fixed point, which is g = 0 regardless).
        blocks = precond_blocks(v0, x_prev, dt, params.rho, system, u_prev=u_prev)

        def cond(carry):
            _, k, done = carry
            return jnp.logical_and(k < params.max_sweeps, jnp.logical_not(done))

        def body(carry):
            v, k, done = carry
            v = sweep(v, x_prev, v_prev, lam, blocks, u_prev)
            check = (k % params.convergence_check_interval) == 0
            norm_g = jnp.where(
                check, flat_norm(g_of(v, x_prev, v_prev, lam, u_prev=u_prev)), jnp.inf
            )
            done = jnp.logical_or(done, norm_g < params.inner_tol)
            return (v, k + 1, done)

        v, sweeps, _ = jax.lax.while_loop(cond, body, (v0, 0, False))
        return v, sweeps

    def _run(state: StepState, f_ext):
        from tlfea.elements.assembly import node_ref

        x_prev = state.x
        x_ref = node_ref(system.elems)
        u_prev = state.u if state.u is not None else x_prev - x_ref

        def outer_body(carry):
            v, v_prev, lam, k, _, sweeps_tot = carry
            v, n_sweeps = inner(v, x_prev, v_prev, lam, u_prev)
            v_prev = v
            if cons is not None:
                c = constraint_values(cons, x_prev, v, dt, system.elems,
                                      u_prev=u_prev)
                lam = lam + params.rho * c  # SyncedVBD.cu:456-464
                norm_c = flat_norm(c)
            else:
                norm_c = jnp.zeros((), dtype=v.dtype)
            return (v, v_prev, lam, k + 1, norm_c, sweeps_tot + n_sweeps)

        def outer_cond(carry):
            _, _, _, k, norm_c, _ = carry
            return jnp.logical_and(
                k < params.max_outer, jnp.logical_or(k == 0, norm_c >= params.outer_tol)
            )

        init = (state.v, state.v, state.lam, 0, jnp.asarray(jnp.inf, state.v.dtype), 0)
        v, _, lam, outers, norm_c, sweeps = jax.lax.while_loop(outer_cond, outer_body, init)
        u = u_prev + dt * v  # displacement-scale update (see StepState.u)
        x = (x_ref + u).astype(x_prev.dtype)
        return StepState(x=x, v=v, lam=lam, u=u), {
            "outer_iters": outers,
            "sweeps": sweeps,
            "norm_c": norm_c,
        }

    return _run(state, f_ext)


def make_step(system: System, params: VBDParams, structures: VBDStructures | None = None):
    """Return a jitted step(state, f_ext) for a fixed system."""
    if structures is None:
        structures = prepare(system, group_size=params.color_group_size)

    @jax.jit
    def _f(state, f_ext):
        return _step_impl(system, structures, params, state, f_ext)

    return _f


def stepper(params: VBDParams, structures: VBDStructures):
    """Return a jitted step(system, state, f_ext) — the `Simulation`
    contract, supporting dynamic constraint targets / material params."""

    @jax.jit
    def _f(system, state, f_ext):
        return _step_impl(system, structures, params, state, f_ext)

    return _f
