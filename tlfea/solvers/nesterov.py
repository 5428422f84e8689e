"""Nesterov accelerated-gradient first-order implicit solver.

True NAG with the t-sequence momentum schedule: look-ahead
y = v_k + beta (v_k - v_{k-1}) with beta = (t - 1)/t_next,
t_next = (1 + sqrt(1 + 4 t^2))/2, then v_next = y - alpha g(y)
(reference: `lib_src/solvers/SyncedNesterov.cu:151-258`). The reference runs
the whole multi-step ALM loop in one persistent cooperative CUDA kernel with
`grid.sync()` phase barriers (`SyncedNesterov.cu:95-379`); here one jitted
`lax.while_loop` is the native equivalent (SURVEY P5).

Convergence matches the reference's twin checks: |‖g‖ − ‖g_prev‖| < tol and
|‖v_next‖ − ‖v_k‖| < tol (`SyncedNesterov.cu:230-283`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tlfea import struct
from tlfea.solvers.common import StepState, System, grad_L, flat_norm, constraint_values

__all__ = ["NesterovParams", "step", "make_step"]


@struct.dataclass
class NesterovParams:
    """Reference: `SyncedNesterov.cuh:26-30`."""

    dt: jnp.ndarray = 1e-3
    rho: jnp.ndarray = 1e6
    alpha: jnp.ndarray = 1e-6  # gradient step size
    inner_tol: jnp.ndarray = 1e-6
    outer_tol: jnp.ndarray = 1e-8
    max_outer: int = struct.field(pytree_node=False, default=4)
    max_inner: int = struct.field(pytree_node=False, default=2000)


def _inner(v0, x_prev, v_prev, lam, f_ext, params: NesterovParams, system: System, u_prev=None):
    dt, rho = params.dt, params.rho

    def g_of(v):
        return grad_L(v, x_prev, v_prev, lam, f_ext, dt, rho, system, u_prev=u_prev)

    def cond(carry):
        _, _, _, k, done, _ = carry
        return jnp.logical_and(k < params.max_inner, jnp.logical_not(done))

    def body(carry):
        v_k, v_km1, t, k, done, prev_norm_g = carry
        t_next = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        beta = (t - 1.0) / t_next
        y = v_k + beta * (v_k - v_km1)

        g = g_of(y)
        norm_g = flat_norm(g)
        done_g = jnp.logical_and(k > 0, jnp.abs(norm_g - prev_norm_g) < params.inner_tol)

        v_next = y - params.alpha * g
        done_v = jnp.logical_and(
            k > 0, jnp.abs(flat_norm(v_next) - flat_norm(v_k)) < params.inner_tol
        )
        done = jnp.logical_or(done, jnp.logical_or(done_g, done_v))
        return (v_next, v_k, t_next, k + 1, done, norm_g)

    init = (v0, v0, jnp.asarray(1.0, v0.dtype), 0, False, jnp.asarray(0.0, v0.dtype))
    v, _, _, iters, _, norm_g = jax.lax.while_loop(cond, body, init)
    return v, iters, norm_g


def _step(system: System, state: StepState, params: NesterovParams, f_ext):
    from tlfea.elements.assembly import node_ref

    x_prev = state.x
    x_ref = node_ref(system.elems)
    u_prev = state.u if state.u is not None else x_prev - x_ref
    cons = system.constraints

    def outer_body(carry):
        v, v_prev, lam, k, _, inner_tot = carry
        v, n_it, _ = _inner(v, x_prev, v_prev, lam, f_ext, params, system, u_prev=u_prev)
        v_prev = v
        if cons is not None:
            c = constraint_values(cons, x_prev, v, params.dt, system.elems, u_prev=u_prev)
            lam = lam + params.rho * params.dt * c  # SyncedNesterov.cu:335-341
            norm_c = flat_norm(c)
        else:
            norm_c = jnp.zeros((), dtype=v.dtype)
        return (v, v_prev, lam, k + 1, norm_c, inner_tot + n_it)

    def outer_cond(carry):
        _, _, _, k, norm_c, _ = carry
        return jnp.logical_and(k < params.max_outer, jnp.logical_or(k == 0, norm_c >= params.outer_tol))

    init = (state.v, state.v, state.lam, 0, jnp.asarray(jnp.inf, state.v.dtype), 0)
    v, _, lam, outers, norm_c, inner_tot = jax.lax.while_loop(outer_cond, outer_body, init)
    u = u_prev + params.dt * v  # displacement-scale update (see StepState.u)
    x = (x_ref + u).astype(x_prev.dtype)
    return StepState(x=x, v=v, lam=lam, u=u), {
        "outer_iters": outers,
        "inner_iters": inner_tot,
        "norm_c": norm_c,
    }


step = jax.jit(_step)


def make_step(system: System, params: NesterovParams):
    @jax.jit
    def _f(state, f_ext):
        return _step(system, state, params, f_ext)

    return _f


def stepper(params):
    """Jitted step(system, state, f_ext) — the `Simulation` contract; the
    system is a pytree argument, so constraint targets / material parameters
    may change between calls without retracing."""

    @jax.jit
    def _f(system, state, f_ext):
        return _step(system, state, params, f_ext)

    return _f
