"""AdamW first-order implicit solver.

Runs AdamW on the velocity unknowns against the ALM gradient. The reference
implements this twice — once as a persistent cooperative kernel with
`grid.sync()` between phases (`lib_src/solvers/SyncedAdamW.cu:96-359`) and
once as a host-orchestrated kernel stream for meshes exceeding the
cooperative-launch occupancy cap (`SyncedAdamWNocoop.cu:266-497`). Here a
single jitted `lax.while_loop` is both: every phase fuses into one XLA
executable with implicit grid-wide synchronization, and there is no scale
cap, so the coop/nocoop fork disappears (SURVEY P5/P6).

Update order matches the reference exactly (update-then-evaluate: the first
inner iteration applies a zero gradient): `SyncedAdamW.cu:156-212`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tlfea import struct
from tlfea.solvers.common import StepState, System, grad_L, flat_norm, constraint_values

__all__ = ["AdamWParams", "step", "make_step"]


@struct.dataclass
class AdamWParams:
    """Reference: `SyncedAdamW.cuh:27-34`."""

    dt: jnp.ndarray = 1e-3
    rho: jnp.ndarray = 1e6
    lr: jnp.ndarray = 1e-3
    beta1: jnp.ndarray = 0.9
    beta2: jnp.ndarray = 0.999
    eps: jnp.ndarray = 1e-8
    weight_decay: jnp.ndarray = 0.0
    lr_decay: jnp.ndarray = 1.0
    inner_tol: jnp.ndarray = 1e-6
    inner_rtol: jnp.ndarray = 0.0
    outer_tol: jnp.ndarray = 1e-8
    max_outer: int = struct.field(pytree_node=False, default=4)
    max_inner: int = struct.field(pytree_node=False, default=2000)
    convergence_check_interval: int = struct.field(pytree_node=False, default=50)


def _inner(v0, x_prev, v_prev, lam, f_ext, params: AdamWParams, system: System, u_prev=None):
    dt, rho = params.dt, params.rho

    def g_of(v):
        return grad_L(v, x_prev, v_prev, lam, f_ext, dt, rho, system, u_prev=u_prev)

    zeros = jnp.zeros_like(v0)

    def cond(carry):
        _, _, _, _, _, _, k, done, _ = carry
        return jnp.logical_and(k < params.max_inner, jnp.logical_not(done))

    def body(carry):
        v, g, m, s, lr, t, k, done, g0 = carry
        # Update-then-evaluate, matching SyncedAdamW.cu:156-172.
        lr = lr * params.lr_decay
        t = t + 1.0
        m = params.beta1 * m + (1.0 - params.beta1) * g
        s = params.beta2 * s + (1.0 - params.beta2) * g * g
        m_hat = m / (1.0 - params.beta1**t)
        s_hat = s / (1.0 - params.beta2**t)
        v = v - lr * (m_hat / (jnp.sqrt(s_hat) + params.eps) + params.weight_decay * v)

        g = g_of(v)

        check = (k % params.convergence_check_interval) == 0
        norm_g = flat_norm(g)
        g0 = jnp.where(jnp.logical_and(check, g0 < 0), norm_g, g0)
        norm_v = flat_norm(v)
        tol_abs = params.inner_tol * (1.0 + norm_v)
        tol_rel = jnp.where(
            jnp.logical_and(params.inner_rtol > 0.0, g0 > 0.0),
            params.inner_rtol * g0,
            0.0,
        )
        conv = jnp.logical_or(norm_g <= tol_abs, jnp.logical_and(tol_rel > 0.0, norm_g <= tol_rel))
        done = jnp.logical_or(done, jnp.logical_and(check, conv))
        return (v, g, m, s, lr, t, k + 1, done, g0)

    init = (v0, zeros, zeros, zeros, params.lr, jnp.asarray(1.0, v0.dtype), 0, False, jnp.asarray(-1.0, v0.dtype))
    v, g, _, _, _, _, iters, _, _ = jax.lax.while_loop(cond, body, init)
    return v, iters, flat_norm(g)


def _step(system: System, state: StepState, params: AdamWParams, f_ext):
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
            # First-order dual update: lam += rho * h * c (SyncedAdamW.cu:316-322).
            lam = lam + params.rho * params.dt * c
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


def make_step(system: System, params: AdamWParams):
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
