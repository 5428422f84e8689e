"""Shared machinery for the implicit time-step solvers.

Every solver integrates the same dynamics: one backward-Euler step
x_{n+1} = x_n + h v_{n+1} is found as an Augmented-Lagrangian optimization
over the velocity v:

  g(v) = M (v - v_prev)/h + f_int(x_prev + h v) - f_ext
         + h J^T (lambda + rho c(x_prev + h v))

(the reference's `solver_grad_L`, `lib_src/solvers/SyncedNewton.cu:343-407`).
Inner loops minimize over v (Newton-PCG, Nesterov, AdamW, or VBD); the outer
loop updates duals lambda += rho * c (Newton, `SyncedNewton.cu:470-481`) or
lambda += rho * h * c (first-order solvers, `SyncedNesterov.cu:335-341`) and
stops when ||c|| < outer_tol.

The whole step — inner loop, convergence predicates, dual updates — lives
inside one jitted function using `lax.while_loop`, so there is no
device->host readback per iteration (the reference reads ||g|| back to the
host every inner iteration: `SyncedNewton.cu:1063-1074`).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from tlfea import struct
from tlfea.elements.assembly import ElementBatch, internal_force, mass_matvec, mass_diag, node_ref
from tlfea.ops.segment import gather_coefs

__all__ = [
    "System", "StepState", "grad_L", "eval_constraints", "constraint_values",
    "precond_blocks", "suggest_rho",
]


@struct.dataclass
class System:
    """Static problem definition: elements + material + constraints.

    `constraints` is None, a FixedCoefs, or a LinearConstraints pytree.
    External force is passed per-step (it changes under collision coupling).
    """

    elems: ElementBatch
    material: Any
    constraints: Any = None
    # Fuse mass+internal-force (+pin-constraint) contributions into a single
    # gather/scatter pair per gradient (fewer gather/scatter passes over
    # the node arrays). Static so it participates in
    # the jit cache key (round-1 review: env-var toggles inside traced code
    # silently shared compile caches).
    fused_grad: bool = struct.field(pytree_node=False, default=True)
    # Accumulation dtype for the residual scatter-add ('float64' or None).
    # At high stiffness the per-slot element forces are ~1e5x the net nodal
    # residual; f32 scatter cancellation then floors ||g|| at ~1% of the
    # load. Accumulating just the scatter (and the f_ext subtract) in f64
    # removes that floor while element kernels stay f32 — the mixed-precision
    # answer to the reference's all-f64 CUDA assembly.
    accum_dtype: str | None = struct.field(pytree_node=False, default=None)

    @property
    def n_coef(self) -> int:
        return self.elems.n_coef


@struct.dataclass
class StepState:
    """Dynamic state advanced step to step.

    `u` (displacements x - x_ref) is the PRIMARY mechanical state: solvers
    advance u and derive x = x_ref + u for geometry consumers (collision,
    IO). Storing only absolute x quantizes the state at eps*|x| (coordinate
    scale), which floors the achievable f32 residual at ~1% of the load for
    stiff problems; u's quantization is eps*|u| (displacement scale), 100x+
    finer. `u=None` (e.g. states built by hand or loaded from old
    checkpoints) makes solvers fall back to u = x - x_ref once per step.
    """

    x: jnp.ndarray  # (n_coef, 3) coefficient positions (derived geometry)
    v: jnp.ndarray  # (n_coef, 3) coefficient velocities
    lam: jnp.ndarray  # dual variables, shaped like eval_constraints output
    u: jnp.ndarray | None = None  # (n_coef, 3) displacements (primary)
    # Velocity increment of the last completed step (v_new - v_prev). Used by
    # Newton to warm-start the iterate at v + dv (constant-acceleration
    # extrapolation): measured Newton 3 -> 2 and CG halved per converged step
    # on the bench problem. Purely an iterate initial guess — the converged
    # backward-Euler solution is unchanged. None (hand-built states) starts
    # from v.
    dv: jnp.ndarray | None = None

    @staticmethod
    def rest(system: System, x0: jnp.ndarray) -> "StepState":
        x0 = jnp.asarray(x0)
        cons = system.constraints
        if cons is None:
            lam = jnp.zeros((0,), dtype=x0.dtype)
        else:
            c0 = eval_constraints(cons, x0)
            lam = jnp.zeros_like(c0)
        x_ref = node_ref(system.elems).astype(x0.dtype)
        return StepState(x=x0, v=jnp.zeros_like(x0), lam=lam, u=x0 - x_ref,
                         dv=jnp.zeros_like(x0))


def eval_constraints(cons, x: jnp.ndarray):
    """c(x); shape (C, 3) for FixedCoefs or (n_rows,) for LinearConstraints."""
    return cons.eval_c(x)


def constraint_values(cons, x_prev, v, dt, elems, u_prev=None):
    """c(x_prev + dt v) evaluated in displacement space.

    Groups the arithmetic as c = (u_prev + dt v) - target_u so the dt*v
    increment is never added to coordinate-scale values first — in f32,
    x_prev + dt*v rounds increments below eps*|x| away entirely (see
    ElementBatch.x_ref). Pass u_prev (the stored StepState.u) to avoid
    re-deriving it from quantized absolute positions."""
    x_ref = node_ref(elems)
    if u_prev is None:
        u_prev = x_prev - x_ref
    # c is a small violation — downcast to the working dtype so dual
    # updates don't promote when u is carried wide (accuracy mode).
    return cons.eval_c_u(u_prev + dt * v, x_ref).astype(v.dtype)


def grad_L(
    v: jnp.ndarray,
    x_prev: jnp.ndarray,
    v_prev: jnp.ndarray,
    lam: jnp.ndarray,
    f_ext: jnp.ndarray,
    dt,
    rho,
    system: System,
    u_prev=None,
) -> jnp.ndarray:
    """ALM gradient g(v), shape (n_coef, 3). Pure in v -> exact Hv via jax.jvp.

    All hot paths evaluate in DISPLACEMENT space u = u_prev + dt*v: forming
    absolute x = x_prev + dt*v first would round dt*v increments below
    eps*|x| away in f32 and stall Newton on stiff problems (see
    ElementBatch.x_ref). u_prev defaults to x_prev - x_ref; pass the stored
    StepState.u for the full displacement-resolution state.

    Constraint folding: FixedCoefs rides the single element scatter-add
    (extra rows); DensePins is pure dense math (apply_jt is a mask
    multiply); LinearConstraints applies J^T via its own scatter."""
    from tlfea.constraints import FixedCoefs

    elems = system.elems
    x_ref = node_ref(elems)
    if u_prev is None:
        u_prev = x_prev - x_ref
    u = u_prev + dt * v
    cons = system.constraints
    if system.fused_grad:
        from tlfea.elements.assembly import _element_contrib_values
        from tlfea.ops.segment import coef_scatter_add

        contrib = _element_contrib_values(
            u, v, (v - v_prev) / dt, elems, system.material,
            compute_dtype=system.accum_dtype,
        )
        idx = elems.conn.reshape(-1)
        vals = contrib.reshape(-1, 3)
        if isinstance(cons, FixedCoefs):
            # Fold the constraint force h (lam + rho c) into the same
            # scatter (one scatter-add per gradient, total).
            c = cons.eval_c_u(u, x_ref)
            idx = jnp.concatenate([idx, cons.idx])
            vals = jnp.concatenate([vals, dt * (lam + rho * c)], axis=0)
        acc = jnp.dtype(system.accum_dtype) if system.accum_dtype else v.dtype
        out = jnp.zeros((elems.n_coef, 3), dtype=acc)
        g = (out.at[idx].add(vals.astype(acc)) - f_ext.astype(acc)).astype(v.dtype)
        if cons is not None and not isinstance(cons, FixedCoefs):
            c = cons.eval_c_u(u, x_ref)
            g = g + dt * cons.apply_jt(lam + rho * c, elems.n_coef)
        return g

    # Legacy unfused path (validation/profiling): absolute-coordinate eval.
    x = x_prev + dt * v
    g = mass_matvec(v - v_prev, elems) / dt
    g = g + internal_force(x, v, elems, system.material) - f_ext
    if cons is not None:
        c = eval_constraints(cons, x)
        g = g + dt * cons.apply_jt(lam + rho * c, elems.n_coef)
    return g


def precond_blocks(
    v: jnp.ndarray,
    x_prev: jnp.ndarray,
    dt,
    rho,
    system: System,
    u_prev=None,
) -> jnp.ndarray:
    """Block-Jacobi 3x3 preconditioner blocks of dg/dv -> (n_coef, 3, 3).

    H_aa ~= m_aa/h I + h * sum_{(e,q): a in e} K_block(F_eq, gradN_eqa) dV
            + h^2 rho (J^T J)_aa.

    The same per-node blocks the reference computes for VBD
    (`SyncedVBD.cu:162-377`) and that its unused CG scaffolding anticipated
    (`SyncedNewton.cuh:105-109`).
    """
    elems = system.elems
    if u_prev is None:
        u_prev = x_prev - node_ref(elems)
    # Preconditioner quality is insensitive to the wide-u accuracy mode —
    # work in the solver dtype.
    u = (u_prev + dt * v).astype(v.dtype)
    ue = gather_coefs(u, elems.conn)  # (E, S, 3)
    Du = jnp.einsum("eai,eqaj->eqij", ue, elems.grad_N)
    F = Du + jnp.eye(3, dtype=Du.dtype)  # (E, Q, 3, 3)
    # (E, Q, S, 3, 3) diag tangent blocks, weighted by dt * dV.
    Kb = system.material.tangent_diag_block(F[:, :, None, :, :], elems.grad_N)
    Kb = Kb * (dt * elems.dV)[:, :, None, None, None]
    Kb = Kb.sum(axis=1)  # (E, S, 3, 3)
    blocks = jnp.zeros((elems.n_coef, 3, 3), dtype=v.dtype)
    blocks = blocks.at[elems.conn.reshape(-1)].add(Kb.reshape(-1, 3, 3))

    # Kelvin-Voigt viscous tangent: f_vis is linear in v through
    # Fdot = sum_a v_a grad_N_a (no dt factor), and its diagonal block has
    # the same lam*A + mu*B structure as the elastic one with
    # (lam_d, eta) in place of (dt*lam, dt*mu). Fold it in as a scalar
    # proportionality factor (exact for proportional damping; a
    # preconditioner-quality approximation otherwise). Without this, heavy
    # damping (eta/dt >> E) leaves the dominant Hessian term
    # unpreconditioned and CG stalls.
    mat = system.material
    eta_d = getattr(mat, "eta_damp", 0.0)
    lam_d = getattr(mat, "lam_damp", 0.0)
    lam_mu = mat.lam + mat.mu if hasattr(mat, "lam") else None
    if lam_mu is not None:
        blocks = blocks * (1.0 + (eta_d + lam_d) / (dt * lam_mu))

    eye = jnp.eye(3, dtype=v.dtype)
    md = mass_diag(elems) / dt  # (n_coef,)
    blocks = blocks + md[:, None, None] * eye

    cons = system.constraints
    if cons is not None:
        d = cons.jtj_diag(elems.n_coef, v.dtype)  # (n_coef,) or (n_coef, 3)
        if d.ndim == 1:
            blocks = blocks + (dt * dt * rho) * d[:, None, None] * eye
        else:
            blocks = blocks + (dt * dt * rho) * jnp.einsum("ad,de->ade", d, eye)

    # PCG requires an SPD preconditioner; the raw blocks can be indefinite
    # (large-deformation SVK tangents, or the reference-parity keast5 mass
    # whose negative quadrature weight makes even mass diagonals negative).
    # Symmetrize and shift by the Gershgorin lower-bound deficit.
    blocks = 0.5 * (blocks + jnp.swapaxes(blocks, -1, -2))
    offdiag = jnp.sum(jnp.abs(blocks), axis=-1) - jnp.abs(
        jnp.diagonal(blocks, axis1=-2, axis2=-1)
    )
    lmin_lb = jnp.min(jnp.diagonal(blocks, axis1=-2, axis2=-1) - offdiag, axis=-1)
    scale = jnp.maximum(jnp.abs(blocks).max(axis=(-2, -1)), 1e-30)
    shift = jnp.maximum(-lmin_lb, 0.0) + 1e-7 * scale
    blocks = blocks + shift[:, None, None] * eye
    # Keep the solver's working dtype even when u is carried wide (the
    # mixed-precision accuracy mode stores ONLY u in f64; see StepState.u).
    return blocks.astype(v.dtype)


def flat_norm(a: jnp.ndarray) -> jnp.ndarray:
    """L2 norm of an arbitrarily-shaped array viewed as a flat vector."""
    return jnp.sqrt(jnp.sum(a * a))


def suggest_rho(elems: ElementBatch, material, dt: float) -> float:
    """ALM penalty scaled to the problem stiffness: rho ~ E * h_elem / dt.

    The penalty stiffness dt^2*rho must be comparable to the elastic
    stiffness dt*k_elem (~ dt*E*h) at constrained nodes. A much weaker
    penalty leaves constraint enforcement to the dual integral action
    (lam += rho c per outer iteration), which couples unstably with
    barely-damped structural oscillation — |lam| and the kinetic energy
    then grow exponentially in ANY precision (measured at E=7e8 with the
    round-1 default rho=1e7; see docs/ARCHITECTURE.md "Float32 convergence
    floor").

    Host-side helper (concrete numbers in, float out); call once at setup.
    """
    E_mod = float(np.asarray(material.mu)) * 2.0 + float(np.asarray(material.lam))
    vol = float(np.asarray(elems.dV).sum()) / max(elems.n_elem, 1)
    h = vol ** (1.0 / 3.0)
    return E_mod * h / float(dt)
