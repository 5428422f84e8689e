"""Matrix-free Newton-PCG implicit solver — this repo's replacement for
the reference's `SyncedNewtonSolver` + cuDSS direct sparse Cholesky
(`lib_src/solvers/SyncedNewton.cu:909-1394`).

Why not a direct solve: XLA has no sparse factorization among its device
ops, and the reference's per-iteration pattern (assemble global CSR ->
factorize -> solve) is host-orchestrated with device->host norm readbacks
every inner iteration (`SyncedNewton.cu:1063-1074`). Here the Newton system

    H delta_v = -g,   H = M/h + h K_t(x) [+ C_visc] + h^2 rho J^T J

is solved by preconditioned conjugate gradients where H @ p is an exact
Hessian-vector product `jax.jvp(grad_L, v, p)` — no global matrix, no
sparsity analysis (the reference's `AnalyzeHessianSparsity`,
`SyncedNewton.cu:546-907`, has no equivalent here because nothing is
assembled). The preconditioner is block-Jacobi with analytic per-node 3x3
tangent blocks. The entire ALM step (outer dual loop, inner Newton loop,
inner-inner PCG loop) is a single jitted computation using `lax.while_loop`
with on-device predicates.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tlfea import struct
from tlfea.ops.linalg import inv3x3
from tlfea.solvers.common import (
    StepState, System, grad_L, precond_blocks, flat_norm, constraint_values,
)

__all__ = ["NewtonParams", "step", "make_step", "make_rollout"]


@struct.dataclass
class NewtonParams:
    """Tolerances/iteration caps (reference: `SyncedNewton.cuh:29-33`)."""

    dt: jnp.ndarray = 1e-3
    rho: jnp.ndarray = 1e6  # ALM penalty
    inner_atol: jnp.ndarray = 1e-7
    inner_rtol: jnp.ndarray = 0.0
    outer_tol: jnp.ndarray = 1e-8
    max_outer: int = struct.field(pytree_node=False, default=4)
    max_inner: int = struct.field(pytree_node=False, default=20)
    cg_rtol: jnp.ndarray = 1e-4  # CG tolerance floor
    cg_max_iter: int = struct.field(pytree_node=False, default=200)
    # Newton warm-start: initial iterate v0 = v + predict * dv with dv the
    # previous step's velocity increment (StepState.dv). predict=1 is
    # constant-acceleration extrapolation — measured Newton 3 -> 2 / CG
    # halved per converged bench step; the converged solution is unchanged
    # (it's only the iterate's starting point). Set 0.0 to disable.
    predict: jnp.ndarray = 1.0
    # Trust-region-style step bound: rescale each Newton update so
    # ||dv||_2 <= max_dv (0 = unbounded, the default). Superseded by the
    # scale-free `ls_max` backtracking safeguard below (kept for
    # compatibility / A-B experiments; both may be active).
    max_dv: jnp.ndarray = 0.0
    # Residual-norm backtracking safeguard (scale-free globalization,
    # replaces per-scene `max_dv` tuning). The SVK tangent is INDEFINITE
    # under strong compression (contact onset); CG's negative-curvature
    # guard stops iterating but still returns the partial step, which can
    # be unboundedly bad — one such step was
    # measured teleporting a self-contact run from vmax 1.5 to 1e19 m/s.
    # When CG reports it hit non-positive curvature (the only source of
    # such directions — an SPD solve always yields a descent direction for
    # ||g||), the update is backtracked: try t = 1, 1/2, ... 2^-(ls_max-1),
    # accept the first t with ||g(v + t dv)|| <= (1 - 1e-4 t) ||g(v)||,
    # else take the best t seen. Costs one extra gradient evaluation per
    # TRIAL, and nothing at all on healthy steps (lax.cond). 0 disables.
    ls_max: int = struct.field(pytree_node=False, default=8)
    # Eisenstat-Walker adaptive forcing (choice 2): per-Newton-iteration CG
    # tolerance eta_k = clamp(0.9 (||g_k||/||g_{k-1}||)^2, cg_rtol,
    # ew_eta_max). Early Newton iterations then use loose CG solves (SURVEY
    # hard part #1 mitigation); set ew_eta_max = 0 to disable.
    ew_eta_max: jnp.ndarray = 0.5


def _pcg(hvp, precond, b, rtol, max_iter):
    """Preconditioned CG for H x = b; returns (x, n_iters, final ||r||,
    neg_curv) — neg_curv flags that an H-conjugate direction with
    non-positive curvature was encountered (indefinite H; the returned x is
    the partial iterate and needs a globalization safeguard).

    hvp: p -> H @ p; precond: r -> M^{-1} r; all over (n_coef, 3) arrays.
    """

    def dot(a, c):
        return jnp.sum(a * c)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    p0 = z0
    rz0 = dot(r0, z0)
    bnorm = flat_norm(b)
    tol2 = (rtol * bnorm) ** 2

    # Numerical floor: even with tol = 0 (fixed-budget benchmarking), stop
    # once the residual reaches f32/f64 noise — running CG past convergence
    # corrupts the iterate (denominators underflow).
    eps_floor = jnp.asarray(1e-30 if b.dtype == jnp.float64 else 1e-18, b.dtype)
    tol2 = jnp.maximum(tol2, eps_floor * jnp.maximum(bnorm, 1.0) ** 2)

    def cond(carry):
        _, r, _, _, rz, k, _ = carry
        ok = jnp.logical_and(dot(r, r) > tol2, rz > 0)
        return jnp.logical_and(k < max_iter, ok)

    def body(carry):
        x, r, p, z, rz, k, neg = carry
        hp = hvp(p)
        denom = dot(p, hp)
        # Non-positive curvature (or breakdown): take no step and terminate
        # via the rz guard next round.
        good = denom > 0
        alpha = jnp.where(good, rz / jnp.where(good, denom, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * hp
        z = precond(r)
        rz_new = jnp.where(good, dot(r, z), 0.0)
        beta = jnp.where(rz > 0, rz_new / jnp.where(rz > 0, rz, 1.0), 0.0)
        p = z + beta * p
        return (x, r, p, z, rz_new, k + 1, jnp.logical_or(neg, ~good))

    x, r, _, _, _, k, neg = jax.lax.while_loop(
        cond, body, (x0, r0, p0, z0, rz0, 0, jnp.asarray(False))
    )
    return x, k, flat_norm(r), neg


def _newton_inner(v0, x_prev, v_prev, lam, f_ext, params: NewtonParams, system: System, coarse=None, inv_blocks=None, u_prev=None):
    """Inner Newton loop at fixed duals; returns (v, iters, ||g||).

    inv_blocks: optional precomputed inverted block-Jacobi blocks (n, 3, 3)
    — pass to reuse a (possibly slightly stale) preconditioner across steps
    (see `make_rollout`); staleness only affects CG iteration count, never
    correctness.
    u_prev: stored displacement state (StepState.u) for full f32
    displacement-scale resolution; falls back to x_prev - x_ref.
    """
    dt, rho = params.dt, params.rho

    def g_of(v):
        return grad_L(v, x_prev, v_prev, lam, f_ext, dt, rho, system, u_prev=u_prev)

    def linearize_g(v):
        # One primal pass; CG applies its tangent-only linearization.
        return jax.linearize(g_of, v)

    # Frozen block-Jacobi preconditioner: assembled once per inner solve at
    # the incoming iterate (tangent blocks are the most expensive single
    # computation in the step; freshness barely affects CG quality). The
    # reference's cuDSS analog is REFACTORIZATION reuse
    # (`SyncedNewton.cu:1101-1108`).
    if inv_blocks is None:
        blocks0 = precond_blocks(v0, x_prev, dt, rho, system, u_prev=u_prev)
        # Invert once per inner solve: the block-Jacobi apply sits on the CG
        # critical path, and a 3x3 matvec per iteration beats re-running the
        # adjugate solve every iteration.
        inv_blocks0 = inv3x3(blocks0, eps=1e-30)
    else:
        inv_blocks0 = inv_blocks

    def bj_apply(r):
        return jnp.einsum("nij,nj->ni", inv_blocks0, r)

    if coarse is not None and hasattr(coarse, "apply"):
        # Frozen two-level correction (CoarsePrecond): matmul-based apply,
        # no per-solve assembly (see tlfea.solvers.coarse).
        def precond(r):
            return bj_apply(r) + coarse.apply(r)

    elif coarse is not None:
        # Legacy per-solve Galerkin assembly (CoarseSetup): exact at the
        # current iterate, expensive — kept for validation.
        from tlfea.solvers.coarse import coarse_operator, make_two_level_precond

        Ac = coarse_operator(
            x_prev + dt * v0, system.elems, system.material,
            system.constraints, coarse, dt, rho,
        )
        chol = jax.scipy.linalg.cho_factor(Ac, lower=True)[0]
        precond = make_two_level_precond(
            precond_blocks(v0, x_prev, dt, rho, system, u_prev=u_prev), chol, coarse
        )
    else:
        precond = bj_apply

    tiny = jnp.asarray(jnp.finfo(v0.dtype).tiny, v0.dtype)

    def cond(carry):
        v, k, done, *_ = carry
        return jnp.logical_and(k < params.max_inner, jnp.logical_not(done))

    def body(carry):
        v, k, done, norm_g, norm_g0, norm_g_prev, cg_total, hist = carry
        # One primal gradient evaluation per Newton iteration; CG applies its
        # tangent-only linearization (the round-1 jvp path recomputed the
        # full primal residual inside every Hessian-vector product).
        g, hvp = linearize_g(v)
        norm_g_new = flat_norm(g)
        norm_g0 = jnp.where(k == 0, norm_g_new, norm_g0)
        # Per-iteration ||g|| telemetry (the reference prints these every
        # inner iteration, `SyncedNewton.cu:1065`; recorded on-device).
        hist = hist.at[k].set(norm_g_new)
        conv = jnp.logical_or(
            norm_g_new < params.inner_atol,
            jnp.logical_and(
                params.inner_rtol > 0.0, norm_g_new <= params.inner_rtol * norm_g0
            ),
        )
        # Eisenstat-Walker forcing (choice 2): eta_k = 0.9 (g_k/g_{k-1})^2,
        # clipped to [cg_rtol, ew_eta_max] — loose CG early, tight as Newton
        # converges. First iteration has no history: use the loose end.
        emax = jnp.maximum(params.ew_eta_max, params.cg_rtol)
        ratio = norm_g_new / jnp.maximum(norm_g_prev, tiny)
        eta = jnp.clip(0.9 * ratio * ratio, params.cg_rtol, emax)
        eta = jnp.where(k == 0, emax, eta)

        def do_cg(_):
            dv, it, _r, neg = _pcg(hvp, precond, -g, eta, params.cg_max_iter)
            return dv, jnp.asarray(it, jnp.int32), neg

        def skip(_):
            return jnp.zeros_like(v), jnp.asarray(0, jnp.int32), jnp.asarray(False)

        dv, cg_iters, neg_curv = jax.lax.cond(conv, skip, do_cg, None)
        # Bounded step (params.max_dv): legacy opt-in rescale. No-op at the
        # default max_dv == 0 (the ls_max safeguard below is the principled
        # replacement).
        dv_norm = flat_norm(dv)
        bound_on = params.max_dv > 0
        scale = jnp.where(
            jnp.logical_and(bound_on, dv_norm > params.max_dv),
            params.max_dv / jnp.maximum(dv_norm, tiny),
            jnp.ones((), dv.dtype),
        )
        dv = scale * dv

        # Scale-free globalization (NewtonParams.ls_max): a Newton direction
        # from an SPD solve is always a descent direction for ||g|| — only
        # when CG encountered NON-POSITIVE curvature (or produced non-finite
        # values) can the partial step be arbitrarily bad, so only then pay
        # for a residual-norm backtracking search. lax.cond keeps the search
        # entirely off the healthy-step execution path.
        suspicious = jnp.logical_or(neg_curv, ~jnp.isfinite(dv_norm))

        def take_full(vdvg):
            vv, dvv, _ = vdvg
            return vv + dvv

        def backtrack(vdvg):
            vv, dvv, gn0 = vdvg

            def ls_cond(c):
                t, j, _bt, _bg, done = c
                return jnp.logical_and(j < params.ls_max, ~done)

            def ls_body(c):
                t, j, best_t, best_gn, _ = c
                # Gradient-only evaluation on the fast path (the linearized
                # hvp half is unused and DCE'd by XLA).
                gn = flat_norm(linearize_g(vv + t * dvv)[0])
                better = gn < best_gn  # False for NaN: best stays as-is
                best_t = jnp.where(better, t, best_t)
                best_gn = jnp.where(better, gn, best_gn)
                done = gn <= (1.0 - 1e-4 * t) * gn0
                return (t * 0.5, j + 1, best_t, best_gn, done)

            # best starts at (t=0, ||g(v)||): if EVERY trial fails the
            # sufficient-decrease test (or all trial gradients are NaN — a
            # non-finite dv makes every vv + t*dvv non-finite), the fallback
            # step is ZERO, never a residual-increasing or NaN update. A
            # rejected step costs one wasted inner iteration; the previous
            # fallback (best_t = t_min = 2^-(ls_max-1), relative) still
            # teleported the iterate by 1/128 of an unbounded CG direction.
            one = jnp.ones((), vv.dtype)
            _, _, best_t, _, _ = jax.lax.while_loop(
                ls_cond, ls_body,
                (one, jnp.asarray(0, jnp.int32), jnp.zeros((), vv.dtype),
                 gn0, jnp.asarray(False)),
            )
            return vv + best_t * dvv

        if params.ls_max > 0:
            v = jax.lax.cond(suspicious, backtrack, take_full,
                             (v, dv, norm_g_new))
        else:
            v = v + dv
        k = k + jnp.where(conv, 0, 1)
        return (v, k, conv, norm_g_new, norm_g0, norm_g_new, cg_total + cg_iters, hist)

    hist0 = jnp.full((params.max_inner + 1,), jnp.nan, dtype=v0.dtype)
    big = jnp.asarray(jnp.inf, v0.dtype)
    init = (v0, jnp.asarray(0, jnp.int32), jnp.asarray(False), big, big, big,
            jnp.asarray(0, jnp.int32), hist0)
    v, iters, _, norm_g, _, _, cg_total, hist = jax.lax.while_loop(cond, body, init)
    return v, iters, norm_g, cg_total, hist


def _step(system: System, state: StepState, params: NewtonParams, f_ext, coarse=None, inv_blocks=None):
    """One backward-Euler step; returns (new_state, diagnostics dict)."""
    from tlfea.elements.assembly import node_ref

    x_prev = state.x
    x_ref = node_ref(system.elems)
    # Displacement is the primary state (StepState.u); derive it once when
    # stepping a hand-built state that only carries absolute positions.
    u_prev = state.u if state.u is not None else x_prev - x_ref
    cons = system.constraints

    # Warm-start iterate (see NewtonParams.predict). v_prev (the physics,
    # entering the inertia/damping terms) stays state.v regardless.
    v_init = state.v
    if state.dv is not None:
        v_init = state.v + params.predict * state.dv

    def outer_body(carry):
        v, v_prev, lam, k, _, newton_tot, cg_tot, hist_all, _ok = carry
        v, n_it, norm_g, cg_it, hist = _newton_inner(
            v, x_prev, v_prev, lam, f_ext, params, system, coarse, inv_blocks,
            u_prev=u_prev,
        )
        hist_all = hist_all.at[k].set(hist)  # per-outer row, nothing dropped
        # Inner loop exits either converged or at the iteration budget; a
        # budget exit means v is NOT the backward-Euler solution this step.
        ok = n_it < params.max_inner
        v_prev = v
        if cons is not None:
            c = constraint_values(cons, x_prev, v, params.dt, system.elems,
                                  u_prev=u_prev)
            lam = lam + params.rho * c  # Newton dual update (SyncedNewton.cu:470-481)
            norm_c = flat_norm(c)
        else:
            norm_c = jnp.zeros((), dtype=v.dtype)
        return (v, v_prev, lam, k + 1, norm_c, newton_tot + n_it, cg_tot + cg_it, hist_all, ok)

    def outer_cond(carry):
        _, _, _, k, norm_c, _, _, _, _ = carry
        unconverged = jnp.logical_or(k == 0, norm_c >= params.outer_tol)
        return jnp.logical_and(k < params.max_outer, unconverged)

    hist0 = jnp.full((params.max_outer, params.max_inner + 1), jnp.nan,
                     dtype=state.v.dtype)
    init = (
        v_init, state.v, state.lam, jnp.asarray(0, jnp.int32),
        jnp.asarray(jnp.inf, dtype=state.v.dtype),
        jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32), hist0,
        jnp.asarray(False),
    )
    v, _, lam, outers, norm_c, newton_tot, cg_tot, hist, ok = (
        jax.lax.while_loop(outer_cond, outer_body, init)
    )
    u = u_prev + params.dt * v  # displacement-scale state update (exact)
    # Derived geometry for collision/IO consumers; keeps the state dtype
    # even when u is carried wide (mixed-precision accuracy mode).
    x = (x_ref + u).astype(x_prev.dtype)
    # Warm-start safety: only feed the NEXT step's extrapolation when this
    # step actually converged. A budget-exhausted solve from a predicted
    # start feeds its error into the next prediction — measured to compound
    # into divergence on stiff large-dt runs (beam collapsing 60x past the
    # static sag). Zeroing dv makes the next step start cold, breaking the
    # feedback loop at zero extra cost.
    dv_next = jnp.where(ok, v - state.v, jnp.zeros_like(v))
    new_state = StepState(x=x, v=v, lam=lam, u=u, dv=dv_next)
    diag = {
        "outer_iters": outers,
        "newton_iters": newton_tot,
        "cg_iters": cg_tot,
        "norm_c": norm_c,
        # Flattened (max_outer, max_inner+1) per-Newton ||g|| telemetry —
        # every outer iteration's row, row-major, NaN-padded (the reference
        # prints these every inner iteration, `SyncedNewton.cu:1065`).
        "norm_g_history": hist.reshape(-1),
    }
    return new_state, diag


_step_jit = jax.jit(_step)


def step(system: System, state, params: NewtonParams, f_ext, coarse=None):
    """Jitted one-off step. Production loops should use `make_step` /
    `make_rollout` (one trace per system)."""
    return _step_jit(system, state, params, f_ext, coarse)


def make_step(system: System, params: NewtonParams, coarse=None):
    """Return a jitted step(state, f_ext) closure over a fixed system.

    coarse: optional `tlfea.solvers.coarse.CoarsePrecond` (frozen two-level)
    or legacy `CoarseSetup`, enabling the two-level preconditioner (SVK
    systems).

    `system` and `coarse` enter the jit as ARGUMENT pytrees, not closure
    constants: closed-over arrays become constant literals of the
    executable, which is then recompiled for every new system and holds a
    second copy of every element table on the device (grad_N alone is
    58 MB at 100k elements; the dense coarse basis is ~300 MB).
    """

    @jax.jit
    def _fc(sys_, state, f_ext, co):
        return _step(sys_, state, params, f_ext, co)

    return lambda state, f_ext: _fc(system, state, f_ext, coarse)


def _normalize_state(system: System, state: StepState) -> StepState:
    """Fill the OPTIONAL state fields on the host, before the jit boundary.

    A rollout's output state always carries u and dv arrays, so a None-field
    input would give the warmup call a different pytree structure than every
    chained call: a second trace and compile that lands inside whatever the
    caller is timing (measured as a phantom 150x "regression" when dv was
    first added).
    """
    if state.u is None:
        from tlfea.elements.assembly import node_ref

        state = state.replace(u=state.x - node_ref(system.elems))
    if state.dv is None:
        state = state.replace(dv=jnp.zeros_like(state.v))
    return state


def _fresh_inv(sys_, st: StepState, params: NewtonParams):
    """Inverted block-Jacobi blocks at the state's configuration."""
    return inv3x3(
        precond_blocks(st.v, st.x, params.dt, params.rho, sys_, u_prev=st.u),
        eps=1e-30,
    )


def make_rollout(system: System, params: NewtonParams, n_steps: int, coarse=None,
                 precond_refresh: int = 1):
    """Jitted sustained rollout: `roll(state, f_ext) -> (state, (newton_iters,
    cg_iters))` chaining `n_steps` backward-Euler steps in one `lax.scan`.

    precond_refresh=K freezes the inverted block-Jacobi preconditioner for K
    consecutive steps (the blocks change slowly between steps, and
    assembling them costs several CG iterations' worth of work).
    Staleness only affects CG iteration counts, never the converged solution.
    The production-shape API: one dispatch per rollout instead of per step,
    so benchmarks and long runs should scan.
    """
    refresh = max(int(precond_refresh), 1)

    @jax.jit
    def _roll(sys_, state: StepState, f_ext, co):
        def body(carry, k):
            st, inv_b = carry
            if refresh > 1:
                inv_b = jax.lax.cond(
                    k % refresh == 0, lambda s, b: _fresh_inv(sys_, s, params),
                    lambda s, b: b, st, inv_b,
                )
            ns, d = _step(sys_, st, params, f_ext, co, inv_blocks=inv_b)
            return (ns, inv_b), (d["newton_iters"], d["cg_iters"])

        if refresh > 1:
            inv0 = _fresh_inv(sys_, state, params)
            (s, _), its = jax.lax.scan(
                body, (state, inv0), jnp.arange(n_steps)
            )
        else:
            def body1(st, _):
                ns, d = _step(sys_, st, params, f_ext, co)
                return ns, (d["newton_iters"], d["cg_iters"])

            s, its = jax.lax.scan(body1, state, None, length=n_steps)
        return s, its

    def roll(state: StepState, f_ext):
        return _roll(system, _normalize_state(system, state), f_ext, coarse)

    # roll.lower(state, f_ext).compile() exposes the executable, e.g. for
    # its memory_analysis().
    roll.lower = lambda state, f_ext: _roll.lower(
        system, _normalize_state(system, state), f_ext, coarse)
    return roll


def make_coupled_rollout(system: System, params: NewtonParams, n_steps: int,
                         force_fn, coarse=None, precond_refresh: int = 1):
    """Jitted collision-coupled rollout: `roll(state, f_base) -> (state,
    (newton_iters, cg_iters), any_overflow)` chaining n_steps of
    [f_ext = f_base + force_fn(x, v); backward-Euler step] in one lax.scan.

    force_fn(x, v) -> (f_col (n,3), overflow bool) — e.g. a closure over
    `HydroelasticCollision.step`. The overflow flags are OR-reduced across
    the scan and returned for the caller's capacity check (the deferred
    overflow contract of `Simulation`, amortized over the whole rollout).

    Why: the host-driven Simulation loop pays ~4 dispatches per step
    (collision phases + solve); production collision runs should scan
    exactly like the dry solver rollouts.
    """
    refresh = max(int(precond_refresh), 1)

    @jax.jit
    def _roll(sys_, state: StepState, f_base, co):
        def body(carry, k):
            st, inv_b, ovf = carry
            if refresh > 1:
                inv_b = jax.lax.cond(
                    k % refresh == 0, lambda s, b: _fresh_inv(sys_, s, params),
                    lambda s, b: b, st, inv_b,
                )
            f_col, o = force_fn(st.x, st.v)
            ns, d = _step(sys_, st, params, f_base + f_col, co,
                          inv_blocks=inv_b if refresh > 1 else None)
            return (ns, inv_b, jnp.logical_or(ovf, o)), (
                d["newton_iters"], d["cg_iters"])

        inv0 = _fresh_inv(sys_, state, params)
        (s, _, ovf), its = jax.lax.scan(
            body, (state, inv0, jnp.asarray(False)), jnp.arange(n_steps)
        )
        return s, its, ovf

    def roll(state: StepState, f_base):
        return _roll(system, _normalize_state(system, state), f_base, coarse)

    return roll


def stepper(params, coarse=None):
    """Jitted step(system, state, f_ext) — the `Simulation` contract; the
    system is a pytree argument, so constraint targets / material parameters
    may change between calls without retracing."""

    @jax.jit
    def _f(system, state, f_ext, co):
        return _step(system, state, params, f_ext, co)

    return lambda system, state, f_ext: _f(system, state, f_ext, coarse)
