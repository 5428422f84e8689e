"""Headline benchmark: sustained implicit Newton-PCG throughput.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "series"}.

Measurement protocol:
- Steps are CONVERGENCE-driven (inner_atol = 2.5% of the load norm, the
  float32 attainable floor — see docs/ARCHITECTURE.md; Eisenstat-Walker CG
  forcing on), not a fixed iteration budget. Entries record newton/cg
  medians and `newton_capped_frac` (budget exits that did NOT converge).
- Throughput is a sustained ROLLOUT: N steps chained inside one jit
  (lax.scan), N per scale (see ROLLOUT); the fixed cost of one dispatch is
  recorded as `dispatch_ms`.
- Collision scales run the FUSED collision+solve scan
  (`newton.make_coupled_rollout`) after a host-driven capacity-growing
  warmup, with in-scan per-phase breakdowns.
- Every entry names the device it ran on (`platform`, `device_kind`,
  `device_count`). The bench refuses to run on the CPU backend, and exits
  non-zero after printing the series when any scale failed.

Default series: 10k,100k,ancf_shell,1k,collision,dragon,10k_tight
(headline = 10k). Override with TLFEA_BENCH_SCALES.
"""

import json
import os
import sys
import time

import numpy as np

_T_START = time.monotonic()
# Per-scale start guard: don't BEGIN a new scale once this much wall-clock
# has elapsed (a run under a hard timeout would otherwise record nothing).
# Completed scales are always emitted (see main's incremental printing).
_BUDGET_S = float(os.environ.get("TLFEA_BENCH_BUDGET", 2400))

CONFIGS = {
    "1k": (1.0, 0.25, 0.25, 12, 4, 3),  # 6*12*4*3  = 864 elems
    "10k": (2.0, 0.35, 0.3, 42, 7, 6),  # 6*42*7*6 = 10,584 elems
    "100k": (4.0, 0.7, 0.6, 96, 16, 11),  # 6*96*16*11 = 101,376 elems
}

# Rollout length per scale. The timed region is ONE dispatch of an N-step
# lax.scan, so each timing carries one fixed dispatch cost; small scales
# scan more steps, which is also the production shape. The measured
# per-dispatch overhead is recorded per entry (`dispatch_ms`) so the
# residual inflation ~dispatch_ms/N stays visible.
ROLLOUT = {"1k": 250, "10k": 60, "100k": 30}
# Steps between block-Jacobi refreshes in every rollout.
PRECOND_REFRESH = 8

_DISPATCH_MS = None


def _dispatch_overhead():
    """Measured wall time of a trivial jitted dispatch (host dispatch +
    device round trip): the fixed per-call cost every rollout timing carries
    once. Cached per process."""
    global _DISPATCH_MS
    if _DISPATCH_MS is None:
        import jax
        import jax.numpy as jnp

        f = jax.jit(lambda x: x + 1.0)
        x = jnp.zeros((1024, 3), np.float32)
        jax.block_until_ready(f(f(x)))
        t0 = time.perf_counter()
        for _ in range(5):
            # dispatch + block each iteration: the full round trip a timed
            # rollout pays exactly once.
            jax.block_until_ready(f(x))
        _DISPATCH_MS = (time.perf_counter() - t0) / 5 * 1e3
    return _DISPATCH_MS


def beam_problem(name, tol=2.5e-2, dtype=np.float32):
    """The T10 beam of scale `name` (CONFIGS) in its production solver
    configuration: (system, state, f_ext, params, coarse).

    Call with x64 enabled for dtype=np.float64."""
    import jax.numpy as jnp

    from tlfea.constraints import FixedCoefs
    from tlfea.elements import feat10
    from tlfea.elements.assembly import lumped_mass
    from tlfea.materials import SVK, lame_from_E_nu
    from tlfea.solvers import System, StepState, newton
    from tlfea.solvers.coarse import build_coarse_precond
    from tlfea.utils.reorder import apply_node_order, best_order
    from tlfea.utils.tetmesh import box_t10_mesh

    L, W, H, nx, ny, nz = CONFIGS[name]
    nodes, conn = box_t10_mesh(L, W, H, nx, ny, nz)
    # Bandwidth-reducing node order: box_t10_mesh appends mid-edge nodes
    # after all corners (~N/2 band); best_order picks the tighter of RCM and
    # PCA-axis sort (the axis sort wins 2.5x on long boxes), which keeps
    # each element's gathers and scatters local in memory. All downstream
    # sets (fixed nodes, loads) derive from coordinates/mass, so renumbering
    # is physics-invariant (tests/test_reorder.py).
    nodes, conn = apply_node_order(nodes, conn, best_order(nodes, conn))

    lam, mu = lame_from_E_nu(1e7, 0.3)
    mat = SVK(
        lam=jnp.asarray(lam, dtype), mu=jnp.asarray(mu, dtype),
        eta_damp=jnp.asarray(1e3, dtype), lam_damp=jnp.asarray(1e3, dtype),
    )
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    elems = feat10.build(nodes, conn, rho=1000.0, dtype=dtype)
    system = System(
        elems=elems, material=mat,
        constraints=FixedCoefs.from_indices(fixed, nodes.astype(dtype)),
    )
    state = StepState.rest(system, nodes.astype(dtype))
    f_ext = (
        jnp.zeros((nodes.shape[0], 3), dtype).at[:, 2].add(lumped_mass(elems) * dtype(-9.81))
    )
    # Converged implicit steps: tolerance = 2.5% of the load norm (the f32
    # Newton-PCG attainable floor at this stiffness, verified vs float64 —
    # docs/ARCHITECTURE.md). EW forcing adapts CG depth; max_inner bounds
    # cost.
    f_scale = float(jnp.sqrt(jnp.sum(f_ext * f_ext)))
    params = newton.NewtonParams(
        dt=dtype(1e-3), rho=dtype(1e7),
        inner_atol=dtype(tol * f_scale), inner_rtol=dtype(0.0),
        outer_tol=dtype(0.0), max_outer=1, max_inner=6,
        cg_rtol=dtype(1e-3), cg_max_iter=50, ew_eta_max=dtype(0.5),
    )
    # Production rollout config: frozen rotation-enriched coarse correction
    # (CG 29 -> 8 per Newton) + block-Jacobi refreshed every 8 steps
    # (assembly amortized; staleness only affects CG counts, never the
    # converged solution). Range-mode aggregation at scale: exactly the
    # dense coarse space, applied through per-slot masked reshape-sums +
    # local one-hot matmuls (~85 MB streamed/CG-iter at 145k nodes vs 600 MB
    # dense — see CoarsePrecond.seg), with a 2x larger coarse space. bf16
    # apply tables at scale: the coarse correction is preconditioner-quality,
    # and bf16 halves the traffic of the frozen tables (same CG counts — see
    # CoarsePrecond.mm_dtype).
    big = nodes.shape[0] > 50_000
    coarse = build_coarse_precond(system, state.x, float(params.dt),
                                  float(params.rho), ranges=big,
                                  max_agg=1024 if big else 512,
                                  mm_dtype="bfloat16" if big else None)
    return system, state, f_ext, params, coarse


def run_scale(name, rollout=None, tol=2.5e-2):
    from tlfea.solvers import newton

    if rollout is None:
        rollout = ROLLOUT.get(name, 20)
    system, state, f_ext, params, coarse = beam_problem(name, tol)
    roll = newton.make_rollout(system, params, rollout, coarse=coarse,
                               precond_refresh=PRECOND_REFRESH)
    return _measure(name, roll, state, f_ext, rollout, system.elems.n_elem,
                    max_inner=params.max_inner)


def require_accelerator():
    """Exit unless JAX's default device is an accelerator: a timing taken
    on the CPU backend is not a device number."""
    import jax

    if jax.devices()[0].platform == "cpu":
        sys.exit(f"{os.path.basename(sys.argv[0])} measures an accelerator; "
                 f"JAX found only the CPU")


def device_info():
    """The device every entry was measured on, as JAX reports it."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices())}


def _measure(name, roll, state, f_ext, rollout, n_elem, max_inner=None,
             **extra):
    import jax

    s, (nit, cgit) = roll(state, f_ext)  # compile + warm (settles transients)
    jax.block_until_ready(s)
    t0 = time.perf_counter()
    s, (nit, cgit) = roll(s, f_ext)
    jax.block_until_ready(s)
    wall = time.perf_counter() - t0
    assert np.isfinite(np.asarray(s.x)).all(), "simulation diverged"

    ms_per_step = wall / rollout * 1e3
    steps_per_sec = 1.0 / (wall / rollout)
    info = {
        **device_info(),
        "elems": n_elem,
        **extra,
        "rollout": rollout,
        "dispatch_ms": round(_dispatch_overhead(), 2),
        "ms_per_step": round(ms_per_step, 3),
        "steps_per_sec": round(steps_per_sec, 3),
        "newton_per_step": float(np.median(np.asarray(nit))),
        "cg_per_step": float(np.median(np.asarray(cgit))),
    }
    if max_inner is not None:
        # Fraction of timed steps that exhausted the Newton budget WITHOUT
        # reaching the tolerance (honesty flag: a capped step is not a
        # converged step — the 0.5%-tol entry caps on most steps in the
        # peak-|v| transient window, where the f32 attainable floor rises
        # with h*K*eps*|v|; see docs/ARCHITECTURE.md "Float32 convergence
        # floor").
        info["newton_capped_frac"] = round(
            float((np.asarray(nit) >= max_inner).mean()), 3)
    print(f"[{name}] {info}", file=sys.stderr)
    return info


def shell_problem(tol=2.5e-2, nx=72, ny=72):
    """ANCF3443 shell plate: (system, state, f_ext, params, coarse)."""
    import jax.numpy as jnp

    from tlfea.constraints import FixedCoefs
    from tlfea.elements import ancf3443
    from tlfea.elements.assembly import lumped_mass
    from tlfea.materials import SVK, lame_from_E_nu
    from tlfea.solvers import System, StepState, newton
    from tlfea.solvers.coarse import build_coarse_precond

    dtype = np.float32
    coefs, conn = ancf3443.shell_grid(nx, ny, L=0.05, W=0.05)
    elems = ancf3443.build(coefs, conn, 0.05, 0.05, 0.01, rho=1000.0,
                           dtype=dtype)
    n_coef = coefs.shape[0]

    lam, mu = lame_from_E_nu(1e7, 0.3)
    mat = SVK(
        lam=jnp.asarray(lam, dtype), mu=jnp.asarray(mu, dtype),
        eta_damp=jnp.asarray(1e3, dtype), lam_damp=jnp.asarray(1e3, dtype),
    )
    # Clamp the x=0 edge: all 4 coefficient rows of those nodes (position +
    # directors — the reference's cantilever clamp, `test_ancf3443.cc`).
    pos_rows = np.arange(0, n_coef, 4)
    edge_nodes = np.nonzero(coefs[pos_rows, 0] < 1e-12)[0]
    fixed = (4 * edge_nodes[:, None] + np.arange(4)[None, :]).reshape(-1)
    system = System(
        elems=elems, material=mat,
        constraints=FixedCoefs.from_indices(fixed, coefs.astype(dtype)),
    )
    state = StepState.rest(system, coefs.astype(dtype))
    f_ext = (
        jnp.zeros((n_coef, 3), dtype).at[:, 2].add(lumped_mass(elems) * dtype(-9.81))
    )
    f_scale = float(jnp.sqrt(jnp.sum(f_ext * f_ext)))
    params = newton.NewtonParams(
        dt=dtype(1e-3), rho=dtype(1e7),
        inner_atol=dtype(tol * f_scale), inner_rtol=dtype(0.0),
        outer_tol=dtype(0.0), max_outer=1, max_inner=6,
        cg_rtol=dtype(1e-3), cg_max_iter=50, ew_eta_max=dtype(0.5),
    )
    coarse = build_coarse_precond(system, state.x, float(params.dt),
                                  float(params.rho))
    return system, state, f_ext, params, coarse


def run_ancf_shell(rollout=40, tol=2.5e-2):
    """ANCF3443 shell-plate at stress scale: 5,184 elements / 64k DOF of the
    reference's heaviest element (48 stiffness QPs x 16 shape fns,
    `SyncedNewton.cu:101`), through the same converged-rollout protocol as
    the T10 scales, with the frozen coarse correction. `e_eff` =
    E * (48*16)/(5*10) is the T10-equivalent element count of equal
    per-step quadrature work, for comparison with the T10 scales."""
    from tlfea.solvers import newton

    system, state, f_ext, params, coarse = shell_problem(tol)
    roll = newton.make_rollout(system, params, rollout, coarse=coarse,
                               precond_refresh=PRECOND_REFRESH)
    n_elem = system.elems.n_elem
    return _measure("ancf_shell", roll, state, f_ext, rollout, n_elem,
                    dofs=3 * system.elems.n_coef,
                    e_eff=int(n_elem * (48 * 16) / (5 * 10)))


def _collision_scene(kind):
    """Build the reference collision workloads (BASELINE.md protocol):
    sphere-drop (2 x 256-elem T10 spheres, `test_sphere_drop_collision.cc:
    29-44`) and the dragon item drop (14,273 elems onto a deformable floor,
    `test_item_drop.cc:46-48`), hydroelastic backend. Falls back to box
    meshes when the reference data dir is absent; the returned label says
    which scene was built."""
    import jax.numpy as jnp

    from tlfea.collision.hydroelastic import (
        HydroelasticCollision, HydroelasticParams,
    )
    from tlfea.constraints import FixedCoefs
    from tlfea.elements import feat10
    from tlfea.materials import SVK, lame_from_E_nu
    from tlfea.solvers import System, StepState
    from tlfea.utils.mesh_manager import MeshManager
    from tlfea.utils.pressure import distance_pressure_field
    from tlfea.utils.tetmesh import box_t10_mesh

    REF = "/root/reference/data/meshes/T10"
    dtype = np.float32
    mm = MeshManager()
    if kind == "collision":  # sphere drop
        node, ele = os.path.join(REF, "sphere.1.node"), os.path.join(REF, "sphere.1.ele")
        if os.path.exists(node):
            a = mm.load_mesh(node, ele, "a")
            b = mm.load_mesh(node, ele, "b")
            label = "two reference 256-element T10 spheres"
        else:
            label = "box fallback: two boxes (reference meshes absent)"
            n0, c0 = box_t10_mesh(0.5, 0.5, 0.5, 4, 4, 2)
            a, b = mm.add_mesh(n0, c0, "a"), mm.add_mesh(n0, c0, "b")
        za = mm.mesh_nodes(a)[:, 2]
        mm.translate_mesh(b, (0.0, 0.0, za.max() - za.min() + 0.002))
        meshes, window, max_pairs, dt = (a, b), 256, 4096, 5e-4
        falling, v_init = b, -1.0  # contact within the warmup steps
        rest_nodes = False
    else:  # dragon item drop
        node, ele = (os.path.join(REF, "item_drop/dragon.node"),
                     os.path.join(REF, "item_drop/dragon.ele"))
        if os.path.exists(node):
            item = mm.load_mesh(node, ele, "dragon")
            label = "reference dragon on a deformable floor"
        else:
            label = "box fallback: a box item on a deformable floor (reference meshes absent)"
            ni, ci = box_t10_mesh(0.3, 0.3, 0.3, 6, 6, 6)
            item = mm.add_mesh(ni, ci, "box_item")
        inodes = mm.mesh_nodes(item)
        ext = inodes.max(axis=0) - inodes.min(axis=0)
        # nz >= 2 is load-bearing: with one element through the thickness
        # every corner node is on the surface, the per-tet affine pressure
        # fields are identically zero, and the scene NEVER contacts (the
        # round-3 red-test root cause — see tests/test_sharding.py).
        fn, fc = box_t10_mesh(2.5 * ext[0], 2.5 * ext[1], 0.2 * ext[2], 6, 6, 2)
        floor = mm.add_mesh(fn, fc, "floor")
        # Pressed-contact start (stable + contact-rich): floor top pushed
        # 0.15*H INTO the dragon, dragon TOP pinned so the press persists
        # through the whole timed region (the reference's gripper-press
        # idiom). Shallower overlaps measured ZERO patches: the dragon's
        # feet/legs are thin, so every tet there has all 4 corners on the
        # surface and an identically-zero pressure field (86% of the
        # reference's own dragon.npz corner pressures are zero); the first
        # interior-corner tets engage near the belly, ~0.15*H deep.
        overlap = 0.15 * ext[2]
        mm.translate_mesh(floor, (inodes[:, 0].min() - 0.75 * ext[0],
                                  inodes[:, 1].min() - 0.75 * ext[1],
                                  inodes[:, 2].min() - 0.2 * ext[2] + overlap))
        meshes, window, max_pairs, dt = (item, floor), 256, 8192, 2e-4
        falling, v_init = item, 0.0
        rest_nodes = True
    for mid in meshes:
        inst = mm.instances[mid]
        lc = (mm.elements[inst.elem_offset: inst.elem_offset + inst.n_elems]
              - inst.node_offset)
        mm.set_scalar_field(
            mid, distance_pressure_field(mm.mesh_nodes(mid), lc, 1e6))
    scene = mm.scene(reorder=True)  # band-minimizing relabeling
    nodes, conn = scene.nodes, scene.conn

    lam, mu = lame_from_E_nu(1e6, 0.3)
    mat = SVK(lam=jnp.asarray(lam, dtype), mu=jnp.asarray(mu, dtype),
              eta_damp=jnp.asarray(1e2, dtype), lam_damp=jnp.asarray(1e2, dtype))
    zmin = nodes[:, 2].min()
    zext = nodes[:, 2].max() - zmin
    thresh = 1e-9 if kind != "collision" else 0.05 * zext
    fixed = np.nonzero(nodes[:, 2] < zmin + thresh)[0]
    if kind == "dragon":
        # Pin the dragon's top as well (pressed-contact hold, see above).
        item_nodes = scene.mesh_node_ids(meshes[0])
        iz = nodes[item_nodes, 2]
        top = item_nodes[iz > iz.max() - 0.08 * (iz.max() - iz.min())]
        fixed = np.unique(np.concatenate([fixed, top]))
    system = System(
        elems=feat10.build(nodes, conn, rho=1000.0, dtype=dtype),
        material=mat,
        constraints=FixedCoefs.from_indices(fixed, nodes.astype(dtype)),
    )
    state = StepState.rest(system, nodes.astype(dtype))
    # Initial downward velocity on the falling body so contact happens
    # inside the warmup (pure free fall to the reference drop heights takes
    # hundreds of dt=2e-4 steps; the timed region must be contact-rich).
    fall_nodes = scene.mesh_node_ids(falling)
    v0 = np.zeros_like(nodes, dtype=dtype)
    v0[fall_nodes, 2] = v_init
    state = state.replace(v=jnp.asarray(v0))
    collision = HydroelasticCollision(
        conn, scene.elem_mesh_ids, scene.pressures.astype(dtype),
        window=window, max_pairs=max_pairs,
        rest_nodes=nodes if rest_nodes else None,
    )
    return (system, state, collision, HydroelasticParams(friction=dtype(0.3)),
            conn, dt, label)


def run_collision(kind, warm=None, timed=40):
    """Collision-coupled converged throughput: the full
    broadphase -> narrowphase -> forces -> implicit-Newton-solve step on the
    reference collision workloads, steady-state steps/s plus a per-phase
    in-scan breakdown (the reference prints per-phase averages,
    `test_sphere_drop_collision.cc:448-473`)."""
    import jax
    import jax.numpy as jnp

    from tlfea.simulation import Simulation, gravity_force
    from tlfea.solvers import newton
    from tlfea.solvers.coarse import build_coarse_precond

    if warm is None:
        # Dragon: gap 2 mm at v=-0.5 m/s, dt=2e-4 -> contact ~step 20; the
        # timed region must be contact-rich (assert below).
        warm = 30 if kind == "dragon" else 15
    dtype = np.float32
    system, state, collision, col_params, conn, dt, label = _collision_scene(kind)
    print(f"[{kind}] scene: {label}", file=sys.stderr)
    n_elem = conn.shape[0]
    f_grav = gravity_force(system)
    f_scale = float(jnp.sqrt(jnp.sum(f_grav * f_grav)))
    params = newton.NewtonParams(
        dt=dtype(dt), rho=dtype(1e8),
        inner_atol=dtype(2.5e-2 * f_scale), inner_rtol=dtype(0.0),
        outer_tol=dtype(0.0), max_outer=1, max_inner=6,
        cg_rtol=dtype(1e-3), cg_max_iter=50, ew_eta_max=dtype(0.5),
    )
    coarse = build_coarse_precond(system, state.x, float(params.dt),
                                  float(params.rho))
    sim = Simulation(system, state, newton.stepper(params, coarse=coarse),
                     base_f_ext=f_grav, collision=collision,
                     collision_params=col_params)
    # Warmup: compiles + the initial free-fall transient (contact onset),
    # host-driven so capacity overflow auto-grows before the timed region.
    for _ in range(warm):
        sim.step()
    jax.block_until_ready(sim.state.x)
    collision = sim.collision  # may have been regrown

    # Timed region: FUSED collision+solve lax.scan (the host-driven loop
    # pays ~4 dispatches per step; production collision runs scan).
    def force_fn(x, v):
        f, _patches, ovf = collision.step(x, v, col_params)
        return f, ovf

    roll = newton.make_coupled_rollout(system, params, timed, force_fn,
                                       coarse=coarse,
                                       precond_refresh=PRECOND_REFRESH)
    s, _, _ = roll(sim.state, f_grav)  # compile + warm
    jax.block_until_ready(s.x)
    t0 = time.perf_counter()
    s, (nit_a, cgit_a), ovf = roll(s, f_grav)
    jax.block_until_ready(s.x)
    wall = time.perf_counter() - t0
    assert np.isfinite(np.asarray(s.x)).all(), "diverged"
    assert not bool(np.asarray(ovf)), "collision capacity overflowed in the timed rollout"
    nit = float(np.median(np.asarray(nit_a)))
    cgit = float(np.median(np.asarray(cgit_a)))
    # Contact count at the END of the timed region: the workload must be
    # contact-rich or the number is a dry-solver measurement in disguise.
    _f, patches, _o = collision.step(s.x, s.v, col_params)
    n_contacts = int(np.asarray(patches.n_contacts))
    assert n_contacts > 0, f"[{kind}] timed region ended with zero contacts"

    # Per-phase breakdown, in-scan (dispatch-free): broadphase / narrowphase
    # / forces at the CURRENT (contact-rich) configuration.
    x_now, v_now = s.x, s.v

    def scan_time(fn, n=30):
        @jax.jit
        def run(x):
            def body(x, _):
                f = fn(x)
                return x + 1e-12 * f, jnp.sum(f)

            return jax.lax.scan(body, x, None, length=n)

        out = run(x_now)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        out = run(x_now)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / n * 1e3

    full_ms = scan_time(lambda x: collision.step(x, v_now, col_params)[0])

    def broad_only(x):
        _p, valid, _ = collision.broadphase_fn(x)
        return jnp.zeros_like(x) + valid.sum() * jnp.asarray(0.0, x.dtype)

    def broad_narrow(x):
        pairs, valid, _ = collision.broadphase_fn(x)
        patches = collision.narrowphase_fn(x, pairs, valid)
        return jnp.zeros_like(x) + patches.area.sum() * 0.0

    broad_ms = scan_time(broad_only)
    bn_ms = scan_time(broad_narrow)
    steps_per_sec = timed / wall
    ms_per_step = wall / timed * 1e3
    info = {
        **device_info(),
        "scene": label,
        "elems": n_elem,
        "ms_per_step": round(ms_per_step, 2),
        "steps_per_sec": round(steps_per_sec, 3),
        "newton_per_step": float(nit),
        "cg_per_step": float(cgit),
        "contacts": n_contacts,
        "collision_ms_in_scan": round(full_ms, 2),
        "broadphase_ms": round(broad_ms, 2),
        "narrowphase_ms": round(bn_ms - broad_ms, 2),
        "forces_ms": round(full_ms - bn_ms, 2),
        "solve_ms_est": round(ms_per_step - full_ms, 2),
        "overflow_events": sim.overflow_events,
    }
    print(f"[{kind}] {info}", file=sys.stderr)
    return info


def _series_json(series):
    good = {k: v for k, v in series.items() if "error" not in v}
    head = good.get("10k") or next(iter(good.values()), None)
    return json.dumps({
        "metric": (f"implicit_newton_steps_per_sec_T10_{head['elems']}elem_rollout"
                   if head else "implicit_newton_steps_per_sec"),
        "value": head["steps_per_sec"] if head else 0.0,
        "unit": "steps/s",
        "series": series,
    })


def main():
    from tlfea.utils.compile_cache import enable_compile_cache

    require_accelerator()
    enable_compile_cache()

    # Headline scales FIRST (10k, 100k, ancf_shell): if a hard timeout
    # fires mid-series, the scales that matter are already recorded.
    scales = os.environ.get(
        "TLFEA_BENCH_SCALES",
        "10k,100k,ancf_shell,1k,collision,dragon,10k_tight",
    ).split(",")
    series = {}
    for name in scales:
        name = name.strip()
        elapsed = time.monotonic() - _T_START
        if elapsed > _BUDGET_S:
            series[name] = {"error": f"skipped: bench budget exhausted "
                                     f"({elapsed:.0f}s > {_BUDGET_S:.0f}s)"}
            continue
        try:
            if name == "ancf_shell":
                series[name] = run_ancf_shell()
            elif name in ("collision", "dragon"):
                series[name] = run_collision(name)
            elif name.endswith("_tight"):
                # Tight convergence: 0.5% of the load norm. Attainable near
                # rest and early transient; in the PEAK-|v| window the f32
                # floor (h*K*eps*|v|, docs/ARCHITECTURE.md) rises past it
                # and most steps exhaust the Newton budget instead — the
                # entry's newton_capped_frac records exactly how many.
                series[name] = run_scale(name[: -len("_tight")], tol=5e-3)
            else:
                series[name] = run_scale(name)
        except Exception as e:  # recorded; the exit code reports it below
            print(f"[{name}] FAILED: {type(e).__name__}: {str(e)[:300]}",
                  file=sys.stderr)
            series[name] = {"error": f"{type(e).__name__}: {str(e)[:200]}"}
        # Incremental partial record on stderr (survives a hard timeout that
        # kills the process before the final stdout line).
        print("PARTIAL " + _series_json(series), file=sys.stderr, flush=True)

    print(_series_json(series))
    failed = [k for k, v in series.items() if "error" in v]
    if failed:
        sys.exit(f"bench.py: scales failed: {', '.join(failed)}")


if __name__ == "__main__":
    main()
