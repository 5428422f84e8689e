"""f32 Newton convergence on the stiff beam-sag config (E=7e8, the
reference's `lib_bin/beam_sag/test_ancf3243.cc:287-291` material) — the
round-2 acceptance experiment.

Three things were required to make this work (full story in
docs/ARCHITECTURE.md "Float32 convergence floor"):

1. Displacement-space state (`StepState.u`): evaluating at
   x_prev + dt*v in absolute coordinates rounds the Newton increment away
   entirely in f32 and stalls the solver.
2. ALM penalty scaled to the stiffness: rho must satisfy
   dt^2 * rho ~ dt * k_elem (~ dt*E*h). At E=7e8 / dt=1e-3 that is
   rho ~ 1e11. With the round-1 default (1e7) the pin constraints are
   enforced almost entirely by the dual integral action, which couples
   unstably with the barely-damped beam oscillation — |lam| and the
   kinetic energy grow exponentially REGARDLESS of precision (reproduced
   in f64). This was the dominant failure, masked by precision floors.
3. Mixed-precision accuracy mode: the displacement vector alone carried in
   f64 (x, v, duals, all kernels stay f32) + f64 scatter accumulation
   (`System.accum_dtype`). Pure-f32 evaluation floors at ~eps*E*theta of
   the load (theta = element rotation) — at the full-gravity sag of this
   config that is ~5e-3..1e-2, an information limit any f32 FEM shares.

Run on CPU f32 (fast compiles): `python benchmarks/stiff_beam_f32.py`.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from tlfea.constraints import FixedCoefs
from tlfea.elements import feat10
from tlfea.elements.assembly import lumped_mass
from tlfea.materials import SVK, lame_from_E_nu
from tlfea.solvers import System, StepState, newton
from tlfea.solvers.coarse import build_coarse_precond
from tlfea.utils.tetmesh import box_t10_mesh

dtype = np.float32
L, W, H = 2.0, 0.35, 0.3
nodes, conn = box_t10_mesh(L, W, H, 12, 3, 2)
print(f"elems={conn.shape[0]} nodes={nodes.shape[0]}")

E_mod = 7e8  # stiff config (reference test_ancf3243.cc:287-291)
lam, mu = lame_from_E_nu(E_mod, 0.3)
mat = SVK(lam=jnp.asarray(lam, dtype), mu=jnp.asarray(mu, dtype),
          eta_damp=jnp.asarray(1e5, dtype), lam_damp=jnp.asarray(1e5, dtype))
fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
elems = feat10.build(nodes, conn, rho=1000.0, dtype=dtype)
system = System(
    elems=elems, material=mat,
    constraints=FixedCoefs.from_indices(fixed, nodes.astype(dtype)),
    accum_dtype="float64",
)
state = StepState.rest(system, nodes.astype(dtype))
# Accuracy mode: ONLY the displacement vector in f64.
state = state.replace(u=state.u.astype(jnp.float64))
f_ext = jnp.zeros((nodes.shape[0], 3), dtype).at[:, 2].add(
    lumped_mass(elems) * dtype(-9.81))
f_scale = float(jnp.sqrt(jnp.sum(f_ext * f_ext)))
print(f"||f_ext|| = {f_scale:.4g}")

params = newton.NewtonParams(
    dt=dtype(1e-3), rho=dtype(1e11),  # dt^2*rho ~ dt*E*h (see module doc)
    inner_atol=dtype(1e-4 * f_scale), inner_rtol=dtype(0.0),
    outer_tol=dtype(1e-5 * f_scale), max_outer=2,
    max_inner=8, cg_rtol=dtype(1e-4), cg_max_iter=200, ew_eta_max=dtype(0.0),
)
coarse = build_coarse_precond(system, state.x, float(params.dt), float(params.rho))
step = newton.make_step(system, params, coarse=coarse)

RAMP, HOLD = 150, 60
final = None
for k in range(RAMP + HOLD):
    scale = dtype(min(1.0, (k + 1) / RAMP))
    state, diag = step(state, f_ext * scale)
    h = np.asarray(diag["norm_g_history"])
    h = h[np.isfinite(h)]
    if len(h) == 0:
        print(f"step {k}: diverged"); break
    final = float(h[-1] / f_scale)
    if k % 20 == 0 or k >= RAMP + HOLD - 3:
        vmax = float(jnp.max(jnp.abs(state.v)))
        print(
            f"step {k:3d}: newton={int(diag['newton_iters'])} "
            f"cg={int(diag['cg_iters'])} "
            f"||g||/||f|| end={final:.3e} |v|max={vmax:.2e} "
            f"tip_uz={float(state.x[:, 2].min() - nodes[:, 2].min()):+.6e}"
        )

# Euler-Bernoulli static sag for orientation (coarse 3D mesh will differ
# by shear/section effects; the acceptance metric is the residual).
I2 = W * H ** 3 / 12.0
q = 1000.0 * 9.81 * W * H
print(f"\nEuler-Bernoulli tip sag ~ {q * L ** 4 / (8 * E_mod * I2):.3e}")
ok = final is not None and final <= 1e-3
print(f"settled-state ||g||/||f_ext|| = {final:.3e}  target <= 1e-3  "
      f"{'PASS' if ok else 'FAIL'}")
