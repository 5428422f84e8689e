"""Converged-VBD benchmark: full convergence-driven VBD steps at the bench
scales, same tolerance as bench.py's Newton-PCG (2.5% of the load norm),
measured in-scan (no dispatch overhead).

The reference's VBD is a performance solver (CUDA-graph inner sweeps,
`SyncedVBD.cu:1155-1291,1475-1641`); this measures whether this repo's
per-sweep cost (a serial chain of ~n_colors color updates) amortizes at
convergence or stays a parity-only path. Needs a GPU.

    python benchmarks/vbd_converged.py
TLFEA_SCALES=1k,10k; TLFEA_VBD_SWEEPS caps sweeps/outer (default 400).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import bench
from tlfea.constraints import FixedCoefs
from tlfea.elements import feat10
from tlfea.elements.assembly import lumped_mass, node_ref
from tlfea.materials import SVK, lame_from_E_nu
from tlfea.solvers import StepState, System, vbd
from tlfea.utils.compile_cache import enable_compile_cache
from tlfea.utils.reorder import apply_node_order, best_order
from tlfea.utils.tetmesh import box_t10_mesh

bench.require_accelerator()
enable_compile_cache()

CONFIGS = bench.CONFIGS
ROLLOUT = 5
MAX_SWEEPS = int(os.environ.get("TLFEA_VBD_SWEEPS", 400))
dtype = np.float32

for scale in os.environ.get("TLFEA_SCALES", "1k,10k").split(","):
    L, W, H, nx, ny, nz = CONFIGS[scale.strip()]
    nodes, conn = box_t10_mesh(L, W, H, nx, ny, nz)
    nodes, conn = apply_node_order(nodes, conn, best_order(nodes, conn))
    lam, mu = lame_from_E_nu(1e7, 0.3)
    mat = SVK(lam=jnp.asarray(lam, dtype), mu=jnp.asarray(mu, dtype),
              eta_damp=jnp.asarray(1e3, dtype), lam_damp=jnp.asarray(1e3, dtype))
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    elems = feat10.build(nodes, conn, rho=1000.0, dtype=dtype)
    system = System(
        elems=elems, material=mat,
        constraints=FixedCoefs.from_indices(fixed, nodes.astype(dtype)),
    )
    state = StepState.rest(system, nodes.astype(dtype))
    f_ext = jnp.zeros((nodes.shape[0], 3), dtype).at[:, 2].add(
        lumped_mass(elems) * dtype(-9.81))
    f_scale = float(jnp.sqrt(jnp.sum(f_ext * f_ext)))
    tol = dtype(2.5e-2 * f_scale)
    params = vbd.VBDParams(
        dt=dtype(1e-3), rho=dtype(1e7), omega=dtype(1.0),
        inner_tol=tol, outer_tol=dtype(0.0), max_outer=1,
        max_sweeps=MAX_SWEEPS, color_group_size=4,
        convergence_check_interval=4,
    )
    structures = vbd.prepare(system, group_size=4)
    step = vbd.make_step(system, params, structures)

    # VBD's step emits StepState(x, v, lam, u) with dv=None — match the
    # carry structure (no warm-start field in VBD).
    state = state.replace(u=state.x - node_ref(system.elems), dv=None)

    @jax.jit
    def roll(state, f_ext):
        def body(st, _):
            ns, d = vbd._step_impl(system, structures, params, st, f_ext)
            return ns, d["sweeps"]

        return jax.lax.scan(body, state, None, length=ROLLOUT)

    s, sweeps = roll(state, f_ext)
    jax.block_until_ready(s.x)
    t0 = time.perf_counter()
    s, sweeps = roll(s, f_ext)
    jax.block_until_ready(s.x)
    wall = time.perf_counter() - t0
    sweeps = np.asarray(sweeps)
    # A step that used the full sweep budget did NOT reach tolerance.
    print(f"[{scale}] {conn.shape[0]} elems: {wall / ROLLOUT * 1e3:.1f} "
          f"ms/step, sweeps/step median {float(np.median(sweeps))}, "
          f"converged {int((sweeps < MAX_SWEEPS).sum())}/{ROLLOUT}",
          flush=True)
