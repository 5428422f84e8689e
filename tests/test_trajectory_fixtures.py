"""Trajectory regression against committed float64-CPU fixtures.

Pins the full dynamic trajectory (not just end states) so solver/kernel/
sharding refactors can't silently change the physics — the committed-CSV
analogue of the reference's FEniCS validation CSVs (SURVEY §4).
"""

import os
import sys

import numpy as np
import pytest

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
sys.path.insert(0, FIXDIR)


@pytest.mark.slow
def test_beam_sag_trajectory_pinned():
    path = os.path.join(FIXDIR, "beam_sag_t10_tip.csv")
    if not os.path.exists(path):
        pytest.skip("fixture not generated")
    from generate import beam_sag_trajectory

    ref = np.loadtxt(path, delimiter=",", skiprows=1)
    got = beam_sag_trajectory(write=False)
    scale = np.abs(ref[:, 1:4]).max()
    np.testing.assert_allclose(got[:, 1:4], ref[:, 1:4], rtol=0, atol=1e-9 * scale)


@pytest.mark.gpu
def test_beam_sag_trajectory_gpu_f32_matches_f64_fixture():
    """Accuracy bar (BASELINE.md): float32 on the card, through the XLA path
    with `jax_default_matmul_precision="float32"` (set by `import tlfea`;
    without it the GPU may run f32 dots in TF32), must match the committed
    float64-CPU trajectory to 1e-6 of the displacement scale over all 150
    steps."""
    import jax
    import jax.numpy as jnp

    path = os.path.join(FIXDIR, "beam_sag_t10_tip.csv")
    if not os.path.exists(path):
        pytest.skip("fixture not generated")

    from tlfea.constraints import FixedCoefs
    from tlfea.elements import feat10
    from tlfea.elements.assembly import lumped_mass
    from tlfea.materials import SVK, lame_from_E_nu
    from tlfea.solvers import StepState, System, newton
    from tlfea.utils.tetmesh import box_t10_mesh

    dtype = np.float32
    nodes, conn = box_t10_mesh(1.0, 0.1, 0.1, 10, 1, 1)
    lam, mu = lame_from_E_nu(1e7, 0.3)
    mat = SVK(lam=jnp.asarray(lam, dtype), mu=jnp.asarray(mu, dtype),
              eta_damp=jnp.asarray(1e3, dtype),
              lam_damp=jnp.asarray(1e3, dtype))
    fixed = np.nonzero(nodes[:, 0] < 1e-12)[0]
    system = System(
        elems=feat10.build(nodes, conn, rho=1000.0, dtype=dtype),
        material=mat,
        constraints=FixedCoefs.from_indices(fixed, nodes.astype(dtype)),
    )
    state = StepState.rest(system, nodes.astype(dtype))
    f_ext = jnp.zeros((len(nodes), 3), dtype).at[:, 2].add(
        lumped_mass(system.elems) * dtype(-9.81))
    params = newton.NewtonParams(
        dt=dtype(1e-3), rho=dtype(1e8), inner_atol=dtype(1e-8),
        inner_rtol=dtype(1e-10), outer_tol=dtype(1e-10),
        max_outer=2, max_inner=10, cg_rtol=dtype(1e-6), cg_max_iter=500,
        ew_eta_max=dtype(0.0),
    )
    step = newton.make_step(system, params)
    tip = int(np.lexsort((nodes[:, 2], nodes[:, 1], -nodes[:, 0]))[0])
    rows = []
    for k in range(150):
        state, _ = step(state, f_ext)
        rows.append(np.asarray(state.x[tip]))
    rows = np.asarray(rows)
    ref = np.loadtxt(path, delimiter=",", skiprows=1)
    scale = np.abs(ref[:, 1:4] - nodes[tip]).max()
    dev = np.abs(rows - ref[:, 1:4]).max()
    print(f"f32 on {jax.devices()[0].device_kind} vs the f64 fixture: "
          f"max tip deviation / displacement scale = {dev / scale:.3e} (bar 1e-6)")
    assert dev < 1e-6 * scale, (dev, scale, dev / scale)


@pytest.mark.slow
def test_sphere_drop_trajectory_pinned():
    path = os.path.join(FIXDIR, "sphere_drop_lownode.csv")
    if not os.path.exists(path):
        pytest.skip("fixture not generated (reference meshes absent?)")
    from generate import sphere_drop_trajectory

    ref = np.loadtxt(path, delimiter=",", skiprows=1)
    got = sphere_drop_trajectory(write=False)
    scale = np.abs(ref[:, 1:4]).max()
    np.testing.assert_allclose(got[:, 1:4], ref[:, 1:4], rtol=0, atol=1e-8 * scale)
    # Contact counts are integers; identical counts = same discrete events.
    np.testing.assert_array_equal(got[:, 4], ref[:, 4])
