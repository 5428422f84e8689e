"""The XLA Newton-PCG building blocks against finite differences.

Every element family and material runs one device path: the ALM gradient
`grad_L`, its Hessian-vector product from `jax.linearize`, and the
block-Jacobi blocks of `precond_blocks`. These tests check that path
against central finite differences and a dense `jacfwd` Hessian, in float64.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tlfea import diagnostics
from tlfea.constraints import DensePins, FixedCoefs, LinearConstraintBuilder
from tlfea.elements import ancf3243, ancf3443, feat10
from tlfea.elements.assembly import mass_matvec, node_ref
from tlfea.materials import SVK, MooneyRivlin, lame_from_E_nu
from tlfea.solvers import System
from tlfea.solvers.common import grad_L, precond_blocks
from tlfea.utils.tetmesh import box_t10_mesh

DTYPE = np.float64
DT, RHO = 1e-3, 1e6


def _mesh(family):
    """(coefs, elems) of a small mesh of the family."""
    if family == "feat10":
        nodes, conn = box_t10_mesh(0.6, 0.3, 0.3, 2, 1, 1)
        return nodes, feat10.build(nodes, conn, rho=1000.0, dtype=DTYPE)
    if family == "ancf3243":
        coefs, conn = ancf3243.straight_beam(3, L=0.5, origin=(0.0, 0.0, 0.0))
        return coefs, ancf3243.build(coefs, conn, 0.5, 0.1, 0.1, rho=1000.0, dtype=DTYPE)
    coefs, conn = ancf3443.shell_grid(2, 2, L=0.2, W=0.2)
    return coefs, ancf3443.build(coefs, conn, 0.2, 0.2, 0.02, rho=1000.0, dtype=DTYPE)


def _material(name, damped=False):
    d = 2e2 if damped else 0.0
    if name == "svk":
        lam, mu = lame_from_E_nu(1e6, 0.3)
        return SVK(lam=jnp.asarray(lam, DTYPE), mu=jnp.asarray(mu, DTYPE),
                   eta_damp=jnp.asarray(d, DTYPE), lam_damp=jnp.asarray(d, DTYPE))
    return MooneyRivlin(mu10=jnp.asarray(2e5, DTYPE), mu01=jnp.asarray(5e4, DTYPE),
                        kappa=jnp.asarray(1e6, DTYPE),
                        eta_damp=jnp.asarray(d, DTYPE), lam_damp=jnp.asarray(d, DTYPE))


def _state(coefs, seed):
    """A deformed iterate: (x_prev, u_prev, v, v_prev, p, f_ext)."""
    rng = np.random.default_rng(seed)
    n = coefs.shape[0]
    u_prev = jnp.asarray(1e-3 * rng.standard_normal((n, 3)), DTYPE)
    x_prev = jnp.asarray(coefs, DTYPE) + u_prev
    v = jnp.asarray(0.1 * rng.standard_normal((n, 3)), DTYPE)
    v_prev = jnp.asarray(0.1 * rng.standard_normal((n, 3)), DTYPE)
    p = jnp.asarray(rng.standard_normal((n, 3)), DTYPE)
    f_ext = jnp.asarray(rng.standard_normal((n, 3)), DTYPE)
    return x_prev, u_prev, v, v_prev, p, f_ext


def _central(f, v, p, eps):
    return (f(v + eps * p) - f(v - eps * p)) / (2 * eps)


def _rel(a, b):
    return float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))


@pytest.mark.parametrize("material", ["svk", "mooney_rivlin"])
@pytest.mark.parametrize("family", ["feat10", "ancf3243", "ancf3443"])
def test_residual_and_hv_match_finite_differences(family, material):
    coefs, elems = _mesh(family)
    x_prev, u_prev, v, v_prev, p, f_ext = _state(coefs, seed=1)
    lam0 = jnp.zeros((0,), DTYPE)

    # Residual: without damping, g is the gradient of the backward-Euler
    # objective L(v) = |v - v_prev|_M^2 / 2h + Psi(x_prev + h v) / h - f.v,
    # with the strain energy Psi summed by quadrature (no scatter-add).
    system = System(elems=elems, material=_material(material))
    x_ref = node_ref(elems)

    def L(vv):
        dv = vv - v_prev
        x = x_ref + u_prev + DT * vv
        return (0.5 * jnp.sum(dv * mass_matvec(dv, elems)) / DT
                + diagnostics.strain_energy(x, elems, system.material) / DT
                - jnp.sum(f_ext * vv))

    g = grad_L(v, x_prev, v_prev, lam0, f_ext, DT, RHO, system, u_prev=u_prev)
    fd = (L(v + 1e-6 * p) - L(v - 1e-6 * p)) / 2e-6
    assert abs(float(jnp.sum(g * p)) - float(fd)) <= 1e-6 * abs(float(fd))

    # Hv (damped): the linearized tangent against central differences of g.
    system = System(elems=elems, material=_material(material, damped=True))

    def g_of(vv):
        return grad_L(vv, x_prev, v_prev, lam0, f_ext, DT, RHO, system, u_prev=u_prev)

    _, hvp = jax.linearize(g_of, v)
    assert _rel(hvp(p), _central(g_of, v, p, 1e-4)) < 1e-7


def _constraints(kind, coefs):
    fixed = np.nonzero(coefs[:, 0] < 1e-12)[0]
    if kind == "fixed_coefs":
        return FixedCoefs.from_indices(fixed, coefs.astype(DTYPE))
    if kind == "dense_pins":
        return DensePins.from_indices(fixed, coefs.astype(DTYPE))
    b = LinearConstraintBuilder()
    for c in fixed[:2]:
        b.fix_dof(int(c), 2, float(coefs[c, 2]))
    b.equate_dofs(int(fixed[2]), int(fixed[3]))
    return b.build(DTYPE)


@pytest.mark.parametrize("kind", [None, "fixed_coefs", "dense_pins", "linear"])
def test_hv_matches_finite_differences_per_constraint(kind):
    coefs, elems = _mesh("feat10")
    cons = None if kind is None else _constraints(kind, coefs)
    system = System(elems=elems, material=_material("svk", damped=True),
                    constraints=cons)
    x_prev, u_prev, v, v_prev, p, f_ext = _state(coefs, seed=2)
    if cons is None:
        lam = jnp.zeros((0,), DTYPE)
    else:
        c0 = cons.eval_c(x_prev)
        lam = jnp.asarray(np.random.default_rng(3).standard_normal(c0.shape), DTYPE)
        if kind == "dense_pins":
            lam = lam * cons.mask

    def g_of(vv):
        return grad_L(vv, x_prev, v_prev, lam, f_ext, DT, RHO, system, u_prev=u_prev)

    g, hvp = jax.linearize(g_of, v)
    assert bool(jnp.isfinite(g).all())
    assert _rel(hvp(p), _central(g_of, v, p, 1e-4)) < 1e-7


@pytest.mark.parametrize("family", ["feat10", "ancf3243", "ancf3443"])
def test_precond_blocks_are_dense_hessian_diagonal_blocks(family):
    coefs, elems = _mesh(family)
    fixed = np.nonzero(coefs[:, 0] < 1e-12)[0]
    system = System(elems=elems, material=_material("svk"),
                    constraints=FixedCoefs.from_indices(fixed, coefs.astype(DTYPE)))
    x_prev, u_prev, v, v_prev, _, f_ext = _state(coefs, seed=4)
    lam = jnp.zeros((len(fixed), 3), DTYPE)
    n = coefs.shape[0]

    def g_flat(vf):
        return grad_L(vf.reshape(n, 3), x_prev, v_prev, lam, f_ext, DT, RHO,
                      system, u_prev=u_prev).reshape(-1)

    H = jax.jacfwd(g_flat)(v.reshape(-1)).reshape(n, 3, n, 3)
    want = H[jnp.arange(n), :, jnp.arange(n), :]  # (n, 3, 3) diagonal blocks
    got = precond_blocks(v, x_prev, DT, RHO, system, u_prev=u_prev)
    # precond_blocks adds an SPD shift of 1e-7 of each block's largest entry.
    scale = jnp.abs(want).max(axis=(1, 2), keepdims=True)
    assert float(jnp.max(jnp.abs(got - want) / scale)) < 1e-6
