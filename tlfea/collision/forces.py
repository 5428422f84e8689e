"""Contact-patch force evaluation and nodal distribution.

Per valid patch: F = p_eq * A * n_hat with optional Drake-style normal
damping p(1 - d * v_n) (clamped at 0) and regularized Coulomb friction
mu |N| v_t / (|v_t| + v_reg), distributed to the 4+4 corner nodes of the two
tets by barycentric weights of the patch centroid. Tet A receives -F, tet B
receives +F (Newton's third law holds exactly).

Reference: `computeExternalForcesKernel`
(`lib_src/collision/HydroelasticNarrowphaseFunc.cuh:701-854`); the atomicAdd
scatter becomes an XLA scatter-add.
"""

from __future__ import annotations

import jax.numpy as jnp

from tlfea.collision.narrowphase import ContactPatches
from tlfea.ops.linalg import solve3x3

__all__ = ["patch_forces"]

V_REG = 1e-3  # friction regularization velocity (reference: ...Func.cuh:817)


def _barycentric(x, v):
    """Barycentric coords of points x (P, 3) in tets v (P, 4, 3) -> (P, 4)."""
    M = jnp.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], v[:, 3] - v[:, 0]], axis=-1)
    lam123 = solve3x3(M, x - v[:, 0], eps=1e-30)  # (P, 3)
    lam0 = 1.0 - jnp.sum(lam123, axis=-1, keepdims=True)
    return jnp.concatenate([lam0, lam123], axis=-1)


def patch_forces(
    patches: ContactPatches,
    x: jnp.ndarray,
    v: jnp.ndarray | None,
    corners: jnp.ndarray,
    damping: float = 0.0,
    friction: float = 0.0,
) -> jnp.ndarray:
    """Per-node external contact forces -> (n_nodes, 3)."""
    n_nodes = x.shape[0]
    use = patches.valid & patches.valid_orientation & (patches.area > 1e-18)

    nodesA = corners[patches.tetA]  # (P, 4)
    nodesB = corners[patches.tetB]
    vA = x[nodesA]  # (P, 4, 3)
    vB = x[nodesB]
    N_A = _barycentric(patches.centroid, vA)  # (P, 4)
    N_B = _barycentric(patches.centroid, vB)

    # Branchless: damping/friction may be traced scalars, so the velocity
    # terms are always computed; zero coefficients yield zero contributions.
    p_damped = patches.p_eq
    F_t = jnp.zeros_like(patches.normal)
    if v is not None:
        velA = jnp.einsum("pa,pad->pd", N_A, v[nodesA])
        velB = jnp.einsum("pa,pad->pd", N_B, v[nodesB])
        v_rel = velB - velA
        v_rel_n = jnp.sum(v_rel * patches.normal, axis=-1)
        factor = jnp.maximum(1.0 - damping * v_rel_n, 0.0)
        # damping == 0 -> factor == 1 exactly, so this is a no-op then.
        p_damped = patches.p_eq * factor
        v_t = v_rel - v_rel_n[:, None] * patches.normal
        v_t_norm = jnp.linalg.norm(v_t, axis=-1)
        slip = v_t_norm / (v_t_norm + V_REG)
        N_mag = jnp.abs(p_damped * patches.area)
        Ft_mag = friction * N_mag * slip
        t_hat = v_t / jnp.maximum(v_t_norm, 1e-30)[:, None]
        F_t = -Ft_mag[:, None] * t_hat

    F_patch = (p_damped * patches.area)[:, None] * patches.normal + F_t
    F_patch = jnp.where(use[:, None], F_patch, 0.0)

    f = jnp.zeros((n_nodes, 3), dtype=x.dtype)
    f = f.at[nodesA.reshape(-1)].add(
        (N_A[..., None] * (-F_patch)[:, None, :]).reshape(-1, 3)
    )
    f = f.at[nodesB.reshape(-1)].add(
        (N_B[..., None] * F_patch[:, None, :]).reshape(-1, 3)
    )
    return f
