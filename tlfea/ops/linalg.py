"""Small batched 3x3 linear algebra (closed-form, elementwise).

Replaces the reference's per-thread Gaussian elimination
(`lib_src/elements/FEAT10DataFunc.cuh:30-83`) with closed-form adjugate
solves, which vectorize cleanly over (elements, quadrature points, nodes).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["det3x3", "solve3x3", "inv3x3", "inv_transpose3x3"]


def det3x3(a: jnp.ndarray) -> jnp.ndarray:
    """Determinant of (..., 3, 3)."""
    return (
        a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
        - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
        + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
    )


def _adjugate3x3(a: jnp.ndarray) -> jnp.ndarray:
    """Adjugate (transpose of cofactor matrix) of (..., 3, 3)."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    # adj[i, j] = cofactor(j, i)
    row0 = jnp.stack([c00, c10, c20], axis=-1)
    row1 = jnp.stack([c01, c11, c21], axis=-1)
    row2 = jnp.stack([c02, c12, c22], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def solve3x3(a: jnp.ndarray, b: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Solve a @ x = b for (..., 3, 3) a and (..., 3) b via the adjugate.

    With eps > 0 the determinant is clamped away from zero (sign-preserving),
    matching the reference's singular-matrix guards.
    """
    det = det3x3(a)
    if eps:
        det = jnp.where(jnp.abs(det) < eps, jnp.where(det >= 0, eps, -eps), det)
    adj = _adjugate3x3(a)
    return jnp.einsum("...ij,...j->...i", adj, b) / det[..., None]


def inv3x3(a: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Inverse of (..., 3, 3) via the adjugate, with sign-preserving det clamp.

    Precomputing the inverse turns a per-CG-iteration `solve3x3` (adjugate +
    determinant every iteration) into a single 3x3 matvec — the block-Jacobi
    apply is on the CG critical path.
    """
    det = det3x3(a)
    if eps:
        det = jnp.where(jnp.abs(det) < eps, jnp.where(det >= 0, eps, -eps), det)
    return _adjugate3x3(a) / det[..., None, None]


def inv_transpose3x3(a: jnp.ndarray, det: jnp.ndarray | None = None, eps: float = 1e-12) -> jnp.ndarray:
    """Inverse-transpose of (..., 3, 3) with sign-preserving det clamp.

    Mirrors the reference's `mr_invT3x3` det clamping
    (`lib_src/materials/MooneyRivlin.cuh:23-43`).
    """
    if det is None:
        det = det3x3(a)
    safe = jnp.where(jnp.abs(det) < eps, jnp.where(det >= 0, eps, -eps), det)
    adj = _adjugate3x3(a)
    # inv(a) = adj / det, so inv(a)^T = adj^T / det.
    return jnp.swapaxes(adj, -1, -2) / safe[..., None, None]
