"""Compressible Mooney-Rivlin hyperelastic material.

Strain energy (isochoric mu10/mu01 split + volumetric kappa term) whose first
Piola-Kirchhoff stress is

  P = 2 mu10 J^{-2/3} (F - I1/3 F^{-T})
    + 2 mu01 J^{-4/3} (I1 F - F C - 2 I2/3 F^{-T})
    + kappa (J - 1) J F^{-T}

matching the reference's `mr_compute_P` (`lib_src/materials/MooneyRivlin.cuh:
45-111`). Tangent action is obtained by `jax.jvp` of `first_piola` — the
reference's hand-derived 4th-order tangent (`MooneyRivlin.cuh:113-225`) is
used only as a test oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tlfea import struct
from tlfea.ops.linalg import det3x3, inv_transpose3x3

__all__ = ["MooneyRivlin"]


@struct.dataclass
class MooneyRivlin:
    """Compressible Mooney-Rivlin material with optional Kelvin-Voigt damping."""

    mu10: jnp.ndarray
    mu01: jnp.ndarray
    kappa: jnp.ndarray
    eta_damp: jnp.ndarray = struct.field(default=0.0)
    lam_damp: jnp.ndarray = struct.field(default=0.0)

    @property
    def mu(self):
        """Small-strain shear-modulus equivalent, mu = 2 (mu10 + mu01).

        Used only where a Lamé-parameter SCALE is needed (preconditioner
        blocks, `suggest_rho`, viscous-fold proportionality) — the stress
        itself always evaluates the full Mooney-Rivlin form."""
        return 2.0 * (self.mu10 + self.mu01)

    @property
    def lam(self):
        """Small-strain first-Lamé equivalent, lam = kappa - 2 mu / 3,
        clamped at 0: valid compressible parameter sets with small kappa
        give a NEGATIVE equivalent (nu < 0), which would flip the sign of
        the Lamé-scale terms in the consumers of this property
        (preconditioner blocks, `suggest_rho`) — those need a non-negative
        stiffness SCALE, not the signed constant. The stress itself never
        reads this."""
        return jnp.maximum(
            self.kappa - (4.0 / 3.0) * (self.mu10 + self.mu01), 0.0
        )

    def first_piola(self, F: jnp.ndarray) -> jnp.ndarray:
        """Elastic first Piola-Kirchhoff stress for F of shape (..., 3, 3)."""
        C = jnp.einsum("...ki,...kj->...ij", F, F)
        I1 = C[..., 0, 0] + C[..., 1, 1] + C[..., 2, 2]
        trC2 = jnp.sum(C * jnp.swapaxes(C, -1, -2), axis=(-2, -1))
        I2 = 0.5 * (I1 * I1 - trC2)

        J = det3x3(F)
        FinvT = inv_transpose3x3(F, det=J)

        J13 = jnp.cbrt(J)
        Jm23 = 1.0 / (J13 * J13)
        Jm43 = Jm23 * Jm23

        FC = jnp.einsum("...ik,...kj->...ij", F, C)

        t1 = (2.0 * self.mu10 * Jm23)[..., None, None]
        t2 = (2.0 * self.mu01 * Jm43)[..., None, None]
        t3 = (self.kappa * (J - 1.0) * J)[..., None, None]

        term1 = F - (I1 / 3.0)[..., None, None] * FinvT
        term2 = I1[..., None, None] * F - FC - (2.0 * I2 / 3.0)[..., None, None] * FinvT
        return t1 * term1 + t2 * term2 + t3 * FinvT

    def first_piola_du(self, Du: jnp.ndarray) -> jnp.ndarray:
        """P from the displacement gradient Du = F - I with an exact
        (cancellation-free) J - 1:

            J - 1 = tr(Du) + c2(Du) + det(Du),

        c2 = sum of principal 2x2 minors. The volumetric term
        kappa (J-1) J F^{-T} dominates the float32 noise of the naive
        det(F) - 1 at small strains; the isochoric terms are evaluated as in
        `first_piola` (their leading-order cancellations are structural to
        the Mooney-Rivlin form).
        """
        F = Du + jnp.eye(3, dtype=Du.dtype)
        trDu = Du[..., 0, 0] + Du[..., 1, 1] + Du[..., 2, 2]
        c2 = (
            Du[..., 0, 0] * Du[..., 1, 1] - Du[..., 0, 1] * Du[..., 1, 0]
            + Du[..., 0, 0] * Du[..., 2, 2] - Du[..., 0, 2] * Du[..., 2, 0]
            + Du[..., 1, 1] * Du[..., 2, 2] - Du[..., 1, 2] * Du[..., 2, 1]
        )
        Jm1 = trDu + c2 + det3x3(Du)
        J = 1.0 + Jm1

        C = jnp.einsum("...ki,...kj->...ij", F, F)
        I1 = C[..., 0, 0] + C[..., 1, 1] + C[..., 2, 2]
        trC2 = jnp.sum(C * jnp.swapaxes(C, -1, -2), axis=(-2, -1))
        I2 = 0.5 * (I1 * I1 - trC2)
        FinvT = inv_transpose3x3(F, det=J)
        J13 = jnp.cbrt(J)
        Jm23 = 1.0 / (J13 * J13)
        Jm43 = Jm23 * Jm23
        FC = jnp.einsum("...ik,...kj->...ij", F, C)
        t1 = (2.0 * self.mu10 * Jm23)[..., None, None]
        t2 = (2.0 * self.mu01 * Jm43)[..., None, None]
        t3 = (self.kappa * Jm1 * J)[..., None, None]
        term1 = F - (I1 / 3.0)[..., None, None] * FinvT
        term2 = I1[..., None, None] * F - FC - (2.0 * I2 / 3.0)[..., None, None] * FinvT
        return t1 * term1 + t2 * term2 + t3 * FinvT

    def energy_density(self, F: jnp.ndarray) -> jnp.ndarray:
        """W = mu10 (I1bar - 3) + mu01 (I2bar - 3) + kappa/2 (J - 1)^2."""
        C = jnp.einsum("...ki,...kj->...ij", F, F)
        I1 = C[..., 0, 0] + C[..., 1, 1] + C[..., 2, 2]
        trC2 = jnp.sum(C * jnp.swapaxes(C, -1, -2), axis=(-2, -1))
        I2 = 0.5 * (I1 * I1 - trC2)
        J = det3x3(F)
        Jm23 = jnp.cbrt(J) ** -2.0
        return (
            self.mu10 * (I1 * Jm23 - 3.0)
            + self.mu01 * (I2 * Jm23 * Jm23 - 3.0)
            + 0.5 * self.kappa * (J - 1.0) ** 2
        )

    def tangent_diag_block(self, F: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
        """3x3 block K[d,e] = A[d,J,e,L] h_J h_L via three JVPs of P.

        Column e of K is (dP/dF : (e_e x h)) @ h. Exact (forward-mode AD of
        the closed-form P), no materialized 4th-order tensor.
        """

        def col(e_vec):
            dF = jnp.einsum("...d,...l->...dl", jnp.broadcast_to(e_vec, h.shape[:-1] + (3,)), h)
            _, dP = jax.jvp(self.first_piola, (F,), (dF,))
            return jnp.einsum("...dl,...l->...d", dP, h)

        eye = jnp.eye(3, dtype=F.dtype)
        cols = [col(eye[e]) for e in range(3)]
        return jnp.stack(cols, axis=-1)
