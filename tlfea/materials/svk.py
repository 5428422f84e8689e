"""St. Venant-Kirchhoff hyperelastic material.

P(F) = lambda * tr(E) * F + 2 mu * F E  with E = (F^T F - I)/2, equivalently
P(F) = lambda * (tr(F^T F)/2 - 3/2) * F + mu * (F F^T F - F), the exact form
the reference evaluates (`lib_src/materials/SVK.cuh:14-33`).

Also provides the closed-form diagonal tangent block used by the VBD solver
and the Newton-PCG block-Jacobi preconditioner (reference:
`SVK.cuh:35-55`); general tangent action is obtained via `jax.jvp` of
`first_piola`.
"""

from __future__ import annotations

import jax.numpy as jnp

from tlfea import struct

__all__ = ["SVK", "lame_from_E_nu"]


def lame_from_E_nu(E: float, nu: float) -> tuple[float, float]:
    """Lame parameters (lambda, mu) from Young's modulus and Poisson ratio."""
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = E / (2.0 * (1.0 + nu))
    return lam, mu


@struct.dataclass
class SVK:
    """St. Venant-Kirchhoff material with optional Kelvin-Voigt damping.

    lam, mu: Lame parameters. eta_damp, lam_damp: Kelvin-Voigt viscosity
    parameters (see `tlfea.elements.assembly.viscous_piola`); zero disables
    damping.
    """

    lam: jnp.ndarray
    mu: jnp.ndarray
    eta_damp: jnp.ndarray = struct.field(default=0.0)
    lam_damp: jnp.ndarray = struct.field(default=0.0)

    def first_piola(self, F: jnp.ndarray) -> jnp.ndarray:
        """Elastic first Piola-Kirchhoff stress for F of shape (..., 3, 3)."""
        trFtF = jnp.sum(F * F, axis=(-2, -1))
        FFtF = jnp.einsum("...ik,...jk,...jl->...il", F, F, F)
        lam_factor = self.lam * (0.5 * trFtF - 1.5)
        return lam_factor[..., None, None] * F + self.mu * (FFtF - F)

    def first_piola_du(self, Du: jnp.ndarray) -> jnp.ndarray:
        """Strain-safe P from the displacement gradient Du = F - I.

        E = (Du + Du^T + Du^T Du)/2 is evaluated without forming F^T F, so
        small strains suffer no catastrophic cancellation in float32 (the
        (tr F^T F - 3)/2 form loses ~7 digits at strain ~1e-4). Identical to
        `first_piola(I + Du)` in exact arithmetic.
        """
        DtD = jnp.einsum("...ki,...kj->...ij", Du, Du)
        E = 0.5 * (Du + jnp.swapaxes(Du, -1, -2) + DtD)
        trE = E[..., 0, 0] + E[..., 1, 1] + E[..., 2, 2]
        S = 2.0 * self.mu * E
        S = S + (self.lam * trE)[..., None, None] * jnp.eye(3, dtype=Du.dtype)
        # P = (I + Du) S
        return S + jnp.einsum("...ik,...kj->...ij", Du, S)

    def energy_density(self, F: jnp.ndarray) -> jnp.ndarray:
        """Strain energy density W(F) = lam/2 tr(E)^2 + mu E:E."""
        E = 0.5 * (jnp.einsum("...ki,...kj->...ij", F, F) - jnp.eye(3, dtype=F.dtype))
        trE = E[..., 0, 0] + E[..., 1, 1] + E[..., 2, 2]
        return 0.5 * self.lam * trE**2 + self.mu * jnp.sum(E * E, axis=(-2, -1))

    def tangent_diag_block(self, F: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
        """Closed-form 3x3 block  K[d,e] = A[d,J,e,L] h_J h_L  for one node.

        F: (..., 3, 3), h: (..., 3) shape-function gradient of the node.
        Returns (..., 3, 3). Matches the reference's
        `svk_compute_tangent_block` with i == j (`SVK.cuh:35-55`).
        """
        Fh = jnp.einsum("...ij,...j->...i", F, h)  # (..., 3)
        hij = jnp.sum(h * h, axis=-1)  # (...,)
        trE = 0.5 * (jnp.sum(F * F, axis=(-2, -1)) - 3.0)
        Fh_dot_Fh = jnp.sum(Fh * Fh, axis=-1)
        FFT = jnp.einsum("...ik,...jk->...ij", F, F)
        eye = jnp.eye(3, dtype=F.dtype)
        K = (
            self.lam * jnp.einsum("...d,...e->...de", Fh, Fh)
            + (self.lam * trE * hij)[..., None, None] * eye
            + (self.mu * Fh_dot_Fh)[..., None, None] * eye
            + self.mu * jnp.einsum("...d,...e->...de", Fh, Fh)
            + self.mu * hij[..., None, None] * FFT
            - (self.mu * hij)[..., None, None] * eye
        )
        return K
