"""Unified device-side element representation and assembly kernels.

Design: every element family (FEAT10 tet, ANCF3243 beam, ANCF3443 shell)
reduces, after host-side precomputation, to the same four arrays:

  conn       (E, S)  int32   element -> global coefficient indices
  grad_N     (E, Q, S, 3)    physical shape-function gradients at QPs
  dV         (E, Q)          detJ * quadrature weight (reference volume)
  mass_elem  (E, S, S)       consistent per-element mass blocks

so a single set of jitted, vmapped kernels — deformation gradient, stress,
internal force, mass matvec — serves all families. This replaces the
reference's per-family CUDA kernel triplicate (`lib_src/elements/
{FEAT10,ANCF3243,ANCF3443}Data*.cu*`) with one batched compute path that XLA
fuses for the device.

"Coefficients" generalize nodes: for FEAT10 a coefficient is a node (S = 10);
for ANCF each node carries 4 vector coefficients (position + 3 gradients), so
S = 8 (3243) or 16 (3443), matching the reference's `n_coef` convention
(`lib_src/elements/ANCF3243Data.cuh:434-440`).

The global mass matrix is never assembled: M @ v is computed as a batched
(E, S, S) x (E, S, 3) matmul plus a scatter-add,
replacing the reference's CSR + atomicAdd assembly (`FEAT10Data.cu:206-278`)
and CSR SpMV row loops (`SyncedNewton.cu:343-407`).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from tlfea import struct
from tlfea.ops.segment import coef_scatter_add, gather_coefs

__all__ = [
    "ElementBatch",
    "node_ref",
    "deformation_gradient",
    "velocity_gradient",
    "viscous_piola",
    "total_piola",
    "internal_force",
    "alm_residual_contributions",
    "mass_matvec",
    "mass_diag",
    "lumped_mass",
]


@struct.dataclass
class ElementBatch:
    """Device-resident batch of same-family elements (a pytree).

    The reference's mutable `GPU_*_Data` device structs
    (`lib_src/elements/ElementBase.h:22-50`) become this immutable pytree;
    "Setup" is a pure host-side constructor in each family module.
    """

    conn: jnp.ndarray  # (E, S) int32
    grad_N: jnp.ndarray  # (E, Q, S, 3)
    dV: jnp.ndarray  # (E, Q)
    mass_elem: jnp.ndarray  # (E, S, S)
    # Per-element reference coefficient positions (E, S, 3). F is computed
    # displacement-based, F = I + sum_a (x_a - X_a) x grad_N_a: in float32,
    # the direct sum_a x_a x grad_N_a carries O(|x|) cancellation noise that
    # swamps small strains for stiff materials (SURVEY hard part #4); the
    # displacement form is exact in the strain scale. (Uses
    # sum_a X_a x grad_N_a = I, which holds for every isoparametric family.)
    xe_ref: jnp.ndarray
    n_coef: int = struct.field(pytree_node=False)
    # Node-level reference coefficient positions (n_coef, 3): x_ref[conn] ==
    # xe_ref. The hot solver paths work in DISPLACEMENT space u = x - x_ref
    # (node-space subtraction once per gradient) so that the f32 iterate
    # update u_prev + dt*v resolves increments at the strain scale, not the
    # coordinate scale — forming x = x_prev + dt*v in absolute coordinates
    # rounds dt*v away entirely for stiff problems (dt*v ~ 1e-7 |x|) and
    # stalls Newton. Kernels then need no reference subtract at all.
    x_ref: jnp.ndarray | None = None
    # Static per-slot mask of TRANSLATION coefficients: slots whose shape
    # gradients sum to exactly zero (all slots for isoparametric FEAT10;
    # the position slots for ANCF, whose gradient-coefficient slots carry a
    # rigid translation as zeros). Gradient contractions may subtract one
    # translation slot's value from the others without changing the result
    # — "element-local centering" — which removes the rigid-motion common
    # mode from the operands and with it the dominant f32 cancellation
    # noise at large displacement/strain ratios (eps*|u| -> eps*|du|).
    trans_mask: tuple | None = struct.field(pytree_node=False, default=None)

    @property
    def n_elem(self) -> int:
        return self.conn.shape[0]

    @property
    def n_shape(self) -> int:
        return self.conn.shape[1]

    @property
    def n_qp(self) -> int:
        return self.grad_N.shape[1]

    def astype(self, dtype) -> "ElementBatch":
        return ElementBatch(
            conn=self.conn,
            grad_N=self.grad_N.astype(dtype),
            dV=self.dV.astype(dtype),
            mass_elem=self.mass_elem.astype(dtype),
            xe_ref=self.xe_ref.astype(dtype),
            n_coef=self.n_coef,
            x_ref=None if self.x_ref is None else self.x_ref.astype(dtype),
            trans_mask=self.trans_mask,
        )


def node_ref(elems: ElementBatch) -> jnp.ndarray:
    """Node-level reference positions (n_coef, 3).

    Prefers the precomputed `elems.x_ref`; falls back to a scatter from the
    per-element `xe_ref` (each element writes the same value for a shared
    coefficient) for batches built before the field existed.
    """
    if elems.x_ref is not None:
        return elems.x_ref
    out = jnp.zeros((elems.n_coef, 3), dtype=elems.xe_ref.dtype)
    return out.at[elems.conn.reshape(-1)].set(elems.xe_ref.reshape(-1, 3))


def deformation_gradient(x: jnp.ndarray, elems: ElementBatch) -> jnp.ndarray:
    """F at every quadrature point: F_ij = sum_a x_a[i] * dN_a/dX[j].

    x: (n_coef, 3) current coefficient positions -> (E, Q, 3, 3).
    Reference: `compute_p` F accumulation (`FEAT10DataFunc.cuh:85-130`),
    rewritten displacement-based for float32 robustness (see ElementBatch).
    """
    xe = gather_coefs(x, elems.conn)  # (E, S, 3)
    Du = jnp.einsum("eai,eqaj->eqij", xe - elems.xe_ref, elems.grad_N)
    return Du + jnp.eye(3, dtype=Du.dtype)


def velocity_gradient(v: jnp.ndarray, elems: ElementBatch) -> jnp.ndarray:
    """Fdot at every QP from coefficient velocities v: (n_coef, 3)."""
    ve = gather_coefs(v, elems.conn)
    return jnp.einsum("eai,eqaj->eqij", ve, elems.grad_N)


def viscous_piola(F: jnp.ndarray, Fdot: jnp.ndarray, eta: jnp.ndarray, lam_d: jnp.ndarray) -> jnp.ndarray:
    """Kelvin-Voigt viscous first Piola stress.

    P_vis = F S_vis with S_vis = 2 eta Edot + lam_d tr(Edot) I and
    Edot = (Fdot^T F + F^T Fdot)/2. Reference: `FEAT10DataFunc.cuh:135-232`.
    """
    FdotT_F = jnp.einsum("...ki,...kj->...ij", Fdot, F)
    Edot = 0.5 * (FdotT_F + jnp.swapaxes(FdotT_F, -1, -2))
    trEdot = Edot[..., 0, 0] + Edot[..., 1, 1] + Edot[..., 2, 2]
    eye = jnp.eye(3, dtype=F.dtype)
    S_vis = 2.0 * eta * Edot + (lam_d * trEdot)[..., None, None] * eye
    return jnp.einsum("...ik,...kj->...ij", F, S_vis)


def total_piola(x: jnp.ndarray, v: jnp.ndarray | None, elems: ElementBatch, material) -> jnp.ndarray:
    """Elastic + viscous first Piola stress at every QP -> (E, Q, 3, 3)."""
    xe = gather_coefs(x, elems.conn)
    Du = jnp.einsum("eai,eqaj->eqij", xe - elems.xe_ref, elems.grad_N)
    if hasattr(material, "first_piola_du"):
        P = material.first_piola_du(Du)  # strain-safe
    else:
        P = material.first_piola(Du + jnp.eye(3, dtype=Du.dtype))
    if v is not None:
        # Trace-time zero test keeps undamped materials free of the extra work.
        damped = _is_nonzero(material.eta_damp) or _is_nonzero(material.lam_damp)
        if damped:
            Fdot = velocity_gradient(v, elems)
            F = Du + jnp.eye(3, dtype=Du.dtype)
            P = P + viscous_piola(F, Fdot, material.eta_damp, material.lam_damp)
    return P


def _is_nonzero(p) -> bool:
    """True unless p is a concrete (non-traced) zero."""
    if isinstance(p, (int, float)):
        return p != 0.0
    arr = np.asarray(p) if not hasattr(p, "aval") else None
    if arr is not None and arr.size == 1:
        return bool(arr != 0.0)
    return True  # traced value: assume damping may be active


def internal_force(
    x: jnp.ndarray,
    v: jnp.ndarray | None,
    elems: ElementBatch,
    material,
) -> jnp.ndarray:
    """Global internal force f_int: (n_coef, 3).

    f_a = sum_q P(q) grad_N_a(q) dV(q), scattered over connectivity.
    Reference: `compute_internal_force` (`FEAT10DataFunc.cuh:397-458`), with
    the atomicAdd scatter replaced by an XLA scatter-add.
    """
    P = total_piola(x, v, elems, material)
    fe = jnp.einsum("eqij,eqaj,eq->eai", P, elems.grad_N, elems.dV)
    return coef_scatter_add(fe, elems.conn, elems.n_coef)


def alm_residual_contributions(
    u: jnp.ndarray,
    v: jnp.ndarray,
    dv_dt: jnp.ndarray,
    elems: ElementBatch,
    material,
) -> jnp.ndarray:
    """Fused element contributions of the ALM gradient:

        out = scatter( M_e @ dv_dt  +  f_int,e(u, v) )

    u: node-level DISPLACEMENTS (x - x_ref); see ElementBatch.x_ref for why
    the hot path is displacement-based.

    i.e. M (v - v_prev)/h + f_int in one pass. Performance-critical: the
    gather/scatter passes over the node arrays dominate a residual
    evaluation at FEM sizes, so this path
    packs [x | v | dv_dt] into a single (n_coef, 9) gather and merges the
    mass and internal-force contributions into a single scatter-add —
    ~2x faster per evaluation than composing `mass_matvec` +
    `internal_force`.
    """
    contrib = _element_contrib_values(u, v, dv_dt, elems, material)
    return coef_scatter_add(contrib, elems.conn, elems.n_coef)  # single scatter


def center_translation(ae: jnp.ndarray, elems: ElementBatch) -> jnp.ndarray:
    """Element-local centering of gathered per-slot values (E, S, k).

    Subtracts the first translation slot's value from every translation
    slot — exact (their shape gradients sum to zero, see
    ElementBatch.trans_mask) but removes the rigid-motion common mode, so
    downstream gradient contractions see operands at the element-relative
    scale instead of |u|, eliminating the dominant f32 cancellation noise.
    """
    tm = elems.trans_mask
    if tm is None:
        return ae
    r = tm.index(True)
    mask = jnp.asarray(np.asarray(tm))  # (S,) bool
    return ae - jnp.where(mask[None, :, None], ae[:, r : r + 1, :], 0)


def _element_contrib_values(u, v, dv_dt, elems: ElementBatch, material,
                            compute_dtype=None) -> jnp.ndarray:
    """Per-element-slot contribution values (E, S, 3), pre-scatter.

    u: node-level displacements — the gather yields ue directly (no xe_ref
    subtract in the element loop).
    compute_dtype: optional wide dtype for the element pipeline (accuracy
    mode, see System.accum_dtype): the f32 Du contraction carries
    eps*|rotation| noise that the modulus amplifies into a residual floor
    ~eps*E*theta — at E=7e8 that is ~1% of a gravity load. Returns values
    in compute_dtype so the caller's scatter accumulates wide too."""
    packed = jnp.concatenate([u, v, dv_dt], axis=1)  # (n_coef, 9)
    pe = packed[elems.conn]  # (E, S, 9) — the single gather
    if compute_dtype is not None:
        pe = pe.astype(compute_dtype)
    ue = center_translation(pe[..., 0:3], elems)
    dve = pe[..., 6:9]

    Du = jnp.einsum("eai,eqaj->eqij", ue, elems.grad_N)
    if hasattr(material, "first_piola_du"):
        P = material.first_piola_du(Du)  # strain-safe path
    else:
        P = material.first_piola(Du + jnp.eye(3, dtype=Du.dtype))
    damped = _is_nonzero(material.eta_damp) or _is_nonzero(material.lam_damp)
    if damped:
        ve = center_translation(pe[..., 3:6], elems)
        Fdot = jnp.einsum("eai,eqaj->eqij", ve, elems.grad_N)
        F = Du + jnp.eye(3, dtype=Du.dtype)
        P = P + viscous_piola(F, Fdot, material.eta_damp, material.lam_damp)

    fe = jnp.einsum("eqij,eqaj,eq->eai", P, elems.grad_N, elems.dV)
    me = jnp.einsum("eab,ebi->eai", elems.mass_elem, dve)
    return fe + me


def mass_matvec(v: jnp.ndarray, elems: ElementBatch) -> jnp.ndarray:
    """Consistent-mass product M @ v without assembling M.

    v: (n_coef, 3) -> (n_coef, 3). Batched (E,S,S)x(E,S,3) matmul + scatter.
    """
    ve = gather_coefs(v, elems.conn)
    mv = jnp.einsum("eab,ebi->eai", elems.mass_elem, ve)
    return coef_scatter_add(mv, elems.conn, elems.n_coef)


def mass_diag(elems: ElementBatch) -> jnp.ndarray:
    """Diagonal of the assembled consistent mass matrix -> (n_coef,).

    Used by block-Jacobi preconditioners (the reference extracts the same
    diagonal blocks from its mass CSR: `SyncedVBD.cu:1030-1075`).
    """
    diag_e = jnp.einsum("eaa->ea", elems.mass_elem)  # (E, S)
    out = jnp.zeros((elems.n_coef,), dtype=diag_e.dtype)
    return out.at[elems.conn.reshape(-1)].add(diag_e.reshape(-1))


def lumped_mass(elems: ElementBatch) -> jnp.ndarray:
    """Row-sum lumped mass -> (n_coef,)."""
    rows = jnp.sum(elems.mass_elem, axis=2)  # (E, S)
    out = jnp.zeros((elems.n_coef,), dtype=rows.dtype)
    return out.at[elems.conn.reshape(-1)].add(rows.reshape(-1))


def assemble_mass_csr(elems: ElementBatch):
    """Host-side assembled coefficient-level mass in CSR form.

    Returns (offsets (n+1,), columns (nnz,), values (nnz,)) as NumPy arrays —
    the analogue of the reference's `RetrieveMassCSRToCPU`
    (`FEAT10Data.cuh` retrieval methods) for inspection/export. The solver
    itself never assembles this (it is matrix-free).
    """
    conn = np.asarray(elems.conn)
    me = np.asarray(elems.mass_elem)
    E, S = conn.shape
    rows = np.repeat(conn, S, axis=1).reshape(-1)
    cols = np.tile(conn, (1, S)).reshape(-1)
    vals = me.reshape(-1)
    # Sum duplicates via lexicographic sort.
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    new = np.ones(len(rows), dtype=bool)
    new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    group = np.cumsum(new) - 1
    u_rows = rows[new]
    u_cols = cols[new]
    u_vals = np.zeros(int(group[-1]) + 1 if len(group) else 0)
    np.add.at(u_vals, group, vals)
    offsets = np.zeros(elems.n_coef + 1, dtype=np.int64)
    np.add.at(offsets, u_rows + 1, 1)
    offsets = np.cumsum(offsets)
    return offsets, u_cols, u_vals
