"""Two-level (aggregation) preconditioner for Newton-PCG.

Block-Jacobi handles the high-frequency end of the spectrum; for stiff or
slender structures the low-frequency (long-wavelength) modes dominate
kappa and CG stalls (observed: CG hitting its cap on slender-beam problems).
This adds a coarse correction in the classic additive two-level form

    z = B_jacobi(r) + R A_c^{-1} R^T r,

with piecewise-constant prolongation R over spatial node aggregates and the
exact Galerkin coarse operator A_c = R^T H R assembled from per-element
tangent/mass blocks (SVK closed form, reference `SVK.cuh:35-55` generalized
to off-diagonal node pairs) and Cholesky-factorized on device once per inner
solve. The coarse apply per CG iteration is one segment-sum, one small dense
triangular solve pair, and one gather.

The reference has no analog (its Newton uses a direct factorization); this
is the matrix-free answer to the same robustness need.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tlfea import struct
from tlfea.elements.assembly import ElementBatch, deformation_gradient

__all__ = ["CoarseSetup", "build_aggregates", "coarse_operator", "make_two_level_precond"]


def _viscous_factor(material, dt):
    """Proportional-damping scale for elastic tangent blocks: the
    Kelvin-Voigt tangent has the same lam*A + mu*B structure with
    (lam_d, eta) replacing (dt*lam, dt*mu), so H_el + H_vis ~=
    H_el * (1 + (eta + lam_d)/(dt (lam + mu))). Preconditioner-quality
    (exact under proportional damping); without it, heavy damping leaves
    the dominant Hessian term unrepresented and CG stalls."""
    eta_d = getattr(material, "eta_damp", 0.0)
    lam_d = getattr(material, "lam_damp", 0.0)
    return 1.0 + (eta_d + lam_d) / (dt * (material.lam + material.mu))


@struct.dataclass
class CoarseSetup:
    agg: jnp.ndarray  # (n_coef,) int32 cluster id
    n_agg: int = struct.field(pytree_node=False)


def build_aggregates(x_ref: np.ndarray, target_cluster: int = 48) -> CoarseSetup:
    """Spatial-grid aggregation of coefficients into ~target_cluster-size
    clusters (host, NumPy)."""
    x_ref = np.asarray(x_ref, dtype=np.float64)
    n = x_ref.shape[0]
    n_agg_target = max(1, n // target_cluster)
    lo = x_ref.min(axis=0)
    ext = np.maximum(x_ref.max(axis=0) - lo, 1e-12)
    # Grid resolution ~ cube root of target cluster count, scaled per axis by
    # extent so cells are roughly isotropic.
    rel = ext / ext.max()
    k = (n_agg_target / max(rel.prod(), 1e-12)) ** (1.0 / 3.0)
    dims = np.maximum(1, np.round(k * rel)).astype(int)
    cell = np.minimum(
        ((x_ref - lo) / (ext / dims)).astype(int), dims - 1
    )
    keys = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    uniq, agg = np.unique(keys, return_inverse=True)
    return CoarseSetup(agg=jnp.asarray(agg.astype(np.int32)), n_agg=int(len(uniq)))


def _svk_pair_blocks(F, grad_N, dV, lam, mu, dt):
    """Full per-element tangent blocks K[e, a, b, 3, 3] = sum_q dt dV
    svk_tangent(F_q; h_a, h_b) (reference `svk_compute_tangent_block`,
    `SVK.cuh:35-55`, for all (a, b) node pairs)."""
    Fh = jnp.einsum("eqij,eqaj->eqai", F, grad_N)  # (E,Q,S,3)
    hij = jnp.einsum("eqaj,eqbj->eqab", grad_N, grad_N)
    FhFh = jnp.einsum("eqai,eqbi->eqab", Fh, Fh)  # Fh_b . Fh_a
    trE = 0.5 * (jnp.sum(F * F, axis=(-2, -1)) - 3.0)  # (E,Q)
    FFT = jnp.einsum("eqik,eqjk->eqij", F, F)
    eye = jnp.eye(3, dtype=F.dtype)
    w = dt * dV  # (E,Q)

    # Each term contracts the QP axis inside the einsum, so the only
    # (E,S,S,3,3) array is the accumulated output. ('x' = element axis;
    # 'd','c' = the 3x3 block indices.)
    K = lam * jnp.einsum("xq,xqad,xqbc->xabdc", w, Fh, Fh)
    K = K + mu * jnp.einsum("xq,xqbd,xqac->xabdc", w, Fh, Fh)
    K = K + mu * jnp.einsum("xq,xqab,xqdc->xabdc", w, hij, FFT)
    # Kronecker-delta terms combined: [(lam trE - mu) h_ab + mu FhFh] delta.
    scal = jnp.einsum("xq,xqab->xab", w * (lam * trE - mu), hij)
    scal = scal + mu * jnp.einsum("xq,xqab->xab", w, FhFh)
    K = K + scal[..., None, None] * eye
    return K  # (E, S, S, 3, 3)


def coarse_operator(x, elems: ElementBatch, material, cons, setup: CoarseSetup, dt, rho):
    """Assemble A_c = R^T H R -> (n_agg, 3, n_agg, 3) dense."""
    F = deformation_gradient(x, elems)
    Kb = _svk_pair_blocks(F, elems.grad_N, elems.dV, material.lam, material.mu, dt)
    Kb = Kb * _viscous_factor(material, dt)
    # Mass blocks: (M/h)_ab = mass_elem/dt on the diagonal of the 3x3.
    eye = jnp.eye(3, dtype=x.dtype)
    Mb = (elems.mass_elem / dt)[..., None, None] * eye  # (E,S,S,3,3)
    Hb = Kb + Mb

    agg = setup.agg
    ca = agg[elems.conn]  # (E, S)
    E, S = ca.shape
    na = setup.n_agg
    rows = jnp.repeat(ca, S, axis=1).reshape(-1)  # (E*S*S,)
    cols = jnp.tile(ca, (1, S)).reshape(-1)
    vals = Hb.reshape(-1, 3, 3)
    A = jnp.zeros((na, na, 3, 3), dtype=x.dtype)
    A = A.at[rows, cols].add(vals)

    if cons is not None and hasattr(cons, "idx"):
        pen = jnp.zeros((na,), dtype=x.dtype).at[agg[cons.idx]].add(dt * dt * rho)
        A = A.at[jnp.arange(na), jnp.arange(na)].add(pen[:, None, None] * eye)

    Ad = jnp.transpose(A, (0, 2, 1, 3)).reshape(3 * na, 3 * na)
    # Regularize: coarse correction need not be exact, must be SPD.
    diag_scale = jnp.maximum(jnp.max(jnp.abs(jnp.diagonal(Ad))), 1e-30)
    Ad = 0.5 * (Ad + Ad.T) + (1e-6 * diag_scale) * jnp.eye(3 * na, dtype=x.dtype)
    return Ad


@struct.dataclass
class CoarsePrecond:
    """Frozen two-level coarse correction with matmul-based apply.

    Built ONCE (typically at the rest configuration): piecewise modes per
    spatial aggregate — 3 translations (`k_modes=3`), + 3 rotations
    (`k_modes=6`, rigid), or the full affine family (`k_modes=12`:
    translations + all 9 linear-gradient modes, which contains the
    rotations and additionally reproduces every constant-strain field
    exactly — the standard smoothed-aggregation near-kernel enrichment for
    elasticity) — with the exact Galerkin operator A_c = R^T H(x0) R
    Cholesky-factorized up front. Per CG iteration the apply is two (or
    four) dense (na, n) matmuls + a small triangular solve: no gathers, no
    scatters, no per-step assembly (the round-1 coarse apply paid one
    scatter + one gather per iteration and re-assembled A_c every inner
    solve).

    Freezing at x0 is the multigrid "frozen coarse operator" trade: the
    long-wavelength stiffness it must capture changes slowly with
    deformation; rebuild via `build_coarse_precond` if the mesh deforms
    far from the build state.
    """

    Agg: jnp.ndarray  # (na, n) one-hot aggregation, f32 (None when seg > 0)
    u0: jnp.ndarray  # (n, 3) lever arms about aggregate centroids
    Ainv: jnp.ndarray  # (k, k) explicit inverse of A_c (dense, SPD)
    k_modes: int = struct.field(pytree_node=False)  # 3 | 6 | 12 per agg
    n_agg: int = struct.field(pytree_node=False)
    # seg > 0: FACTORED restrict, EXACTLY equal to the dense one-hot Agg.
    # Nodes reshape-sum into contiguous index ranges of `seg` nodes — but a
    # range can straddle aggregate boundaries, so each node carries a SLOT:
    # the rank of its aggregate among the distinct aggregates in its range
    # (first-occurrence order). Restrict masks the reshape-sum per slot (m
    # fused elementwise passes over one input), then maps (slot, range) ->
    # aggregate. That map is BANDED — grid-cell aggregate ids (x-major key
    # order) and RCM range ids both advance along the structure — so chunks
    # of C consecutive ranges touch only a B-wide window of aggregate ids:
    # `Gc` holds per-chunk local one-hot blocks and `Gmap` the (na, nc*B)
    # window-row -> global-aggregate one-hot. The apply is one small batched
    # matmul (n_fine*m*B*4 bytes ~ 30 MB at 145k nodes vs 600 MB for the
    # dense (na, n) Agg) plus a tiny (na, nc*B) matmul. NO quality loss:
    # hard whole-range assignment was measured 57.5 CG at 100k where the
    # exact factorization gives the dense mode's 35 (ranges are arcs of an
    # RCM level set that straddle cell boundaries; majority-voting them
    # cannot fix the raggedness).
    # All arrays in the seg > 0 apply are FLOAT one-hots — zero integer
    # indexing (gather/scatter/compare) on the CG critical path: dense
    # matmuls over one-hot tables in place of row-granular scatter/gather.
    # Whether that still wins on the GPU is not measured (ROADMAP S6).
    seg: int = struct.field(pytree_node=False, default=0)
    Gc: jnp.ndarray = None  # (n_chunks, B, m, C) local one-hot, seg > 0 only
    Gmap: jnp.ndarray = None  # (na, n_chunks*B) f32 window row -> aggregate
    smask: jnp.ndarray = None  # (n_chunks, m, seg, C) f32 slot one-hot
    chunk: int = struct.field(pytree_node=False, default=0)  # C, seg > 0
    # Matmul compute dtype for the apply ("bfloat16" | None). The coarse
    # correction is preconditioner-quality: bf16 tables halve the HBM
    # traffic of the apply (the coarse solve table alone is 150 MB f32 at
    # max_agg=1024) AND run the matmuls at the bf16 rate instead of the
    # full-f32 one that jax_default_matmul_precision="float32" forces
    # (one-hot tables are EXACT in bf16). CRITICAL: the coarse solve must stay SPD under rounding —
    # entrywise bf16 rounding of the explicit inverse makes it INDEFINITE
    # for stiff problems (smallest eigenvalue ~1e-6 of largest; measured:
    # CG's rz>0 breakdown guard fires at iter 3 and Newton stalls on the
    # E=2e9 slender beam). So bf16 mode stores the inverse CHOLESKY factor
    # `Li` = bf16(L^-1) and applies M_c^-1 = Li^T (Li rhs): SPSD by
    # construction for ANY rounding. Two (k,k) matvecs in bf16 stream the
    # same bytes as one in f32; the one-hot table savings are pure win.
    mm_dtype: str = struct.field(pytree_node=False, default=None)
    Li: jnp.ndarray = None  # (k, k) inverse Cholesky factor, mm_dtype only
    # Spectral truncation (rank=r): keep only the r SMALLEST-eigenvalue
    # modes of A_c, stored whitened (W = V_r diag(lambda_r^-1/2)) so the
    # apply W (W^T rhs) is SPSD under ANY rounding and streams 2 k r bytes
    # instead of k^2. MEASURED LOSS on the 100k bench problem (CG 7 -> 28
    # at both r=512 and r=1024 of k=6120; ms/step 23.4 -> 42.2): the
    # aggregate space is already a 140x reduction, so ALL its modes carry
    # low-frequency content — truncation amputates the correction rather
    # than trimming redundancy. Kept as an option for problems with a
    # genuinely clustered coarse spectrum; default off.
    W: jnp.ndarray = None  # (k, r) whitened truncated eigenbasis

    def _mm(self, a: jnp.ndarray) -> jnp.ndarray:
        """Cast a matmul operand to the apply compute dtype. Tables built
        with mm_dtype are already stored in it (no-op cast, no HBM hit);
        the per-iteration vectors round here."""
        return a if self.mm_dtype is None else a.astype(self.mm_dtype)

    def restrict(self, r: jnp.ndarray) -> jnp.ndarray:
        if self.k_modes == 6:
            # Augmented channels: translations and moments restricted in ONE
            # product/sum (one op fewer on the CG critical path).
            r = jnp.concatenate([r, jnp.cross(self.u0, r)], axis=1)  # (n, 6)
        elif self.k_modes == 12:
            # Affine: channel 3 + 3a + b restricts sum_i u0[i, a] r[i, b].
            outer = (self.u0[:, :, None] * r[:, None, :]).reshape(-1, 9)
            r = jnp.concatenate([r, outer], axis=1)  # (n, 12)
        r = self._mm(r)
        if self.seg:
            # Every materialized temp keeps C (=256) in the minor dim: a
            # minor dim of k=6 pads badly under tiled layouts.
            nc, B, m, C = self.Gc.shape
            k = r.shape[1]
            pad = nc * C * self.seg - r.shape[0]
            rt = jnp.pad(r, ((0, pad), (0, 0))).T.reshape(k, nc, C, self.seg)
            rp = jnp.transpose(rt, (1, 0, 3, 2))  # (nc, k, seg, C)
            fine = jnp.einsum("nksc,nmsc->nmkc", rp, self._mm(self.smask))
            rc_loc = jnp.einsum("nbmc,nmkc->nbk", self._mm(self.Gc), fine)
            return (self._mm(self.Gmap) @ rc_loc.reshape(-1, k)).reshape(-1)
        return (self._mm(self.Agg) @ r).reshape(-1)

    def prolong(self, w: jnp.ndarray) -> jnp.ndarray:
        k = self.k_modes
        w = self._mm(w).reshape(self.n_agg, k)
        if self.seg:
            nc, B, m, C = self.Gc.shape
            n = self.u0.shape[0]
            w_loc = (self._mm(self.Gmap).T @ w).reshape(nc, B, k)
            fine = jnp.einsum("nbmc,nbk->nmkc", self._mm(self.Gc), w_loc)
            z = jnp.einsum("nmkc,nmsc->nksc", fine, self._mm(self.smask))
            z6 = jnp.transpose(z, (1, 0, 3, 2)).reshape(k, -1).T[:n]
        else:
            z6 = self._mm(self.Agg).T @ w  # (n, k) — one matmul, both families
        z6 = z6.astype(self.u0.dtype)
        if self.k_modes == 3:
            return z6
        if self.k_modes == 6:
            return z6[:, :3] + jnp.cross(z6[:, 3:], self.u0)
        W9 = z6[:, 3:].reshape(-1, 3, 3)  # [a, b] layout (see restrict)
        return z6[:, :3] + jnp.einsum("na,nab->nb", self.u0, W9)

    def apply(self, r: jnp.ndarray) -> jnp.ndarray:
        # Explicit-inverse matmul, not a triangular solve: cho_solve is k
        # sequential steps, a (k, k) matvec is one parallel product. The
        # inverse is fine numerically here — A_c is regularized SPD and this
        # is only a preconditioner.
        rhs = self.restrict(r)
        if self.W is not None:
            # Truncated spectral solve (see W): SPSD for any rounding.
            W = self._mm(self.W)
            w = W @ (W.T @ rhs)
        elif self.Li is not None:
            # Factored SPSD solve (see mm_dtype): w = Li^T (Li rhs).
            Li = self._mm(self.Li)
            w = Li.T @ (Li @ rhs)
        else:
            w = self._mm(self.Ainv) @ rhs
        return self.prolong(w).astype(r.dtype)


def _phi(u0_e, k_modes: int):
    """Per-slot mode matrix Phi (…, 3, k): z = Phi @ w_modes.

    k=3: Phi = I; k=6: [I | -skew(u)] (rigid); k=12: [I | u_x I | u_y I |
    u_z I] (affine — column 3 + 3a + c is mode u_a e_c, matching
    CoarsePrecond.restrict's channel layout)."""
    shape = u0_e.shape[:-1]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=u0_e.dtype), shape + (3, 3))
    if k_modes == 3:
        return eye
    if k_modes == 12:
        return jnp.concatenate(
            [eye] + [u0_e[..., a, None, None] * eye for a in range(3)],
            axis=-1,
        )  # (..., 3, 12)
    ux, uy, uz = u0_e[..., 0], u0_e[..., 1], u0_e[..., 2]
    zero = jnp.zeros_like(ux)
    # -skew(u): rows of (-u x e_j) -> (-skew(u))[d, c]
    msk = jnp.stack(
        [
            jnp.stack([zero, uz, -uy], axis=-1),
            jnp.stack([-uz, zero, ux], axis=-1),
            jnp.stack([uy, -ux, zero], axis=-1),
        ],
        axis=-2,
    )
    return jnp.concatenate([eye, msk], axis=-1)  # (..., 3, 6)


def build_coarse_precond(
    system,
    x0,
    dt,
    rho,
    target_cluster: int = 48,
    rotations: bool = True,
    modes: str = None,
    max_agg: int = 512,
    chunk: int = 16384,
    ranges: bool = False,
    mm_dtype: str = None,
    rank: int = None,
) -> CoarsePrecond:
    """Assemble + factor the frozen coarse correction at configuration x0.

    SVK materials (closed-form pair tangents). `max_agg` caps the coarse
    problem so the dense Agg matrix and Cholesky stay small at 100k+ elems.

    ranges=True builds the SAME spatial-grid aggregates and an EXACTLY
    equivalent restrict/prolong factored through contiguous `seg`-node
    index ranges: per-slot masked reshape-sums plus a small one-hot
    (m, na, n/seg) batched matmul, where m is the max number of distinct
    aggregates any range touches (see CoarsePrecond.seg). Same CG counts
    as dense mode by construction; the dense (na, n) Agg matmul (~600 MB
    HBM per CG iteration at 145k nodes) disappears. A bandwidth-reducing
    node order (RCM, `utils.reorder`) keeps m small; any order stays
    correct, just with larger m.

    mm_dtype="bfloat16" stores the apply tables (Agg / Gc / Gmap / smask /
    Ainv) in bf16 and runs the apply matmuls in it — see
    CoarsePrecond.mm_dtype. Assembly and factorization stay in the build
    dtype; only the frozen products round.
    """
    if modes is None:
        modes = "rigid" if rotations else "trans"
    k_modes = {"trans": 3, "rigid": 6, "affine": 12}[modes]
    x0np = np.asarray(x0)
    n = x0np.shape[0]
    target_cluster = max(target_cluster, int(np.ceil(n / max_agg)))
    if ranges:
        # The coarse SPACE is the node-level spatial grid — identical to
        # dense mode. Only the restrict/prolong implementation is factored
        # through contiguous `seg`-node ranges plus per-node slots (see
        # CoarsePrecond.seg). Hard whole-range assignment loses real
        # quality (57.5 CG at 100k vs 35 exact: ranges are arcs of an RCM
        # level set that straddle cell boundaries), so assignment is exact.
        seg = int(np.clip(target_cluster // 4, 1, 8))
        n_fine = -(-n // seg)
        setup = build_aggregates(x0np, target_cluster=target_cluster)
        node_agg = np.asarray(setup.agg)
        na_r = setup.n_agg
        # Chunk ranges; pad the range count to whole chunks (slot -1 rows
        # never match a mask) and the node count to whole ranges with
        # copies of the last node's aggregate (pad positions carry zeros at
        # apply time, so they only need a valid slot id).
        C = min(256, n_fine)
        n_chunks = -(-n_fine // C)
        A = np.concatenate(
            [node_agg, np.full(n_fine * seg - n, node_agg[-1], node_agg.dtype)]
        ).reshape(n_fine, seg)
        # slot[r, i] = rank of A[r, i] among the distinct aggregates of
        # range r in first-occurrence order; leaders are positions whose
        # aggregate is new within the range.
        first = (A[:, :, None] == A[:, None, :]).argmax(axis=2)  # (nf, seg)
        lead = first == np.arange(seg)[None, :]
        slot_of_pos = np.cumsum(lead, axis=1) - 1
        slot_np = np.take_along_axis(slot_of_pos, first, axis=1).astype(np.int32)
        slot_np = np.concatenate(
            [slot_np, np.full((n_chunks * C - n_fine, seg), -1, np.int32)]
        )
        m = int(lead.sum(axis=1).max())
        # Per-chunk aggregate-id windows: grid-cell ids (x-major key order)
        # and RCM range ids both advance along the structure, so each chunk
        # of C consecutive ranges touches a narrow window [base, base + B).
        rr, pp = np.nonzero(lead)  # leader (range, pos) pairs
        gg = A[rr, pp]
        cc = rr // C
        base = np.full(n_chunks, np.iinfo(np.int64).max, np.int64)
        hi = np.full(n_chunks, -1, np.int64)
        np.minimum.at(base, cc, gg)
        np.maximum.at(hi, cc, gg)
        base = np.where(hi >= 0, base, 0)
        B = int(max(1, (hi - base + 1).max()))
        B = -(-B // 8) * 8
        gidx = (base[:, None] + np.arange(B)[None, :]).reshape(-1)
        # Lane-major table layouts (C minor) — see CoarsePrecond.restrict.
        Gc_np = np.zeros((n_chunks, B, m, C), dtype=x0np.dtype)
        Gc_np[
            cc, gg - base[cc], slot_of_pos[rr, pp], rr - cc * C
        ] = 1.0
        # Float one-hots for the apply (no integer indexing on the CG path —
        # see the CoarsePrecond.seg comment).
        Gmap_np = np.zeros((na_r, n_chunks * B), dtype=x0np.dtype)
        inb = np.nonzero(gidx < na_r)[0]
        Gmap_np[gidx[inb], inb] = 1.0  # OOB window rows stay all-zero
        smask_np = (
            slot_np.reshape(n_chunks, C, 1, seg)
            == np.arange(m).reshape(1, 1, m, 1)
        ).transpose(0, 2, 3, 1).astype(x0np.dtype)  # (nc, m, seg, C)
    else:
        seg = C = 0
        Gc_np = Gmap_np = smask_np = None
        setup = build_aggregates(x0np, target_cluster=target_cluster)
    na = setup.n_agg
    agg = np.asarray(setup.agg)

    dtype = x0np.dtype if isinstance(x0, np.ndarray) else np.asarray(x0).dtype
    dtype = np.dtype(dtype)
    counts = np.zeros(na)
    np.add.at(counts, agg, 1.0)
    cent = np.zeros((na, 3))
    np.add.at(cent, agg, x0np)
    cent /= counts[:, None]
    u0 = (x0np - cent[agg]).astype(dtype)

    if ranges:
        Aggd = None
    else:
        Aggd = np.zeros((na, n), dtype=dtype)
        Aggd[agg, np.arange(n)] = 1.0

    elems = system.elems
    material = system.material
    k = k_modes
    K = k * na
    x0_d = jnp.asarray(x0np.astype(dtype))
    u0_d = jnp.asarray(u0)

    conn_np = np.asarray(elems.conn)
    E = conn_np.shape[0]
    Ac = jnp.zeros((na, na, k, k), dtype=jnp.asarray(x0_d).dtype)

    @jax.jit
    def accumulate(Ac, conn_c, gradN_c, dV_c, mass_c, xe_ref_c):
        # F displacement-based (float32-robust), matching
        # assembly.deformation_gradient: F = I + (x - X) . grad_N.
        Du = jnp.einsum("eai,eqaj->eqij", x0_d[conn_c] - xe_ref_c, gradN_c)
        F = Du + jnp.eye(3, dtype=Du.dtype)
        Kb = _svk_pair_blocks(F, gradN_c, dV_c, material.lam, material.mu, dt)
        Kb = Kb * _viscous_factor(material, dt)
        eye = jnp.eye(3, dtype=Kb.dtype)
        Hb = Kb + (mass_c / dt)[..., None, None] * eye  # (e,S,S,3,3)
        Phi = _phi(u0_d[conn_c], k_modes)  # (e,S,3,k)
        Ac6 = jnp.einsum("eadf,eabdc,ebcg->eabfg", Phi, Hb, Phi)
        ca = setup.agg[conn_c]
        S = conn_c.shape[1]
        rows = jnp.repeat(ca, S, axis=1).reshape(-1)
        cols = jnp.tile(ca, (1, S)).reshape(-1)
        return Ac.at[rows, cols].add(Ac6.reshape(-1, k, k))

    # Scale the chunk so the (chunk, S, S, k, k) assembly temps stay near
    # ~1 GB for every k (12.5 GB at chunk=16384, k=12 once ran out of
    # memory at compile time); assembly is one-time (frozen
    # preconditioner), so more dispatches are fine.
    chunk = max(512, chunk * 9 // (k * k))
    for s0 in range(0, E, chunk):
        s1 = min(s0 + chunk, E)
        Ac = accumulate(
            Ac,
            jnp.asarray(conn_np[s0:s1]),
            elems.grad_N[s0:s1],
            elems.dV[s0:s1],
            elems.mass_elem[s0:s1],
            elems.xe_ref[s0:s1],
        )

    # Constraint penalty dt^2 rho R^T diag(J^T J) R (diagonal approximation
    # for general linear constraints; exact for pins).
    cons = system.constraints
    if cons is not None:
        d = cons.jtj_diag(n, Ac.dtype)
        if d.ndim == 1:
            d = d[:, None] * jnp.ones((1, 3), Ac.dtype)
        Phi_n = _phi(u0_d, k_modes)  # (n,3,k)
        pen = jnp.einsum("ndf,nd,ndg->nfg", Phi_n, (dt * dt * rho) * d, Phi_n)
        pen_a = jnp.zeros((na, k, k), dtype=Ac.dtype).at[setup.agg].add(pen)
        Ac = Ac.at[jnp.arange(na), jnp.arange(na)].add(pen_a)

    Ad = jnp.transpose(Ac, (0, 2, 1, 3)).reshape(K, K)
    diag_scale = jnp.maximum(jnp.max(jnp.abs(jnp.diagonal(Ad))), 1e-30)
    Ad = 0.5 * (Ad + Ad.T) + (1e-5 * diag_scale) * jnp.eye(K, dtype=Ad.dtype)
    Ainv = Li = W = None
    if rank is not None and rank < K:
        # Truncated spectral solve (see CoarsePrecond.W). Host f64 eigh:
        # one-time build cost (~seconds at K=6k), frozen thereafter.
        lam_c, Vc = np.linalg.eigh(np.asarray(Ad, dtype=np.float64))
        Wnp = Vc[:, :rank] / np.sqrt(lam_c[:rank])
        W = jnp.asarray(Wnp.astype(mm_dtype or dtype))
    elif mm_dtype is None:
        chol = jax.scipy.linalg.cho_factor(Ad, lower=True)
        Ainv = jax.scipy.linalg.cho_solve(chol, jnp.eye(K, dtype=Ad.dtype))
    else:
        # Factored form: rounding the explicit inverse entrywise can make
        # it indefinite (CG breakdown — see CoarsePrecond.mm_dtype); the
        # inverse Cholesky factor keeps M_c^-1 = Li^T Li SPSD under any
        # rounding.
        chol = jax.scipy.linalg.cho_factor(Ad, lower=True)
        Li = jax.scipy.linalg.solve_triangular(
            chol[0], jnp.eye(K, dtype=Ad.dtype), lower=True
        ).astype(mm_dtype)

    def _store(a):
        if a is None:
            return None
        a = jnp.asarray(a)
        return a if mm_dtype is None else a.astype(mm_dtype)

    return CoarsePrecond(
        Agg=_store(Aggd),
        u0=u0_d,
        Ainv=Ainv,
        k_modes=k_modes,
        n_agg=na,
        seg=seg,
        Gc=_store(Gc_np),
        Gmap=_store(Gmap_np),
        smask=_store(smask_np),
        chunk=C,
        mm_dtype=mm_dtype,
        Li=Li,
        W=W,
    )


def make_two_level_precond(blocks, chol, setup: CoarseSetup):
    """Additive two-level preconditioner apply: r -> B_j r + R A_c^{-1} R^T r.

    blocks: (n_coef, 3, 3) SPD block-Jacobi blocks; chol: Cholesky factor of
    the dense coarse operator.
    """
    from tlfea.ops.linalg import solve3x3

    agg = setup.agg
    na = setup.n_agg

    def apply(r):
        z = solve3x3(blocks, r, eps=1e-30)
        rc = jnp.zeros((na, 3), dtype=r.dtype).at[agg].add(r)  # R^T r
        zc = jax.scipy.linalg.cho_solve((chol, True), rc.reshape(-1))
        return z + zc.reshape(na, 3)[agg]  # + R zc

    return apply
