"""Constraint handling for the Augmented-Lagrangian time stepper.

Two constraint families, matching the reference:

- `FixedCoefs`: pin selected coefficients (nodes for FEAT10, ANCF coefficient
  vectors for beams/shells) to target positions. c = x[idx] - target; the
  Jacobian is an identity selection, so J / J^T never materialize
  (reference: `SetNodalFixed` `FEAT10Data.cu:728-749`, constraint eval
  `FEAT10DataFunc.cuh:468-483`).

- `LinearConstraints`: general sparse linear rows over the flattened DOF
  space, c_r = sum_k J[r, k] x_flat[k] - b_r, stored as static COO arrays and
  applied with gathers / segment sums (reference: `LinearConstraintCSR`
  `lib_utils/mesh_utils.h:105-160`, `SetLinearConstraintsCSR`
  `ANCF3243Data.cuh:810-852`).

Both expose the same interface: `eval_c(x)`, `apply_jt(y)`, `n_constraints`,
so solvers are agnostic to the constraint family.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from tlfea import struct

__all__ = ["FixedCoefs", "DensePins", "LinearConstraints", "no_constraints"]


@struct.dataclass
class FixedCoefs:
    """Pin coefficients `idx` to `target` positions (3 constraints each)."""

    idx: jnp.ndarray  # (C,) int32
    target: jnp.ndarray  # (C, 3)

    @staticmethod
    def from_indices(idx, x0) -> "FixedCoefs":
        """Pin coefficients at their current positions in x0."""
        idx = jnp.asarray(np.asarray(idx, dtype=np.int32))
        return FixedCoefs(idx=idx, target=jnp.asarray(x0)[idx])

    @property
    def n_constraints(self) -> int:
        return 3 * self.idx.shape[0]

    def eval_c(self, x: jnp.ndarray) -> jnp.ndarray:
        """Constraint values, shape (C, 3)."""
        return x[self.idx] - self.target

    def eval_c_u(self, u: jnp.ndarray, x_ref: jnp.ndarray) -> jnp.ndarray:
        """c from displacements u = x - x_ref, grouped for f32 precision:
        c = u[idx] - (target - x_ref[idx]) — the parenthesized term is
        displacement-scale, so tiny dt*v increments inside u are never
        rounded against coordinate-scale values."""
        return u[self.idx] - (self.target - x_ref[self.idx])

    def apply_jt(self, y: jnp.ndarray, n_coef: int) -> jnp.ndarray:
        """J^T @ y for y of shape (C, 3) -> (n_coef, 3)."""
        out = jnp.zeros((n_coef, 3), dtype=y.dtype)
        return out.at[self.idx].add(y)

    def jtj_diag(self, n_coef: int, dtype) -> jnp.ndarray:
        """diag(J^T J) over coefficients -> (n_coef,) of {0, 1}."""
        out = jnp.zeros((n_coef,), dtype=dtype)
        return out.at[self.idx].add(jnp.ones_like(self.idx, dtype=dtype))

    def with_targets(self, target: jnp.ndarray) -> "FixedCoefs":
        """Functional analogue of `UpdateConstraintTargets`
        (`FEAT10Data.cuh:687-701`): prescribe new target positions."""
        return FixedCoefs(idx=self.idx, target=jnp.asarray(target))


@struct.dataclass
class DensePins:
    """Pin constraints as DENSE per-coefficient fields: mask (n, 1) in
    {0, 1} selects pinned coefficients, target (n, 3) their prescribed
    positions (ignored where mask = 0).

    The static-shape answer to the reference's runtime pin management
    (`SetNodalFixed` / `UpdateNodalFixed`, `FEAT10Data.cu:728-832`):
    because BOTH membership and targets are data (fixed shapes, no index
    arrays), changing WHICH coefficients are pinned (`with_mask` /
    `pinning`) or WHERE they are pinned (`with_targets`) never retraces.
    All constraint algebra is elementwise (J = diag(mask)): no gather or
    scatter anywhere.

    Duals are dense too: StepState.lam has shape (n, 3), zero (and staying
    zero — c is masked) at unpinned coefficients. Memory cost is one extra
    node-vector, negligible beside the element tables.
    """

    mask: jnp.ndarray  # (n, 1) working-dtype {0., 1.}
    target: jnp.ndarray  # (n, 3)

    @staticmethod
    def from_indices(idx, x0) -> "DensePins":
        """Pin coefficients `idx` at their current positions in x0."""
        x0 = jnp.asarray(x0)
        idx = np.asarray(idx, dtype=np.int32)
        mask = jnp.zeros((x0.shape[0], 1), x0.dtype).at[idx].set(1.0)
        return DensePins(mask=mask, target=x0)

    @property
    def n_constraints(self) -> int:
        return 3 * self.mask.shape[0]

    def eval_c(self, x: jnp.ndarray) -> jnp.ndarray:
        """Masked constraint values, shape (n, 3)."""
        return self.mask * (x - self.target)

    def eval_c_u(self, u: jnp.ndarray, x_ref: jnp.ndarray) -> jnp.ndarray:
        """c from displacements, grouped for f32 precision (see
        FixedCoefs.eval_c_u)."""
        return self.mask.astype(u.dtype) * (
            u - (self.target - x_ref).astype(u.dtype)
        )

    def apply_jt(self, y: jnp.ndarray, n_coef: int) -> jnp.ndarray:
        """J^T y = mask * y (J is a diagonal selection)."""
        return self.mask.astype(y.dtype) * y

    def jtj_diag(self, n_coef: int, dtype) -> jnp.ndarray:
        """diag(J^T J) over coefficients -> (n_coef,) of {0, 1}."""
        return self.mask[:, 0].astype(dtype)

    def with_targets(self, target: jnp.ndarray) -> "DensePins":
        """Prescribe new targets (`UpdateConstraintTargets` analogue). The
        caller may pass a full (n, 3) field; entries at unpinned
        coefficients are inert."""
        return DensePins(mask=self.mask, target=jnp.asarray(target))

    def with_mask(self, mask: jnp.ndarray) -> "DensePins":
        """Replace the membership mask (`UpdateNodalFixed` analogue,
        `FEAT10Data.cu:751-832`) — same shapes, so no retrace."""
        return DensePins(mask=jnp.asarray(mask), target=self.target)

    def pinning(self, idx, pinned: bool, x0=None) -> "DensePins":
        """Pin or release coefficients `idx`; when pinning with `x0` given,
        targets are refreshed to the current positions (the reference's
        UpdateNodalFixed semantics: newly fixed nodes hold where they are)."""
        idx = np.asarray(idx, dtype=np.int32)
        mask = self.mask.at[idx].set(1.0 if pinned else 0.0)
        target = self.target
        if pinned and x0 is not None:
            target = target.at[idx].set(jnp.asarray(x0)[idx])
        return DensePins(mask=mask, target=target)


@struct.dataclass
class LinearConstraints:
    """General sparse linear constraints over flattened DOFs (COO, static nnz).

    rows/cols/vals: (nnz,) with rows in [0, n_rows); cols index x.ravel().
    c = J x_flat - b.
    """

    rows: jnp.ndarray  # (nnz,) int32
    cols: jnp.ndarray  # (nnz,) int32
    vals: jnp.ndarray  # (nnz,)
    b: jnp.ndarray  # (n_rows,)
    n_rows: int = struct.field(pytree_node=False)

    @property
    def n_constraints(self) -> int:
        return self.n_rows

    def eval_c(self, x: jnp.ndarray) -> jnp.ndarray:
        """Constraint values, shape (n_rows,)."""
        xf = x.reshape(-1)
        contrib = self.vals * xf[self.cols]
        return jnp.zeros((self.n_rows,), dtype=x.dtype).at[self.rows].add(contrib) - self.b

    def eval_c_u(self, u: jnp.ndarray, x_ref: jnp.ndarray) -> jnp.ndarray:
        """c from displacements: J u + (J x_ref - b). The constant part is
        evaluated at coordinate scale once; the J u part carries the tiny
        solver increments at full f32 resolution."""
        return self._apply_j(u) + (self._apply_j(x_ref) - self.b)

    def _apply_j(self, x: jnp.ndarray) -> jnp.ndarray:
        xf = x.reshape(-1)
        contrib = self.vals * xf[self.cols]
        return jnp.zeros((self.n_rows,), dtype=x.dtype).at[self.rows].add(contrib)

    def apply_jt(self, y: jnp.ndarray, n_coef: int) -> jnp.ndarray:
        """J^T @ y for y of shape (n_rows,) -> (n_coef, 3)."""
        out = jnp.zeros((n_coef * 3,), dtype=y.dtype)
        out = out.at[self.cols].add(self.vals * y[self.rows])
        return out.reshape(n_coef, 3)

    def jtj_diag(self, n_coef: int, dtype) -> jnp.ndarray:
        """Per-DOF diag(J^T J) -> (n_coef, 3). Note: unlike FixedCoefs this is
        per-DOF, callers broadcast appropriately."""
        out = jnp.zeros((n_coef * 3,), dtype=dtype)
        out = out.at[self.cols].add((self.vals * self.vals).astype(dtype))
        return out.reshape(n_coef, 3)


class LinearConstraintBuilder:
    """Host-side accumulation of linear constraint rows (NumPy).

    Mirrors the reference's `LinearConstraintBuilder` (`mesh_utils.h:
    120-160`) plus the vector-equality / welded-joint appenders
    (`mesh_utils.h:217-245`).
    """

    def __init__(self):
        self._rows: list[int] = []
        self._cols: list[int] = []
        self._vals: list[float] = []
        self._b: list[float] = []
        self._n_rows = 0

    def add_row(self, cols, vals, rhs: float = 0.0) -> int:
        r = self._n_rows
        for c, v in zip(cols, vals):
            self._rows.append(r)
            self._cols.append(int(c))
            self._vals.append(float(v))
        self._b.append(float(rhs))
        self._n_rows += 1
        return r

    def fix_dof(self, coef: int, dof: int, value: float) -> int:
        """x[coef, dof] = value."""
        return self.add_row([coef * 3 + dof], [1.0], value)

    def equate_dofs(self, coef_a: int, coef_b: int) -> None:
        """Weld all 3 components of two coefficients together."""
        for d in range(3):
            self.add_row([coef_a * 3 + d, coef_b * 3 + d], [1.0, -1.0], 0.0)

    def build(self, dtype=np.float64) -> LinearConstraints:
        return LinearConstraints(
            rows=jnp.asarray(np.asarray(self._rows, dtype=np.int32)),
            cols=jnp.asarray(np.asarray(self._cols, dtype=np.int32)),
            vals=jnp.asarray(np.asarray(self._vals, dtype=dtype)),
            b=jnp.asarray(np.asarray(self._b, dtype=dtype)),
            n_rows=self._n_rows,
        )


def no_constraints() -> None:
    """Sentinel for unconstrained systems (use Python None)."""
    return None
