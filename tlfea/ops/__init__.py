"""Low-level device ops: gathers/scatters, small batched linear algebra."""

from tlfea.ops.segment import coef_scatter_add, gather_coefs
from tlfea.ops.linalg import solve3x3, det3x3, inv_transpose3x3

__all__ = [
    "coef_scatter_add",
    "gather_coefs",
    "solve3x3",
    "det3x3",
    "inv_transpose3x3",
]
