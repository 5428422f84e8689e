"""Implicit backward-Euler ALM solvers: Newton-PCG, Nesterov, AdamW, VBD.

All solvers share the `step(system, state, params, f_ext) -> (state, diag)`
interface and are interchangeable, mirroring the reference's `SolverBase`
(`lib_src/solvers/SolverBase.h:16-23`).
"""

from tlfea.solvers.common import System, StepState, grad_L, suggest_rho  # noqa: F401
from tlfea.solvers import newton, adamw, nesterov, vbd, coarse  # noqa: F401

# The reference ships AdamW twice (cooperative + "Nocoop" host-loop variants,
# `SyncedAdamWNocoop.cuh:21`); here the split has no meaning — both are the
# same jitted while_loop. Alias kept for API discoverability.
adamw_nocoop = adamw
