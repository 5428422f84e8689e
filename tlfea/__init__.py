"""tlfea — Total-Lagrangian FEA on JAX/XLA.

A rebuild of the capabilities of uwsbel/Total-Lagrangian-FEA
("RoboDyna" / "TL-FEA", CUDA C++) as jitted JAX programs:

- Element families: FEAT10 (10-node quadratic tetrahedron), ANCF3243 (beam),
  ANCF3443 (shell), all expressed through one unified device-side element
  pytree so a single set of jitted kernels serves every family.
- Materials: St. Venant-Kirchhoff, compressible Mooney-Rivlin, plus
  Kelvin-Voigt viscous damping.
- Implicit backward-Euler time stepping as Augmented-Lagrangian optimization
  over velocities, with four interchangeable inner solvers: Newton-PCG
  (matrix-free, JVP Hessian-vector products in place of the reference's
  cuDSS direct solve), Nesterov, AdamW, and colored Vertex-Block-Descent.
- Hydroelastic contact-patch collision pipeline (broadphase sweep-and-prune +
  Drake-style pressure-field narrowphase), fully on-device with static shapes.
- SPMD scaling over `jax.sharding.Mesh` (element-axis sharding).

Precision: the reference is float64 throughout. On the CPU backend x64 is
enabled so validation runs match it; on an accelerator the default stays
float32. All kernels are dtype-polymorphic. Set TLFEA_NO_X64=1 before import
to skip the backend probe and keep JAX's default float32.
"""

import os as _os

if not _os.environ.get("TLFEA_NO_X64"):
    import jax as _jax

    # x64 is the validation mode; accelerator runs are float32 unless a
    # caller enables x64 itself (e.g. `with jax.enable_x64(True):`).
    if _jax.default_backend() == "cpu":
        _jax.config.update("jax_enable_x64", True)

# Full-float32 dots. On a GPU, XLA's default precision may run f32 dots in
# TF32 (10-bit mantissa), which puts ~1e-3 relative errors into the
# deformation-gradient and stress contractions — too coarse for FEA. No
# effect on CPU or float64.
if not _os.environ.get("TLFEA_KEEP_DEFAULT_MATMUL"):
    import jax as _jax

    _jax.config.update("jax_default_matmul_precision", "float32")

__version__ = "0.1.0"

from tlfea import utils, materials, elements, solvers, collision, parallel, ops  # noqa: E402,F401
