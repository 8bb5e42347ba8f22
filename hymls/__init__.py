"""hymls — a hybrid multilevel solver framework in JAX.

A from-scratch JAX/XLA implementation of the HYMLS algorithm family
(hybrid direct/iterative multilevel solver for F-matrices arising from
incompressible Navier-Stokes / Stokes / Darcy / Laplace problems on
structured staggered grids; reference: nlesc-smcm/hymls, C++/Trilinos/MPI).

Architecture (a device design, not a port):
  * All *symbolic* setup (Cartesian partitioning, separator-group
    classification, orthogonal-transform structure, static gather /
    scatter index plans) runs once on the host in numpy.
  * All *numeric* work (block extraction, batched dense LU/inverse,
    Schur-complement assembly, the multilevel preconditioner apply and
    the Krylov iteration) is pure JAX: one jitted `compute` per matrix
    structure and one jitted `apply_inverse`, built from batched dense
    ops (batched matmuls), plus static gathers/segment-sums.
  * Multi-chip: the subdomain batch axis is shardable over a
    `jax.sharding.Mesh`; see hymls.parallel.
"""
from .utils import malloc as _malloc

_malloc.maybe_enable_from_env()

import jax as _jax

# The reference solver is entirely double precision and hits 1e-10
# relative tolerances (see reference testSuite/integration_tests);
# allow f64 throughout.  Arrays are still dtype-parametric so f32 can
# be selected for speed.
_jax.config.update("jax_enable_x64", True)

# TRUE-dtype products everywhere: on the GPU a default-precision f32
# matmul/einsum may run in TF32 (2^-11 rounding, ~1e-3 relative error).
# For a linear solver that is a correctness bug, not a speed knob — a
# reduced-precision pass degrades Gram-Schmidt bases, Schur assembly
# and one-hot value picks (stokes128 L=2 inner iterations 150 -> 558
# through one bf16-pass pick).  'highest' keeps f32 products in full
# f32; f64/complex paths are unaffected.  Hot sites additionally pin
# precision=HIGHEST explicitly so they stay correct even if an
# embedding application resets this global (or sets
# HYMLS_DEFAULT_MATMUL_PRECISION, kept as an A/B knob for perf triage).
import os as _os

_jax.config.update(
    "jax_default_matmul_precision",
    _os.environ.get("HYMLS_DEFAULT_MATMUL_PRECISION", "highest") or None)

from .config import Params, load_xml  # noqa: E402
from .solvers.solver import Solver  # noqa: E402
from .core.preconditioner import Preconditioner  # noqa: E402

__all__ = ["Params", "load_xml", "Solver", "Preconditioner"]
__version__ = "0.1.0"
