"""PyTorch/CUDA port of ``hmcmt2d_tpu``: 2-D magnetotelluric Bayesian
inversion with Hamiltonian Monte Carlo, for an NVIDIA H100.

The JAX package ``hmcmt2d_tpu`` is the reference; each module here has the
same name as its counterpart there.  This package imports neither JAX nor
anything of ``hmcmt2d_tpu``.  Entry points run on the GPU unless the caller
passes ``device="cpu"``; the CUDA kernels build at first use, never at
import.
"""

from .mesh import TensorMesh2D, make_mesh  # noqa: F401
