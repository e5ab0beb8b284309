"""The benchmark of the PyTorch and CUDA port, ``hmcmt2d_tpu_torch``: a
harness driven by the files beside it (``BENCHMARK.json`` at the root of the
checkout names the cells), a plain reference that decides ``correct``, and
one reader a per-layer metric.  It imports neither JAX nor the JAX package."""
