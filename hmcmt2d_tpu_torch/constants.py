"""Physical constants shared across the framework.

Values match the reference implementation so that forward responses are
bit-comparable (reference: HMCMT/src/MTFwdSolver/mt1DField.jl:34-35,
MT2DFwdSolver.jl:76).
"""

MU0 = 4.0e-7 * 3.141592653589793  # vacuum permeability [H/m]
EPS0 = 8.85e-12                   # vacuum permittivity [F/m] (reference uses 8.85e-12)
SIGMA_AIR = 1.0e-8                # air conductivity [S/m] (readEMModel2D.jl:141)
