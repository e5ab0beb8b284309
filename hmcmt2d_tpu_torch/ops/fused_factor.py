"""The fused block-Thomas engine: three hand-written CUDA kernels.

Counterpart of ``hmcmt2d_tpu/ops/pallas_factor.py``, whose three Pallas TPU
kernels carry the production solve.  Each becomes a CUDA C++ kernel for
Hopper (sources in ``hmcmt2d_tpu_torch/csrc``, built by
:mod:`.kernel_build`), with beside it:

* a plain PyTorch version that computes the same function with the same
  algorithm, in the input's dtype (the CPU path, and the yardstick the
  kernel is held against on the card);
* a wrapper that takes the plain version for a CPU tensor and launches the
  kernel for a CUDA tensor, or raises: it never falls back;
* a launch counter, ``<wrapper>.launches``, raised by one at each launch
  (and, for a CUDA graph that recorded the launches, by
  :func:`add_launches` at each replay).

=================  ==============================================  ==========
kernel (csrc)      replaces (hmcmt2d_tpu/ops/pallas_factor.py)      bound
=================  ==============================================  ==========
schur_factor       ``_factor_kernel`` :137-194, polish :113-134     operations
bt_sweep_fwd       ``_sweep_fwd_kernel`` :357-380                   bytes
bt_sweep_bwd       ``_sweep_bwd_kernel`` :383-408                   bytes
gj_inverse         ``inv_nopivot`` (XLA ops), ops/blockinv.py:41    operations
=================  ==============================================  ==========

``gj_inverse`` is not on the fused path: it is the batched inverse of the
thomas, thomas_blocked and bcr engines under ``inv_method="gj"``
(``ops/solver.py``), on the CPU as on the GPU.

Each system is factorised in its ordering of least work
(:func:`line_axis`): its lines along the longer axis, min(ny_i, nz_i)
unknowns wide.  Where that is along y, the same kernels run on the
transposed system (:class:`FusedFactor` records the axis).

The TPU layout (split real/imaginary planes, q padded to 128, q-tight
rows) existed because Pallas on a TPU has no complex type and tiles by
(8, 128).  The kernels here take complex64 tensors as interleaved float2
(``gj_inverse`` also complex128, as double2): G is (B, nzi, q, q)
complex64, C-contiguous, one system (or matrix) per thread block.
The source notes in ``csrc/*.cu`` (``schur_factor.cu``, ``bt_sweep.cu``,
``gj_inverse.cu``) say what bounds each kernel on the
card and what its design does about it.  Each kernel is compiled for a few
padded widths; its launch plan (:func:`schur_factor_plan`,
:func:`bt_sweep_fwd_plan`, :func:`bt_sweep_bwd_plan`,
:func:`gj_inverse_plan`) picks the variant, threads, shared memory and
ring depth for a given q, and the C entry points refuse a plan they were
not compiled for.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import kernel_build

Q_MAX = 128   # widest line the kernels are compiled for
SMEM_PER_BLOCK = 232_448   # dynamic shared memory a block may ask for (H100)
# shared memory of an H100 SM (228 KB), of which 1 KB is reserved for each
# resident block (CUDA C++ Programming Guide, compute capability 9.0)
SMEM_PER_SM = 233_472


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device or device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}, expected one CUDA device")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous() or t.is_conj() or t.is_neg():
        raise ValueError(f"{name} must be contiguous, with no lazy conj/neg bit")


def _storage(t: torch.Tensor) -> torch.Tensor:
    """The tensor beneath ``torch.func.jvp``'s wrappers, which have no
    storage for a kernel to read.  A ``vmap`` batch is refused: no kernel
    here has a batching rule."""
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        if torch._C._functorch.is_batchedtensor(t):
            raise ValueError("the CUDA kernels have no vmap rule")
        t = torch._C._functorch.get_unwrapped(t)
    return t


def beneath_transforms(launch):
    """Run a kernel launch beneath ``torch.func``'s transforms: under
    ``torch.func.jvp`` (``models/jacobian.py`` ``jv``) the traced function
    hands wrapped tensors to the factor and an autograd.Function's ``jvp``
    gets its saved tensors and tangents wrapped, and every tensor made
    there is wrapped too.  The launch reads the values beneath its tensor
    arguments and makes its outputs outside the transform; functorch treats
    them as constants, or wraps what a ``jvp`` returns."""
    @functools.wraps(launch)
    def run(*args):
        with torch._C._DisableFuncTorch():
            return launch(*(_storage(a) if isinstance(a, torch.Tensor) else a for a in args))
    return run


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _on_cpu(t: torch.Tensor) -> bool:
    """CPU tensors take the plain version; every other tensor the kernel,
    which raises unless the tensor lies on a GPU and the kernels build."""
    return t.device.type == "cpu"


# ---------------------------------------------------------------------------
# launch plans
# ---------------------------------------------------------------------------

class LaunchPlan(NamedTuple):
    """How a kernel is launched for lines of width q.  The thread block is
    ``threads = (lanes, warps)``; a ``tile`` of (rows, columns) of a line
    padded to ``qp`` falls to each thread (the factor) or to each warp and
    lane (the sweep); ``ring`` is the sweep's number of G slots (0 for the
    factor); ``panel`` is the pivots a step of ``gj_inverse`` eliminates
    (0 for the other kernels)."""

    q: int
    qp: int
    threads: tuple[int, int]
    tile: tuple[int, int]
    smem_bytes: int
    ring: int
    blocks_per_sm: int
    panel: int = 0

    @property
    def n_threads(self) -> int:
        return self.threads[0] * self.threads[1]


LANES, WARPS = 32, 16
COMPLEX_BYTES = 8
SWEEP_VEC_LINES = 3   # lines of the rhs and c in a sweep's ring (csrc/bt_sweep.cu E)


def _padded(q: int) -> int:
    if not 1 <= q <= Q_MAX:
        raise ValueError(f"the kernels support 1 <= q <= {Q_MAX}, got {q}")
    return -(-q // 32) * 32


def schur_factor_plan(q: int, polish: int = 0) -> LaunchPlan:
    """Plan of ``csrc/schur_factor.cu``: S in registers, row r on warp
    r % 16 and column c on lane c % 32, so a thread holds a (qp/16, qp/32)
    complex tile.  Shared memory holds the double-buffered pivot row and
    column (4 qp complex) and the staged line: diag (qp complex), offy and
    offz (qp floats each).  With ``polish`` > 0 also the qp x qp complex
    buffers the Newton-Schulz products read: S_j and G_j up to qp = 96,
    S_j alone at qp = 128, where two do not fit (G_j is read from device
    memory there).  Two blocks per SM up to qp = 96 (at most 64 registers
    a thread), one at qp = 128 (a 64-register tile); the polish variant
    takes one at qp = 96 too (its two buffers fill an SM, and a thread gets
    128 registers).  The C entry point refuses another plan."""
    qp = _padded(q)
    smem = 5 * qp * COMPLEX_BYTES + 2 * qp * 4
    if polish > 0:
        smem += (2 if qp <= 96 else 1) * qp * qp * COMPLEX_BYTES
    blocks = 2 if qp <= (64 if polish > 0 else 96) else 1
    return LaunchPlan(q, qp, (LANES, WARPS), (qp // WARPS, qp // LANES),
                      smem, 0, blocks)


def bt_sweep_bwd_plan(q: int) -> LaunchPlan:
    """Plan of the backward sweep (``csrc/bt_sweep.cu``): 16 warps
    multiply, warp w rows qp/16 w .. qp/16 (w + 1) - 1 of each line and
    lane l columns l + 32 c; a 17th warp fetches.  G streams through a ring
    of ``ring`` chunk slots in shared memory, one TMA bulk copy a chunk: a
    line up to qp = 96, half a line at 128 (three lines would not fit).  A
    slot holds its rows x qp + 2 complex (a chunk starting 8 bytes off a
    16-byte boundary sits one element in) and has an mbarrier.  Beside
    them: the double-buffered carry and SWEEP_VEC_LINES lines of y and c.
    Three slots.  The C entry point computes the same bytes and refuses
    another plan."""
    qp = _padded(q)
    rows = qp // WARPS                                 # rows per warp and line
    chunk = qp if qp <= 96 else qp // 2                # rows per chunk
    ring = 3
    smem = (ring * ((chunk * qp + 2) * COMPLEX_BYTES + 8)
            + 2 * qp * COMPLEX_BYTES                   # carry
            + SWEEP_VEC_LINES * qp * (COMPLEX_BYTES + 4))   # y, c
    return LaunchPlan(q, qp, (LANES, WARPS + 1), (rows, qp // LANES), smem,
                      ring, 1)


def bt_sweep_fwd_plan(q: int) -> LaunchPlan:
    """Plan of the forward sweep (``csrc/bt_sweep.cu``): the layout of
    :func:`bt_sweep_bwd_plan`, with b in place of y.  Half-line chunks at
    qp = 96, which would fit two blocks an SM, were measured and lost
    (csrc/bt_sweep.cu).  The C entry point computes the same bytes and
    refuses another plan."""
    return bt_sweep_bwd_plan(q)


# ---------------------------------------------------------------------------
# schur_factor
# ---------------------------------------------------------------------------

def gj_inverse_nopivot(A: torch.Tensor) -> torch.Tensor:
    """In-place-order unpivoted Gauss-Jordan inverse of (..., q, q): the
    elimination of ``csrc/schur_factor.cu``, step for step.  Stable on the
    equilibrated MT operator, whose real part is positive definite."""
    A = A.clone()
    for k in range(A.shape[-1]):
        p = 1.0 / A[..., k, k]
        col = A[..., :, k].clone()
        row = A[..., k, :] * p[..., None]
        A = A - col[..., :, None] * row[..., None, :]
        A[..., k, :] = row
        A[..., :, k] = -col * p[..., None]
        A[..., k, k] = p
    return A


def _dense_line(d: torch.Tensor, oy: torch.Tensor) -> torch.Tensor:
    """Tridiagonal T (B, q, q) from its diagonal (B, q) and y-coupling
    (B, q-1); the off-diagonal entries are -oy."""
    T = torch.diag_embed(d)
    ocx = (-oy).to(d.dtype)
    return T + torch.diag_embed(ocx, 1) + torch.diag_embed(ocx, -1)


def ns_polish(S: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """One Newton-Schulz step G + G (I - S G) on (..., q, q): contracts the
    inversion residual I - S G quadratically (``_ns_polish``,
    hmcmt2d_tpu/ops/pallas_factor.py:120-134)."""
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    return G + G @ (eye - S @ G)


def schur_factor_plain(diag: torch.Tensor, offy: torch.Tensor,
                       offz: torch.Tensor, polish: int = 0) -> torch.Tensor:
    """Plain version of ``schur_factor``: G (B, nzi, q, q) from diag (B, nzi,
    q) complex, offy (B, nzi, q-1) and offz (B, nzi-1, q) real; ``polish``
    Newton-Schulz steps on each line's inverse before it feeds the next
    line's downdate."""
    Gs = []
    for j in range(diag.shape[1]):
        S = _dense_line(diag[:, j], offy[:, j])
        if j > 0:
            c = offz[:, j - 1]
            S = S - (c[:, :, None] * c[:, None, :]) * Gs[-1]
        G = gj_inverse_nopivot(S)
        for _ in range(polish):
            G = ns_polish(S, G)
        Gs.append(G)
    return torch.stack(Gs, dim=1)


def schur_factor(diag: torch.Tensor, offy: torch.Tensor,
                 offz: torch.Tensor, polish: int = 0) -> torch.Tensor:
    """Schur-chain factor: CUDA kernel for CUDA tensors (complex64 diag,
    float32 couplings, contiguous), plain version for CPU tensors; with
    ``polish`` Newton-Schulz steps a line (the kernel's polish variant,
    counted in ``schur_factor.polish_launches``)."""
    if polish < 0:
        raise ValueError(f"polish must be >= 0, got {polish}")
    if _on_cpu(diag):
        return schur_factor_plain(diag, offy, offz, polish)
    return _launch_factor(diag, offy, offz, polish)


@beneath_transforms
def _launch_factor(diag, offy, offz, polish: int) -> torch.Tensor:
    B, nzi, q = diag.shape
    plan = schur_factor_plan(q, polish)
    lib = kernel_build.library()
    dev = diag.device
    _check(diag, "diag", torch.complex64, (B, nzi, q), dev)
    _check(offy, "offy", torch.float32, (B, nzi, q - 1), dev)
    _check(offz, "offz", torch.float32, (B, nzi - 1, q), dev)
    G = torch.empty((B, nzi, q, q), dtype=torch.complex64, device=dev)
    err = lib.hmc_schur_factor(diag.data_ptr(), offy.data_ptr(),
                               offz.data_ptr(), G.data_ptr(), B, nzi, q,
                               plan.qp, plan.n_threads, plan.smem_bytes,
                               polish, _stream())
    _raise_on(err, "schur_factor")
    if polish:
        schur_factor.polish_launches += 1
    else:
        schur_factor.launches += 1
    return G


schur_factor.launches = 0
schur_factor.polish_launches = 0


# ---------------------------------------------------------------------------
# bt_sweep_fwd / bt_sweep_bwd
# ---------------------------------------------------------------------------

def _mv(Gj: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (Gj @ v[..., None])[..., 0]


def bt_sweep_fwd_plain(G: torch.Tensor, offz: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """y_0 = G_0 b_0, y_j = G_j (b_j + c_{j-1} * y_{j-1}); (B, nzi, q)."""
    c = offz.to(G.dtype)
    ys = [_mv(G[:, 0], b[:, 0])]
    for j in range(1, G.shape[1]):
        ys.append(_mv(G[:, j], b[:, j] + c[:, j - 1] * ys[-1]))
    return torch.stack(ys, dim=1)


def bt_sweep_bwd_plain(G: torch.Tensor, offz: torch.Tensor,
                       y: torch.Tensor) -> torch.Tensor:
    """x_{n-1} = y_{n-1}, x_j = y_j + G_j (c_j * x_{j+1}); (B, nzi, q)."""
    c = offz.to(G.dtype)
    nzi = G.shape[1]
    xs = [y[:, nzi - 1]]
    for j in range(nzi - 2, -1, -1):
        xs.append(y[:, j] + _mv(G[:, j], c[:, j] * xs[-1]))
    return torch.stack(xs[::-1], dim=1)


@beneath_transforms
def _sweep(name: str, plan: LaunchPlan, G: torch.Tensor, offz: torch.Tensor,
           v: torch.Tensor) -> torch.Tensor:
    if G.data_ptr() % 16:
        raise ValueError(f"{name} needs G 16-byte aligned (TMA bulk copies)")
    lib = kernel_build.library()
    B, nzi, q, _ = G.shape
    dev = G.device
    _check(G, "G", torch.complex64, (B, nzi, q, q), dev)
    _check(offz, "offz", torch.float32, (B, nzi - 1, q), dev)
    _check(v, "rhs", torch.complex64, (B, nzi, q), dev)
    out = torch.empty((B, nzi, q), dtype=torch.complex64, device=dev)
    err = getattr(lib, "hmc_" + name)(G.data_ptr(), offz.data_ptr(),
                                      v.data_ptr(), out.data_ptr(), B, nzi,
                                      q, plan.qp, plan.ring, plan.n_threads,
                                      plan.smem_bytes, _stream())
    _raise_on(err, name)
    return out


def bt_sweep_fwd(G: torch.Tensor, offz: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Forward sweep: CUDA kernel for CUDA tensors, plain version on CPU."""
    if _on_cpu(G):
        return bt_sweep_fwd_plain(G, offz, b)
    out = _sweep("bt_sweep_fwd", bt_sweep_fwd_plan(G.shape[-1]), G, offz, b)
    bt_sweep_fwd.launches += 1
    return out


def bt_sweep_bwd(G: torch.Tensor, offz: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """Backward sweep: CUDA kernel for CUDA tensors, plain version on CPU."""
    if _on_cpu(G):
        return bt_sweep_bwd_plain(G, offz, y)
    out = _sweep("bt_sweep_bwd", bt_sweep_bwd_plan(G.shape[-1]), G, offz, y)
    bt_sweep_bwd.launches += 1
    return out


bt_sweep_fwd.launches = 0
bt_sweep_bwd.launches = 0


# ---------------------------------------------------------------------------
# gj_inverse
# ---------------------------------------------------------------------------

GJ_DTYPES = (torch.complex64, torch.complex128)
GJ_PANEL = 16   # pivots a step of gj_inverse (csrc/gj_inverse.cu NB), as JAX's block


def gj_inverse_plan(n: int, dtype: torch.dtype = torch.complex64) -> LaunchPlan:
    """Plan of ``csrc/gj_inverse.cu``: schur_factor's thread tile (row r on
    warp r % 16, column c on lane c % 32, an (qp/16, qp/32) tile a thread)
    for n x n matrices in ``dtype``, complex64 or complex128, eliminated
    ``GJ_PANEL`` pivots a step.  Shared memory holds the panel's rows
    (panel x qp complex), its columns (2 x qp x panel, double-buffered),
    the pivot block's inverse (panel x panel) and R (2 x panel x qp,
    double-buffered).  Two blocks an SM up to qp = 96 in complex64 and
    qp = 64 in complex128 (at most 64 registers a thread), else one.  The C
    entry point computes the same bytes and refuses another plan."""
    if dtype not in GJ_DTYPES:
        raise ValueError(f"gj_inverse takes complex64 or complex128, got {dtype}")
    qp = _padded(n)
    nb = GJ_PANEL
    two = qp <= (96 if dtype == torch.complex64 else 64)
    return LaunchPlan(n, qp, (LANES, WARPS), (qp // WARPS, qp // LANES),
                      nb * (5 * qp + nb) * dtype.itemsize, 0, 2 if two else 1,
                      nb)


def gj_inverse_blocked(A: torch.Tensor, panel: int = GJ_PANEL) -> torch.Tensor:
    """Panel-blocked unpivoted Gauss-Jordan inverse of (..., n, n), in
    place: the order of ``csrc/gj_inverse.cu`` and of the JAX package's
    ``inv_nopivot`` (``hmcmt2d_tpu/ops/blockinv.py``, its block of 16).
    For each panel K of ``panel`` pivots (the last one cut at n):
    R = inv(A[K, K]) A[K, :] with R[:, K] = inv(A[K, K]) (the pivot block
    inverted by :func:`gj_inverse_nopivot`); then A[:, K] = 0,
    A -= A_old[:, K] R, and A[K, :] = R."""
    n = A.shape[-1]
    X = A.clone()
    for k0 in range(0, n, panel):
        K = slice(k0, min(k0 + panel, n))
        Pinv = gj_inverse_nopivot(X[..., K, K])
        R = Pinv @ X[..., K, :]
        R[..., :, K] = Pinv
        col = X[..., :, K].clone()
        X[..., :, K] = 0
        X = X - col @ R
        X[..., K, :] = R
    return X


def gj_inverse(A: torch.Tensor) -> torch.Tensor:
    """Batched unpivoted Gauss-Jordan inverse of A (..., n, n), complex64
    or complex128, 1 <= n <= Q_MAX: one launch of the CUDA kernel for a
    CUDA tensor, the batch axes collapsed to one (as the JAX package's
    ``inv_c``); :func:`gj_inverse_blocked` at the kernel's panel for a CPU
    tensor.

    No pivoting: stable only where every leading block keeps a nonzero
    pivot, as on the equilibrated MT operator (real part positive
    definite), which ``ops/solver.py::factorize`` always builds before it
    inverts a block.  A general matrix may need a pivot this never takes."""
    if _on_cpu(A):
        return gj_inverse_blocked(A)
    return _launch_gj(A)


@beneath_transforms
def _launch_gj(A: torch.Tensor) -> torch.Tensor:
    if A.ndim < 2 or A.shape[-2] != A.shape[-1]:
        raise ValueError(f"gj_inverse takes square matrices, got {tuple(A.shape)}")
    n = A.shape[-1]
    plan = gj_inverse_plan(n, A.dtype)
    lib = kernel_build.library()
    flat = A.reshape((-1, n, n)).resolve_conj().resolve_neg().contiguous()
    _check(flat, "A", A.dtype, flat.shape, A.device)
    X = torch.empty_like(flat)
    err = lib.hmc_gj_inverse(flat.data_ptr(), X.data_ptr(), flat.shape[0], n,
                             plan.qp, plan.n_threads, plan.smem_bytes,
                             plan.panel, int(A.dtype == torch.complex128),
                             _stream())
    _raise_on(err, "gj_inverse")
    gj_inverse.launches += 1
    return X.reshape(A.shape)


gj_inverse.launches = 0

KERNELS = (schur_factor, bt_sweep_fwd, bt_sweep_bwd)
# counted kernels off the fused factor and solve, which appear in launches()
# only when nonzero: gj_inverse, and those that register()
_OPTIONAL = {"gj_inverse": gj_inverse}


def register(wrapper) -> None:
    """Count another kernel's wrapper (``wrapper.launches``) under its name
    in :func:`launches`, only when nonzero, and in :func:`add_launches` and
    :func:`reset_launches` (``ops/mt1d.py`` registers its two)."""
    _OPTIONAL[wrapper.__name__] = wrapper


def reset_launches() -> None:
    for k in KERNELS + tuple(_OPTIONAL.values()):
        k.launches = 0
    schur_factor.polish_launches = 0


def launches() -> dict[str, int]:
    """Launches of each fused-path kernel since the last
    :func:`reset_launches`; the factor's polish variant
    (``schur_factor_polish``), the engines' ``gj_inverse`` and the
    registered kernels (the boundary fields' ``mt1d_field`` and
    ``mt1d_field_vjp``) count apart, and appear only when nonzero, so a
    path that runs none of them keeps the three keys."""
    out = {k.__name__: k.launches for k in KERNELS}
    if schur_factor.polish_launches:
        out["schur_factor_polish"] = schur_factor.polish_launches
    out.update((name, k.launches) for name, k in _OPTIONAL.items() if k.launches)
    return out


def launch_delta(before: dict[str, int], after: dict[str, int]) -> dict[str, int]:
    """``after - before`` for each kernel of two :func:`launches` readings
    (a key missing from one reads 0 there)."""
    return {k: after.get(k, 0) - before.get(k, 0) for k in {**before, **after}}


def add_launches(delta: dict[str, int]) -> None:
    """Add ``delta`` (kernel name -> count, as :func:`launch_delta` gives
    it) to the launch counters.  A CUDA graph's replay launches the kernels
    its capture recorded without passing through the wrappers, so the
    replaying code (``sampler/graphed.py``) adds the capture's delta here
    once a replay."""
    by_name = {k.__name__: k for k in KERNELS} | _OPTIONAL
    for name, n in delta.items():
        if name == "schur_factor_polish":
            schur_factor.polish_launches += n
        else:
            by_name[name].launches += n


# ---------------------------------------------------------------------------
# batched factor / solve on (..., nzi, q) systems
# ---------------------------------------------------------------------------

class FusedFactor(NamedTuple):
    """Factors of the fused engine for a batch of systems collapsed to B.
    ``lines`` is the axis its lines run along (:func:`line_axis`, the
    system's longer axis): "z", or "y" for the factor of the transposed
    system, in whose layout ``G`` and ``offz`` lie (:func:`fused_bt_solve`
    takes the right-hand side in that layout too)."""

    G: torch.Tensor      # (B, nzi, q, q) complex64 inverse Schur complements
    offz: torch.Tensor   # (B, nzi-1, q) float32 z-coupling
    batch: torch.Size    # the leading batch shape that was collapsed
    lines: str = "z"


def line_axis(nzi: int, nyi: int) -> str:
    """The axis along which the fused engine lays the lines of an nzi x
    nyi interior system: the ordering of least work, its lines along the
    longer axis so that each holds min(nzi, nyi) unknowns.  "z" (lines of
    nyi unknowns, one per z-row) when nyi <= nzi, ties included; else "y"
    (lines of nzi unknowns, the system transposed).  The factor's
    operations go as lines x width^3 and its sweeps' bytes as lines x
    width^2, and a narrower line runs in a narrower tile.  A system whose
    shorter side is wider than ``Q_MAX`` raises."""
    if min(nzi, nyi) > Q_MAX:
        raise ValueError(f"the fused engine needs lines of at most {Q_MAX} unknowns along "
                         f"one axis: ny_i = {nyi} (lines along z) and nz_i = {nzi} "
                         f"(lines along y) are both wider")
    return "z" if nyi <= nzi else "y"


def flatten_system(diag: torch.Tensor, offy: torch.Tensor, offz: torch.Tensor):
    """Broadcast an interior system's leading batch axes together and
    collapse them: contiguous complex64 diag (B, nzi, q), float32 offy
    (B, nzi, q-1) and offz (B, nzi-1, q), and the batch shape."""
    nzi, q = diag.shape[-2:]
    batch = torch.broadcast_shapes(diag.shape[:-2], offy.shape[:-2],
                                   offz.shape[:-2])

    def flat(t, tail, dtype):
        t = t.expand(batch + tail).reshape((-1,) + tail).to(dtype)
        return t.resolve_conj().contiguous()

    return (flat(diag, (nzi, q), torch.complex64),
            flat(offy, (nzi, q - 1), torch.float32),
            flat(offz, (nzi - 1, q), torch.float32), batch)


def fused_schur_factor(diag: torch.Tensor, offy: torch.Tensor,
                       offz: torch.Tensor, polish: int = 0,
                       lines: str = "z") -> FusedFactor:
    """Factorise an (equilibrated) interior system with leading batch axes
    that broadcast together; complex64 factors, float32 couplings;
    ``polish`` Newton-Schulz steps a line (0 on the main path).  The
    system is given in the layout of its lines: ``lines`` "y" says that it
    is a system transposed (``ops/solver.py`` does that), which changes
    nothing here but the factor's record."""
    q = diag.shape[-1]
    if q > Q_MAX:
        raise ValueError(f"fused factor supports q <= {Q_MAX}, got {q}")
    d, oy, oz, batch = flatten_system(diag, offy, offz)
    return FusedFactor(schur_factor(d, oy, oz, polish), oz, batch, lines)


def fused_bt_solve(fac: FusedFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve with fused factors; ``b`` is (..., nzi, q) with the factor's
    batch shape, in the factor's layout.  Complex-symmetric, so also the
    transpose solve."""
    tail = b.shape[-2:]
    v = b.expand(fac.batch + tail).reshape((-1,) + tail)
    v = v.to(torch.complex64).resolve_conj().contiguous()
    y = bt_sweep_fwd(fac.G, fac.offz, v)
    x = bt_sweep_bwd(fac.G, fac.offz, y)
    return x.reshape(fac.batch + tail).to(b.dtype)
