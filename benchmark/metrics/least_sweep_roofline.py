"""least_sweep_roofline: the least time of the block sweeps' traffic at the
card's memory bandwidth, over the device time of the sweeps' launches.  The
traffic is the least of the systems (``check.shapes``), the same whichever
ordering or engine solves them: a forward sweep reads every line of G (8
width^2 bytes each, complex64), the couplings (4 width bytes each) and the
right-hand side and writes y; a backward sweep reads lines 0..lines-2 of G,
the couplings and y and writes x.  A sweep whose lines hold the longer
axis's unknowns reads more, so no line-by-line sweep reads above 100%."""


def sweep_bytes(sh):
    """(forward, backward) bytes of one least-work sweep of ``sh``'s systems."""
    w, n, B = sh["width"], sh["lines"], sh["B"]
    vec = 4 * B * (n - 1) * w + 2 * 8 * B * n * w
    return 8 * B * n * w * w + vec, 8 * B * (n - 1) * w * w + vec


def read(rec):
    prof, sh, pk = rec["profile"], rec["shapes"], rec["peaks"]
    fwd = [e - s for name, s, e in prof["kernels"] if "bt_sweep_fwd_kernel" in name]
    bwd = [e - s for name, s, e in prof["kernels"] if "bt_sweep_bwd_kernel" in name]
    if not (fwd or bwd) or pk is None:
        return None
    f, b = sweep_bytes(sh)
    nbytes = len(fwd) * f + len(bwd) * b
    return 100.0 * nbytes / pk["bytes_per_s"] / ((sum(fwd) + sum(bwd)) / 1e9)
