"""bt_sweep_roofline: the least time of the block sweeps' traffic at the
card's memory bandwidth over their device time.  A forward sweep reads
every line of G (8 q^2 bytes each, complex64), offz (4 q a coupling) and
the right-hand side and writes y; a backward sweep reads lines 0..nzi-2 of
G, offz and y and writes x."""


def read(rec):
    prof, sh, pk = rec["profile"], rec["shapes"], rec["peaks"]
    fwd = [e - s for name, s, e in prof["kernels"] if "bt_sweep_fwd_kernel" in name]
    bwd = [e - s for name, s, e in prof["kernels"] if "bt_sweep_bwd_kernel" in name]
    if not (fwd or bwd) or pk is None:
        return None
    q, nzi, B = sh["q"], sh["nzi"], sh["B"]
    vec = 4 * B * (nzi - 1) * q + 2 * 8 * B * nzi * q
    nbytes = len(fwd) * (8 * B * nzi * q * q + vec) + len(bwd) * (8 * B * (nzi - 1) * q * q + vec)
    return 100.0 * nbytes / pk["bytes_per_s"] / ((sum(fwd) + sum(bwd)) / 1e9)
