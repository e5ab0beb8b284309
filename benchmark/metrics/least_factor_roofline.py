"""least_factor_roofline: the least time of the factor's work at the card's
float32 peak, over the device time of the fused factor's launches.  The
work is the least of the systems (``check.shapes``): one complex inverse
and products of width x width blocks a line, 8 width^3 lines B real
operations, the same whichever ordering or engine solves them.  A factor
whose lines hold the longer axis's unknowns does more, so no line-by-line
factor reads above 100%."""


def flops(sh):
    """Real operations of the least-work factor of ``sh``'s systems."""
    return 8.0 * sh["width"] ** 3 * sh["lines"] * sh["B"]


def read(rec):
    prof, sh, pk = rec["profile"], rec["shapes"], rec["peaks"]
    runs = [e - s for name, s, e in prof["kernels"] if "schur_factor_kernel" in name]
    if not runs or pk is None:
        return None
    return 100.0 * len(runs) * flops(sh) / pk["flops"] / (sum(runs) / 1e9)
