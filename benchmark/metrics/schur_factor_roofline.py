"""schur_factor_roofline: the least time of the fused factor's work, 8 q^3
nzi B real operations (one complex inverse and products of q x q blocks a
line) at the card's float32 peak, over the device time of its launches,
counted from the real q, nzi and B, never the padded tile."""


def read(rec):
    prof, sh, pk = rec["profile"], rec["shapes"], rec["peaks"]
    runs = [e - s for name, s, e in prof["kernels"] if "schur_factor_kernel" in name]
    if not runs or pk is None:
        return None
    flops = 8.0 * sh["q"] ** 3 * sh["nzi"] * sh["B"]
    return 100.0 * len(runs) * flops / pk["flops"] / (sum(runs) / 1e9)
