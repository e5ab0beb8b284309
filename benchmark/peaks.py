"""Published peaks of the cards the benchmark runs on (NVIDIA data sheets,
dense rates without sparsity), by a part of the name torch reports.  The
arithmetic rate is float32's on the CUDA cores, which on these parts equals
float64's best (its tensor cores), so one figure bounds complex64 and
complex128 work alike.  The rates assume the card's full power limit; the
result line carries the limit the card was set to."""

PEAKS = {   # name part: (FLOP/s, bytes/s of device memory)
    "H100 PCIe": (51e12, 2.0e12),
    "H100 NVL": (60e12, 3.9e12),
    "H200": (67e12, 4.8e12),
    "H100": (67e12, 3.35e12),       # SXM, "NVIDIA H100 80GB HBM3"
}


def peaks(device_name: str) -> tuple[float, float]:
    """(FLOP/s, bytes/s) of the first entry whose key is in the name; an
    unknown card raises, since a share of a guessed peak means nothing."""
    for key, rates in PEAKS.items():
        if key in device_name:
            return rates
    raise KeyError(f"no published peaks for {device_name!r}")
