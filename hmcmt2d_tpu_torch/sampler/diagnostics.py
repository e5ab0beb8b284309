"""Cross-chain convergence diagnostics: split-R-hat and effective sample size.

Copy of ``hmcmt2d_tpu/sampler/diagnostics.py`` (numpy only).  The reference
has no convergence diagnostics (chains are written to disk and inspected
offline); these implement the full Vehtari, Gelman, Simpson,
Carpenter & Buerkner (2021) formulation: rank-normalized split chains, the
multi-chain pooled autocorrelation estimate with the between-chain variance
term, and the Geyer initial-monotone-sequence truncation.  ``split_rhat``
returns the max of the bulk (rank-normalized) and tail (folded) statistics;
``ess`` is bulk-ESS; ``ess_tail`` is the 5%/95% quantile-indicator ESS.

Everything is vectorized numpy over the parameter axis (P can be ~5e3);
inputs are (S, C, P) sample stacks as produced by the sampler.
"""

from __future__ import annotations

import numpy as np

from ..device import to_numpy

try:                               # normal quantile function
    from scipy.special import ndtri as _ndtri
except ImportError:                # pragma: no cover
    def _ndtri(p):
        from statistics import NormalDist
        return np.vectorize(NormalDist().inv_cdf)(p)


def _split(s: np.ndarray) -> np.ndarray:
    """(S, C, P) -> (S//2, 2C, P): each chain halved (discard odd tail)."""
    S = (s.shape[0] // 2) * 2
    half = S // 2
    return np.concatenate([s[:half], s[half:S]], axis=1)


def _rank_normalize(s: np.ndarray) -> np.ndarray:
    """Fractional average ranks over the pooled draws -> normal quantiles.

    z = ndtri((r - 3/8) / (N + 1/4))  (Blom offsets, Vehtari 2021 eq. 14).
    Average ranks matter here: MH rejections duplicate values, and 'ordinal'
    ranking would order ties by position, injecting fake trend.
    """
    S, C, P = s.shape
    flat = s.reshape(S * C, P)
    try:
        from scipy.stats import rankdata
        r = rankdata(flat, axis=0, method="average")
    except ImportError:            # pragma: no cover
        order = np.argsort(flat, axis=0, kind="stable")
        r = np.empty_like(flat)
        np.put_along_axis(r, order, np.arange(1.0, S * C + 1)[:, None], axis=0)
    z = _ndtri((r - 0.375) / (S * C + 0.25))
    return z.reshape(S, C, P)


def _chain_acov(x: np.ndarray) -> np.ndarray:
    """Per-chain autocovariance via FFT, biased (1/N) normalization.
    ``x`` is (N, M, P) demeaned per chain; returns (N, M, P)."""
    N = x.shape[0]
    nfft = int(2 ** np.ceil(np.log2(2 * N)))
    f = np.fft.rfft(x, n=nfft, axis=0)
    return np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:N].real / N


def _rhat_of(seq: np.ndarray) -> np.ndarray:
    """Classic R-hat of an (N, M, P) split-chain stack."""
    N = seq.shape[0]
    chain_mean = seq.mean(axis=0)
    chain_var = seq.var(axis=0, ddof=1)
    W = chain_var.mean(axis=0)
    B = N * chain_mean.var(axis=0, ddof=1)
    var_plus = (N - 1) / N * W + B / N
    return np.sqrt(var_plus / np.maximum(W, 1e-300))


def split_rhat(samples) -> np.ndarray:
    """Rank-normalized split-R-hat per parameter (Vehtari 2021): the max of
    the bulk statistic and the tail (folded-about-the-median) statistic.
    ``samples`` is (S, C, P)."""
    s = _split(to_numpy(samples).astype(np.float64))
    bulk = _rhat_of(_rank_normalize(s))
    folded = _rhat_of(_rank_normalize(np.abs(s - np.median(s, axis=(0, 1)))))
    return np.maximum(bulk, folded)


def _tau_int(seq: np.ndarray, max_lag: int | None = None) -> np.ndarray:
    """Integrated autocorrelation time of an (N, M, P) split-chain stack,
    using the multi-chain pooled estimate
    ``rho_t = 1 - (W - mean_m(s_m^2 rho_{t,m})) / var_plus``
    with Geyer initial-positive + initial-monotone truncation."""
    N, M, P = seq.shape
    if N < 2:
        # too short to estimate any autocorrelation: tau=1 (ESS = raw count)
        # instead of an IndexError on the empty Geyer pair array
        return np.ones(P)
    x = seq - seq.mean(axis=0, keepdims=True)
    acov = _chain_acov(x) * N / (N - 1)        # acov[0] == s_m^2 (ddof=1)
    W = acov[0].mean(axis=0)                   # (P,)
    if M > 1:
        B = N * seq.mean(axis=0).var(axis=0, ddof=1)
    else:
        B = np.zeros(P)
    var_plus = np.maximum((N - 1) / N * W + B / N, 1e-300)

    L = min(max_lag or N, N)
    rho = 1.0 - (W - acov[:L].mean(axis=1)) / var_plus   # (L, P)
    rho[0] = 1.0

    # Geyer pair sums P_k = rho_{2k} + rho_{2k+1}
    K = L // 2
    pairs = rho[0:2 * K:2] + rho[1:2 * K:2]              # (K, P)
    # truncate at the first non-positive pair (always keep the first pair)
    pos = pairs > 0
    pos[0] = True
    valid = np.logical_and.accumulate(pos, axis=0)
    # initial monotone sequence: enforce non-increasing pair sums
    mono = np.minimum.accumulate(np.where(valid, pairs, np.inf), axis=0)
    tau = -1.0 + 2.0 * np.sum(np.where(valid, np.maximum(mono, 0.0), 0.0),
                              axis=0)
    return np.maximum(tau, 1.0 / np.log10(max(N * M, 10)))


def ess(samples, max_lag: int | None = None) -> np.ndarray:
    """Bulk effective sample size per parameter (Vehtari 2021): ESS of the
    rank-normalized split chains.  ``samples`` is (S, C, P)."""
    s = _split(to_numpy(samples).astype(np.float64))
    N, M, _ = s.shape
    tau = _tau_int(_rank_normalize(s), max_lag)
    total = N * M
    # Stan's cap: noisy tau estimates cannot claim better than ~log10 scaling
    return np.minimum(total / tau, total * np.log10(max(total, 10)))


def ess_tail(samples, max_lag: int | None = None) -> np.ndarray:
    """Tail-ESS: min of the 5% and 95% quantile-indicator ESS."""
    s = _split(to_numpy(samples).astype(np.float64))
    N, M, _ = s.shape
    total = N * M
    out = []
    for q in (0.05, 0.95):
        ind = (s <= np.quantile(s, q, axis=(0, 1))).astype(np.float64)
        tau = _tau_int(ind - 0.0, max_lag)     # indicators: no rank-norm
        out.append(np.minimum(total / tau,
                              total * np.log10(max(total, 10))))
    return np.minimum(*out)


def misfit_summary(stats) -> dict:
    """Quick scalar summaries from the (S, C, 4) stats array."""
    st = to_numpy(stats)
    return {
        "misfit_final_mean": float(st[-1, :, 0].mean()),
        "misfit_min": float(st[:, :, 0].min()),
        "hamiltonian_final_mean": float(st[-1, :, 3].mean()),
    }
