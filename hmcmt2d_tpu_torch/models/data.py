"""Survey/data description shared by the forward model and the sampler.

Equivalent of the reference's ``MTData`` (HMCFileIO.jl:26-41): receiver
locations, frequencies, data type ("Impedance" or "Rho_Pha"), per-datum
(freq, rx, component) indices and the dense boolean mask over the
(nFreq, nRx, nComp) response cube.  All members are **static** numpy data
(they define trace-time shapes/gathers for the jitted forward model).
"""

from __future__ import annotations

import dataclasses

import numpy as np

TE_COMPONENTS = {"ZXY", "RhoXY", "PhsXY", "log10RhoXY", "TZY"}
TM_COMPONENTS = {"ZYX", "RhoYX", "PhsYX", "log10RhoYX"}

# dataType families of the reference (readMT2DData.jl:81-86,117-121;
# dataFuncSens.jl:118-176): "Impedance[_Tipper]" rows are complex,
# "Rho_Pha"/"Rho_Phs" rows are real.  Tipper (TZY = Hz/Hy, TE mode) is
# supported with the Impedance family, where it is complex like Z.
DATA_TYPES = ("Impedance", "Impedance_Tipper", "Rho_Pha", "Rho_Phs")


@dataclasses.dataclass(frozen=True)
class MTData:
    rx_loc: np.ndarray          # (nrx, 2) receiver (y, z)
    freqs: np.ndarray           # (nfreq,)
    data_type: str              # "Impedance" | "Rho_Pha"
    data_comp: tuple            # component names, cube dt-axis order
    freq_id: np.ndarray         # (ndata,) 0-based frequency index
    rx_id: np.ndarray           # (ndata,) 0-based receiver index
    dt_id: np.ndarray           # (ndata,) 0-based component index

    @property
    def n_rx(self) -> int:
        return self.rx_loc.shape[0]

    @property
    def n_freq(self) -> int:
        return len(self.freqs)

    @property
    def n_comp(self) -> int:
        return len(self.data_comp)

    @property
    def n_data(self) -> int:
        return len(self.freq_id)

    @property
    def comp_te(self) -> bool:
        """TE required iff any XY component present (readMT2DData.jl:149-155)."""
        return any(c in TE_COMPONENTS for c in self.data_comp)

    @property
    def comp_tm(self) -> bool:
        return any(c in TM_COMPONENTS for c in self.data_comp)

    @property
    def flat_index(self) -> np.ndarray:
        """Indices of observed data in the C-order ravel of the
        (nFreq, nRx, nComp) cube — the component axis fastest, matching the
        reference's vec of the (nDt, nRx, nFreq) Fortran cube
        (readMT2DData.jl:164-172, MT2DFwdSolver.jl:209-210)."""
        return (self.freq_id * self.n_rx + self.rx_id) * self.n_comp + self.dt_id

    @property
    def is_complex(self) -> bool:
        """Complex observations iff the Impedance family
        (readMT2DData.jl:117-121)."""
        return "Impedance" in self.data_type

    def validate(self):
        assert self.data_type in DATA_TYPES, self.data_type
        if any(c == "TZY" for c in self.data_comp):
            assert self.is_complex, "tipper requires the Impedance family"
        for c in self.data_comp:
            assert c in TE_COMPONENTS | TM_COMPONENTS, c
        assert self.freq_id.max() < self.n_freq and self.rx_id.max() < self.n_rx
        return self
