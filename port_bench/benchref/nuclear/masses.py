# Frozen copy of attpc_engine_tpu_torch/nuclear/masses.py; the benchmark's reference imports nothing of the port.
"""Nuclear mass data: ``NucleusData`` records and the ``NuclearDataMap``.

This module fills the role of ``spyral_utils.nuclear`` in the reference engine
(used throughout, e.g. upstream attpc_engine/kinematics/reaction.py:3)
but is self-contained: masses come from the embedded AME2020 transcription in
:mod:`attpc_engine_tpu.nuclear.ame_data`, with a semi-empirical
(Bethe-Weizsaecker) fallback for nuclides outside the table and an optional
loader for a real AME ``mass.mas20`` file.

Masses are *nuclear* masses in MeV/c^2:
    m = A * u + excess_atomic - Z * m_e
(electron binding neglected, sub-keV for the light-nuclide regime).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from ..constants import AMU_MEV, ELECTRON_MASS_MEV
from .ame_data import MASS_EXCESS_KEV, ELEMENT_SYMBOLS

# Bethe-Weizsaecker liquid-drop coefficients (MeV), Wapstra-style fit
_SEMF_AV = 15.75
_SEMF_AS = 17.8
_SEMF_AC = 0.711
_SEMF_AA = 23.7
_SEMF_AP = 11.18


@dataclass(frozen=True)
class NucleusData:
    """Data describing a single nuclide.

    Attributes
    ----------
    mass: float
        Nuclear mass in MeV/c^2.
    atomic_mass: float
        Atomic mass in MeV/c^2 (nuclear mass + Z electrons).
    element_symbol: str
        Element symbol, e.g. "C".
    isotopic_symbol: str
        Isotope symbol, e.g. "12C".
    Z: int
        Proton number.
    A: int
        Mass number.
    is_estimated: bool
        True if the mass came from the semi-empirical fallback rather than
        the AME table.
    """

    mass: float
    atomic_mass: float
    element_symbol: str
    isotopic_symbol: str
    Z: int
    A: int
    is_estimated: bool = field(default=False, compare=False)

    def __str__(self) -> str:
        return self.isotopic_symbol

    def get_latex_rep(self) -> str:
        """LaTeX representation, e.g. ``^{12}C``."""
        return f"$^{{{self.A}}}${self.element_symbol}"


def _semf_mass_excess_kev(z: int, a: int) -> float:
    """Bethe-Weizsaecker estimate of the *atomic* mass excess in keV."""
    n = a - z
    be = (
        _SEMF_AV * a
        - _SEMF_AS * a ** (2.0 / 3.0)
        - _SEMF_AC * z * (z - 1) / a ** (1.0 / 3.0)
        - _SEMF_AA * (a - 2 * z) ** 2 / a
    )
    if z % 2 == 0 and n % 2 == 0:
        be += _SEMF_AP / a**0.5
    elif z % 2 == 1 and n % 2 == 1:
        be -= _SEMF_AP / a**0.5
    # atomic mass = Z * m(1H)_atomic + N * m(n) - BE
    m_atomic = (
        z * (AMU_MEV + MASS_EXCESS_KEV[(1, 1)] * 1.0e-3)
        + n * (AMU_MEV + MASS_EXCESS_KEV[(0, 1)] * 1.0e-3)
        - be
    )
    return (m_atomic - a * AMU_MEV) * 1.0e3


class NuclearDataMap:
    """Lookup of nuclide data by (Z, A).

    API-compatible with the reference's ``spyral_utils.nuclear.NuclearDataMap``
    (`get_data(Z, A) -> NucleusData`). Data is materialized lazily and cached.
    """

    def __init__(self) -> None:
        self._map: dict[tuple[int, int], NucleusData] = {}
        self._excess_kev: dict[tuple[int, int], float] = dict(MASS_EXCESS_KEV)

    def load_ame_file(self, path: Path | str) -> None:
        """Load an AME ``mass.mas20``-format mass table, overriding the
        embedded values.

        The AME2020 file format is fixed-width; we parse the Z, A and
        mass-excess columns. Estimated entries (marked with ``#``) are
        accepted with ``#`` treated as a decimal point, following AME
        convention.
        """
        path = Path(path)
        with path.open("r") as f:
            lines = f.readlines()
        # Data lines start after the 36-line header in mass.mas20
        for line in lines:
            try:
                z = int(line[11:16])
                a = int(line[16:21])
                excess_str = line[29:42].replace("#", ".").strip()
                excess = float(excess_str)
            except (ValueError, IndexError):
                continue
            self._excess_kev[(z, a)] = excess
        self._map.clear()

    def get_data(self, z: int, a: int) -> NucleusData:
        """Get the data for a nuclide specified by Z, A.

        Parameters
        ----------
        z: int
            Proton number.
        a: int
            Mass number.

        Returns
        -------
        NucleusData
            The nuclide data. ``is_estimated`` is True when the mass came
            from the semi-empirical fallback.
        """
        key = (int(z), int(a))
        cached = self._map.get(key)
        if cached is not None:
            return cached
        z, a = key
        if z < 0:
            raise ValueError(f"Invalid nuclide Z={z} A={a} (Z < 0)")
        if a < 1:
            raise ValueError(f"Invalid nuclide Z={z} A={a} (A < 1)")
        if z > a:
            raise ValueError(f"Invalid nuclide Z={z} A={a} (Z > A)")
        if z >= len(ELEMENT_SYMBOLS):
            raise ValueError(f"Unsupported element Z={z}")
        excess = self._excess_kev.get(key)
        estimated = excess is None
        if excess is None:
            excess = _semf_mass_excess_kev(z, a)
        atomic_mass = a * AMU_MEV + excess * 1.0e-3
        mass = atomic_mass - z * ELECTRON_MASS_MEV
        symbol = ELEMENT_SYMBOLS[z]
        iso = f"{a}{symbol}" if z > 0 else ("n" if a == 1 else f"{a}n")
        data = NucleusData(
            mass=mass,
            atomic_mass=atomic_mass,
            element_symbol=symbol,
            isotopic_symbol=iso,
            Z=z,
            A=a,
            is_estimated=estimated,
        )
        self._map[key] = data
        return data
