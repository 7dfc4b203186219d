# Frozen copy of attpc_engine_tpu_torch/constants.py; the benchmark's reference imports nothing of the port.
"""Physical constants for the engine.

Mirrors the constant set of the reference engine
(upstream attpc_engine/detector/constants.py:23-35) but is defined
from CODATA 2018 values directly so the package does not depend on scipy at
runtime.

Attributes
----------
NUM_TB: int
    Number of GET time buckets (samples) per event.
MEV_2_JOULE: float
    Conversion factor MeV -> Joule.
MEV_2_KG: float
    Conversion factor MeV/c^2 -> kg.
C: float
    Speed of light in m/s.
E_CHARGE: float
    Elementary charge in Coulombs.
AMU_MEV: float
    Atomic mass unit in MeV/c^2 (AME2020 / CODATA).
ELECTRON_MASS_MEV: float
    Electron rest mass in MeV/c^2.
"""

NUM_TB: int = 512

# CODATA 2018
E_CHARGE: float = 1.602176634e-19  # C (exact)
C: float = 299792458.0  # m/s (exact)

MEV_2_JOULE: float = E_CHARGE * 1.0e6  # J / MeV
MEV_2_KG: float = 1.78266192162e-30  # kg per MeV/c^2 (CODATA: eV/c^2 -> kg x 1e6)

AMU_MEV: float = 931.49410242  # MeV / u
ELECTRON_MASS_MEV: float = 0.51099895000  # MeV
