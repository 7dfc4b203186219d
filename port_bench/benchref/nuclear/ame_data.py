# Frozen copy of attpc_engine_tpu_torch/nuclear/ame_data.py; the benchmark's reference imports nothing of the port.
"""Embedded atomic-mass-evaluation data.

This is an original transcription of AME2020 atomic mass excesses (keV) for
the light-nuclide region relevant to AT-TPC physics (Z = 0..20 plus a few
common heavier species). It replaces the role of the ``spyral-utils`` nuclear
data dependency of the reference engine
(upstream attpc_engine/__init__.py:1-3) with data shipped directly
in this package.

Values are *atomic* mass excesses: m_atomic(Z, A) = A * u + excess. Nuclear
masses are derived by subtracting Z electron masses (electron binding is
neglected, < 1 keV for light nuclides).

Nuclides not present in this table fall back to a Bethe-Weizsaecker
semi-empirical estimate (see :mod:`attpc_engine_tpu.nuclear.masses`), flagged
as estimated. Users needing exact coverage of the full chart can load an AME
``mass.mas20``-format file via
:func:`attpc_engine_tpu.nuclear.masses.NuclearDataMap.load_ame_file`.
"""

# (Z, A) -> atomic mass excess in keV
MASS_EXCESS_KEV: dict[tuple[int, int], float] = {
    # Z = 0 (neutron)
    (0, 1): 8071.318,
    # Z = 1 hydrogen
    (1, 1): 7288.971,
    (1, 2): 13135.722,
    (1, 3): 14949.811,
    (1, 4): 24621.0,
    (1, 5): 32892.0,
    # Z = 2 helium
    (2, 3): 14931.218,
    (2, 4): 2424.916,
    (2, 5): 11231.0,
    (2, 6): 17592.09,
    (2, 7): 26101.0,
    (2, 8): 31609.7,
    # Z = 3 lithium
    (3, 4): 25320.0,
    (3, 5): 11679.0,
    (3, 6): 14086.88,
    (3, 7): 14907.10,
    (3, 8): 20945.80,
    (3, 9): 24954.90,
    (3, 10): 33051.0,
    (3, 11): 40728.3,
    # Z = 4 beryllium
    (4, 6): 18165.0,
    (4, 7): 15769.0,
    (4, 8): 4941.67,
    (4, 9): 11348.45,
    (4, 10): 12607.49,
    (4, 11): 20177.17,
    (4, 12): 25078.0,
    (4, 14): 39950.0,
    # Z = 5 boron
    (5, 7): 27677.0,
    (5, 8): 22921.6,
    (5, 9): 12416.5,
    (5, 10): 12050.611,
    (5, 11): 8667.9,
    (5, 12): 13369.4,
    (5, 13): 16562.2,
    (5, 14): 23664.0,
    (5, 15): 28966.0,
    # Z = 6 carbon
    (6, 8): 35064.0,
    (6, 9): 28911.0,
    (6, 10): 15698.7,
    (6, 11): 10650.3,
    (6, 12): 0.0,
    (6, 13): 3125.009,
    (6, 14): 3019.893,
    (6, 15): 9873.1,
    (6, 16): 13694.0,
    # Z = 7 nitrogen
    (7, 12): 17338.1,
    (7, 13): 5345.48,
    (7, 14): 2863.417,
    (7, 15): 101.438,
    (7, 16): 5683.7,
    (7, 17): 7871.0,
    # Z = 8 oxygen
    (8, 13): 23115.0,
    (8, 14): 8007.36,
    (8, 15): 2855.6,
    (8, 16): -4737.002,
    (8, 17): -808.76,
    (8, 18): -782.82,
    (8, 19): 3332.9,
    (8, 20): 3796.2,
    (8, 21): 8062.0,
    (8, 22): 9280.0,
    # Z = 9 fluorine
    (9, 17): 1951.70,
    (9, 18): 873.1,
    (9, 19): -1487.45,
    (9, 20): -17.46,
    (9, 21): -47.6,
    # Z = 10 neon
    (10, 17): 16500.0,
    (10, 18): 5317.6,
    (10, 19): 1752.05,
    (10, 20): -7041.93,
    (10, 21): -5731.78,
    (10, 22): -8024.72,
    (10, 23): -5154.0,
    (10, 24): -5951.5,
    # Z = 11 sodium
    (11, 21): -2184.6,
    (11, 22): -5181.6,
    (11, 23): -9529.85,
    (11, 24): -8418.1,
    # Z = 12 magnesium
    (12, 23): -5473.8,
    (12, 24): -13933.57,
    (12, 25): -13192.83,
    (12, 26): -16214.55,
    (12, 27): -14586.6,
    # Z = 13 aluminium
    (13, 26): -12210.1,
    (13, 27): -17196.7,
    (13, 28): -16850.4,
    # Z = 14 silicon
    (14, 27): -12384.3,
    (14, 28): -21492.80,
    (14, 29): -21895.08,
    (14, 30): -24432.96,
    (14, 31): -22949.0,
    (14, 32): -24077.7,
    # Z = 15 phosphorus
    (15, 30): -20200.9,
    (15, 31): -24440.54,
    (15, 32): -24305.0,
    # Z = 16 sulfur
    (16, 32): -26015.53,
    (16, 33): -26586.24,
    (16, 34): -29931.78,
    (16, 35): -28846.3,
    (16, 36): -30664.1,
    # Z = 17 chlorine
    (17, 35): -29013.54,
    (17, 36): -29522.0,
    (17, 37): -31761.53,
    # Z = 18 argon
    (18, 36): -30231.54,
    (18, 37): -30948.0,
    (18, 38): -34714.4,
    (18, 39): -33242.0,
    (18, 40): -35039.89,
    (18, 41): -33067.5,
    (18, 46): -29772.0,
    # Z = 19 potassium
    (19, 39): -33807.01,
    (19, 40): -33535.49,
    (19, 41): -35559.54,
    # Z = 20 calcium
    (20, 40): -34846.27,
    (20, 41): -35137.9,
    (20, 42): -38547.24,
    (20, 43): -38408.82,
    (20, 44): -41468.68,
    (20, 45): -40812.2,
    (20, 46): -43135.0,
    (20, 47): -42340.0,
    (20, 48): -44223.6,
    # A few common heavier species
    (22, 48): -48491.7,
    (24, 52): -55418.1,
    (26, 56): -60606.4,
    (28, 58): -60227.7,
    (28, 60): -64472.5,
    (30, 64): -66003.6,
}

ELEMENT_SYMBOLS: tuple[str, ...] = (
    "n", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
    "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm",
    "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds",
    "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
)
