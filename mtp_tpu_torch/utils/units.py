"""Physical unit constants (LAMMPS ``metal`` convention).

The reference package runs under LAMMPS metal units (README.md:127 in the
reference uses ``units metal``): lengths in Angstrom, energies in eV, time in
picoseconds, masses in g/mol (amu), temperature in K, pressure in bar.
"""

# Boltzmann constant [eV / K]
KB = 8.617333262e-5

# mass * velocity^2 -> energy:  amu * (A/ps)^2 -> eV
MVV2E = 1.0364269e-4

# force/mass -> acceleration:  (eV/A) / amu -> A/ps^2
FTM2A = 1.0 / MVV2E

# pressure conversion: eV/A^3 -> bar
EVA3_TO_BAR = 1.602176634e6
