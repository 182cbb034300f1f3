"""Plain reference of the Goutsias network: its own frozen copy of the
network (reference ``examples/transcr6d.f90``), mass action in numpy.
Species order M, D, RNA, DNA, DNA.D, DNA.2D."""

import numpy as np

STOICHIOMETRY = np.array([
    [1, 0, 0, 0, 0, 0],
    [-1, 0, 0, 0, 0, 0],
    [0, 0, 1, 0, 0, 0],
    [0, 0, -1, 0, 0, 0],
    [0, -1, 0, -1, 1, 0],
    [0, 1, 0, 1, -1, 0],
    [0, -1, 0, 0, -1, 1],
    [0, 1, 0, 0, 1, -1],
    [-2, 1, 0, 0, 0, 0],
    [2, -1, 0, 0, 0, 0],
])
#: the reference box it starts from at t=30 (fsp.solve doubles a bound
#: that leaks); DNA, DNA.D and DNA.2D hold the 2 gene copies between them
BOUNDS = (48, 32, 24, 3, 3, 3)


def propensities(s, c):
    m, d, rna, dna, dnad, dna2d = s.T
    return np.stack([c[0] * rna, c[1] * m, c[2] * dnad, c[3] * rna,
                     c[4] * dna * d, c[5] * dnad, c[6] * dnad * d,
                     c[7] * dna2d, c[8] * m * (m - 1) / 2.0, c[9] * d],
                    axis=1)
