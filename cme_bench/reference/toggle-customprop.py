"""Plain reference of the CUSTOMPROP toggle switch: its own frozen copy of
the network (reference ``examples/toggle.f90``), in numpy."""

import numpy as np

STOICHIOMETRY = np.array([[1, 0], [-1, 0], [0, 1], [0, -1]])
#: the reference box it starts from at t=100 (fsp.solve doubles a bound
#: that leaks)
BOUNDS = (320, 320)


def propensities(states, p):
    x, y = states[:, 0], states[:, 1]
    return np.stack([p[0] + p[1] / (1.0 + y ** 1.5), p[2] * x,
                     p[3] + p[4] / (1.0 + x ** 3.5), p[5] * y], axis=1)
