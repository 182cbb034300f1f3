"""The birth-death case of the fused-loop tests: ``models/
birth_death_model.input`` (read by both packages' loaders) with its
parameters, the solve's arguments and the closed form of its law."""

import math
from pathlib import Path

import numpy as np

PATH = str(Path(__file__).resolve().parent.parent / "models"
           / "birth_death_model.input")
PARAMS = [1.0, 0.1]
CASE = dict(t=50.0, x0=[[200]], fsp_tol=1e-6, krylov_tol=1e-10)


def exact(n_max, x0=200, kp=PARAMS[0], kd=PARAMS[1], t=CASE["t"]):
    """P(X(t) = n), n = 0..n_max: the survivors of x0 are
    Binomial(x0, e^{-kd t}), the newcomers Poisson(kp/kd (1 - e^{-kd t})),
    independent."""
    q = math.exp(-kd * t)
    binom = np.array([math.comb(x0, k) * q ** k * (1 - q) ** (x0 - k)
                      for k in range(x0 + 1)])
    lam = kp / kd * (1 - q)
    pois = np.empty(n_max + 1)
    pois[0] = math.exp(-lam)
    for k in range(1, n_max + 1):
        pois[k] = pois[k - 1] * lam / k
    return np.convolve(binom, pois)[:n_max + 1]
