"""``expm_us_per_call`` where the cell's end-to-end time is the card's
(``device_s_per_solve``): the same reading, under a name of its own
because it moves that metric and not ``solve_s``."""

from cme_bench import harness

UNIT = harness.load_module("metrics", "expm_us_per_call").UNIT


def read(trace):
    return harness.load_module("metrics", "expm_us_per_call").read(trace)
