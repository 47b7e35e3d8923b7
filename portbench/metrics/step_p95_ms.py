"""The 95th percentile, over every step of the window, of the wall
time of one ``pool.step(fetch=True)`` call, from the call to the master
on the host."""

import numpy as np


def read(run):
    return float(np.percentile(run.step_times, 95)) * 1e3
