"""95th percentile (nearest rank) of the walls of all the window's calls,
in ms."""

import math


def read(rec):
    walls = sorted(c["t1"] - c["t0"] for c in rec["calls"])
    return 1e3 * walls[math.ceil(0.95 * len(walls)) - 1]
