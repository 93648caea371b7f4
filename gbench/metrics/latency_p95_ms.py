"""The 95th percentile of submit-to-result time over every job submitted
inside the window, by the benchmark's clock. A job that failed or did
not finish counts as missing every limit (an infinite time)."""

import math


def read(run):
    t0, t1 = run["window"]
    lat = sorted((j["done"] - j["submitted"]) * 1e3 if j["ok"]
                 else math.inf
                 for j in run["jobs"] if t0 <= j["submitted"] < t1)
    if not lat:
        return None
    # nearest rank: the smallest time that 95% of the jobs met
    return lat[max(math.ceil(0.95 * len(lat)) - 1, 0)]
