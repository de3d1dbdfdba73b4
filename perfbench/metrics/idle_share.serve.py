"""Device: the share of the profiled stretch's wall time in which no
operation ran on the card, in %: 100 * (1 - busy / window), busy the
union of device activity intervals in the `torch.profiler` trace."""


def read(records):
    p = records.get("profile")
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
