"""degraded_read_p95_ms: the 95th percentile (nearest rank) of every read due
in the window, each timed from its due time until its completion event was
seen by the host; a read that failed or never finished counts as infinite."""
import math


def read(r):
    lat = sorted(r.window.latency_s)
    if not lat:
        return None
    value = lat[math.ceil(0.95 * len(lat)) - 1]
    return None if math.isinf(value) else value * 1e3
