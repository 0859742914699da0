"""gen_lag_p95_ms.degraded_read: the 95th percentile (nearest rank) of how
late the open loop issued each read against its due time, in the traced
run's unprofiled part, by the harness's clock."""
import math


def read(r):
    lag = sorted(r.window.lag_s)
    if not lag:
        return None
    return max(lag[math.ceil(0.95 * len(lag)) - 1], 0.0) * 1e3
