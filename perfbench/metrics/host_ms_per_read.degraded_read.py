"""host_ms_per_read.degraded_read: the mean host milliseconds inside each
read's call of the entry point (plan lookup, one GF launch a send, the
concatenations; no synchronise), in the traced run's unprofiled part."""


def read(r):
    host = r.window.host_s
    if not host:
        return None
    return sum(host) / len(host) * 1e3
