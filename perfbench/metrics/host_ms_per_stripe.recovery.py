"""host_ms_per_stripe.recovery: the host's seconds inside each call of the
entry point (no synchronise: what it costs the host to enqueue a call), over
the stripes those calls repaired, in the traced run's unprofiled part."""


def read(r):
    host = r.window.host_s
    if not host or not r.stripes_per_op:
        return None
    return sum(host) / (len(host) * r.stripes_per_op) * 1e3
