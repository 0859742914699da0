"""gf_calls_per_stripe.recovery: the program's counter
``kernel.gf_matmul.calls`` over one pass of every distinct operation, per
stripe repaired in that pass (exact: a count)."""


def read(r):
    if not r.counters or "kernel.gf_matmul.calls" not in r.counters:
        return None
    stripes = r.counted_ops * r.stripes_per_op
    return r.counters["kernel.gf_matmul.calls"] / stripes if stripes else None
