"""gf_matmul_roofline.write: the encode's least time over the GF kernel's
device time a stripe, in percent.  Least time: the stripe's data read once
and its parity written once, (k + (n-k)) * alpha * sub bytes, over the
card's published HBM rate (``peaks.json``).  Device time: the kernels whose
name holds ``gf_`` in the profiled stretch, over the stripes encoded there."""


def read(r):
    d, t = r.device, r.traced
    if d is None or t is None or not r.peaks or t.done == 0:
        return None
    gf_s = d.seconds_matching("gf_")
    if gf_s <= 0:
        return None
    cfg = r.cfg
    least_s = cfg["n"] * cfg["alpha"] * cfg["sub_bytes"] / r.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (gf_s / (t.done * r.stripes_per_op))
