"""repair_roofline.<cell>: the repair's least time over all device time a
lost block, in percent.  Least time: each helper byte the repair reads, read once,
and the rebuilt block written once, (repair_read_blocks + 1) * alpha * sub
bytes (the configuration's count of whole helper blocks a repair reads, from
the code's shape), over the card's published HBM rate (``peaks.json``).
Device time: every kernel, copy and fill in the profiled stretch, over the
blocks rebuilt there; a fused or batched repair is read against the same
count."""


def read(r):
    d, t = r.device, r.traced
    if d is None or t is None or not r.peaks or t.done == 0 or d.device_s <= 0:
        return None
    cfg = r.cfg
    least_bytes = (cfg["repair_read_blocks"] + 1) * cfg["alpha"] * cfg["sub_bytes"]
    least_s = least_bytes / r.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (d.device_s / (t.done * r.blocks_per_op))
