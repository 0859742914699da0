"""cross_rack_bytes_per_block.recovery: the program's counter
``repair.bytes.cross_rack`` over one pass of every distinct operation, per
lost block rebuilt in that pass (exact: a count, not a time)."""


def read(r):
    if not r.counters or "repair.bytes.cross_rack" not in r.counters:
        return None
    blocks = r.counted_ops * r.blocks_per_op
    return r.counters["repair.bytes.cross_rack"] / blocks if blocks else None
