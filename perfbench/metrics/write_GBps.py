"""write_GBps: user data bytes encoded in the whole window (k * alpha * sub a
stripe) over the window's seconds, the drain of the last enqueued encodes
included."""


def read(r):
    return r.window_GBps()
