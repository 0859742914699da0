"""recovery_GBps: bytes of lost blocks rebuilt in the whole window (a block is
alpha * sub bytes) over the window's seconds, the drain of the last enqueued
calls included."""


def read(r):
    return r.window_GBps()
