"""device_idle_pct.<cell>: the share of the profiled stretch in which no
kernel, copy or fill ran on the card, in percent (``torch.profiler``
recording the card's activity alone, every operation's interval merged)."""


def read(r):
    d = r.device
    if d is None or d.window_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)
