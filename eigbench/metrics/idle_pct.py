"""idle_pct: the share of the traced window in which the card ran no
kernel and no copy (one minus the union of the device intervals over the
window), in percent.  None without a device trace."""


def read(ctx):
    trc = ctx["trace"]
    if trc is None or not trc.device or trc.window_us <= 0:
        return None
    return 100.0 * (1.0 - trc.busy_us / trc.window_us)
