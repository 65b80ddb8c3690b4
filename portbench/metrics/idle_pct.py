"""Device: the share of the traced window in which no operation ran on
the card (one minus the union of the device operations' intervals over
the window's wall time)."""

from portbench import devtrace


def read(rec):
    lo, hi = rec.trace.window
    if not rec.trace.ops or hi <= lo:
        return None
    return 100.0 * (1.0 - devtrace.busy_ns(rec.trace) / (hi - lo))
