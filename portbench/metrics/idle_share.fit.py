"""The device's idle share of the traced window, in %: 1 - (seconds in
which some operation ran on the device) / (the window's length)."""


def read(ctx):
    trace = ctx.get('trace')
    if trace is None or trace.window_s() <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s())
