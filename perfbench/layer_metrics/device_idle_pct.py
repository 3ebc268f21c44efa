"""``device_idle_pct.<kind>``: the share of the traced stretch's wall time
in which no operation ran on the device."""


def read(run, name):
    red = run.tracer.result
    if red is None or red.window_s <= 0:
        return None
    return 100.0 * (1.0 - red.busy_s / red.window_s)
