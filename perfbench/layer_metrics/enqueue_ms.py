"""``enqueue_ms.<kind>``: host milliseconds from the call into the
program's step to its return, the mean over the window's calls outside
the traced stretch (the harness's wrapper times them); the device works
behind it."""


def read(run, name):
    values = run.counters.get("enqueue_s")
    return 1e3 * sum(values) / len(values) if values else None
