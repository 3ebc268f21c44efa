"""``batch_fill.<kind>``: the serving engine's ``EngineStats.mean_fill``
(real rows a batch over the batch size) over the window's batches."""


def read(run, name):
    fill = run.counters.get("batch_fill")
    return None if fill is None else 100.0 * fill
