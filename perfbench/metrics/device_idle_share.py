"""Share of the traced slice in which no device activity ran (kernels,
copies and fills, from ``torch.profiler``'s CUPTI trace). ``.chat``
moves ``tpot_p90_ms``, ``.docqa`` and ``.batch``
``output_tok_s``."""
SOURCE = 'device_trace'


def read(run):
    sl = run.slice
    if sl is None or not sl.dev or sl.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - sl.busy_s() / sl.window_s)
