"""Device milliseconds of one decode step: the summed durations of the
kernels that CUDA graph replays ran in the traced slice (the step
graphs and the ring merges), over the step replays in it. A step
replay is a ``cudaGraphLaunch`` whose kernels number at least the
model's layers (a step attends once per layer; a merge launches
fewer). ``.chat`` moves ``tpot_p90_ms``, ``.batch`` ``output_tok_s``."""
SOURCE = 'device_trace'


def read(run):
    sl = run.slice
    if sl is None:
        return None
    steps = sl.graph_launches(min_kernels=run.sizes.n_layers)
    if not steps:
        return None
    return sl.seconds(sl.graph) * 1e3 / steps
