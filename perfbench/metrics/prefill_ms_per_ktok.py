"""Device milliseconds of the eagerly launched kernels per thousand
prompt tokens prefilled, over the traced slice. Every decode step and
ring merge replays a CUDA graph, so the eager kernels are the prefill
chunks' (``paged_prefill_chunk``: the projections and experts on
cuBLAS, ``cached_attention`` in plain torch) and the host loop's small
index updates. The tokens are the engine's own prefill-chunk spans,
each counted by the share of its span inside the slice.
Moves ``ttft_p90_ms``; ``.docqa`` moves ``output_tok_s``."""
SOURCE = 'device_trace'


def read(run):
    sl = run.slice
    if sl is None:
        return None
    tokens = run.prefill_tokens_between(sl.raw['t0'], sl.raw['t1'])
    eager = sl.kernels(sl.eager)
    if tokens < 1 or not eager:
        return None
    return sl.seconds(eager) * 1e3 / (tokens / 1e3)
