"""Share of the prompt tokens that the prefix cache served, over the
requests queued in the window: the engine's per-request prefix hit
(pages kept x page size, from its ``prefix_cache_hit`` span) over the
prompt tokens (its ``queue`` span). Moves ``ttft_p90_ms``; ``.docqa``
(the control, which shares nothing) moves ``output_tok_s``."""
SOURCE = 'program_span'


def read(run):
    traces = run.traces_between(run.w0, run.w1)
    prompt = sum(t[1] or 0 for t in traces)
    if not prompt:
        return None
    return 100.0 * sum(t[3] for t in traces) / prompt
