"""Rows a decode step serves, on average over the window: the tokens
decoded in the window (every streamed token but each request's first,
which prefill makes) over the change of the engine's
``decode_substeps`` counter. Moves ``output_tok_s``."""
SOURCE = 'program_counter'


def read(run):
    steps = (run.metrics1.get('decode_substeps', 0)
             - run.metrics0.get('decode_substeps', 0))
    if steps <= 0:
        return None
    return run.tokens_between(run.w0, run.w1, first=False) / steps
