"""Output tokens per second: every token streamed to any client inside
the window, over the window's seconds (client clock)."""
SOURCE = 'host_clock'


def read(run):
    return run.tokens_between(run.w0, run.w1) / run.seconds
