"""Time per output token after the first, p90 over every request due
in the window: (last token - first token) / (tokens - 1), client clock.
A request that failed or hit the cap counts as the cap."""
from perfbench.harness.stats import percentile

SOURCE = 'host_clock'


def _tpot_ms(run, rec):
    if not rec.ok:
        return run.cap_s * 1e3
    return (rec.times[-1] - rec.times[0]) / (len(rec.times) - 1) * 1e3


def read(run):
    return percentile([_tpot_ms(run, r) for r in run.window
                       if r.req.max_new > 1], 90)
