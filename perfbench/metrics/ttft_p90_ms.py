"""Time to first token, p90 over every request due in the window.

Client clock: from when the request was due (not when it was sent) to
its first streamed token. A request that failed or hit the cap counts
as the cap. End to end where its runs repeat within the bound (chat);
``.docqa``, whose runs do not, is a per-layer reading that moves
``output_tok_s``."""
from perfbench.harness.stats import percentile

SOURCE = 'host_clock'


def read(run):
    return percentile([run.ttft_ms(r) for r in run.window], 90)
