"""Mean queue wait of the requests admitted in the window: the change
of the server's ``skytpu_request_queue_wait_ms`` histogram (submit to
slot assignment) between the window's ends, sum over count.
Moves ``ttft_p90_ms``; ``.docqa``, whose cell reports no TTFT end to end,
moves ``output_tok_s``."""
from perfbench.harness.client import histogram_sum_count

SOURCE = 'program_counter'
NAME = 'skytpu_request_queue_wait_ms'


def read(run):
    s0, c0 = histogram_sum_count(run.prom0, NAME)
    s1, c1 = histogram_sum_count(run.prom1, NAME)
    if c1 <= c0:
        return None
    return (s1 - s0) / (c1 - c0)
