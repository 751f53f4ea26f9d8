"""The whole step's share of the card's bf16 peak over the window: the
FLOPs the window's tokens need, over the window's seconds x 989e12.

- a decoded token (every streamed token but a request's first): 2 x
  the weights it passes through (two experts for Mixtral), the
  unembedding included, plus causal attention over its context;
- a prefilled prompt token (the engine's prefill-chunk spans in the
  window, at their positions after the prefix hit): the same without
  the unembedding, which only a prompt's last token needs (added once
  per completed prompt).

Tokens served from the prefix cache need no compute and are not
counted. ``.chat`` moves ``tpot_p90_ms``, ``.docqa`` and ``.batch``
``output_tok_s``."""
from perfbench.harness import costs

SOURCE = 'program_span'


def read(run):
    s, a, b = run.sizes, run.w0, run.w1
    flops = 0.0
    per_token = costs.token_matmul_flops(s)
    for r in run.records:
        p = len(r.req.prompt)
        for i, t in enumerate(r.times[1:], start=1):
            if a <= t < b:
                flops += per_token + costs.attention_flops(s, p + i)
    no_unembed = costs.token_matmul_flops(s, unembed=False)
    unembed = per_token - no_unembed
    for tr in run.traces:
        hit, chunks = tr[3], tr[4]
        for t0, t1, tokens, offset in chunks:
            if not tokens or t1 <= t0:
                continue
            share = max(0.0, min(b, t1) - max(a, t0)) / (t1 - t0)
            if share <= 0:
                continue
            work = (tokens * no_unembed
                    + costs.attention_flops_span(s, hit + offset, tokens))
            if hit + offset + tokens == tr[1]:
                work += unembed
            flops += share * work
    if flops <= 0:
        return None
    return 100.0 * flops / (run.seconds * costs.PEAK_BF16_FLOPS)
