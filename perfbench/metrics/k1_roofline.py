"""K1's share of its roofline in the traced slice: the least time the
KV rows it must read take at the card's 3.35e12 B/s, over K1's device
time (``csrc/paged_decode.cuh`` ``paged_decode_kernel``).

The bytes are the benchmark's own count: K1 reads each decoding row's
keys and values once per step and layer, in bf16. A row's context at a
moment is its prompt plus the tokens its client had by then; the pool
part K1 reads leaves out the rows of the current call's ring, at most
31 of them, so 31 are taken off each row (a lower bound). Steps in the
slice = K1 launches / layers; rows and contexts are the mean over 64
moments of the slice. Bound by memory: a decode step's attention does
~1 FLOP a byte. ``.chat`` moves ``tpot_p90_ms``, ``.batch``
``output_tok_s``."""
from perfbench.harness import costs

SOURCE = 'device_trace'
RING_ROWS = 31
MOMENTS = 64


def read(run):
    sl = run.slice
    if sl is None:
        return None
    k1 = sl.kernels(named=('paged_decode_kernel',))
    t = sl.seconds(k1)
    if not k1 or t <= 0:
        return None
    steps = len(k1) / run.sizes.n_layers
    a, b = sl.raw['t0'], sl.raw['t1']
    ctx = 0.0
    for i in range(MOMENTS):
        rows = run.decoding_rows(a + (b - a) * (i + 0.5) / MOMENTS)
        ctx += sum(max(0, p + got - RING_ROWS) for p, got in rows)
    ctx /= MOMENTS
    least = steps * ctx * run.kv_bytes_per_token() / costs.PEAK_HBM_BYTES_PER_S
    return 100.0 * least / t
