"""Faults planted in the program under test, for the harness's own
tests: each is called in the server process before the server is built
(``run.main(..., fault='perfbench.tests.faults:<name>')``) and breaks
the timed path underneath, where a later change could break it.
"""
from __future__ import annotations


def altered_token() -> None:
    """A token altered where it is produced: every readback of the
    engine's sampled tokens comes back with its first token's id
    changed."""
    from skypilot_tpu_torch.inference import paged
    read = paged.host_sync

    def host_sync(x):
        vals = read(x).copy()
        flat = vals.reshape(-1)
        if flat.size and flat[0] >= 0:
            flat[0] = flat[0] ^ 1
        return vals

    paged.host_sync = host_sync


def stale_pool() -> None:
    """A step that leaves its state unchanged: a decode call's new KV
    rows never land in the page pool, so later steps read stale rows."""
    from skypilot_tpu_torch.inference import paged
    paged.merge_ring_into_pool = lambda cache, *a, **k: cache
