"""How ``correct`` is decided: the served tokens against the plain
reference.

Once the window has closed and the server process has exited, a sample
of the window's finished requests, drawn from the seed and always
holding the longest (prompt plus output), is run once through the fp32
reference (``reference/model.py``) over each prompt followed by its
served tokens. At every served position the reference's logit of the
served token is compared with its best logit there: greedy serving in
bf16 may pick a token the fp32 model ranks second only where the two
are near a tie, so the gap stays small; a wrong token, a stale cache or
a wrong layer gives a large one somewhere among hundreds of tokens.
The number compared is the widest gap.

Mixtral: where the reference's second and third router logits of a
token lie within ``tie_margin`` in some layer, a bf16 run may route
that token through the third expert there, and its logits at that
position are then those of the reference routed so. The reference
computes these routing variants (``reference/model.py``), and a
position's gap is the least over the reference and its variants. Which
variants exist depends on the reference alone, and the control (below)
is judged against the same ones, so the treatment gives a lower
precision no more room than it gives the program.

The control (``control=True``, never in the benchmark's own runs) is
the same reference computed as an fp8 serving path would
(``reference/model.py``, ``mode='fp8'``): at each position the token it
ranks first, and that token's gap in the fp32 reference. It has to read
above the limit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import model, weights
from perfbench.reference.sizes import Sizes

# Router margins whose widest gaps a Mixtral control run also reports.
TIE_SCAN = (0.0, 0.01, 0.02, 0.05, 0.1)


@dataclasses.dataclass
class Verdict:
    correct: bool
    compared: Dict[str, Dict[str, float]]
    info: Dict[str, Any]


def sample(records, seed: int, min_tokens: int, max_requests: int):
    """The finished requests to check: the longest, then others in a
    seeded order until ``min_tokens`` served tokens or
    ``max_requests``."""
    done = [r for r in records if r.ok]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.req.prompt) + len(r.tokens))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([int(seed), 4]).permutation(len(rest))
    out, n = [longest], len(longest.tokens)
    for i in order:
        if n >= min_tokens or len(out) >= max_requests:
            break
        out.append(rest[int(i)])
        n += len(rest[int(i)].tokens)
    return out


def _gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    best = logits.max(-1).values
    return best - logits.gather(-1, tokens[:, None])[:, 0]


def _tie_aware(gaps: torch.Tensor, tokens: torch.Tensor,
               var: Optional[model.Variants], cut: float) -> torch.Tensor:
    """Each position's gap of ``tokens``: the least over the reference
    and its routing variants whose margins lie under ``cut``."""
    if var is None or var.logits.shape[0] == 0:
        return gaps
    use = var.margin < cut
    vg = _gaps(var.logits[use], tokens[var.position[use]])
    return gaps.scatter_reduce(0, var.position[use], vg, 'amin')


def judge(recs, s: Sizes, seed: int, device, limits: Dict[str, float],
          tie_margin: Optional[float] = None,
          control: bool = False) -> Verdict:
    """Run the reference over the sampled records and compare."""
    t0 = time.monotonic()
    if not recs:
        return Verdict(False, {'logit_gap': {'value': float('inf'),
                                             'limit': limits['logit_gap']}},
                       {'error': 'no finished request to check'})
    params = weights.make_params(s, seed, device)
    seqs = [list(r.req.prompt) + list(r.tokens[:-1]) for r in recs]
    starts = [len(r.req.prompt) - 1 for r in recs]
    served = torch.tensor([t for r in recs for t in r.tokens], device=device)
    # Calibration reads the widest gaps at several margins at once.
    scan = (list(TIE_SCAN)
            if control and s.is_moe and tie_margin is not None else [])
    gen = max([tie_margin] + scan) if tie_margin is not None else None
    ref, var = model.logits_at(params, s, seqs, starts, 'fp32',
                               tie_margin=gen)
    ref = torch.cat(ref)
    plain = _gaps(ref, served)
    cut = tie_margin if tie_margin is not None else 0.0
    gaps = _tie_aware(plain, served, var, cut)
    gap = float(gaps.max())
    info = {'requests': len(recs), 'positions': int(ref.shape[0]),
            'routing_variants': 0 if var is None else int(
                (var.margin < cut).sum()),
            'gap_without_variants': float(plain.max()),
            'served_not_ref_argmax': int((plain > 0).sum())}
    if control:
        low, _ = model.logits_at(params, s, seqs, starts, 'fp8')
        first = torch.cat(low).argmax(-1)
        del low
        cplain = _gaps(ref, first)
        info['control_gap'] = float(_tie_aware(cplain, first, var,
                                               cut).max())
        info['control_gap_without_variants'] = float(cplain.max())
        for c in scan:
            info[f'gap@{c}'] = float(_tie_aware(plain, served, var, c).max())
            info[f'control_gap@{c}'] = float(
                _tie_aware(cplain, first, var, c).max())
    del params, ref, var
    info['reference_s'] = time.monotonic() - t0
    compared = {'logit_gap': {'value': gap, 'limit': limits['logit_gap']}}
    return Verdict(gap <= limits['logit_gap'], compared, info)
