"""SLO invariants: tail latency as a crash code (the counterpart of
`madsim_tpu.harness.slo`).

The latency plane (cfg.latency_hist) measures; `slo_invariant(p99_le=...)`
enforces: it builds a `Runtime(invariant=)` callable over the lanes'
histogram leaves, so a lane whose request-latency quantile passes its
target crashes with `CRASH_SLO`, and search and minimisation inherit the
verdict. Installing one makes the latency plane part of that runtime's
replay domain (the crash code depends on lh_e2e); keep every lane's
latency recording on, since a `latency_lanes`-masked lane never folds
and its SLO can never fire.

The check is all-integer torch over the state's leaves, with no host
value and no host sync, so it runs inside a CUDA-graph capture
(`run_fused`) as it does in the eager step, and fires on the same
dispatch in every replay.
"""

from __future__ import annotations

import torch

from ..core import types as T
from ..parallel.stats import bucket_lower_edge

# quantile -> (numerator, denominator) so the threshold stays exact
# integer arithmetic: the q-th sample index is ceil(total * num / den)
_Q_RATIONAL = {"p50": (1, 2), "p90": (9, 10), "p99": (99, 100),
               "p999": (999, 1000)}

_I32 = torch.int32


def _hist_quantile_edge(hist: torch.Tensor, num: int, den: int):
    """Lower bucket edge (ticks) of the q = num/den quantile of each
    lane's [N, LB] int32 histogram, nodes folded, and the lane's sample
    count: (edge, total), int32 [B] each, every sum wrapping at 32 bits
    as the JAX package's int32 sums do. 0 where the histogram is
    empty."""
    counts = hist.sum(1).to(_I32)                        # [B, LB]
    total = counts.sum(-1).to(_I32)                      # [B]
    cdf = torch.cumsum(counts, -1).to(_I32)
    need = torch.clamp((total * num + (den - 1)) // den, min=1)
    # argmax refuses bool: the first bucket whose cdf reaches `need`
    b = torch.argmax((cdf >= need[:, None]).to(_I32), -1).to(_I32)
    return torch.where(total > 0, bucket_lower_edge(b), 0), total


def slo_invariant(p99_le: int | None = None, *, q: str = "p99",
                  target: int | None = None, sojourn: bool = False,
                  min_count: int = 1, code: int = T.CRASH_SLO):
    """Build a `Runtime(invariant=)` callable that crashes a lane when its
    request-latency quantile exceeds a target.

    Args:
      p99_le: crash when the lane's end-to-end p99 estimate exceeds this
        many ticks (q="p99", target=p99_le).
      q / target: any of p50/p90/p99/p999 against `target` ticks.
      sojourn: check the queue-wait histogram (lh_sojourn) instead of the
        end-to-end one (lh_e2e).
      min_count: fire only once the lane folded this many samples.
      code: the crash code reported (default CRASH_SLO).

    The estimate is the bucket-CDF lower bound: a firing invariant means
    the bucketed quantile really exceeds the target. Requires
    cfg.latency_hist > 0 (raises at the first step otherwise) and, for the
    e2e form, cfg.complete_kinds.
    """
    if p99_le is not None:
        q, target = "p99", p99_le
    if target is None:
        raise ValueError("slo_invariant needs p99_le= or (q=, target=)")
    if q not in _Q_RATIONAL:
        raise ValueError(f"q must be one of {sorted(_Q_RATIONAL)}: {q!r}")
    num, den = _Q_RATIONAL[q]
    target = int(target)
    min_count = int(min_count)
    field = "lh_sojourn" if sojourn else "lh_e2e"

    def check(state):
        hist = getattr(state, field)
        if hist.shape[-2] == 0 or hist.shape[-1] == 0:
            raise ValueError(
                "slo_invariant needs the latency plane compiled in — "
                "set SimConfig(latency_hist=...) > 0"
                + ("" if sojourn else
                   " and declare complete_kinds (no completions = the "
                   "e2e histogram never fills)"))
        edge, total = _hist_quantile_edge(hist, num, den)
        bad = (total >= min_count) & (edge > target)
        return bad, torch.full_like(total, code)

    return check
