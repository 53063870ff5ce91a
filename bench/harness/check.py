"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests finished in the window, drawn from the seed and holding the
one with the most served tokens, is run through the family's plain
reference (float32, TF32 off) over its prompt and served tokens, as the
admission that served it padded and routed it.  At the position of each
served token the gap between the reference's best logit and the served
token's is read.  Greedy decoding serves the argmax, so a sound program
reads only its rounding.  Two numbers are compared: the mean gap over
every judged position, and the worst request's own mean gap, which a
fault confined to one slot or one request raises.

Also compared, exactly: finished requests whose token count is not their
budget (no end token is set), requests that failed before the close, and
that enough tokens were judged.

``control=True`` also judges the control, the reference in float8 (e4m3,
a scale per row of each operand) put in the program's place: at each
judged position, the gap of its first choice under the reference, held
to the same limits by the same ``passed``.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List

import numpy as np
import torch

from harness import catalog, traffic
from harness.loop import Rec
from reference import common


def admission_plens(recs: List[Rec]) -> Dict[int, int]:
    """The padded length of each admission prefill: the bucket of the
    longest prompt among the requests whose first token it gave."""
    longest: Dict[int, int] = {}
    for q in recs:
        if q.first_boundary is not None:
            longest[q.first_boundary] = max(longest.get(q.first_boundary, 0),
                                            q.n_prompt)
    return {k: traffic.bucket(n) for k, n in longest.items()}


def sample(done: List[Rec], n: int, seed: int) -> List[Rec]:
    """The request with the most served tokens, and ``n - 1`` others drawn
    from the seed."""
    if not done:
        return []
    done = sorted(done, key=lambda q: q.spec.index)
    top = max(done, key=lambda q: (len(q.tokens), q.n_prompt))
    rest = [q for q in done if q is not top]
    digest = hashlib.sha256(f"sample/{int(seed)}".encode()).digest()
    rng = np.random.default_rng(int.from_bytes(digest[:8], "big"))
    picks = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [top] + [rest[i] for i in sorted(picks)]


def judge(cfg: dict, check: dict, weights: Dict[str, torch.Tensor],
          recs: List[Rec], t0: float, t1: float, seed: int,
          failed: int, control: bool = False):
    """``({name: {"value", "limit"}}`` of every number compared, the gap
    statistics of the program and of the control, the control's gap
    numbers beside the same limits (None without it))``."""
    done = [q for q in recs if q.reason is not None
            and q.t_done is not None and t0 <= q.t_done < t1]
    short = sum(len(q.tokens) != q.spec.max_new for q in done)
    picked = sample(done, int(check["sample"]), seed)
    plens = admission_plens(recs)
    ref = catalog.reference(cfg["family"])
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gaps, ctl = [], []
    try:
        with torch.no_grad():
            for q in picked:
                served = torch.tensor(q.tokens, device=weights[
                    "embedding"].device)
                plen = plens[q.first_boundary]
                lg = ref.logits(cfg, weights, q.spec.prompt, q.tokens, plen)
                best = lg.max(-1).values
                gaps.append(best - lg.gather(1, served[:, None])[:, 0])
                if control:
                    cl = ref.logits(cfg, weights, q.spec.prompt, q.tokens,
                                    plen, quant=common.fp8)
                    pick = cl.argmax(-1)
                    ctl.append(best - lg.gather(1, pick[:, None])[:, 0])
                    del cl
                del lg
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
    program = gap_checks(gaps, check)
    program.update({
        "short_answers": {"value": short, "limit": 0},
        "failed_requests": {"value": failed, "limit": 0},
        "judged_tokens": {"value": stats(gaps)["n"],
                          "limit": int(check["min_tokens"]),
                          "at_least": True},
    })
    gap_stats = {"program": stats(gaps),
                 "control": stats(ctl) if control else None}
    return program, gap_stats, gap_checks(ctl, check) if control else None


def gap_checks(gaps: List[torch.Tensor], check: dict) -> Dict[str, dict]:
    """The two gap numbers compared, each beside its limit: the mean over
    every judged position, and the largest of the requests' own means."""
    worst = max((float(g.double().mean()) for g in gaps if g.numel()),
                default=float("inf"))
    return {
        "mean_logit_gap": {"value": stats(gaps)["mean"],
                           "limit": float(check["mean_logit_gap"])},
        "worst_request_gap": {"value": worst,
                              "limit": float(check["worst_request_gap"])},
    }


def stats(gaps: List[torch.Tensor]) -> dict:
    """Widest, mean and 99th percentile of the gaps, the share of
    positions whose token is not the reference's first, and the count."""
    if not gaps:
        return {"n": 0, "max": float("inf"), "mean": float("inf"),
                "p99": float("inf"), "mismatch": 1.0}
    g = torch.cat(gaps).double()
    return {"n": int(g.numel()), "max": float(g.max()),
            "mean": float(g.mean()), "p99": float(torch.quantile(g, 0.99)),
            "mismatch": float((g > 0).double().mean())}


def passed(checks: Dict[str, dict]) -> bool:
    """Every number within its limit."""
    ok = True
    for c in checks.values():
        if c.get("at_least"):
            ok &= c["value"] >= c["limit"]
        else:
            ok &= c["value"] <= c["limit"]
    return bool(ok)
