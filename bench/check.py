"""The comparison that decides ``correct``: the numbers compared between
the program's outputs and the plain reference's, each against the
cell's limit (``cells/<cell>.json``'s ``limits``).

Training (a step's state and its first steps' readings): each step's
loss as a relative gap; every leaf's first gradient norm and every
leaf's change after the followed steps, each as the gap between the
program's norm and the reference's over the larger of the reference's
norm of that leaf and of the median leaf, taken at the worst leaf.  A
leaf whose reference gradient is under a thousandth of the median
leaf's moves by round-off alone and is left out of the change.  And the
output head's whole first gradient as a relative L2 distance: no
estimator samples the head, and its gradient reads the forward alone,
so it separates a lower precision from the stated one where the norms,
which a sampled plan that differs in a row also moves, do not.

Prefill (every prompt of the last call in the window): the last
position's logits and each attention layer's K and V, each as the
relative L2 distance to the reference's, taken at the worst prompt and
layer.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

# leaves whose reference gradient is under this share of the median
# leaf's take no part in the change
STILL = 1e-3


def _worst(prog: Dict[str, float], ref: Dict[str, float], keep
           ) -> Tuple[float, str]:
    names = [n for n in ref if keep(n)]
    med = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def head_leaf(conf: Dict) -> str:
    """The output head's leaf: the embedding where the two are tied."""
    return "embed" if conf["tie_embeddings"] else "head"


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """{loss_gap, grad_gap, change_gap, head_grad_gap} and the worst
    leaves' names."""
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    g_ref = ref["grad_norms"]
    med = statistics.median(g_ref.values())
    moving = {n for n, g in g_ref.items() if g >= STILL * med}
    grad_gap, grad_leaf = _worst(prog["grad_norms"], g_ref, lambda n: True)
    change_gap, change_leaf = _worst(prog["change_norms"],
                                     ref["change_norms"],
                                     lambda n: n in moving)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap,
            "head_grad_gap": rel(prog["head_grad"], ref["head_grad"]),
            "grad_leaf": grad_leaf,
            "change_leaf": change_leaf,
            "still_leaves": sorted(set(g_ref) - moving)}


def rel(got, want) -> float:
    """Relative L2 distance of ``got`` to ``want`` (float32)."""
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]], List[str]]:
    """(correct, {name: {value, limit}}, the lines to print): every
    limited number at or under its limit.  A number that is not finite
    fails."""
    out, lines, ok = {}, [], True
    for name, limit in limits.items():
        value = float(numbers[name])
        good = value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
        lines.append(f"check {name} {value!r} limit {limit!r} "
                     f"{'ok' if good else 'FAIL'}")
    for key in ("grad_leaf", "change_leaf"):
        if key in numbers:
            lines.append(f"check {key} {numbers[key]}")
    return ok, out, lines
