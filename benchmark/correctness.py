"""The comparison that decides ``correct`` for a training cell.

Both sides give the same readings of the first steps (the program's in
its set-up, through the very step object that the window then drives;
the reference's by :func:`reference.train.follow`). Three numbers are
compared, each with a limit that the cell's file states:

- ``loss``: the largest gap between the two sides' loss at a step, over
  the reference's loss;
- ``grad``: the first gradient, by the worst tensor: the gap between the
  two sides' norms of it, over the reference's norm of that tensor or of
  the median tensor, whichever is larger;
- ``change``: the parameters' change after the followed steps, taken the
  same way, over the tensors whose reference gradient is not nought to
  rounding (at some step at least a thousandth of the median tensor's:
  a key's bias under softmax moves by round-off alone).
"""

from __future__ import annotations

import statistics

NOUGHT = 1e-3


def _gap(p: float, r: float, scale: float) -> float:
    """|p - r| / scale, and infinity where either side is not finite."""
    g = abs(p - r) / max(scale, 1e-30)
    return g if g < float("inf") else float("inf")


def _worst(prog: dict, ref: dict, names) -> float:
    names = list(names)
    if any(n not in prog for n in names):
        return float("inf")
    med = statistics.median(ref[n] for n in names)
    return max((_gap(prog[n], ref[n], max(ref[n], med)) for n in names),
               default=0.0)


def moved(ref: dict) -> list[str]:
    """The tensors whose reference gradient is not nought to rounding."""
    peak = {n: max(step[n] for step in ref["grad_norms"])
            for n in ref["grad_norms"][0]}
    med = statistics.median(peak.values())
    return [n for n, g in peak.items() if g >= NOUGHT * med]


def gaps(prog: dict, ref: dict) -> dict:
    if len(prog["loss"]) != len(ref["loss"]):
        raise ValueError("the two sides followed different step counts")
    loss = max(_gap(p, r, abs(r)) for p, r in zip(prog["loss"], ref["loss"]))
    return {"loss": loss,
            "grad": _worst(prog["grad1"], ref["grad1"], ref["grad1"]),
            "change": _worst(prog["change"], ref["change"], moved(ref))}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
