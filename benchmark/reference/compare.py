"""The numbers that decide ``correct`` for a training cell; a cell's limits
name the ones it compares.

A reading of a few train steps is ``{"losses": [{key: loss} per step],
"grad_norms": {leaf: norm of its gradient at the first step},
"change_norms": {leaf: norm of its change over the steps}}``, leaves named
``<net>.<parameter>``.  Against the reference's reading:

* ``loss_gap``: the largest relative gap of a loss, over steps and keys;
* ``grad_gap``: the largest gap between the two norms of a leaf's first
  gradient, over the larger of the reference's norm of that leaf and of
  its net's median leaf;
* ``change_gap``: the same of the change of the parameters, over the leaves
  whose reference gradient is at least a thousandth of its net's median
  leaf's (the others move under Adam by round-off alone).
"""

from __future__ import annotations

import statistics

EXEMPT_BELOW = 1e-3


def _by_net(norms: dict) -> dict:
    nets: dict = {}
    for leaf, v in norms.items():
        nets.setdefault(leaf.split(".", 1)[0], {})[leaf] = v
    return nets


def _leaf_gaps(got: dict, want: dict, leaves) -> list:
    leaves = list(leaves)
    if not leaves:
        return [0.0]
    med = statistics.median(want[k] for k in leaves)
    return [abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in leaves]


def _loss_gaps(got: list, want: list) -> list:
    return [max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12) for k in w)
            for g, w in zip(got, want)]


def train_gaps(got: dict, want: dict) -> dict:
    """The numbers above, and ``loss1_gap`` (the first step's losses alone),
    ``grad_gap_med`` and ``change_gap_med`` (the median leaf's gaps, the
    largest over the nets)."""
    losses = _loss_gaps(got["losses"], want["losses"])
    out = {"loss_gap": max(losses), "loss1_gap": losses[0],
           "grad_gap": 0.0, "change_gap": 0.0, "grad_gap_med": 0.0,
           "change_gap_med": 0.0}
    for net, norms in _by_net(want["grad_norms"]).items():
        med = statistics.median(norms.values())
        kept = [k for k, v in norms.items() if v >= EXEMPT_BELOW * med]
        for name, gaps in (
                ("grad", _leaf_gaps(got["grad_norms"], norms, norms)),
                ("change", _leaf_gaps(got["change_norms"],
                                      want["change_norms"], kept))):
            out[f"{name}_gap"] = max(out[f"{name}_gap"], max(gaps))
            out[f"{name}_gap_med"] = max(out[f"{name}_gap_med"],
                                         statistics.median(gaps))
    return out


def worst(got: dict, want: dict, k: int = 3) -> dict:
    """Where the numbers come from: each step's relative loss gaps, and
    the ``k`` leaves of the largest gradient and change gaps, each with
    the program's norm, the reference's and its net's median."""
    out = {"losses": [{key: abs(g[key] - w[key]) / max(abs(w[key]), 1e-12)
                       for key in w}
                      for g, w in zip(got["losses"], want["losses"])]}
    for part in ("grad_norms", "change_norms"):
        rows = []
        for net, norms in _by_net(want[part]).items():
            med = statistics.median(norms.values())
            for leaf, w in norms.items():
                g = got[part][leaf]
                rows.append((abs(g - w) / max(w, med, 1e-30), leaf, g, w, med))
        out[part] = sorted(rows, reverse=True)[:k]
    return out


def with_limits(numbers: dict, limits: dict) -> dict:
    """{name: (number, limit)} for each number the cell's limits name."""
    return {k: (float(numbers[k]), float(limits[k])) for k in limits}


def control_readings(got: dict, want: dict, others: dict) -> dict:
    """The numbers of the program (``got``) and of each of ``others``
    (reference readings put in its place) against ``want``, and of a step
    that leaves the state unchanged."""
    out = {"program": train_gaps(got, want),
           "program_worst": worst(got, want)}
    for name, reading in others.items():
        out[name] = train_gaps(reading, want)
    # the optimizer's state unchanged too: no first moment, no change
    out["unchanged"] = train_gaps(
        {**got, "grad_norms": {k: 0.0 for k in got["grad_norms"]},
         "change_norms": {k: 0.0 for k in got["change_norms"]}}, want)
    return out
