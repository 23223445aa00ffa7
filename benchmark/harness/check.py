"""The comparison that decides ``correct``.

Every answer of the window (a category's alpha [N, P] and X [N, D] on the
host) is checked for its shape, for finite values and for alpha rows that
are distributions.  The answers of the categories drawn from the seed
(``traffic.check_sample``), in every sweep of the window, are compared with
the plain reference's: ``alpha_gap`` and ``x_gap`` are the widest relative
gap of a row, max_i ||got_i - want_i|| / ||want_i||, over those answers.
Each number has its limit in ``limits/<cell>.json``.
"""

from __future__ import annotations

import numpy as np

GAPS = ("alpha_gap", "x_gap")


def row_gap(got: np.ndarray, want: np.ndarray) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    num = np.linalg.norm(got - want, axis=1)
    den = np.maximum(np.linalg.norm(want, axis=1), 1e-30)
    return float(np.max(num / den))


def answer_fault(alpha: np.ndarray, x: np.ndarray, n: int, p: int,
                 d: int) -> str | None:
    """Why an answer is malformed, or None."""
    if alpha.shape != (n, p) or x.shape != (n, d):
        return f"shapes {alpha.shape} {x.shape}, want ({n}, {p}) ({n}, {d})"
    if not (np.isfinite(alpha).all() and np.isfinite(x).all()):
        return "values not finite"
    if (alpha < 0).any() or np.abs(alpha.sum(axis=1) - 1.0).max() > 1e-3:
        return "alpha rows are not distributions"
    return None


def compare(answers: dict, reference: dict, limits: dict, bad: int,
            failed: int) -> tuple[dict, bool]:
    """({number: {"value", "limit"}}, correct).  ``answers``: {(sweep,
    category): (alpha, X)} of the drawn categories; ``reference``:
    {category: (alpha, X)}; ``bad``: malformed answers of the window;
    ``failed``: categories that raised."""
    gaps = dict.fromkeys(GAPS, 0.0)
    for (_, cat), (alpha, x) in answers.items():
        ra, rx = reference[cat]
        gaps["alpha_gap"] = max(gaps["alpha_gap"], row_gap(alpha, ra))
        gaps["x_gap"] = max(gaps["x_gap"], row_gap(x, rx))
    numbers = {name: {"value": gaps[name],
                      "limit": float(limits[name]["limit"])}
               for name in GAPS}
    numbers["bad_answers"] = {"value": bad, "limit": 0}
    numbers["failed"] = {"value": failed, "limit": 0}
    correct = (all(numbers[n]["value"] <= numbers[n]["limit"]
                   for n in (*GAPS, "bad_answers", "failed"))
               and len(answers) >= 1)
    return numbers, correct
