"""Traffic kind ``greedy_decode``: kind ``decode`` at one beam, whose check
also holds every served token to its row's best.

The requests, the window and the reference's reading are ``kinds/
decode.py``'s. At one beam, ``token_gap`` reads a token within its row's
two best as 0 at every position but the last, so a search that served the
second-best token throughout would pass it. A greedy token is its row's
best at every position, but for rounding flips of a few hundredths: this
kind adds ``non_greedy_share``, the share of the checked hypotheses that
lie ``reference/decode.py::DETOUR`` or more below their row's best at some
position before the last (1 - ``greedy_share``).
"""

from __future__ import annotations

from benchmark.kinds import decode
from benchmark.lib.harness import Outcome, Run


def run(r: Run) -> Outcome:
    if r.traffic["num_beams"] != 1:
        raise ValueError("a greedy_decode mix serves one beam")
    out = decode.run(r)
    out.numbers["non_greedy_share"] = 1.0 - out.numbers["greedy_share"]
    return out
