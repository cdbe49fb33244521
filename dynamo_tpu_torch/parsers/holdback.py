"""Suffix-holdback for markers straddling streaming delta boundaries —
the port's copy of dynamo_tpu/parsers/holdback.py.

Every streaming parser in this package (the reasoning splitter, the
tool-call jail's dialect detector, and the per-dialect machines in
parsers/incremental.py) faces the same problem: a marker like
``</tool_call>`` or ``<|channel|>`` can arrive split across two deltas,
so the longest suffix of the visible text that is a prefix of any marker
must be held back one delta instead of emitted. Two hand-rolled copies
of that scheme (jail.py + reasoning.py) had already started to drift;
this module is the single implementation both import.

Semantics:
  * ``find_first(text, markers)`` — earliest complete occurrence of any
    marker (ties broken by position, then by the order markers are
    given), as ``(index, marker)`` or ``(-1, "")``.
  * ``holdback_split(text, markers)`` — ``(emit, hold)`` where ``hold``
    is the longest suffix of ``text`` that is a proper prefix of at
    least one marker (and therefore might complete into that marker on
    the next delta). ``emit + hold == text`` always; a text containing a
    COMPLETE marker is the caller's case to handle first (call
    ``find_first`` before ``holdback_split``).
"""

from __future__ import annotations

from typing import Sequence, Tuple


def find_first(
    text: str, markers: Sequence[str], start: int = 0
) -> Tuple[int, str]:
    """Earliest complete occurrence of any marker → (index, marker), or
    (-1, "") when none occurs."""
    best, best_m = -1, ""
    for m in markers:
        i = text.find(m, start)
        if i != -1 and (best == -1 or i < best):
            best, best_m = i, m
    return best, best_m


def holdback_split(
    text: str, markers: Sequence[str]
) -> Tuple[str, str]:
    """Split ``text`` into ``(emit, hold)``: ``hold`` is the longest
    suffix that is a proper prefix of any marker. Assumes no COMPLETE
    marker occurs in ``text`` (handle that with ``find_first`` first —
    this function only guards the boundary-straddle case)."""
    if not text or not markers:
        return text, ""
    max_n = min(max(len(m) for m in markers) - 1, len(text))
    for n in range(max_n, 0, -1):
        tail = text[-n:]
        for m in markers:
            if m.startswith(tail):
                return text[:-n], tail
    return text, ""
