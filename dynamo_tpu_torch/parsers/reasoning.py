"""Reasoning-content extraction (<think> ... </think> and friends) — the
port's copy of dynamo_tpu/parsers/reasoning.py.

Reference parity: lib/parsers/src/reasoning/{base_parser,gpt_oss_parser,
granite_parser}.rs — split generated text into `reasoning_content` and
`content`. The streaming parser is a small state machine that survives tags
straddling delta boundaries. Styles may have several equivalent marker
spellings (granite emits prose markers in two variants each).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

from dynamo_tpu_torch.parsers.holdback import find_first as _find_first
from dynamo_tpu_torch.parsers.holdback import holdback_split

# style → (open-tag variants, close-tag variants). The first variant is the
# canonical spelling; all variants are recognized on input.
KNOWN_MARKERS = {
    "think": (("<think>",), ("</think>",)),
    "reasoning": (("<reasoning>",), ("</reasoning>",)),
    "seed": (("<seed:think>",), ("</seed:think>",)),
    # ref: granite_parser.rs:19-23 — prose markers, two spellings each.
    "granite": (
        ("Here's my thought process:", "Here is my thought process:"),
        ("Here's my response:", "Here is my response:"),
    ),
}

# Backwards-compatible view for single-tag styles.
KNOWN_TAGS = {
    style: (opens[0], closes[0])
    for style, (opens, closes) in KNOWN_MARKERS.items()
}


def split_reasoning(text: str, style: str = "think") -> Tuple[str, str]:
    """One-shot split of a complete response → (reasoning, content)."""
    opens, closes = KNOWN_MARKERS[style]
    start, open_tag = _find_first(text, opens)
    if start == -1:
        # Some models emit the close tag only (reasoning-first templates).
        end_only, close_tag = _find_first(text, closes)
        if end_only != -1:
            return (
                text[:end_only].strip(),
                text[end_only + len(close_tag):].lstrip(),
            )
        return "", text
    end, close_tag = _find_first(text, closes, start)
    if end == -1:
        return text[start + len(open_tag):].strip(), ""
    reasoning = text[start + len(open_tag): end].strip()
    content = (text[:start] + text[end + len(close_tag):]).lstrip()
    return reasoning, content


@dataclass
class _State:
    mode: str = "content"  # content | reasoning
    buffer: str = ""  # held-back text that may be a partial tag


class ReasoningParser:
    """Streaming splitter: feed text deltas, get (reasoning_delta,
    content_delta) pairs. Holds back a suffix that could be a partial tag."""

    def __init__(self, style: str = "think", starts_in_reasoning: bool = False) -> None:
        self.open_tags, self.close_tags = KNOWN_MARKERS[style]
        self._s = _State(mode="reasoning" if starts_in_reasoning else "content")

    def _active_tags(self) -> Sequence[str]:
        return self.close_tags if self._s.mode == "reasoning" else self.open_tags

    def feed(self, delta: str) -> Tuple[str, str]:
        reasoning_out = []
        content_out = []
        text = self._s.buffer + delta
        self._s.buffer = ""
        while text:
            tags = self._active_tags()
            idx, tag = _find_first(text, tags)
            if idx != -1:
                emitted, text = text[:idx], text[idx + len(tag):]
                if self._s.mode == "reasoning":
                    reasoning_out.append(emitted)
                    self._s.mode = "content"
                else:
                    content_out.append(emitted)
                    self._s.mode = "reasoning"
                continue
            # No full tag: hold back the longest suffix that is a prefix of
            # any tag variant we're looking for (parsers/holdback.py — the
            # same scheme the tool-call jail uses).
            emit, self._s.buffer = holdback_split(text, tags)
            (reasoning_out if self._s.mode == "reasoning" else content_out).append(emit)
            break
        return "".join(reasoning_out), "".join(content_out)

    def flush(self) -> Tuple[str, str]:
        """End of stream: release any held-back partial tag as-is."""
        tail = self._s.buffer
        self._s.buffer = ""
        if not tail:
            return "", ""
        if self._s.mode == "reasoning":
            return tail, ""
        return "", tail
