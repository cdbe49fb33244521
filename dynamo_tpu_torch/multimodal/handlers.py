"""``extract_image_parts`` — the port's copy of the function in
dynamo_tpu/multimodal/handlers.py:83-107 (that module imports jax for its
encoder; this one holds only the message split)."""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


def extract_image_parts(messages: List[Dict[str, Any]]) -> Tuple[List[Dict[str, Any]], List[str]]:
    """Split OpenAI chat messages into (text-only messages, image URLs).

    Handles the standard content-parts form:
    ``{"type": "image_url", "image_url": {"url": ...}}`` mixed with text
    parts (ref: preprocessor media extraction).
    """
    urls: List[str] = []
    out: List[Dict[str, Any]] = []
    for msg in messages:
        content = msg.get("content")
        if not isinstance(content, list):
            out.append(msg)
            continue
        texts: List[str] = []
        for part in content:
            kind = part.get("type")
            if kind == "image_url":
                url = (part.get("image_url") or {}).get("url", "")
                urls.append(url)
                texts.append("<image>")
            elif kind == "text":
                texts.append(part.get("text", ""))
        out.append({**msg, "content": " ".join(texts)})
    return out, urls
