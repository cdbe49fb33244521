"""Pipeline assembly entrypoints — the port's copy of
dynamo_tpu/llm/entrypoint.py (the local pipeline; the routed one waits for
the distributed runtime).

Reference parity: lib/llm/src/entrypoint/input/common.rs:173
(build_routed_pipeline: SegmentSource → OpenAIPreprocessor → Backend →
Migration → Router) and entrypoint.rs EngineConfig. The local variant wires
an in-process engine; the routed variant (runtime/network + router tasks)
inserts Migration and a router client between Backend and the wire.
"""

from __future__ import annotations

from typing import Any, Optional

from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.chat_template import ChatTemplate
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.tokenizer import HFTokenizer, Tokenizer
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.pipeline import build_pipeline


def resolve_tokenizer(card: ModelDeploymentCard) -> Tokenizer:
    if card.model_path:
        return HFTokenizer.from_pretrained_dir(card.model_path)
    from dynamo_tpu_torch.llm.tokenizer import tiny_tokenizer

    return tiny_tokenizer()


def resolve_chat_template(card: ModelDeploymentCard) -> ChatTemplate:
    if card.chat_template_source:
        return ChatTemplate(card.chat_template_source)
    if card.model_path:
        return ChatTemplate.from_model_dir(card.model_path)
    return ChatTemplate()


def build_local_pipeline(
    card: ModelDeploymentCard,
    engine: Any,
    *,
    tokenizer: Optional[Tokenizer] = None,
) -> AsyncEngine:
    """OpenAI dict request → preprocess → detokenize → engine."""
    tokenizer = tokenizer or resolve_tokenizer(card)
    operators = [
        OpenAIPreprocessor(card, tokenizer, resolve_chat_template(card)),
        Backend(tokenizer),
    ]
    return build_pipeline(operators, engine)
