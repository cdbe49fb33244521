"""OpenAIPreprocessor: OpenAI request → PreprocessedRequest (token ids) —
the port's copy of dynamo_tpu/llm/preprocessor.py.

Reference parity: lib/llm/src/preprocessor.rs:131 (OpenAIPreprocessor as a
pipeline Operator), preprocessor/prompt/template/oai.rs (templating),
annotations `formatted_prompt`/`token_ids` (preprocessor.rs:66–68).
"""

from __future__ import annotations

import logging
from typing import Any, AsyncIterator, Dict, Optional, Union

from dynamo_tpu_torch.llm.chat_template import ChatTemplate
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest
from dynamo_tpu_torch.llm.protocols.openai import (
    OpenAIError,
    ParsedRequest,
    parse_chat_request,
    parse_completion_request,
)
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import AsyncEngine

logger = logging.getLogger(__name__)

ANNOTATION_FORMATTED_PROMPT = "formatted_prompt"
ANNOTATION_TOKEN_IDS = "token_ids"


class OpenAIPreprocessor:
    """Pipeline operator: validates, templates, tokenizes, defaults sampling.

    Emits annotation events (dicts with an ``annotation`` key) ahead of engine
    output when requested via nvext.annotations, matching the reference's
    SSE-comment annotations.
    """

    def __init__(
        self,
        card: ModelDeploymentCard,
        tokenizer: Tokenizer,
        chat_template: Optional[ChatTemplate] = None,
    ) -> None:
        self.card = card
        self.tokenizer = tokenizer
        self.chat_template = chat_template or ChatTemplate()

    # -- request conversion ------------------------------------------------

    def preprocess(self, request: Union[Dict[str, Any], ParsedRequest]) -> PreprocessedRequest:
        parsed = self._parse(request)
        media_urls: list = []
        if parsed.kind == "chat":
            messages = parsed.messages
            if any(isinstance(m.get("content"), list) for m in messages):
                # Content-parts form: extract image URLs for the encode
                # stage (ref: preprocessor/media extraction); the template
                # renders the text-only rewrite.
                from dynamo_tpu_torch.multimodal.handlers import extract_image_parts

                messages, media_urls = extract_image_parts(messages)
            prompt = self.chat_template.render(
                messages,
                add_generation_prompt=True,
                tools=parsed.tools,
            )
            token_ids = self.tokenizer.encode(prompt)
        else:
            prompt, token_ids = self._completion_prompt(parsed)

        max_context = self.card.context_length
        if len(token_ids) >= max_context:
            raise OpenAIError(
                f"prompt has {len(token_ids)} tokens which exceeds the model's "
                f"context length of {max_context}",
                status=400,
            )

        stop = parsed.stop
        if stop.max_tokens is None:
            stop.max_tokens = max_context - len(token_ids)
        else:
            stop.max_tokens = min(stop.max_tokens, max_context - len(token_ids))

        sampling = parsed.sampling
        if sampling.temperature is None:
            sampling.temperature = 1.0
        if sampling.top_p is None:
            sampling.top_p = 1.0

        pre = PreprocessedRequest(
            token_ids=token_ids,
            model=parsed.model,
            sampling=sampling,
            stop=stop,
            eos_token_ids=list(self.tokenizer.eos_token_ids or self.card.eos_token_ids),
            annotations=parsed.annotations,
            lora_name=parsed.lora_name,
        )
        if ANNOTATION_FORMATTED_PROMPT in parsed.annotations:
            pre.extra[ANNOTATION_FORMATTED_PROMPT] = prompt
        if media_urls:
            pre.extra["_mm_media"] = media_urls
        if isinstance(request, dict) and "_pinned_worker" in request:
            # Gateway pin (EPP header hint): survives preprocessing so the
            # request-plane KV picker can honor it (router.py attach).
            pre.extra["_pinned_worker"] = int(request["_pinned_worker"])
        return pre

    def _parse(self, request: Union[Dict[str, Any], ParsedRequest]) -> ParsedRequest:
        if isinstance(request, ParsedRequest):
            return request
        if "messages" in request:
            return parse_chat_request(request)
        return parse_completion_request(request)

    def _completion_prompt(self, parsed: ParsedRequest):
        prompt = parsed.prompt
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            return None, list(prompt)  # pre-tokenized
        if isinstance(prompt, list):
            if len(prompt) != 1:
                raise OpenAIError("batched prompts are not supported on this endpoint; send one prompt per request")
            prompt = prompt[0]
        text = str(prompt)
        bos = self.tokenizer.bos_token_id
        ids = self.tokenizer.encode(text)
        if bos is not None and (not ids or ids[0] != bos):
            ids = [bos] + ids
        return text, ids

    # -- operator ----------------------------------------------------------

    async def generate(
        self, request: Any, context: Context, next: AsyncEngine
    ) -> AsyncIterator[Any]:
        pre = self.preprocess(request)
        pre.request_id = context.id
        # Internal annotation consumed by the frontend for usage reporting
        # (never forwarded to clients).
        yield {"annotation": "_prompt_tokens", "value": len(pre.token_ids)}
        for annotation in pre.annotations:
            if annotation == ANNOTATION_FORMATTED_PROMPT and ANNOTATION_FORMATTED_PROMPT in pre.extra:
                yield {"annotation": ANNOTATION_FORMATTED_PROMPT, "value": pre.extra[ANNOTATION_FORMATTED_PROMPT]}
            elif annotation == ANNOTATION_TOKEN_IDS:
                yield {"annotation": ANNOTATION_TOKEN_IDS, "value": list(pre.token_ids)}
        async for item in next.generate(pre, context):
            yield item
