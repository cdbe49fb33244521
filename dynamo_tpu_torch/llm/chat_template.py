"""Chat-template rendering — the port's counterpart of
dynamo_tpu/llm/chat_template.py.

Reference parity: lib/llm/src/preprocessor/prompt/template/oai.rs (minijinja
rendering of HF chat templates). Templates come from the model directory's
tokenizer_config.json (``chat_template``) or fall back to ChatML.

The card's machine has no ``jinja2``. The default ChatML template is
rendered by a plain function whose output is the jinja2 render's, character
for character. Any other template renders through ``jinja2`` with the JAX
package's environment, imported when the template is made: without
``jinja2`` making one raises ``ImportError``; it never renders ChatML in its
place.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional

# ChatML (Qwen-style) default — the most common open-model convention.
DEFAULT_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "{{ '<|im_start|>' + message['role'] + '\n' + message['content'] + '<|im_end|>' + '\n' }}"
    "{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|im_start|>assistant\n' }}{% endif %}"
)


def render_chatml(messages: List[Dict[str, Any]], add_generation_prompt: bool = False,
                  **_: Any) -> str:
    """DEFAULT_CHAT_TEMPLATE without jinja2: each message as
    ``<|im_start|>{role}\\n{content}<|im_end|>\\n``, then the assistant's
    header when asked."""
    out = [
        "<|im_start|>" + message["role"] + "\n" + message["content"] + "<|im_end|>" + "\n"
        for message in messages
    ]
    if add_generation_prompt:
        out.append("<|im_start|>assistant\n")
    return "".join(out)


def _jinja_renderer(template: str) -> Callable[..., str]:
    try:
        import jinja2
    except ImportError as exc:
        raise ImportError(
            "a chat template other than the default ChatML needs jinja2, which is not "
            "installed"
        ) from exc

    def raise_exception(message: str) -> None:
        raise jinja2.TemplateError(message)

    env = jinja2.Environment(
        loader=jinja2.BaseLoader(),
        trim_blocks=True,
        lstrip_blocks=True,
        # HF templates use .items() etc.: a plain environment, since
        # templates come from trusted local model dirs.
    )
    env.globals["raise_exception"] = raise_exception
    env.filters["tojson"] = lambda value, **kw: json.dumps(value, **kw)
    return env.from_string(template).render


class ChatTemplate:
    def __init__(self, template: str = DEFAULT_CHAT_TEMPLATE) -> None:
        self.source = template
        self._render = (render_chatml if template == DEFAULT_CHAT_TEMPLATE
                        else _jinja_renderer(template))

    @classmethod
    def from_model_dir(cls, model_dir: str) -> "ChatTemplate":
        path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(path):
            try:
                with open(path) as f:
                    cfg = json.load(f)
                tpl = cfg.get("chat_template")
                if isinstance(tpl, list):
                    # Newer HF format: [{"name": "default", "template": ...}]
                    for entry in tpl:
                        if entry.get("name") == "default":
                            tpl = entry.get("template")
                            break
                    else:
                        tpl = tpl[0].get("template") if tpl else None
                if isinstance(tpl, str) and tpl:
                    return cls(tpl)
            except (OSError, json.JSONDecodeError):
                pass
        chat_path = os.path.join(model_dir, "chat_template.jinja")
        if os.path.exists(chat_path):
            with open(chat_path) as f:
                return cls(f.read())
        return cls()

    def render(
        self,
        messages: List[Dict[str, Any]],
        *,
        add_generation_prompt: bool = True,
        tools: Optional[List[Dict[str, Any]]] = None,
        bos_token: str = "",
        eos_token: str = "",
        **extra: Any,
    ) -> str:
        # Flatten OpenAI content-part arrays to text (multimodal parts are
        # handled upstream by the media preprocessor).
        normalized = []
        for msg in messages:
            msg = dict(msg)
            content = msg.get("content")
            if isinstance(content, list):
                msg["content"] = "".join(
                    part.get("text", "") for part in content if part.get("type") == "text"
                )
            elif content is None:
                msg["content"] = ""
            normalized.append(msg)
        return self._render(
            messages=normalized,
            add_generation_prompt=add_generation_prompt,
            tools=tools,
            bos_token=bos_token,
            eos_token=eos_token,
            **extra,
        )
