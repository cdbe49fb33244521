"""The port's chat template (dynamo_tpu_torch/llm/chat_template.py) against
the JAX package's jinja2 render: the default ChatML, rendered without
jinja2, must equal ``dynamo_tpu.llm.chat_template.ChatTemplate().render``
character for character (hypothesis over roles, contents with braces,
newlines and template syntax, None, text-part arrays and
add_generation_prompt); a custom template from a model directory (inline
tokenizer_config.json string, its list form, chat_template.jinja) renders
through jinja2 as JAX's does; with jinja2 blocked a custom template raises
ImportError instead of rendering ChatML."""

import json
import sys

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu.llm.chat_template import ChatTemplate as JChatTemplate
from dynamo_tpu_torch.llm import chat_template as tchat

ROLES = ["system", "user", "assistant", "tool", "developer"]
TEXT = st.lists(st.sampled_from(list("ab {}%#<|>\n\t'\"\\é世😀") + [
    "{{", "{%", "%}", "}}", "<|im_end|>"]), max_size=30).map("".join)
CONTENT = st.one_of(
    st.none(),
    TEXT,
    st.lists(st.one_of(
        st.fixed_dictionaries({"type": st.just("text"), "text": TEXT}),
        st.fixed_dictionaries({"type": st.just("image_url"),
                               "image_url": st.just({"url": "http://x"})}),
        st.just({"type": "text"}),
    ), max_size=4),
)
MESSAGES = st.lists(st.fixed_dictionaries({"role": st.sampled_from(ROLES), "content": CONTENT}),
                    max_size=6)


@settings(max_examples=300, deadline=None, derandomize=True, database=None,
          suppress_health_check=list(HealthCheck))
@given(MESSAGES, st.booleans())
def test_default_chatml_equals_jinja_render(messages, add_generation_prompt):
    want = JChatTemplate().render(messages, add_generation_prompt=add_generation_prompt)
    got = tchat.ChatTemplate().render(messages, add_generation_prompt=add_generation_prompt)
    assert got == want


def test_default_template_renders_without_jinja2(monkeypatch):
    monkeypatch.setitem(sys.modules, "jinja2", None)  # import jinja2 now raises
    tpl = tchat.ChatTemplate()
    assert tpl.render([{"role": "user", "content": "hi"}]) == \
        "<|im_start|>user\nhi<|im_end|>\n<|im_start|>assistant\n"


CUSTOM = ("{{ bos_token }}{% for m in messages %}[{{ m['role'] | upper }}] {{ m['content'] }}\n"
          "{% endfor %}{% if tools %}{{ tools | tojson }}{% endif %}"
          "{% if add_generation_prompt %}[ASSISTANT]{% endif %}")
RAISING = "{% if messages[0]['role'] != 'user' %}{{ raise_exception('user first') }}{% endif %}ok"


def _model_dir(tmp_path, source, template):
    if source == "config string":
        (tmp_path / "tokenizer_config.json").write_text(json.dumps({"chat_template": template}))
    elif source == "config list":
        (tmp_path / "tokenizer_config.json").write_text(json.dumps({"chat_template": [
            {"name": "tool_use", "template": "unused"},
            {"name": "default", "template": template}]}))
    elif source == "config list, no default":
        (tmp_path / "tokenizer_config.json").write_text(json.dumps({"chat_template": [
            {"name": "first", "template": template}]}))
    elif source == "jinja file":
        (tmp_path / "tokenizer_config.json").write_text("{not json")
        (tmp_path / "chat_template.jinja").write_text(template)
    return str(tmp_path)


SOURCES = ["config string", "config list", "config list, no default", "jinja file", "none"]


@pytest.mark.parametrize("source", SOURCES)
def test_template_from_model_dir_matches_jax(tmp_path, source):
    path = _model_dir(tmp_path, source, CUSTOM)
    messages = [{"role": "system", "content": None}, {"role": "user", "content": "hi {x}"},
                {"role": "assistant", "content": [{"type": "text", "text": "a"},
                                                  {"type": "text", "text": "b"}]}]
    for kw in ({}, {"add_generation_prompt": False, "bos_token": "<s>",
                    "tools": [{"name": "f"}]}):
        want = JChatTemplate.from_model_dir(path).render(messages, **kw)
        got = tchat.ChatTemplate.from_model_dir(path).render(messages, **kw)
        assert got == want
    assert (tchat.ChatTemplate.from_model_dir(path).source
            == JChatTemplate.from_model_dir(path).source)


def test_custom_template_raise_exception_matches_jax():
    import jinja2

    for tpl in (JChatTemplate(RAISING), tchat.ChatTemplate(RAISING)):
        assert tpl.render([{"role": "user", "content": "x"}]) == "ok"
        with pytest.raises(jinja2.TemplateError, match="user first"):
            tpl.render([{"role": "system", "content": "x"}])


@pytest.mark.parametrize("source", SOURCES[:4])
def test_custom_template_without_jinja2_raises(tmp_path, monkeypatch, source):
    path = _model_dir(tmp_path, source, CUSTOM)
    monkeypatch.setitem(sys.modules, "jinja2", None)
    with pytest.raises(ImportError, match="jinja2"):
        tchat.ChatTemplate.from_model_dir(path)
    with pytest.raises(ImportError, match="jinja2"):
        tchat.ChatTemplate(CUSTOM)
    # the default template still renders
    assert tchat.ChatTemplate.from_model_dir(str(tmp_path / "absent")).source == \
        tchat.DEFAULT_CHAT_TEMPLATE
