"""The port's tokenizer (dynamo_tpu_torch/llm/bpe.py behind
llm/tokenizer.HFTokenizer) against HuggingFace ``tokenizers`` on three
tokenizer.json files made here: the JAX package's tiny tokenizer, a
Qwen2-style one (NFC, Split with Qwen2's \\p{L}/\\p{N} pattern, ByteLevel
without its regex; added tokens with every flag) and a Llama-3-style one
(\\p{N}{1,3}, ignore_merges, a TemplateProcessing post-processor). Encode
ids, decoded text, vocab_size, token_to_id, eos/bos from a model directory
and DecodeStream deltas must be equal — exactly — on hypothesis-drawn text
over ASCII, CJK, emoji, combining marks, runs of \\r\\n, spaces and digits
and added tokens inside the text. Text is drawn from characters that
Python's Unicode tables and the Rust crate's classify alike. Every form the
port does not read raises ValueError."""

import copy
import json
import os
import string

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import AddedToken, Regex, Tokenizer, decoders, models, normalizers, \
    pre_tokenizers, processors, trainers

from dynamo_tpu.llm import tokenizer as jtok
from dynamo_tpu_torch.llm import bpe
from dynamo_tpu_torch.llm import tokenizer as ttok

QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                 r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

CORPUS = [
    "the quick brown fox jumps over the lazy dog 12345 and 67890",
    "Hello World! I'm here, you're there; we've done it, they'll see, she'd go.",
    "Über café naïve résumé Ærøskøbing straße — déjà vu",
    "世界你好 中文字符 日本語のテキスト 한국어 텍스트",
    "Привет мир Ελληνικά κείμενο مرحبا بالعالم नमस्ते दुनिया",
    "emoji 😀🚀👍🏽 tabs\tand\r\nnewlines\n\n  spaces   here 3.14159 1,000,000",
    "fields\x1c\x1c  \x1cseparated  \x1f by\x85 controls",
    "def f(x):\n    return x ** 2  # comment\r\n",
] * 3

SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]


def _tiny_json():
    return jtok.tiny_tokenizer()._tok.to_str()


def _train(pre, normalizer=None, vocab_size=700):
    tok = Tokenizer(models.BPE(unk_token=None))
    if normalizer is not None:
        tok.normalizer = normalizer
    tok.pre_tokenizer = pre
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=SPECIALS,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                                  show_progress=False)
    tok.train_from_iterator(CORPUS, trainer=trainer)
    return tok


def _qwen2_json():
    tok = _train(pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_PATTERN), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ]), normalizer=normalizers.NFC())
    tok.add_special_tokens([AddedToken("[MASK]", lstrip=True, rstrip=True, special=True)])
    tok.add_tokens([
        AddedToken("<tool_call>", special=False, normalized=False),
        AddedToken("hello", single_word=True, special=False, normalized=True),
        AddedToken("café", special=False, normalized=True),
        AddedToken("世界", special=False, normalized=False),
        AddedToken("<think>", special=False, normalized=False, lstrip=True),
    ])
    return tok.to_str()


def _llama3_json():
    tok = _train(pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_PATTERN), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=True, use_regex=False),
    ]))
    tok.add_special_tokens(["<|begin_of_text|>"])
    bos = tok.token_to_id("<|begin_of_text|>")
    # Llama-3's own tokenizer.json chains ByteLevel and the template
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(single="<|begin_of_text|> $A",
                                      special_tokens=[("<|begin_of_text|>", bos)])])
    spec = json.loads(tok.to_str())
    model = spec["model"]
    model["ignore_merges"] = True
    # whole words the merges would split: ignore_merges takes them as one id
    top = max(model["vocab"].values())
    for k, word in enumerate(["ĠXylophonez", "quickbrown", "123"]):
        model["vocab"].setdefault(word, top + 1 + k)
    # the added tokens that are not in the vocabulary follow it
    n = len(model["vocab"])
    for t in spec["added_tokens"]:
        if t["content"] not in model["vocab"]:
            t["id"], n = n, n + 1
    spec["post_processor"]["processors"][1]["special_tokens"]["<|begin_of_text|>"]["ids"] = [
        next(t["id"] for t in spec["added_tokens"] if t["content"] == "<|begin_of_text|>")]
    return json.dumps(spec)


@pytest.fixture(scope="module", params=["tiny", "qwen2", "llama3"])
def pair(request):
    text = {"tiny": _tiny_json, "qwen2": _qwen2_json, "llama3": _llama3_json}[request.param]()
    return request.param, Tokenizer.from_str(text), bpe.BpeTokenizer.from_str(text)


def _added(tok):
    return [t.content for t in tok.get_added_tokens_decoder().values()]


ALPHABET = list(string.ascii_letters + string.digits + string.punctuation) + [
    " ", "  ", "\t", "\n", "\r\n", "\r\n\r\n", "\r", "\x0b", "\x0c", "\x85", "\x1c", "\x1f",
    "\u00a0", "\u3000", "\u200d", "\u0301", "\u0308", "\U0001f3fd",
    "é", "ü", "ñ", "ß", "Ø", "Æ", "α", "Ω", "ж", "Я", "世", "界", "中", "文", "日", "本", "한",
    "국", "م", "ر", "ح", "न", "म", "स", "्", "त", "े", "e\u0301",
    "😀", "🚀", "👍", "٣", "Ⅻ", "²", "½", "€", "—", "…", "’",
    "'s", "'T", "'re", "'Ve", "'M", "'ll", "'D", "hello", "café", "123456", "0",
]


def _texts(extra):
    pieces = st.sampled_from(ALPHABET + extra)
    return st.lists(pieces, max_size=40).map("".join)


SETTINGS = settings(max_examples=300, deadline=None, derandomize=True, database=None,
                    suppress_health_check=list(HealthCheck))


def test_encode_matches_tokenizers(pair):
    name, hf, port = pair

    @SETTINGS
    @given(_texts(_added(hf) + [" [MASK] ", "x<tool_call>y", "ahello", "hello_", "hello!",
                                "quickbrown", " Xylophonez"]))
    def check(text):
        assert port.encode(text) == hf.encode(text, add_special_tokens=False).ids, (name, text)

    check()


# Where the two regex engines' classes or the added-token rules would part:
# \x1c-\x1f are whitespace to re's \s but not to Oniguruma's (a run of
# spaces before one groups differently), NBSP and U+3000 are White_Space,
# lstrip/rstrip eat whitespace around [MASK], single_word needs non-word
# neighbours, café matches after NFC, ignore_merges takes a whole word.
EDGE_CASES = [
    "a  \x1c", "  \x1f b", "x\x1c\x1c  \x1cy", "  \x85x", "x\u00a0\u00a0 y", "\u3000\u3000z",
    " \r\n\r\n  \n x", "a [MASK]  b", "\t[MASK]\n", "hello hello_ hellohello (hello)",
    "cafe\u0301 café", "quickbrown  Xylophonez 1234567", "'S 'll 'VE", "<|im_start|>x<|im_end|>",
    "<think>  <think>", "世界世界", "٣٣٣ⅫⅫ²²", "é👍\U0001f3fd\u200d🚀",
]


@pytest.mark.parametrize("text", EDGE_CASES)
def test_encode_matches_tokenizers_at_edges(pair, text):
    name, hf, port = pair
    assert port.encode(text) == hf.encode(text, add_special_tokens=False).ids, (name, text)


def test_decode_matches_tokenizers(pair):
    name, hf, port = pair
    n = hf.get_vocab_size()

    @SETTINGS
    @given(st.lists(st.integers(0, n + 40), max_size=30), st.booleans())
    def check(ids, skip):
        # ids past the vocabulary and lone bytes of multi-byte characters
        assert port.decode(ids, skip_special_tokens=skip) == hf.decode(
            ids, skip_special_tokens=skip), (name, ids, skip)

    check()


@pytest.mark.parametrize("text", ["café 世界 😀👍🏽 naïve", "é" * 7, "中文字符" + "😀" * 3])
def test_decode_of_split_multibyte_characters(pair, text):
    """Every prefix and every window of a multi-byte text's ids."""
    _, hf, port = pair
    ids = hf.encode(text, add_special_tokens=False).ids
    for i in range(len(ids) + 1):
        for j in range(i, len(ids) + 1):
            assert port.decode(ids[i:j]) == hf.decode(ids[i:j])


def test_vocab_size_and_token_to_id(pair):
    _, hf, port = pair
    assert port.get_vocab_size() == hf.get_vocab_size()
    for token in list(hf.get_vocab())[:: max(1, hf.get_vocab_size() // 200)] + _added(hf) + [
            "nope", "Ġ"]:
        assert port.token_to_id(token) == hf.token_to_id(token), token


def test_ids_past_the_vocabulary_decode_to_nothing():
    port = ttok.tiny_tokenizer()
    ids = port.encode("hello world")
    assert port.vocab_size == 383
    assert port.decode(ids + [600, 151000] + ids) == "hello worldhello world"


def test_add_special_tokens(pair):
    name, hf, port = pair
    text = "hello world"
    if name == "llama3":
        with pytest.raises(ValueError, match="TemplateProcessing"):
            port.encode(text, add_special_tokens=True)
    else:  # no post-processor: nothing is added
        assert port.encode(text, add_special_tokens=True) == hf.encode(text).ids


def test_decode_stream_matches_jax(pair):
    name, hf, port = pair
    jax_side = jtok.HFTokenizer(hf)
    port_side = ttok.HFTokenizer(port)
    n = hf.get_vocab_size()

    @SETTINGS
    @given(st.lists(st.lists(st.integers(0, n + 5), min_size=1, max_size=3), max_size=12),
           st.booleans())
    def check(steps, skip):
        js = jtok.DecodeStream(jax_side, skip_special_tokens=skip)
        ts = ttok.DecodeStream(port_side, skip_special_tokens=skip)
        assert [ts.step(s) for s in steps] == [js.step(s) for s in steps]
        assert ts.flush() == js.flush()
        assert ts.token_count == js.token_count

    check()
    text = "café 世界 😀 the quick brown fox"
    ids = hf.encode(text, add_special_tokens=False).ids
    ts = ttok.DecodeStream(port_side)
    assert "".join(ts.step([i]) for i in ids) + ts.flush() == hf.decode(ids)


@pytest.mark.parametrize("files", [
    {"config.json": {"eos_token_id": [7, 9], "bos_token_id": 4}},
    {"generation_config.json": {"eos_token_id": 5}, "config.json": {"eos_token_id": [7]}},
    {"tokenizer_config.json": {"eos_token": "<|im_end|>"}},
    {"tokenizer_config.json": {"eos_token": {"content": "<|endoftext|>"}}},
    {"tokenizer_config.json": {"eos_token": "<absent>"}},
    {},
])
def test_special_ids_from_model_dir(tmp_path, files):
    (tmp_path / "tokenizer.json").write_text(_tiny_json())
    for fname, body in files.items():
        (tmp_path / fname).write_text(json.dumps(body))
    want = jtok.HFTokenizer.from_pretrained_dir(str(tmp_path))
    got = ttok.HFTokenizer.from_pretrained_dir(str(tmp_path))
    assert (got.eos_token_ids, got.bos_token_id) == (want.eos_token_ids, want.bos_token_id)
    assert got.vocab_size == want.vocab_size
    with pytest.raises(FileNotFoundError):
        ttok.HFTokenizer.from_pretrained_dir(str(tmp_path / "missing"))


def test_committed_tiny_tokenizer_equals_jax_training():
    with open(ttok.TINY_TOKENIZER_PATH, encoding="utf-8") as f:
        assert json.load(f) == json.loads(_tiny_json())
    tok = ttok.tiny_tokenizer()
    assert tok.eos_token_ids == jtok.tiny_tokenizer().eos_token_ids and tok.bos_token_id is None
    assert tok.vocab_size == jtok.tiny_tokenizer().vocab_size


def _mutate(path, value):
    def apply(spec):
        node = spec
        for key in path[:-1]:
            node = node[key]
        if value is _DELETE:
            del node[path[-1]]
        else:
            node[path[-1]] = value
        return spec
    return apply


_DELETE = object()
GEMMA_STYLE = {
    "normalizer": {"type": "Replace", "pattern": {"String": " "}, "content": "▁"},
    "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first",
                      "split": False},
    "decoder": {"type": "Sequence", "decoders": [{"type": "ByteFallback"}]},
}
UNSUPPORTED = {
    "normalizer NFKC": (_mutate(["normalizer"], {"type": "NFKC"}), "NFKC"),
    "normalizer Lowercase": (_mutate(["normalizer"], {"type": "Lowercase"}), "Lowercase"),
    "pre_tokenizer Metaspace": (_mutate(["pre_tokenizer"], GEMMA_STYLE["pre_tokenizer"]),
                                "Metaspace"),
    "pre_tokenizer Whitespace": (_mutate(["pre_tokenizer"], {"type": "Whitespace"}),
                                 "Whitespace"),
    "Split behavior": (_mutate(["pre_tokenizer", "pretokenizers", 0, "behavior"], "Removed"),
                       "Removed"),
    "Split invert": (_mutate(["pre_tokenizer", "pretokenizers", 0, "invert"], True), "invert"),
    "Split \\w": (_mutate(["pre_tokenizer", "pretokenizers", 0, "pattern"], {"Regex": r"\w+"}),
                  r"\\w"),
    "Split anchor": (_mutate(["pre_tokenizer", "pretokenizers", 0, "pattern"], {"Regex": "^a"}),
                     "anchor"),
    "Split named group": (_mutate(["pre_tokenizer", "pretokenizers", 0, "pattern"],
                                  {"Regex": "(?<x>a)"}), "group"),
    "Split property name": (_mutate(["pre_tokenizer", "pretokenizers", 0, "pattern"],
                                    {"Regex": r"\p{Letter}"}), "Letter"),
    "Split nested class": (_mutate(["pre_tokenizer", "pretokenizers", 0, "pattern"],
                                   {"Regex": "[a[b]]"}), "nested"),
    "decoder Metaspace": (_mutate(["decoder"], {"type": "Metaspace"}), "Metaspace"),
    "decoder null": (_mutate(["decoder"], None), "decoder"),
    "model unk_token": (_mutate(["model", "unk_token"], "<unk>"), "unk_token"),
    "model byte_fallback": (_mutate(["model", "byte_fallback"], True), "byte_fallback"),
    "model dropout": (_mutate(["model", "dropout"], 0.1), "dropout"),
    "model prefix": (_mutate(["model", "continuing_subword_prefix"], "##"),
                     "continuing_subword_prefix"),
    "model WordPiece": (_mutate(["model", "type"], "WordPiece"), "WordPiece"),
    "model field": (_mutate(["model", "shiny"], 1), "shiny"),
    "truncation": (_mutate(["truncation"], {"max_length": 8}), "truncation"),
    "padding": (_mutate(["padding"], {"pad_id": 0}), "padding"),
    "post_processor Bert": (_mutate(["post_processor"], {"type": "BertProcessing"}),
                            "BertProcessing"),
    "post_processor in a Sequence": (_mutate(["post_processor"], {
        "type": "Sequence", "processors": [{"type": "RobertaProcessing"}]}), "RobertaProcessing"),
    "added token field": (_mutate(["added_tokens", 0, "shiny"], True), "shiny"),
    "top-level field": (_mutate(["shiny"], 1), "shiny"),
    "merge out of vocabulary": (_mutate(["model", "merges", 0], ["Ġ", "zzzz"]), "zzzz"),
    "added token id": (_mutate(["added_tokens", -1, "id"], 99999), "99999"),
    "added token twice": (lambda spec: {**spec, "added_tokens": spec["added_tokens"] * 2},
                          "twice"),
    "Gemma-style": (lambda spec: {**spec, **GEMMA_STYLE,
                                  "model": {**spec["model"], "byte_fallback": True}}, "Replace"),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_forms_raise(case):
    mutate, fragment = UNSUPPORTED[case]
    spec = mutate(copy.deepcopy(json.loads(_qwen2_json())))
    with pytest.raises(ValueError, match=fragment):
        bpe.BpeTokenizer(spec)


def test_tokenizer_reads_only_the_module_directory_file(tmp_path, monkeypatch):
    """tiny_tokenizer() reads its file from the package, wherever the
    process runs."""
    monkeypatch.chdir(tmp_path)
    assert os.path.dirname(ttok.TINY_TOKENIZER_PATH).endswith(os.path.join("llm", "data"))
    assert ttok.tiny_tokenizer().encode("hello") == jtok.tiny_tokenizer().encode("hello")
