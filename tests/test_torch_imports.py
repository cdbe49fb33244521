"""Import hygiene of the port: dynamo_tpu_torch and chip_smoke.py import
neither jax nor anything of dynamo_tpu, nor a package the card's machine
lacks (tokenizers, regex, aiohttp, msgpack, zmq, prometheus_client,
ml_dtypes; jinja2 only inside a function); every module (the HTTP frontend, the parsers and
the runtime's planes with their msgpack and ZMTP wire modules, and the KV
router with its pure-Python xxh3, discovery, migration, the worker and
frontend mains, the overload and trajectory planes, the system server, the
device plane, the engine's step metrics, the perf ledger and the roofline,
the KV wire and the disagg handlers, among them) imports with all of those and xxhash blocked, and the text
path (tokenizer, default chat template) runs so; an entry point left on
its default device (cuda) raises when there is no card instead of
carrying on on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "dynamo_tpu_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "dynamo_tpu")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


# Packages the card's machine does not have (or is not known to have:
# prometheus_client). The port imports none of these (ml_dtypes: the KV
# wire holds bfloat16 as torch tensors, disagg/wire.py); jinja2 only
# inside a function (a custom chat template); xxhash nowhere (tokens/xxh3.py
# computes the block hashes).
ABSENT_ON_CARD = ("tokenizers", "regex", "aiohttp", "msgpack", "zmq", "prometheus_client",
                  "ml_dtypes")
BLOCKED = ("jax", "jaxlib", "dynamo_tpu") + ABSENT_ON_CARD + ("jinja2", "xxhash")


def _imports(path):
    """(line, module name, inside a function body) of every import."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []

    def visit(node, in_function):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                out.extend((child.lineno, a.name, in_function) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                out.append((child.lineno, child.module, in_function))
            visit(child, in_function or isinstance(child, (ast.FunctionDef,
                                                           ast.AsyncFunctionDef)))

    visit(tree, False)
    return out


def test_no_file_of_the_port_imports_a_package_the_card_lacks():
    bad = []
    for path in _port_files():
        for line, name, in_function in _imports(path):
            top = name.split(".")[0]
            if top in ABSENT_ON_CARD or (top == "jinja2" and not in_function):
                bad.append(f"{path.relative_to(ROOT)}:{line} {name}")
    assert bad == []
    # the scan sees the one import of jinja2, inside a function
    chat = PKG / "llm" / "chat_template.py"
    assert [n for _, n, f in _imports(chat) if n == "jinja2"] == ["jinja2"]
    assert all(f for _, n, f in _imports(chat) if n == "jinja2")


def test_no_file_of_the_port_imports_jax_or_dynamo_tpu():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert bad == []
    assert len(_port_files()) > 15


_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys
sys.path.insert(0, {root!r})

BLOCKED = {blocked!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

for mod in list(sys.modules):
    if mod.split(".")[0] in BLOCKED:
        del sys.modules[mod]
sys.meta_path.insert(0, Block())
import dynamo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dynamo_tpu_torch.__path__, "dynamo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the profiling entry points and the kernels of the last three TPU kernels
wanted = set("dynamo_tpu_torch." + n for n in (
    "tools.prof_attn", "tools.prof_fused_ffn", "tools.prof_8b", "ops.ffn_int8",
    "ops.cuda.decode_attention_proto", "ops.cuda.ffn_int8",
    "llm.bpe", "llm.tokenizer", "llm.chat_template", "llm.preprocessor", "llm.backend",
    "llm.entrypoint", "llm.protocols.openai", "runtime.pipeline",
    "cli.run", "cli.__main__", "http.web", "http.service", "http.metrics",
    "http.model_manager", "http.worker_monitor", "http.audit", "parsers.incremental",
    "parsers.jail", "parsers.observe", "parsers.reasoning", "parsers.tool_calling",
    "runtime.metrics_core", "runtime.faults", "runtime.tasks", "disagg.errors",
    "runtime.network.msgpack_lite", "runtime.network.codec", "runtime.network.errors",
    "runtime.network.tcp", "runtime.drain", "runtime.liveness", "runtime.discovery",
    "runtime.discovery.file", "runtime.discovery.discd", "runtime.component",
    "runtime.distributed", "runtime.events", "runtime.events.zmtp",
    "runtime.events.zmq_plane", "runtime.health", "discd", "discd.__main__",
    "tokens.xxh3", "tokens.blocks", "tokens.radix", "router", "router.protocols",
    "router.indexer", "router.approx", "router.scheduler", "router.publisher",
    "router.router", "runtime.kv_reuse_observe", "runtime.lifecycle", "utils.tracing",
    "llm.migration", "llm.discovery", "disagg", "disagg.prefill_router", "worker",
    "worker.__main__", "frontend", "frontend.__main__", "runtime.overload",
    "runtime.trajectory", "runtime.system_server", "runtime.device_observe",
    "engines.metrics", "runtime.perf_ledger", "runtime.roofline", "disagg.wire",
    "disagg.handlers", "engines.gpu.spec"))
assert wanted <= set(names), sorted(wanted - set(names))
spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
# the text path runs without tokenizers, regex and jinja2
from dynamo_tpu_torch.llm import ChatTemplate, OpenAIPreprocessor, ModelDeploymentCard
from dynamo_tpu_torch.llm import tiny_tokenizer
tok = tiny_tokenizer()
pre = OpenAIPreprocessor(ModelDeploymentCard(name="m"), tok).preprocess(
    {{"model": "m", "messages": [{{"role": "user", "content": "hello world"}}]}})
assert tok.decode(pre.token_ids, skip_special_tokens=False) == ChatTemplate().render(
    [{{"role": "user", "content": "hello world"}}])
try:
    ChatTemplate("{{{{ messages }}}}")
    raise SystemExit("a custom template rendered without jinja2")
except ImportError as exc:
    assert "jinja2" in str(exc)
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print(len(names))
"""


def test_every_module_imports_with_jax_and_dynamo_tpu_blocked():
    code = _BLOCKED_IMPORT.format(root=str(ROOT), smoke=str(ROOT / "chip_smoke.py"),
                                  blocked=BLOCKED)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 15


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from dynamo_tpu_torch.device import resolve_device
    from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.models.config import tiny_config

    cfg = tiny_config()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        llama.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        llama.init_kv_cache(cfg, 8, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchEngine(TorchEngineArgs(config=cfg))
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_use_plain_versions_only_on_cpu_tensors():
    from dynamo_tpu_torch.ops.attention import paged_attention_ref
    from dynamo_tpu_torch.ops.cuda import paged_attention as kernels

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 3, 4, 64, generator=g)
    k = torch.randn(6, 4, 2, 64, generator=g)
    v = torch.randn(6, 4, 2, 64, generator=g)
    tables = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    start = torch.tensor([2, 5], dtype=torch.int32)
    lens = torch.tensor([3, 3], dtype=torch.int32)
    kernels.reset_launch_counts()
    want = paged_attention_ref(q, k, v, tables, start, lens)
    assert torch.equal(kernels.paged_attention_decode(q, k, v, tables, start), want)
    assert torch.equal(kernels.paged_attention_chunk(q, k, v, tables, start, lens), want)
    assert kernels.launch_counts == {"paged_attention_decode": 0, "paged_attention_chunk": 0}
    with pytest.raises(ValueError, match="device"):
        kernels.paged_attention_decode(q.to("meta"), k, v, tables, start)
