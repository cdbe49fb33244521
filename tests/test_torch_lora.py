"""Multi-LoRA serving in the port (models/safetensors_lite.py, lora/,
ops/lora.py, the LoRA hooks of models/llama.py, engines/gpu/runner.py and
engine.py) against the JAX package on the same inputs, at tiny_config, on
PEFT adapters written with ``safetensors.numpy.save_file``:

  - ``safetensors_lite.load_file`` reads what the library writes (F32, F16,
    BF16) and the library reads what ``save_file`` writes; other dtypes,
    overlapping offsets and offsets past the file are refused;
  - ``load_lora_adapter`` and ``stack_adapters`` equal JAX's (float32 and
    bf16 models), ``lora_from_jax`` carries JAX's adapter across;
  - ``apply_lora`` / ``lora_delta`` equal JAX's (float32 within 1e-5, bf16
    within one bf16 step of the output's scale);
  - ``forward_paged`` with a stack and mixed adapter ids equals JAX's
    logits, prefill then decode;
  - ``TorchEngine(lora_dir=...)`` greedy streams equal ``JaxEngine``'s
    exactly: base, each adapter, a concurrent mix, the merged-weights
    oracle of tests/test_lora.py; the unknown-adapter error text;
  - load and unload: stable slot ids, a freed slot's rank-1 zero
    placeholder, an unloaded adapter's in-flight row decoding as base;
  - salted prefix-cache hashes and KV events equal JAX's, and no block is
    shared across adapters;
  - the fused-layer gate under LoRA (None: off; True: raises);
  - a speculative verify under an adapter (= the plain port and JAX);
  - graph keys: a shape-keeping restack keeps the captured graphs, a
    shape-changing one drops them, and each recapture is a new signature
    of JAX's program (a stand-in capture on the CPU);
  - ``routing``, ``cache``, ``load_estimator`` and ``source`` of both
    packages, as tests/test_lora.py holds JAX's.
"""

import asyncio
import json
import os
import struct
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as np_save_file

import dynamo_tpu.lora as jlora_pkg
from dynamo_tpu.engines.tpu import JaxEngine, JaxEngineArgs
from dynamo_tpu.llm.protocols import common as jproto
from dynamo_tpu.lora import loader as jloader
from dynamo_tpu.lora import routing as jrouting
from dynamo_tpu.models import config as jconfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.ops import lora as jops
from dynamo_tpu.runtime import context as jcontext
import dynamo_tpu_torch.lora as tlora_pkg
from dynamo_tpu_torch.engines.gpu import runner as trunner
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.lora import loader as tloader
from dynamo_tpu_torch.lora import routing as trouting
from dynamo_tpu_torch.models import config as tconfig
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models import safetensors_lite
from dynamo_tpu_torch.models.weights import params_from_jax
from dynamo_tpu_torch.ops import lora as tops
from dynamo_tpu_torch.runtime import context as tcontext
from dynamo_tpu_torch.tokens.blocks import adapter_salt, compute_block_hashes

ARGS = dict(block_size=4, num_kv_blocks=128, max_num_seqs=4, max_model_len=128,
            prefill_chunk=32, decode_steps=4)
TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
JAX = types.SimpleNamespace(proto=jproto, Context=jcontext.Context)
TORCH = types.SimpleNamespace(proto=tproto, Context=tcontext.Context)


# -- PEFT adapters on disk ----------------------------------------------------


def _dims(cfg, module):
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    return {"q_proj": (d, cfg.n_heads * hd), "k_proj": (d, cfg.n_kv_heads * hd),
            "v_proj": (d, cfg.n_kv_heads * hd), "o_proj": (cfg.n_heads * hd, d),
            "gate_proj": (d, ff), "up_proj": (d, ff), "down_proj": (ff, d)}[module]


def write_adapter(root, name, cfg, *, rank=4, alpha=8.0, seed=0, targets=("q_proj", "v_proj"),
                  scale=0.3, layers=None):
    """A PEFT adapter directory (adapter_config.json +
    adapter_model.safetensors, lora_A [r, d_in] and lora_B [d_out, r]),
    written by the safetensors library."""
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": alpha, "target_modules": list(targets)}, f)
    rng = np.random.default_rng(seed)
    tensors = {}
    for layer in range(cfg.n_layers) if layers is None else layers:
        for t in targets:
            d_in, d_out = _dims(cfg, t)
            block = "mlp" if t in ("gate_proj", "up_proj", "down_proj") else "self_attn"
            prefix = f"base_model.model.model.layers.{layer}.{block}.{t}"
            tensors[f"{prefix}.lora_A.weight"] = (
                rng.standard_normal((rank, d_in)).astype(np.float32) * scale)
            tensors[f"{prefix}.lora_B.weight"] = (
                rng.standard_normal((d_out, rank)).astype(np.float32) * scale)
    np_save_file(tensors, os.path.join(d, "adapter_model.safetensors"))
    return d


@pytest.fixture(scope="module")
def lora_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("adapters"))
    cfg = tconfig.tiny_config()
    write_adapter(root, "adapter-a", cfg, seed=1, targets=TARGETS)
    write_adapter(root, "adapter-b", cfg, seed=2, rank=2, alpha=4.0)
    # outside the served directory: loaded at run time
    extra = str(tmp_path_factory.mktemp("extra"))
    write_adapter(extra, "adapter-c", cfg, seed=3, rank=2, alpha=4.0)
    write_adapter(extra, "adapter-wide", cfg, seed=4, rank=8, alpha=8.0,
                  targets=("q_proj", "gate_proj"))
    return root, extra


@pytest.fixture(scope="module")
def weights():
    jc = jconfig.tiny_config()
    params = jllama.init_params(jc, jax.random.PRNGKey(5))
    return jc, params, jax.tree.map(np.asarray, params)


# -- safetensors_lite ---------------------------------------------------------

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def _tensors(dtype):
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 5, generator=g).to(dtype), "scalar": torch.tensor(1.5, dtype=dtype),
            "empty": torch.zeros(0, 4, dtype=dtype), "v": torch.randn(7, generator=g).to(dtype)}


@pytest.mark.parametrize("tag", list(DTYPES))
def test_load_file_reads_what_the_library_writes(tmp_path, tag):
    from safetensors.torch import save_file

    want = _tensors(DTYPES[tag])
    path = str(tmp_path / "x.safetensors")
    save_file(want, path, metadata={"format": "pt"})
    got = safetensors_lite.load_file(path)
    assert set(got) == set(want)
    for name, t in want.items():
        assert got[name].dtype == t.dtype and got[name].shape == t.shape
        assert torch.equal(got[name], t)


@pytest.mark.parametrize("tag", list(DTYPES))
def test_the_library_reads_what_save_file_writes(tmp_path, tag):
    from safetensors import safe_open

    want = _tensors(DTYPES[tag])
    path = str(tmp_path / "x.safetensors")
    safetensors_lite.save_file(want, path, metadata={"format": "pt"})
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        got = {k: f.get_tensor(k) for k in f.keys()}
    assert set(got) == set(want)
    for name, t in want.items():
        assert torch.equal(got[name], t) and got[name].dtype == t.dtype
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
    assert n % 8 == 0  # the header padded to 8 bytes, as the library pads it


def _raw_file(path, header, data):
    text = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)) + text + data)


@pytest.mark.parametrize("case", ["dtype", "overlap", "past_end", "size"])
def test_load_file_refuses_what_it_cannot_read(tmp_path, case):
    path = str(tmp_path / "bad.safetensors")
    if case == "dtype":
        np_save_file({"i": np.arange(4, dtype=np.int32)}, path)
        match = "I32"
    else:
        header = {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
                  "b": {"dtype": "F32", "shape": [2], "data_offsets": [8, 16]}}
        if case == "overlap":
            header["b"]["data_offsets"] = [4, 12]
            match = "overlap"
        elif case == "past_end":
            header["b"]["data_offsets"] = [8, 24]
            header["b"]["shape"] = [4]
            match = "past"
        else:
            header["b"]["shape"] = [3]
            match = "needs"
        _raw_file(path, header, bytes(16))
    with pytest.raises(ValueError, match=match):
        safetensors_lite.load_file(path)


# -- loader and stack ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loader_and_stack_equal_jax(lora_root, dtype):
    root, extra = lora_root
    jc = jconfig.tiny_config(dtype=getattr(jnp, dtype))
    tc = tconfig.tiny_config(dtype=getattr(torch, dtype))
    names = [(root, "adapter-a"), (root, "adapter-b"), (extra, "adapter-wide")]
    ja = [jloader.load_lora_adapter(os.path.join(r, n), jc) for r, n in names]
    ta = [tloader.load_lora_adapter(os.path.join(r, n), tc) for r, n in names]
    for j, t in zip(ja, ta):
        assert (t.name, t.rank, t.scaling, t.targets) == (j.name, j.rank, j.scaling, j.targets)
        for target, (A, B) in t.weights.items():
            assert A.dtype == B.dtype == torch.float32  # host tensors
            np.testing.assert_array_equal(A.numpy(), np.asarray(j.weights[target][0], np.float32))
            np.testing.assert_array_equal(B.numpy(), np.asarray(j.weights[target][1], np.float32))
        # the JAX adapter carried across is the same adapter
        c = tloader.lora_from_jax(j)
        assert all(torch.equal(c.weights[k][i], t.weights[k][i])
                   for k in t.weights for i in (0, 1))
    # a freed slot's placeholder (rank 1, no weights) beside real ones
    free = tloader.LoRAAdapter(name="__free_1", rank=1, scaling=0.0)
    jfree = jloader.LoRAAdapter(name="__free_1", rank=1, scaling=0.0)
    targets = sorted({t for a in ta for t in a.targets})
    want = jloader.stack_adapters([ja[0], jfree, ja[1], ja[2]], jc, targets)
    got = tloader.stack_adapters([ta[0], free, ta[1], ta[2]], tc, targets)
    assert set(got) == set(want) == {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
    for target, (A, B) in got.items():
        assert A.dtype == tc.dtype and A.shape == want[target][0].shape
        assert B.shape == want[target][1].shape == (5, tc.n_layers, 8, B.shape[-1])
        np.testing.assert_array_equal(A.float().numpy(), np.asarray(want[target][0], np.float32))
        np.testing.assert_array_equal(B.float().numpy(), np.asarray(want[target][1], np.float32))
        assert not A[0].any() and not A[2].any() and not B[2].any()  # base and freed slots


def test_an_adapter_on_some_layers_holds_zeros_elsewhere(tmp_path):
    cfg = tconfig.tiny_config()
    d = write_adapter(str(tmp_path), "one-layer", cfg, layers=[1], targets=("o_proj",))
    a = tloader.load_lora_adapter(d, cfg)
    A, B = a.weights["wo"]
    assert A.shape == (2, cfg.d_model, 4) and not A[0].any() and A[1].any()
    assert a.targets == ["wo"] and a.name == "one-layer" and a.scaling == 2.0


# -- ops ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2 ** -7)])
@pytest.mark.parametrize("C", [1, 9])
def test_apply_lora_and_lora_delta_equal_jax(dtype, tol, C):
    rng = np.random.default_rng(7)
    B, N, d, r, h = 6, 3, 32, 8, 24
    x = rng.standard_normal((B, C, d)).astype(np.float32)
    A = (rng.standard_normal((N + 1, d, r)) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((N + 1, r, h)) * 0.3).astype(np.float32)
    A[0], Bm[0] = 0, 0
    ids = np.array([0, 1, 2, 3, 1, 0], np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jops.apply_lora(jnp.asarray(x, jd), (jnp.asarray(A, jd), jnp.asarray(Bm, jd)),
                                      jnp.asarray(ids)), np.float32)
    ab = (torch.from_numpy(A).to(td), torch.from_numpy(Bm).to(td))
    got = tops.apply_lora(torch.from_numpy(x).to(td), ab, torch.from_numpy(ids))
    assert got.dtype == td and got.shape == (B, C, h)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol * scale, rtol=0)
    assert not got[0].any() and not got[5].any()  # id 0: exact zeros
    ll = {"wq": ab}
    xt = torch.from_numpy(x).to(td)
    assert torch.equal(tops.lora_delta(ll, "wq", xt, torch.from_numpy(ids)), got)
    # where JAX's lora_delta gives a zero-dim zero, the port's gives None:
    # the layer adds nothing and launches nothing
    jll = {"wq": (jnp.asarray(A, jd), jnp.asarray(Bm, jd))}
    for cll, target, cids in ((ll, "wk", ids), (ll, "wq", None), (None, "wq", None)):
        jzero = jops.lora_delta(jll if cll else None, target, jnp.asarray(x, jd),
                                None if cids is None else jnp.asarray(cids))
        assert jzero.shape == () and float(jzero) == 0.0
        assert tops.lora_delta(cll, target, xt, None if cids is None else torch.from_numpy(cids)) is None


def _stacks(lora_root, jc, tc, names=("adapter-a", "adapter-b")):
    root, _ = lora_root
    ja = [jloader.load_lora_adapter(os.path.join(root, n), jc) for n in names]
    targets = sorted({t for a in ja for t in a.targets})
    jst = {t: (A.swapaxes(0, 1), B.swapaxes(0, 1))
           for t, (A, B) in jloader.stack_adapters(ja, jc, targets).items()}
    tst = {t: (torch.from_numpy(np.asarray(A)).clone(), torch.from_numpy(np.asarray(B)).clone())
           for t, (A, B) in jst.items()}
    return jst, tst


def test_forward_paged_with_lora_equals_jax(lora_root, weights):
    jc, params, tree = weights
    tc = tconfig.tiny_config()
    tp = params_from_jax(tree, tc, "cpu")
    jst, tst = _stacks(lora_root, jc, tc)
    rng = np.random.default_rng(1)
    B, NB, BS = 4, 40, 4
    tables = np.arange(B * 8, dtype=np.int32).reshape(B, 8) + 2
    ids = np.array([0, 1, 2, 1], np.int32)
    jk, jv = jllama.init_kv_cache(jc, NB, BS, layered=True)
    tk, tv = tllama.init_kv_cache(tc, NB, BS, "cpu")
    start = np.zeros(B, np.int32)
    base = None
    for C, lens, first in ((11, np.array([11, 7, 2, 9], np.int32), True),
                           (1, np.ones(B, np.int32), False)):
        toks = rng.integers(0, jc.vocab_size, (B, C)).astype(np.int32)
        jl, jk, jv = jax.block_until_ready(jllama.forward_paged(
            params, jc, jnp.asarray(toks), jnp.asarray(start), jnp.asarray(lens),
            jnp.asarray(tables), jk, jv, first_chunk=first, lora=jst,
            adapter_ids=jnp.asarray(ids)))
        T = torch.from_numpy
        tl, tk, tv = tllama.forward_paged(tp, tc, T(toks), T(start), T(lens), T(tables), tk, tv,
                                          first_chunk=first, lora=tst, adapter_ids=T(ids))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        if base is None:  # the adapters move the logits; row 0 is the base model
            kc, vc = tllama.init_kv_cache(tc, NB, BS, "cpu")
            base, _, _ = tllama.forward_paged(tp, tc, T(toks), T(start), T(lens), T(tables),
                                              kc, vc, first_chunk=first)
            assert torch.equal(base[0], tl[0])
            assert (base[1:] - tl[1:]).abs().amax(-1).min() > 1e-3
        start = start + lens


# -- engines ------------------------------------------------------------------


def _engines(weights, root, **over):
    jc, params, tree = weights
    tc = tconfig.tiny_config()
    args = {**ARGS, **over}
    je = JaxEngine(JaxEngineArgs(config=jc, pipeline_depth=1, lora_dir=root, **args),
                   params=params)
    te = TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False, lora_dir=root,
                                     **args), params=params_from_jax(tree, tc, "cpu"))
    return (je, JAX), (te, TORCH)


def _req(api, prompt, lora=None, max_tokens=12, rid="r"):
    p = api.proto
    return p.PreprocessedRequest(
        token_ids=[int(t) for t in prompt], request_id=rid, lora_name=lora,
        sampling=p.SamplingOptions(temperature=0.0),
        stop=p.StopConditions(max_tokens=max_tokens, ignore_eos=True))


async def _one(engine, api, prompt, lora=None, max_tokens=12):
    toks, err = [], None
    async for out in engine.generate(_req(api, prompt, lora, max_tokens), api.Context()):
        err = err or out.error
        toks += out.token_ids
    return toks, err


PROMPTS = [list(np.random.default_rng(i).integers(3, 500, n)) for i, n in
           enumerate((14, 40, 9, 23))]  # 40 > prefill_chunk
MIX = [None, "adapter-a", "adapter-b", "adapter-a"]


async def _serve(engine, api):
    try:
        out = {"solo": [await _one(engine, api, p, lora) for p, lora in zip(PROMPTS, MIX)]}
        out["base"] = [await _one(engine, api, p) for p in PROMPTS[1:3]]
        out["mixed"] = await asyncio.gather(*(_one(engine, api, p, lora)
                                              for p, lora in zip(PROMPTS, MIX)))
        out["ghost"] = await _one(engine, api, PROMPTS[0], "ghost")
        out["names"] = engine.lora_names()
        return out
    finally:
        await engine.stop()


async def test_greedy_streams_under_adapters_equal_jax(weights, lora_root):
    root, _ = lora_root
    (je, ja), (te, ta) = _engines(weights, root)
    want = await _serve(je, ja)
    got = await _serve(te, ta)
    assert got["solo"] == want["solo"] and got["mixed"] == want["mixed"]
    assert got["mixed"] == got["solo"]  # one batch serves every adapter as alone
    assert got["base"] == want["base"]
    assert all(err is None and len(t) == 12 for t, err in got["solo"])
    # the adapters steer generation
    assert got["base"][0][0] != got["solo"][1][0] and got["base"][1][0] != got["solo"][2][0]
    assert got["ghost"] == want["ghost"]
    assert got["ghost"][1] == "unknown LoRA adapter 'ghost' (loaded: ['adapter-a', 'adapter-b'])"
    assert got["names"] == want["names"] == ["adapter-a", "adapter-b"]
    assert te.runner.lora_index == {"adapter-a": 1, "adapter-b": 2}


async def test_an_adapter_equals_its_merged_weights(weights, lora_root):
    """W' = W + A·B·s per layer (tests/test_lora.py:209-239's oracle): the
    adapter's stream equals the merged model's, on both packages."""
    root, _ = lora_root
    jc, params, tree = weights
    tc = tconfig.tiny_config()
    adapter = jloader.load_lora_adapter(os.path.join(root, "adapter-a"), jc)
    merged = jax.tree.map(np.array, tree)
    for target, (A, B) in adapter.weights.items():
        delta = np.einsum("ldr,lrh->ldh", np.asarray(A), np.asarray(B)) * adapter.scaling
        merged["layers"][target] = merged["layers"][target] + delta.astype(np.float32)
    prompt = list(range(40, 52))
    (je, ja), (te, ta) = _engines(weights, root)
    plain = TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False, **ARGS),
                        params=params_from_jax(merged, tc, "cpu"))
    try:
        want = await _one(je, ja, prompt, "adapter-a")
        got = await _one(te, ta, prompt, "adapter-a")
        oracle = await _one(plain, TORCH, prompt)
    finally:
        for e in (je, te, plain):
            await e.stop()
    assert got == want == oracle and len(got[0]) == 12


async def test_load_and_unload_keep_slot_ids_and_errors(weights, lora_root):
    root, extra = lora_root
    (je, ja), (te, ta) = _engines(weights, root)
    out = {}
    try:
        for name, e, api in (("jax", je, ja), ("torch", te, ta)):
            res = []
            e.unload_lora("adapter-a")  # slot 1 freed: adapter-b keeps id 2
            res.append(dict(e._lora_index))
            with pytest.raises(KeyError, match="'adapter-a' is not loaded"):
                e.unload_lora("adapter-a")
            res.append(await _one(e, api, PROMPTS[0], "adapter-a"))
            res.append(await _one(e, api, PROMPTS[2], "adapter-b"))
            e.load_lora("adapter-c", os.path.join(extra, "adapter-c"))  # takes slot 1
            res.append(dict(e._lora_index))
            with pytest.raises(ValueError, match="'adapter-c' already loaded"):
                e.load_lora("adapter-c", os.path.join(extra, "adapter-c"))
            res.append(await _one(e, api, PROMPTS[2], "adapter-b"))
            res.append(await _one(e, api, PROMPTS[1], "adapter-c"))
            res.append(e.lora_names())
            out[name] = res
    finally:
        await je.stop()
        await te.stop()
    assert out["torch"] == out["jax"]
    got = out["torch"]
    assert got[0] == {"adapter-b": 2} and got[3] == {"adapter-c": 1, "adapter-b": 2}
    assert got[1] == ([], "unknown LoRA adapter 'adapter-a' (loaded: ['adapter-b'])")
    assert got[2] == got[4]  # adapter-b's stream kept through both restacks
    # adapter-a's unload freed slot 1 (a rank-1 zero placeholder) and left
    # adapter-b's targets and rank: a new shape; adapter-c (rank 2, q and v)
    # then took slot 1 in place
    assert te.runner.lora["wq"][0].shape == (tconfig.tiny_config().n_layers, 3, 128, 2)
    assert sorted(te.runner.lora) == ["wq", "wv"]
    assert te.runner.lora_restacks == {"in_place": 1, "reshaped": 2}


async def _run_hooked(weights, root, hook, action, n=2):
    """PROMPTS[1] on adapter-a, 24 tokens, with ``action(engine)`` run at
    the ``n``-th call of the engine's or its runner's method ``hook``
    (``_build_state_sync``: on the event loop's thread before a burst's
    dispatch; ``runner.decode_dispatch``: on the device thread). Returns
    the stream and the engine, stopped."""
    _, _, tree = weights
    tc = tconfig.tiny_config()
    te = TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False,
                                     lora_dir=root, **ARGS),
                     params=params_from_jax(tree, tc, "cpu"))
    owner, name = (te.runner, "decode_dispatch") if hook == "dispatch" else (te, hook)
    fn, calls = getattr(owner, name), []

    def hooked(*a, **kw):
        calls.append(1)
        if len(calls) == n:
            action(te)
        return fn(*a, **kw)

    setattr(owner, name, hooked)
    try:
        return await _one(te, TORCH, PROMPTS[1], "adapter-a", max_tokens=24), te
    finally:
        await te.stop()


async def test_an_unloaded_adapters_running_row_decodes_as_base(weights, lora_root):
    """The adapter is unloaded right before the 2nd decode burst of a row
    that uses it: the row ends whole, equal to the same run with the row's
    adapter id set to 0 at that point (its stack slot is zeros)."""
    root, _ = lora_root
    unloaded, _ = await _run_hooked(weights, root, "dispatch",
                                    lambda e: e.runner.remove_adapter("adapter-a"))
    as_base, _ = await _run_hooked(weights, root, "dispatch",
                                   lambda e: e.runner.slot_state["adapter_ids"].zero_())
    kept, _ = await _run_hooked(weights, root, "dispatch", lambda e: None)
    assert unloaded == as_base and unloaded[1] is None and len(unloaded[0]) == 24
    assert unloaded[0][:5] == kept[0][:5] and unloaded[0] != kept[0]


async def test_an_unloaded_adapters_row_stays_base_when_its_slot_is_refilled(weights, lora_root):
    """The engine's unload of adapter-a right before the 2nd decode burst of
    a row on it, then adapter-c's load into the freed slot 1: the row goes
    on as the base model, not as adapter-c (JAX's engine leaves the row on
    slot 1), and none of its blocks completed after the unload enters the
    prefix cache under adapter-a's salt."""
    root, extra = lora_root
    held = []

    def unload_refill(e):
        held.append(len(next(s for s in e._slots if s is not None).block_hashes))
        e.unload_lora("adapter-a")
        e.load_lora("adapter-c", os.path.join(extra, "adapter-c"))
        assert e._lora_index == {"adapter-c": 1, "adapter-b": 2}

    def runner_refill(e):  # the stack alone, as JAX's unload and load change it
        e.runner.remove_adapter("adapter-a")
        e.runner.install_adapter(trunner._adapter_to_host(tloader.load_lora_adapter(
            os.path.join(extra, "adapter-c"), tconfig.tiny_config(), name="adapter-c")))

    (got, err), te = await _run_hooked(weights, root, "_build_state_sync", unload_refill)
    as_base, _ = await _run_hooked(weights, root, "dispatch",
                                   lambda e: e.runner.slot_state["adapter_ids"].zero_())
    on_c, _ = await _run_hooked(weights, root, "dispatch", runner_refill)
    assert (got, err) == as_base and len(got) == 24 and got != on_c[0]
    stream = PROMPTS[1] + got
    bs = ARGS["block_size"]
    a_hashes = compute_block_hashes(stream, bs, salt=adapter_salt("adapter-a"))
    assert len(a_hashes) > held[0] >= len(PROMPTS[1]) // bs
    assert te.pool.match_prefix(a_hashes) == held[0]
    assert te.pool.match_prefix(compute_block_hashes(stream, bs)) == 0


@pytest.fixture
def kv_events(weights, lora_root):
    root, _ = lora_root
    jc, params, tree = weights
    tc = tconfig.tiny_config()
    made = {}
    for name in ("jax", "torch"):
        events = []
        if name == "jax":
            e = JaxEngine(JaxEngineArgs(config=jc, pipeline_depth=1, lora_dir=root, **ARGS),
                          params=params, on_kv_event=events.append)
        else:
            e = TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False,
                                            lora_dir=root, **ARGS),
                            params=params_from_jax(tree, tc, "cpu"), on_kv_event=events.append)
        made[name] = (e, JAX if name == "jax" else TORCH, events)
    return made


async def test_kv_events_of_adapter_requests_equal_jax(kv_events):
    prompt = PROMPTS[1]
    out = {}
    for name, (e, api, events) in kv_events.items():
        try:
            streams = []
            for lora in (None, "adapter-a", "adapter-a", "adapter-b"):
                p0 = e.stats()["prefill_tokens"]
                streams.append((await _one(e, api, prompt, lora),
                                e.stats()["prefill_tokens"] - p0))
        finally:
            await e.stop()
        out[name] = (streams, [(ev.kind, list(ev.block_hashes), ev.parent_hash)
                               for ev in events])
    assert out["torch"] == out["jax"]
    streams, events = out["torch"]
    assert [n for _, n in streams] == [40, 40, 1, 40]  # no block shared across adapters
    stored = [h for kind, hs, _ in events if kind == "stored" for h in hs]
    for lora in ("adapter-a", "adapter-b"):
        want = compute_block_hashes(prompt, ARGS["block_size"], salt=adapter_salt(lora))
        assert set(want) <= set(stored)
    assert set(compute_block_hashes(prompt, ARGS["block_size"])) <= set(stored)


# -- the fused-layer gate -----------------------------------------------------

INT8_CFG = dict(name="int8-mini", d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
                d_ff=512, vocab_size=512, head_dim=128, rope_theta=10000.0)


def test_the_fused_layer_gate_under_lora(tmp_path):
    cfg = tconfig.ModelConfig(**INT8_CFG)
    write_adapter(str(tmp_path), "a", cfg, targets=("q_proj",))
    base = dict(config=cfg, device="cpu", cuda_graphs=False, quantization="int8",
                **dict(ARGS, block_size=16))
    with pytest.raises(ValueError, match="LoRA adapters active"):
        trunner.DeviceRunner(TorchEngineArgs(**base, use_megakernel=True, lora_dir=str(tmp_path)))
    assert trunner.DeviceRunner(TorchEngineArgs(**base, use_megakernel=True)).use_megakernel
    # None on a card: on without adapters, off with a LoRA directory
    for lora_dir, on in ((None, True), (str(tmp_path), False)):
        runner = trunner.DeviceRunner(TorchEngineArgs(**base, lora_dir=lora_dir))
        runner.device = types.SimpleNamespace(type="cuda")
        assert runner._megakernel_gate(lora=bool(runner.args.lora_dir)) is on


def test_the_first_load_asks_the_fused_layer_gate_again(tmp_path):
    """An adapter loaded at run time into a runner whose fused layer is on:
    ``use_megakernel=True`` refuses it and keeps no stack; ``None`` turns
    the fused layer off, so no burst is counted or labelled fused."""
    cfg = tconfig.ModelConfig(**INT8_CFG)
    write_adapter(str(tmp_path), "a", cfg, targets=("q_proj",))
    base = dict(config=cfg, device="cpu", cuda_graphs=False, quantization="int8",
                **dict(ARGS, block_size=16))
    adapter = trunner._adapter_to_host(
        tloader.load_lora_adapter(os.path.join(tmp_path, "a"), cfg))
    forced = trunner.DeviceRunner(TorchEngineArgs(**base, use_megakernel=True))
    with pytest.raises(ValueError, match="LoRA adapters active"):
        forced.install_adapter(adapter)
    assert forced.use_megakernel and forced.lora is None and forced.lora_index == {}
    auto = trunner.DeviceRunner(TorchEngineArgs(**base))
    auto.use_megakernel = True  # as the gate leaves it on a card
    auto.install_adapter(adapter)
    assert not auto.use_megakernel and auto.lora_index == {"a": 1}
    # the fused layer and a stack never run together
    with pytest.raises(ValueError, match="no LoRA stack"):
        tllama.forward_paged(
            auto.params, cfg, torch.zeros((1, 1), dtype=torch.int64),
            torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
            torch.zeros((1, 1), dtype=torch.int32), auto.k_cache, auto.v_cache,
            use_megakernel=True, lora=auto.lora, adapter_ids=torch.zeros(1, dtype=torch.int32))


# -- speculative decoding under an adapter ------------------------------------

LOOPING = ([9, 9, 9, 9] * 4, [3, 4] * 12)


async def test_spec_verify_under_an_adapter_equals_plain_and_jax(weights, lora_root, tmp_path):
    root, _ = lora_root
    jc, params, tree = weights
    tc = tconfig.tiny_config()
    small = str(tmp_path)  # an adapter that steers the stream and keeps it looping
    write_adapter(small, "soft", tc, seed=9, targets=TARGETS, scale=0.12)
    spec = dict(spec_mode="ngram", spec_ngram=2, spec_k=3)

    def port(**over):
        return TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False,
                                           lora_dir=small, **ARGS, **over),
                           params=params_from_jax(tree, tc, "cpu"))

    je = JaxEngine(JaxEngineArgs(config=jc, lora_dir=small, **ARGS, **spec), params=params)
    te, pe = port(**spec), port()
    out = {}
    for name, e, api in (("jax", je, JAX), ("spec", te, TORCH), ("plain", pe, TORCH)):
        try:
            out[name] = [await _one(e, api, p, lora, 24) for p in LOOPING
                         for lora in ("soft", None)]
            out[name + "_stats"] = e.stats()
        finally:
            await e.stop()
    assert out["spec"] == out["jax"] == out["plain"]
    assert out["spec"][0] != out["spec"][1] or out["spec"][2] != out["spec"][3]
    st = out["spec_stats"]
    assert st["spec_ticks"] > 0 and st["spec_accepted"] > 0
    assert (st["spec_proposed"], st["spec_accepted"]) == (
        out["jax_stats"]["spec_proposed"], out["jax_stats"]["spec_accepted"])


# -- graph keys and restacks --------------------------------------------------


def test_restacks_keep_or_drop_the_graphs_by_the_stacks_shape(monkeypatch, lora_root):
    from tests.test_torch_compile_watch import _stand_in_card
    from dynamo_tpu_torch.runtime import device_observe as tdo

    watcher = tdo.CompileWatcher()
    monkeypatch.setattr(tdo, "_WATCHER", watcher)
    root, extra = lora_root
    tc = tconfig.tiny_config()
    runner = trunner.DeviceRunner(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False,
                                                  lora_dir=root, **ARGS))
    key0 = runner.lora_key()
    assert key0 == ((3, 4, ("w_down", "w_gate", "w_up", "wk", "wo", "wq", "wv")),)
    stack = {t: tuple(x.data_ptr() for x in ab) for t, ab in runner.lora.items()}

    def load(name):
        runner.install_adapter(trunner._adapter_to_host(
            tloader.load_lora_adapter(os.path.join(extra, name), tc)))

    with _stand_in_card(monkeypatch, runner) as on_card:
        on_card((1, False, False) + key0)
        on_card((2, False, False) + key0)
        runner.spec_graphs[("spec", 1, 4) + key0] = "verify"
        # unload b, load c into its slot: the same shape, in place
        runner.remove_adapter("adapter-b")
        load("adapter-c")
        assert runner.lora_key() == key0 and len(runner.graphs) == 2 and runner.spec_graphs
        assert {t: tuple(x.data_ptr() for x in ab) for t, ab in runner.lora.items()} == stack
        assert runner.lora_index == {"adapter-a": 1, "adapter-c": 2}
        # a higher rank and a fourth slot: the shape changes, graphs drop
        load("adapter-wide")
        key1 = runner.lora_key()
        assert key1 == ((4, 8, key0[0][2]),) and not runner.graphs and not runner.spec_graphs
        on_card((1, False, False) + key1)
        # the last adapter out: no stack, the keys of an engine without LoRA
        for name in ("adapter-a", "adapter-c", "adapter-wide"):
            runner.remove_adapter(name)
        assert runner.lora is None and runner.lora_key() == () and not runner.graphs
        on_card((1, False, False))
    st = watcher.snapshot()["programs"][trunner.DECODE_PROGRAM]
    assert st["compiles"] == st["signatures"] == 4 and st["storms"] == 0
    # in place: b's unload, c's load; reshaped: the start, the wide load,
    # a's and c's unloads (each shrinks the targets, as JAX's restack does)
    assert runner.lora_restacks == {"in_place": 2, "reshaped": 4}
    assert runner._captures[(False, False)].signatures == 4


def test_the_first_stack_drops_the_graphs_captured_without_one(monkeypatch, lora_root):
    """A runner without ``lora_dir`` takes its first adapter at run time:
    the decode and verify graphs captured without a stack, which no key
    replays after it, are dropped with it."""
    from tests.test_torch_compile_watch import _stand_in_card
    from dynamo_tpu_torch.runtime import device_observe as tdo

    monkeypatch.setattr(tdo, "_WATCHER", tdo.CompileWatcher())
    _, extra = lora_root
    tc = tconfig.tiny_config()
    runner = trunner.DeviceRunner(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False,
                                                  **ARGS))
    assert runner.lora is None and runner.lora_key() == ()
    with _stand_in_card(monkeypatch, runner) as on_card:
        on_card((1, False, False))
        on_card((2, False, False))
        runner.spec_graphs[("spec", 1, 4)] = "verify"
        runner.install_adapter(trunner._adapter_to_host(
            tloader.load_lora_adapter(os.path.join(extra, "adapter-c"), tc)))
        assert not runner.graphs and not runner.spec_graphs
        assert runner.lora_key() == ((2, 2, ("wq", "wv")),)
        on_card((1, False, False) + runner.lora_key())
    assert list(runner.graphs) == [(1, False, False) + runner.lora_key()]
    assert runner.lora_restacks == {"in_place": 0, "reshaped": 1}


def test_the_stacks_bytes_are_the_ledgers_lora_entry(lora_root):
    root, extra = lora_root
    tc = tconfig.tiny_config()
    engine = TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False,
                                         lora_dir=root, **ARGS))
    per_slot_rank = sum(sum(_dims(tc, t)) for t in TARGETS) * tc.n_layers * 4  # f32
    assert engine.hbm.snapshot()["lora"] == 3 * 4 * per_slot_rank
    engine.load_lora("adapter-wide", os.path.join(extra, "adapter-wide"))
    assert engine.hbm.snapshot()["lora"] == 4 * 8 * per_slot_rank
    plain = TorchEngine(TorchEngineArgs(config=tc, device="cpu", cuda_graphs=False, **ARGS))
    assert plain.hbm.snapshot()["lora"] == 0 and plain.runner.lora is None


# -- routing, cache, load estimator, source: both packages --------------------

PACKAGES = {"jax": (jlora_pkg, jrouting), "torch": (tlora_pkg, trouting)}
WORKERS = [(10, 0), (11, 0), (12, 0), (13, 1)]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_hrw_placement_and_the_routing_table(pkg):
    lora, routing = PACKAGES[pkg]
    H = lora.RendezvousHasher
    assert H.rank_workers("adapter-a", WORKERS) == H.rank_workers("adapter-a", WORKERS)
    names = [f"lora-{i}" for i in range(40)]
    before = {n: H.allocate(n, WORKERS, 1)[0] for n in names}
    shrunk = [w for w in WORKERS if w != (11, 0)]
    after = {n: H.allocate(n, shrunk, 1)[0] for n in names}
    assert all(after[n] == before[n] for n in names if before[n] != (11, 0))
    table = lora.LoraRoutingTable()
    table.update_allocation("a", routing.LoraReplicaConfig(n_desired=2))
    table.update_allocation("b", routing.LoraReplicaConfig(n_desired=1))
    table.reallocate(WORKERS)
    table.reallocate(WORKERS, desired={"b": 3})
    out = (before, {n: table.get_replica_set(n) for n in ("a", "b")}, table.list_loras(),
           routing.RandomAllocator.allocate("x", WORKERS, 2),
           H.compute_score("adapter-a", (10, 0)))
    jout = _jax_routing(names)
    assert out == jout
    assert table.remove_lora("a") is not None and table.get_replica_set("a") is None


def _jax_routing(names):
    H, table = jlora_pkg.RendezvousHasher, jlora_pkg.LoraRoutingTable()
    table.update_allocation("a", jrouting.LoraReplicaConfig(n_desired=2))
    table.update_allocation("b", jrouting.LoraReplicaConfig(n_desired=1))
    table.reallocate(WORKERS)
    table.reallocate(WORKERS, desired={"b": 3})
    return ({n: H.allocate(n, WORKERS, 1)[0] for n in names},
            {n: table.get_replica_set(n) for n in ("a", "b")}, table.list_loras(),
            jrouting.RandomAllocator.allocate("x", WORKERS, 2),
            H.compute_score("adapter-a", (10, 0)))


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_local_source_and_cache(pkg, lora_root):
    lora, _ = PACKAGES[pkg]
    root, _ = lora_root
    source = lora.LocalLoRASource(root)
    assert source.list_adapters() == ["adapter-a", "adapter-b"]
    assert lora.LocalLoRASource(os.path.join(root, "nowhere")).list_adapters() == []
    cache = lora.LoRACache(source, max_adapters=1)
    p = cache.get("adapter-a")
    assert p == os.path.join(root, "adapter-a")
    assert cache.get("adapter-a") == p and cache.stats() == {"cached": 1, "hits": 1, "misses": 1}
    cache.get("adapter-b")  # evicts adapter-a
    assert cache.list_cached() == ["adapter-b"] and not cache.contains("adapter-a")
    with pytest.raises(FileNotFoundError):
        cache.get("ghost")
    with pytest.raises(NotImplementedError, match="egress"):
        __import__(lora.__name__ + ".source", fromlist=["x"]).RemoteLoRASource("s3://b/a")


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_load_estimator_tracks_peak(pkg):
    lora, _ = PACKAGES[pkg]
    est = lora.LoadEstimator(lora.LoadEstimatorConfig(per_replica_capacity=2.0))
    for _ in range(5):
        est.increment("a")
    est.increment("b")
    assert est.current_load() == {"a": 5, "b": 1}
    assert est.desired_replicas() == {"a": 3, "b": 1}
    for _ in range(5):
        est.decrement("a")
    assert "a" not in est.current_load() and est.desired_replicas()["a"] == 3
    assert [n for _, n in est.time_series("b")] == [1] and est.peak_load("a") == 5


def test_the_packages_export_the_same_names():
    assert tlora_pkg.__all__ == jlora_pkg.__all__
    assert tloader._TARGET_MAP == jloader._TARGET_MAP
