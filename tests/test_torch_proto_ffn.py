"""The int8 weight-streaming FFN (ops/ffn_int8.ffn_int8_ref and the wrapper
of ops/cuda/ffn_int8.py) against the TPU prototype of _prof_fused_ffn.py:
``ffn_pallas`` under ``force_tpu_interpret_mode`` and ``ffn_xla``, on the
CPU. The prototype's kernel reads its geometry from module globals (B, D,
F, NT), so a fixture sets them to a miniature (8 rows, d 256, F 1,024 in two
512-wide tiles) and restores them. Inputs are made from numpy seeds, with
the prototype's value ranges (codes in [-127, 127), scales ~0.01).

Tolerance: one bf16 step of each element (tools.cases.bf16_steps <= 1).
Both sum exact bf16 x int8 products in float32 in different orders and
round h and the output to bf16, so an output on a rounding boundary may
land one step away; measured here: 0 on these seeds, at values up to
~14,000 (a step there is 64). The JAX side is compiled with XLA's excess
precision off, so that its bf16 roundings stay where the TPU takes them
(XLA on the CPU may otherwise keep bf16 intermediates in float32, as
tests/test_torch_fused_layer.py found for the fused layer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dynamo_tpu_torch.ops.cuda import ffn_int8 as tkernel
from dynamo_tpu_torch.ops.ffn_int8 import ffn_int8_ref
from dynamo_tpu_torch.tools.cases import bf16_steps
from tests.test_torch_proto_attention import load_script

MINI = dict(B=8, D=256, F=1024, NT=2)  # NT = F / TF, TF = 512 in the prototype
STRICT = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module")
def proto():
    mod = load_script("_prof_fused_ffn")
    saved = {name: getattr(mod, name) for name in MINI}
    for name, value in MINI.items():
        setattr(mod, name, value)
    yield mod
    for name, value in saved.items():
        setattr(mod, name, value)


def ffn_inputs(M, d, F, seed):
    """(x bf16, wg, wu, wd int8, sg, su, sd float32), as numpy arrays."""
    rng = np.random.default_rng(seed)
    codes = lambda *s: rng.integers(-127, 127, s).astype(np.int8)  # noqa: E731
    x = np.asarray(jnp.asarray(rng.standard_normal((M, d)).astype(np.float32), jnp.bfloat16))
    return (x, codes(d, F), codes(d, F), codes(F, d),
            (rng.standard_normal((1, F)) * 0.01).astype(np.float32),
            (rng.standard_normal((1, F)) * 0.01).astype(np.float32),
            (rng.standard_normal((1, d)) * 0.01).astype(np.float32))


def _torch(arrays):
    out = []
    for a in arrays:
        if a.dtype.name == "bfloat16":
            out.append(torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16))
        else:
            out.append(torch.from_numpy(np.array(a)))
    return out


def _strict(fn, args):
    jargs = [jnp.asarray(a) for a in args]
    return np.asarray(jax.block_until_ready(
        jax.jit(fn).lower(*jargs).compile(compiler_options=STRICT)(*jargs)), np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_matches_the_pallas_prototype(proto, seed):
    args = ffn_inputs(MINI["B"], MINI["D"], MINI["F"], seed)
    with pltpu.force_tpu_interpret_mode():
        want = _strict(proto.ffn_pallas, args)
    got = ffn_int8_ref(*_torch(args))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (MINI["B"], MINI["D"])
    assert bf16_steps(got, torch.from_numpy(want)) <= 1.0


@pytest.mark.parametrize("M,d,F,seed", [(8, 256, 1024, 2), (13, 384, 640, 3), (64, 128, 256, 4)])
def test_plain_version_matches_ffn_xla(proto, M, d, F, seed):
    """ffn_xla reads no globals: any geometry the kernel takes."""
    args = ffn_inputs(M, d, F, seed)
    want = _strict(proto.ffn_xla, args)
    got = ffn_int8_ref(*_torch(args))
    assert bf16_steps(got, torch.from_numpy(want)) <= 1.0


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    args = _torch(ffn_inputs(5, 256, 512, 5))
    tkernel.reset_launch_counts()
    assert torch.equal(tkernel.ffn_int8(*args), ffn_int8_ref(*args))
    assert tkernel.launch_counts == {"ffn_int8": 0}
    with pytest.raises(ValueError, match="device"):
        tkernel.ffn_int8(args[0].to("meta"), *args[1:])


def test_wrapper_check_refuses_what_the_kernel_does_not_take():
    x, wg, wu, wd, sg, su, sd = _torch(ffn_inputs(8, 256, 512, 6))
    tkernel.check(x, wg, wu, wd, sg, su, sd)
    big = x.repeat(9, 1)  # 72 rows > 64
    with pytest.raises(ValueError, match="rows"):
        tkernel.check(big, wg, wu, wd, sg, su, sd)
    with pytest.raises(TypeError):
        tkernel.check(x.float(), wg, wu, wd, sg, su, sd)
    with pytest.raises(TypeError):
        tkernel.check(x, wg.float(), wu, wd, sg, su, sd)
    with pytest.raises(ValueError, match="multiples of 128"):
        x2, g2, u2, d2, sg2, su2, sd2 = _torch(ffn_inputs(8, 192, 512, 7))
        tkernel.check(x2, g2, u2, d2, sg2, su2, sd2)
    with pytest.raises(ValueError, match="do not fit"):
        tkernel.check(x, wg, wu, wg.t().contiguous()[:, :128].contiguous(), sg, su, sd)
    with pytest.raises(ValueError, match="contiguous"):
        tkernel.check(x, wg, wu, wd.t(), sg, su, sd)


def test_prof_fused_ffn_entry_point_runs_on_the_cpu():
    """tools/prof_fused_ffn at a miniature with device="cpu": the gate
    passes (the wrapper is the plain version there) and both clocks read."""
    from dynamo_tpu_torch.tools import prof_fused_ffn

    res = prof_fused_ffn.run("cpu", M=8, d=256, ff=512)
    assert res["rel_err"] == 0.0 and res["device"].startswith("cpu")
    assert res["kernel_us"] > 0 and res["plain_us"] > 0
    assert res["weight_gb"] == 3 * 256 * 512 / 1e9
