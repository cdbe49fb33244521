"""The port's pure-Python msgpack subset (runtime/network/msgpack_lite.py)
against the msgpack package: packb byte for byte equal to
``msgpack.packb(use_bin_type=True)`` on generated nested values and at every
width boundary, the default hook, the errors msgpack raises, and unpackb /
the streaming Unpacker returning msgpack's values (a torn tail ending the
iteration at the same offset)."""

import io
import math

import msgpack
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu.llm.protocols import common as jproto
from dynamo_tpu.runtime.network import codec as jcodec
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.runtime.network import codec as tcodec
from dynamo_tpu_torch.runtime.network import msgpack_lite as ml

INTS = st.integers(min_value=-(2 ** 63), max_value=2 ** 64 - 1)
SCALARS = (st.none() | st.booleans() | INTS
           | st.floats(allow_nan=False) | st.text(max_size=300) | st.binary(max_size=300))
KEYS = st.text(max_size=40) | st.integers(min_value=-(2 ** 63), max_value=2 ** 64 - 1)
VALUES = st.recursive(
    SCALARS,
    lambda kids: (st.lists(kids, max_size=20) | st.tuples(kids, kids)
                  | st.dictionaries(KEYS, kids, max_size=20)),
    max_leaves=60,
)


def ref_pack(obj, default=None):
    return msgpack.packb(obj, default=default, use_bin_type=True)


def ref_unpack(data):
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


@settings(max_examples=200, derandomize=True, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(VALUES)
def test_packb_is_msgpacks_bytes_on_generated_values(value):
    want = ref_pack(value)
    assert ml.packb(value) == want
    assert ml.unpackb(want, strict_map_key=False) == ref_unpack(want)


@settings(max_examples=60, derandomize=True, deadline=None)
@given(st.lists(VALUES, min_size=1, max_size=8), st.sampled_from([5, 64, 4096]))
def test_unpacker_streams_msgpacks_values(values, read_size):
    data = b"".join(ref_pack(v) for v in values)
    got = ml.Unpacker(io.BytesIO(data), strict_map_key=False, read_size=read_size)
    want = msgpack.Unpacker(io.BytesIO(data), raw=False, strict_map_key=False)
    assert list(got) == list(want)
    assert got.tell() == want.tell() == len(data)


BOUNDARY_INTS = [0, 1, 127, 128, 2 ** 7 - 1, -(2 ** 7), -(2 ** 7) - 1, 255, 256, 2 ** 8,
                 2 ** 16 - 1, 2 ** 16, 2 ** 32 - 1, 2 ** 32, 2 ** 63 - 1, 2 ** 63,
                 2 ** 64 - 1, -1, -32, -33, -(2 ** 15), -(2 ** 15) - 1, -(2 ** 31),
                 -(2 ** 31) - 1, -(2 ** 63)]
BOUNDARY_LENGTHS = [0, 15, 16, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize("n", BOUNDARY_INTS)
def test_int_widths(n):
    assert ml.packb(n) == ref_pack(n)
    assert ml.unpackb(ml.packb(n)) == n


@pytest.mark.parametrize("n", BOUNDARY_LENGTHS)
@pytest.mark.parametrize("kind", ["str", "str_multibyte", "bin", "bytearray", "list",
                                  "tuple", "map"])
def test_length_widths(kind, n):
    value = {"str": "a" * n, "str_multibyte": "é" * (n // 2), "bin": b"\x01" * n,
             "bytearray": bytearray(n), "list": [1] * n, "tuple": (None,) * n,
             "map": {f"k{i}": i for i in range(n)}}[kind]
    assert ml.packb(value) == ref_pack(value)
    assert ml.unpackb(ml.packb(value)) == ref_unpack(ref_pack(value))


@pytest.mark.parametrize("value", [1.5, -0.0, math.inf, -math.inf, 1e308, 5e-324,
                                   float("nan")], ids=repr)
def test_floats_are_float64(value):
    assert ml.packb(value) == ref_pack(value)


def test_int_keyed_maps_and_strict_map_key():
    value = {1: 2.0, -5: "x", 2 ** 40: [1, {3: None}]}  # OpenAI logit_bias shape
    data = ml.packb(value)
    assert data == ref_pack(value)
    assert ml.unpackb(data, strict_map_key=False) == ref_unpack(data) == value
    with pytest.raises(ValueError, match="not allowed for map key"):
        ml.unpackb(data)
    with pytest.raises(ValueError):
        msgpack.unpackb(data, raw=False)


def test_subclasses_pack_as_their_base_type():
    class D(dict):
        pass

    value = [jproto.FinishReason.EOS, tproto.FinishReason.LENGTH, True, False, D(a=1),
             memoryview(b"xy")]
    assert ml.packb(value) == ref_pack(value)


def _output(proto):
    return proto.BackendOutput(token_ids=[7, 8], finish_reason=proto.FinishReason.EOS,
                               cumulative_tokens=9, error_kind=None, extra={"k": [1]})


def test_default_hook_on_backend_output():
    """The codec's default (``to_dict``) turns a BackendOutput into the
    same bytes in both packages, and unknown objects raise TypeError."""
    t, j = _output(tproto), _output(jproto)
    assert ml.packb(t, default=tcodec._default) == ref_pack(j, default=jcodec._default)
    assert ml.packb({"o": [t]}, default=tcodec._default) == ref_pack(
        {"o": [j]}, default=jcodec._default)
    assert ml.unpackb(ml.packb(t, default=tcodec._default))["finish_reason"] == "eos"
    # the hook runs once an object: what it returns must pack
    with pytest.raises(TypeError):
        ml.packb(object(), default=lambda o: o)
    with pytest.raises(TypeError):
        ref_pack(object(), default=lambda o: o)


@pytest.mark.parametrize("value", [object(), {1, 2}, 1j, [1, object()], {"a": {None: set()}},
                                   frozenset()], ids=lambda v: type(v).__name__)
def test_unsupported_types_raise_type_error(value):
    with pytest.raises(TypeError):
        ref_pack(value)
    with pytest.raises(TypeError):
        ml.packb(value)


@pytest.mark.parametrize("value", [2 ** 64, -(2 ** 63) - 1, [2 ** 70]])
def test_ints_out_of_range_raise_overflow(value):
    with pytest.raises(OverflowError):
        ref_pack(value)
    with pytest.raises(OverflowError):
        ml.packb(value)
    # the default hook gets a second chance, as in msgpack
    assert ml.packb(value, default=str) == ref_pack(value, default=str)


def test_unpackb_errors_match_msgpacks():
    data = ref_pack([1, 2, 3])
    for bad in (data[:-1], data + b"\x01", b"\xc1"):
        with pytest.raises(ValueError) as want:
            msgpack.unpackb(bad, raw=False)
        with pytest.raises(ValueError) as got:
            ml.unpackb(bad)
        # ValueError (incomplete), ExtraData, FormatError: msgpack's names
        assert type(got.value).__name__ == type(want.value).__name__
    with pytest.raises(ml.ExtraData):
        ml.unpackb(data + b"\x01")


def test_unpacker_stops_at_a_torn_tail_where_msgpack_does():
    """The broker's log recovery reads records until a torn tail, then
    truncates at tell(): the same records and offset as msgpack's."""
    recs = [ref_pack([i, "topic", ref_pack({"i": i, "pad": "x" * (40 * i)})])
            for i in range(1, 9)]
    data = b"".join(recs)
    for cut in (len(data) - 1, len(data) - len(recs[-1]) // 2, len(recs[0]) + 3):
        torn = data[:cut]
        got = ml.Unpacker(io.BytesIO(torn), strict_map_key=False, read_size=37)
        want = msgpack.Unpacker(io.BytesIO(torn), raw=False, strict_map_key=False)
        got_items, want_items = [], []
        for items, unp in ((got_items, got), (want_items, want)):
            for rec in unp:
                items.append((rec, unp.tell()))
        assert got_items == want_items


def test_unpacker_feed():
    got = ml.Unpacker()
    want = msgpack.Unpacker(raw=False)
    data = b"".join(ref_pack(v) for v in ({"a": 1}, [b"x" * 300], "end"))
    got_items, want_items = [], []
    for i in range(0, len(data), 7):
        got.feed(data[i:i + 7])
        want.feed(data[i:i + 7])
        got_items += list(got)
        want_items += list(want)
    assert got_items == want_items == [{"a": 1}, [b"x" * 300], "end"]
    assert got.tell() == want.tell() == len(data)


def test_deep_nesting_limit():
    deep = []
    for _ in range(600):
        deep = [deep]
    with pytest.raises(ValueError):
        ref_pack(deep)
    with pytest.raises(ValueError):
        ml.packb(deep)
