"""Launch plans of the kernels on the shared int8 streaming core, from the
shapes alone (CPU): the int8 FFN's two launches (ops/cuda/ffn_int8.plans,
the int8 product's plan with the gate and up matrices side by side in each
stage) against an H100's cluster capacity table, and the fused decoder
layer's plan (ops/cuda/fused_layer.plan: the four products' K splits, the
attention items and the pools' copy boxes) against the kernel's rules."""

import pytest

from dynamo_tpu_torch.ops.cuda import ffn_int8 as tffn
from dynamo_tpu_torch.ops.cuda import fused_layer as tfused
from dynamo_tpu_torch.ops.cuda import int8_matmul as tmatmul
from dynamo_tpu_torch.tools.cases import LAYER_CASES

# Clusters of S blocks (blocks, for S = 1) an H100 SXM holds at once, at
# one and at two blocks an SM (tools/int8_stream_probe.py's capacity line),
# as tests/test_torch_kv_quant.py's table.
H100_CAPACITY = {**{(s, 1): n for s, n in
                    {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}.items()},
                 **{(s, 2): n for s, n in
                    {1: 264, 2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30}.items()}}
FFN_SHAPES = [(4096, 14336), (256, 512), (384, 1152), (1152, 6912), (2048, 8192)]


@pytest.mark.parametrize("d,F", FFN_SHAPES)
def test_ffn_plans_cover_k_in_whole_chunks_within_a_cluster(d, F):
    for M in (1, 13, 16, 33, 64):
        plans = tffn.plans(M, d, F, 132, H100_CAPACITY)
        for (splits, split_k), K in zip(plans, (d, F)):
            assert split_k % 128 == 0 and split_k > 0
            assert splits * split_k >= K > (splits - 1) * split_k  # none empty
            assert 1 <= splits <= tmatmul.MAX_SPLITS  # one cluster
        assert plans == tffn.plans(M, d, F, 132, dict(H100_CAPACITY))  # pure


def test_ffn_plans_at_llama3_8b_widths():
    """Gate/up: 112 tiles of both matrices, one block an SM (two 16 KB
    chunks a stage fill 128 KB), one wave unsplit; down: 32 tiles in 3."""
    for M in (1, 13, 64):
        assert tffn.plans(M, 4096, 14336, 132, H100_CAPACITY) == ((1, 4096), (3, 4864))
    # two matrices a stage never share an SM; one does at up to 32 rows
    assert tmatmul.blocks_per_sm(32, 5, mats=2) == 1
    assert tmatmul.blocks_per_sm(32, 5, mats=1) == 2
    # the shared memory the kernel asks for: the ring of both matrices and x
    assert tmatmul.smem_bytes(64, 32, mats=2) == 1024 + 4 * 2 * 16384 + 2 * 3 * 64 * 256


def test_one_matrix_plan_is_the_int8_products():
    """With one matrix a stage the plan is the int8 product's (the FFN's
    down launch runs that kernel's code)."""
    for M in (1, 32, 64):
        for K, N in ((4096, 4096), (14336, 4096), (1152, 256)):
            assert tmatmul.plan(M, K, N, 132, H100_CAPACITY, mats=1) == \
                tmatmul.plan(M, K, N, 132, H100_CAPACITY)


@pytest.mark.parametrize("label", list(LAYER_CASES))
def test_fused_layer_plan_at_every_layer_case(label):
    """Splits cut each product's chunks evenly (at most 16), attention
    items cover the table's keys, and a copy box never crosses a page."""
    B, d, H, KH, D, F, starts, knobs, _ = LAYER_CASES[label]
    BS = knobs.get("BS", 16)
    P = knobs.get("P") or max(s // BS + 1 for s in starts)
    for grid in (264, 132, 16):
        pl = tfused.plan(B, d, H, KH, D, F, P, BS, grid)
        for name, K in (("s_qkv", d), ("s_o", H * D), ("s_gu", d), ("s_down", F)):
            assert 1 <= pl[name] <= tfused.MAX_SPLITS and (K // 128) % pl[name] == 0, name
        assert pl["n_split"] * tfused.SPLIT_KEYS >= P * BS > (pl["n_split"] - 1) * tfused.SPLIT_KEYS
        bk = pl["box_keys"]
        assert bk & (bk - 1) == 0 and bk <= 16 and BS % bk == 0


def test_fused_layer_plan_at_llama3_8b_b16():
    """264 co-resident blocks (two an SM): every product in one round of
    items — q/k/v 48 tiles x 4, o 32 x 8, gate/up 112 tile pairs x 2,
    down 32 x 8 — and six 256-key items a row at 94 pages of 16."""
    pl = tfused.plan(16, 4096, 32, 8, 128, 14336, 94, 16, 264)
    assert pl == {"s_qkv": 4, "s_o": 8, "s_gu": 2, "s_down": 8, "n_split": 6, "box_keys": 16}
    tiles = {"s_qkv": 48, "s_o": 32, "s_gu": 112, "s_down": 32}
    assert all(tiles[k] * pl[k] <= 264 for k in tiles)


def test_split_choice_and_boxes():
    # the fewest splits on a tie; only splits that cut the chunks evenly
    assert tfused.choose_split(8, 32, 264) == 16
    assert tfused.choose_split(300, 32, 264) == 4  # 5 rounds of 8 chunks beat 2 of 32
    assert tfused.choose_split(32, 112, 264) == 8  # 112 chunks: 1, 2, 4, 7, 8, 14, 16
    assert tfused.choose_split(112, 32, 264, mats=2) == 2
    assert [tfused.box_keys(bs) for bs in (1, 2, 8, 12, 16, 32, 128)] == [1, 2, 8, 4, 16, 16, 16]
