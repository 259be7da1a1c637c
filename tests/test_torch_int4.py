"""comorag_torch.ops.int4 against comorag_tpu.ops.pallas_int4.

The same numpy weights and activations go through both packages:
- packed bytes equal exactly, scales to 1e-7 relative;
- ``dequantize_int4`` is exact;
- ``int4_matmul``'s plain version against JAX's ``interpret=True`` route:
  both round x to bf16 and sum in fp32, JAX applies the scales to the
  weights before one dot and the port to each group's product, so they
  differ by fp32 rounding only: 1e-5 + 1e-5*|jax|;
- ``int4_fused_layer_tail``'s plain version against JAX ``interpret=True``:
  the port rounds ctx, xn and h to bf16 as the TPU kernel does, JAX's
  portable route keeps them in fp32, so the bf16 rule scaled to the
  output's magnitude, |d| <= 2e-2 * max|jax| + 2e-2 * |jax| (each bf16
  rounding errs relative to the sums it feeds, not to the element);
- ``int4_matmul``'s decode route as the kernel forms it (fp32 partials over
  ``matmul_plan``'s K splits, summed in split order) against JAX's
  ``interpret=True`` route: fp32 rounding only, 1e-5 + 1e-5*|jax|.
The CUDA-marked cases hold the kernels against the plain versions on a
card and skip elsewhere: every route under the bf16 rule, and the decode
route against its split order to 1e-4 * max|plain| + 1e-4 * |plain| (the
tensor cores sum a group in another fp32 order than torch.matmul).
"""

import ctypes
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comorag_torch.ops import int4 as tint4
from comorag_tpu.ops import pallas_int4 as jint4

BF16_TOL = 2e-2


def _weights(rng, d_in, d_out, gs=128):
    w = (rng.standard_normal((d_in, d_out)) * 0.05).astype(np.float32)
    jp, js = jint4.quantize_int4_grouped(jnp.asarray(w), gs)
    tp, ts = tint4.quantize_int4_grouped(torch.tensor(w), gs)
    return w, (np.asarray(jp), np.asarray(js)), (tp, ts)


@pytest.mark.parametrize("d_in,d_out,gs", [(256, 384, 128), (128, 259, 64), (64, 70, 16)])
def test_quantize_packing_is_byte_identical(d_in, d_out, gs):
    rng = np.random.default_rng(d_in + d_out)
    _, (jp, js), (tp, ts) = _weights(rng, d_in, d_out, gs)
    assert tp.dtype == torch.int8 and tuple(tp.shape) == jp.shape
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-7, atol=0)


def test_quantize_stacked_layers_matches_per_layer():
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((3, 256, 96)) * 0.05).astype(np.float32)
    tp, ts = tint4.quantize_int4_grouped(torch.tensor(w), 128)
    for layer in range(3):
        jp, js = jint4.quantize_int4_grouped(jnp.asarray(w[layer]), 128)
        np.testing.assert_array_equal(tp[layer].numpy(), np.asarray(jp))
        np.testing.assert_allclose(ts[layer].numpy(), np.asarray(js), rtol=1e-7, atol=0)


def test_dequantize_is_exact():
    rng = np.random.default_rng(1)
    _, (jp, js), (tp, ts) = _weights(rng, 256, 200)
    np.testing.assert_array_equal(tint4.dequantize_int4(tp, ts, 128).numpy(),
                                  np.asarray(jint4.dequantize_int4(jnp.asarray(jp), jnp.asarray(js), 128)))


@pytest.mark.parametrize("m", [1, 8, 16, 130])
def test_int4_matmul_plain_matches_jax_interpret(m):
    rng = np.random.default_rng(m)
    _, (jp, js), (tp, ts) = _weights(rng, 512, 600)  # ragged out: 600 is no tile multiple
    x = rng.standard_normal((m, 512)).astype(np.float32)
    want = np.asarray(jint4.int4_matmul(jnp.asarray(x), jnp.asarray(jp), jnp.asarray(js), interpret=True))
    before = tint4.LAUNCHES.value
    got = tint4.int4_matmul(torch.tensor(x), tp, ts, 128)
    assert tint4.LAUNCHES.value == before  # the CPU runs the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, 600)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _tail_inputs(rng, m, hidden=512, inter=1024, gs=128):
    ctx = rng.standard_normal((m, hidden)).astype(np.float32)
    xres = rng.standard_normal((m, hidden)).astype(np.float32)
    nw = (1.0 + 0.1 * rng.standard_normal(hidden)).astype(np.float32)
    mats = [_weights(rng, hidden, hidden, gs), _weights(rng, hidden, 2 * inter, gs), _weights(rng, inter, hidden, gs)]
    return ctx, xres, nw, mats


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("act", ["silu", "gelu_tanh", "gelu"])
@pytest.mark.parametrize("unit_offset", [False, True])
def test_fused_tail_plain_matches_jax_interpret(m, act, unit_offset):
    rng = np.random.default_rng(m)
    ctx, xres, nw, mats = _tail_inputs(rng, m)
    jw = [a for _, j, _ in mats for a in map(jnp.asarray, j)]
    tw = [a for _, _, t in mats for a in t]
    want = np.asarray(jint4.int4_fused_layer_tail(
        jnp.asarray(ctx), jnp.asarray(xres), jnp.asarray(nw), *jw, group_size=128, eps=1e-5,
        unit_offset=unit_offset, act=act, interpret=True))
    got = tint4.int4_fused_layer_tail(torch.tensor(ctx), torch.tensor(xres), torch.tensor(nw), *tw,
                                      group_size=128, eps=1e-5, unit_offset=unit_offset, act=act)
    assert tuple(got.shape) == (m, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16_TOL, atol=BF16_TOL * np.abs(want).max())


# the decoder's widths: Llama-3.1-8B (chip_smoke.py's server) and DecoderArch's default
_WIDTHS = [(4096, 14336), (2048, 5632)]
# the fused-tail kernel's geometry on an H100 as csrc/int4.cu builds it (the
# library reports it: test_tail_geometry_is_the_kernels holds these on a card)
_TILE_N = 128


def _blocks_per_sm(m):
    return 2 if m <= 32 else 1


def _plan(m, hidden, inter, gs):
    return tint4.tail_plan(m, hidden, inter, gs, 132, _TILE_N, _blocks_per_sm(m))


@pytest.mark.parametrize("hidden,inter", _WIDTHS + [(1024, 2560), (512, 1024)])
@pytest.mark.parametrize("m", [1, 8, 17, 64])
@pytest.mark.parametrize("gs", [64, 128, 512])
def test_tail_plan_splits_cover_k_once_on_group_boundaries(hidden, inter, m, gs):
    plan = _plan(m, hidden, inter, gs)
    assert gs % plan["k_step"] == 0  # a pipeline step never straddles a scale group
    for name, k, n in (("o", hidden, hidden), ("gate_up", hidden, inter), ("down", inter, hidden)):
        stage = plan["stages"][name]
        assert stage["k"] == k and stage["tiles"] * plan["tile_n"] == n
        bounds = stage["bounds"]
        assert len(bounds) == stage["splits"] and stage["items"] == stage["tiles"] * stage["splits"]
        assert bounds[0][0] == 0 and bounds[-1][1] == k
        for (k0, k1), (n0, _) in zip(bounds, bounds[1:] + [(k, None)]):
            assert k1 == n0 and k0 < k1 and k0 % gs == 0 and k1 % gs == 0


@pytest.mark.parametrize("hidden,inter", _WIDTHS)
@pytest.mark.parametrize("m", [8, 64])
def test_tail_plan_fills_every_sm(hidden, inter, m):
    plan = _plan(m, hidden, inter, 128)
    for name, stage in plan["stages"].items():
        assert stage["items"] >= 132, (name, stage["tiles"], stage["splits"])


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("act,unit_offset", [("silu", False), ("gelu_tanh", True), ("gelu", False)])
def test_split_partials_in_plan_order_match_jax(m, act, unit_offset):
    """The kernel's arithmetic on the CPU: each stage as fp32 partials over
    the plan's K splits (here the most splits a 132-SM card is given at
    this width), summed in split order, at the kernel's rounding points.
    Held against JAX's fused-tail reference (its XLA route), which keeps
    ctx, xn and h in fp32: each bf16 rounding errs relative to the sums it
    feeds, hence the bf16 rule scaled to max |jax|, as for the plain tail."""
    rng = np.random.default_rng(100 + m)
    hidden, inter, gs = 512, 1024, 64
    ctx, xres, nw, mats = _tail_inputs(rng, m, hidden, inter, gs)
    jw = [a for _, j, _ in mats for a in map(jnp.asarray, j)]
    want = np.asarray(jint4.int4_fused_layer_tail(
        jnp.asarray(ctx), jnp.asarray(xres), jnp.asarray(nw), *jw, group_size=gs, eps=1e-5,
        unit_offset=unit_offset, act=act, interpret=True))
    plan = _plan(m, hidden, inter, gs)["stages"]
    assert plan["o"]["splits"] > 1 and plan["down"]["splits"] > 1
    (op, os_), (gp, gsc), (dp, ds) = (t for _, _, t in mats)
    xmid = torch.tensor(xres) + tint4.split_partials_plain(torch.tensor(ctx), op, os_, gs, plan["o"]["bounds"])
    normed = xmid * torch.rsqrt((xmid * xmid).mean(dim=-1, keepdim=True) + 1e-5)
    w = torch.tensor(nw)
    xn = normed * (1.0 + w) if unit_offset else normed * w
    gu = tint4.split_partials_plain(xn, gp, gsc, gs, plan["gate_up"]["bounds"])
    h = tint4.activation(gu[:, :inter], act) * gu[:, inter:]
    got = xmid + tint4.split_partials_plain(h, dp, ds, gs, plan["down"]["bounds"])
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16_TOL, atol=BF16_TOL * np.abs(want).max())


# int4_matmul's split-K decode route: qkv and lm_head of Llama-3.1-8B,
# DecoderArch's default qkv, the tiny model's K of 2 groups
_PRODUCTS = [(4096, 6144), (4096, 128256), (2048, 2560), (256, 512)]
# the split-K route's item width and blocks an SM as csrc/int4.cu builds
# them (the library reports them: test_splitk_geometry_is_the_kernels holds
# them on a card)
_SPLITK_TILE_N = 256


def _splitk_blocks_per_sm(m):
    return 5 if m <= 8 else 2 if m <= 32 else 1


@pytest.mark.parametrize("k,n", _PRODUCTS)
@pytest.mark.parametrize("m", [1, 8, 40, 64])
@pytest.mark.parametrize("gs", [64, 128])
def test_matmul_plan_splits_cover_k_once_on_group_boundaries(k, n, m, gs):
    plan = tint4.matmul_plan(m, k, n, gs, 132, _SPLITK_TILE_N, _splitk_blocks_per_sm(m))
    assert gs % plan["k_step"] == 0 and plan["tiles"] * plan["tile_n"] == n
    bounds = plan["bounds"]
    assert len(bounds) == plan["splits"] and plan["items"] == plan["tiles"] * plan["splits"]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    for (k0, k1), (n0, _) in zip(bounds, bounds[1:] + [(k, None)]):
        assert k1 == n0 and k0 < k1 and k0 % gs == 0 and k1 % gs == 0


@pytest.mark.parametrize("k,n", _PRODUCTS)
@pytest.mark.parametrize("m", [8, 64])
def test_matmul_plan_fills_every_sm(k, n, m):
    plan = tint4.matmul_plan(m, k, n, 128, 132, _SPLITK_TILE_N, _splitk_blocks_per_sm(m))
    groups = k // 128
    # every SM gets an item where tiles x groups allows it, else every group is a split
    assert plan["items"] >= 132 or plan["splits"] == groups, (plan["tiles"], plan["splits"])
    if (k, n) == (4096, 6144):
        assert plan["splits"] >= 6  # 24 column tiles: 132 SMs need at least 6 splits


def test_tail_plan_stages_are_matmul_plans():
    args = (132, _TILE_N, 2)
    plan = tint4.tail_plan(8, 4096, 14336, 128, *args)["stages"]
    for name, (k, n) in (("o", (4096, 4096)), ("gate_up", (4096, 14336)), ("down", (14336, 4096))):
        assert plan[name] == tint4.matmul_plan(8, k, n, 128, *args)


# the tail over a model axis's column blocks, (H, I, blocks): Qwen2.5-7B over
# {"model": 8} (o / down 448 columns a block: 3 whole tiles and one of 64),
# and H = 512 / 1,536 over 8 (64 and 192 columns: a tile narrower than a
# whole one a block, and one and a half), Llama-3.1-8B over 8 (512: whole
# tiles)
_TAIL_BLOCKS = [(3584, 18944, 8), (512, 1024, 8), (1536, 512, 8), (4096, 14336, 8)]


@pytest.mark.parametrize("hidden,inter,blocks", _TAIL_BLOCKS)
@pytest.mark.parametrize("m", [1, 8, 64])
def test_tail_plan_over_column_blocks_tiles_o_and_down_block_by_block(hidden, inter, blocks, m):
    """tail_plan over o / down / gate-up column blocks: the o and down
    tiles run block by block, ceil(width / 128) a block, the last of each
    block ragged, and cover every column once; gate/up's tiles are the
    whole weights' (its blocks are whole tiles); every stage takes the
    whole weights' K splits (a blocked launch's sums are the whole
    weights'), and the split bounds are theirs."""
    plan = tint4.tail_plan(m, hidden, inter, 128, 132, _TILE_N, _blocks_per_sm(m), blocks)
    whole = _plan(m, hidden, inter, 128)
    assert plan["blocks"] == blocks and whole["blocks"] == 1
    width = hidden // blocks
    per_block = -(-width // _TILE_N)
    for name in ("o", "down"):
        stage = plan["stages"][name]
        assert stage["tiles"] == blocks * per_block == len(stage["columns"])
        assert stage["items"] == stage["tiles"] * stage["splits"]
        cols = stage["columns"]
        for b in range(blocks):
            mine = cols[b * per_block:(b + 1) * per_block]
            assert mine[0][0] == b * width and mine[-1][1] == (b + 1) * width
            assert [c1 - c0 for c0, c1 in mine] == [_TILE_N] * (per_block - 1) + [width - (per_block - 1) * _TILE_N]
        assert [c for c0, c1 in cols for c in range(c0, c1)] == list(range(hidden))
    assert plan["stages"]["gate_up"] == whole["stages"]["gate_up"]
    for name in ("o", "gate_up", "down"):
        assert plan["stages"][name]["splits"] == whole["stages"][name]["splits"]
        assert plan["stages"][name]["bounds"] == whole["stages"][name]["bounds"]
    if hidden == 3584:
        assert [c1 - c0 for c0, c1 in plan["stages"]["o"]["columns"][:4]] == [128, 128, 128, 64]


@pytest.mark.parametrize("m,n,route", [
    (1, 6144, "splitk"), (8, 128256, "splitk"), (64, 256, "splitk"),
    (64, 384, "splitk"), (8, 32064, "splitk"), (8, 320, "splitk"),  # a ragged last item of 128 or 64 columns
    (65, 128, "wgmma"), (4096, 28672, "wgmma"), (65, 384, "wgmma"),
    (8, 259, "mma_sync"), (4096, 600, "mma_sync"), (64, 600, "mma_sync"), (8, 96, "splitk"),  # 96: 16-column unit
    (65, 32064, "wgmma"), (2, 259, "mma_sync"), (512, 259, "mma_sync"),  # 32,064: a ragged last wgmma tile
    (8, 16032, "splitk"), (64, 16, "splitk"), (8, 40, "mma_sync"), (8, 24, "mma_sync"), (65, 16032, "wgmma"),
    (130, 320, "wgmma"), (65, 40, "mma_sync"), (300, 24, "mma_sync")])  # off 128 on 16; off 16 above 64 rows
def test_int4_matmul_route_gates(m, n, route):
    assert tint4.int4_matmul_route(m, n) == route


# (m, n, blocks, route): n columns in `blocks` equal blocks; "mma_sync"
# for blocks > 1 is a weight the kernels do not take in one launch
@pytest.mark.parametrize("m,n,blocks,route", [
    (8, 4 * 32064, 4, "splitk"), (8, 2 * 32064, 2, "splitk"), (64, 4 * 320, 4, "splitk"), (1, 4 * 64, 4, "splitk"),
    (8, 2 * 64128, 2, "splitk"), (65, 2 * 64128, 2, "wgmma"), (4096, 4 * 7168, 4, "wgmma"),
    (65, 4 * 32064, 4, "wgmma"), (8, 4 * 96, 4, "splitk"), (8, 2 * 32, 2, "splitk"), (8, 1000, 3, "mma_sync"),
    (8, 8 * 16032, 8, "splitk"), (1, 8 * 16, 8, "splitk"), (64, 2 * 48, 2, "splitk"),  # the 8B head over 8, narrow
    (4096, 8 * 16032, 8, "wgmma"), (8, 4 * 24, 4, "mma_sync"), (8, 2 * 40, 2, "mma_sync"),  # ragged tiles, off 16
    (4096, 8 * 576, 8, "wgmma"), (4096, 8 * 448, 8, "wgmma"),  # Qwen2.5-7B's qkv and o / down over {"model": 8}
    (65, 8 * 16, 8, "wgmma"), (300, 2 * 48, 2, "wgmma"),  # blocks narrower than a wgmma tile
    (65, 4 * 24, 4, "mma_sync"), (4096, 2 * 40, 2, "mma_sync")])  # blocks off 16 above 64 rows
def test_int4_matmul_route_over_column_blocks(m, n, blocks, route):
    """The route of a weight in equal column blocks, each a multiple of 16
    columns: split-K up to 64 rows, wgmma above; mma_sync (a whole weight
    only) where a block is off 16 columns."""
    assert tint4.int4_matmul_route(m, n, blocks) == route
    assert tint4.int4_matmul_blocks_supported(m, [n // blocks] * blocks) == (route != "mma_sync" and n % blocks == 0)


# (m, n, blocks, items) of the wgmma route: Qwen2.5-7B's qkv (576 columns a
# block: 5 tiles, the last 64 columns) and o / down (448: 4 tiles) over
# {"model": 8} at M = 4,096 against their whole weights' 36 and 28 tiles;
# the 8B head over 8 at M = 128 (126 tiles a block, the last 32 columns)
# against the whole head's 1,002; whole weights on 128 (gate/up, with a
# ragged token tile at 4,097), blocks narrower than a tile, a whole
# 320-column weight
_WGMMA_ITEMS = [(4096, 8 * 576, 8, 1280), (4096, 4608, 1, 1152), (4096, 8 * 448, 8, 1024), (4096, 3584, 1, 896),
                (128, 8 * 16032, 8, 1008), (128, 128256, 1, 1002), (4096, 28672, 1, 7168), (4097, 28672, 1, 7392),
                (65, 8 * 16, 8, 8), (300, 2 * 48, 2, 6), (130, 320, 1, 6)]


@pytest.mark.parametrize("m,n,blocks,items", _WGMMA_ITEMS)
def test_wgmma_items_tile_each_block_on_its_own(m, n, blocks, items):
    """wgmma_items: a 128-token tile times ceil(width / 128) column tiles
    a block; on a whole weight of a multiple of 128 columns, the token
    tiles times n / 128, as before blocks off 128."""
    assert tint4.wgmma_items(m, n, blocks) == items
    if blocks == 1 and n % 128 == 0:
        assert items == -(-m // 128) * (n // 128)


# column blocks of the split-K route, (n, blocks): the 8B head over
# {"model": 4} and a process's pair of its blocks, the tiny ragged head,
# 64-column blocks, a whole 384-column weight, the 8B head over
# {"model": 2}, the 8B qkv over 4, the whole 8B head; the 8B head over
# {"model": 8} (16,032 columns a block), blocks of 16, 48 and 80 columns
_BLOCK_PLANS = [(4 * 32064, 4), (2 * 32064, 2), (4 * 320, 4), (4 * 64, 4), (384, 1), (2 * 64128, 2), (6144, 4),
                (128256, 1), (8 * 16032, 8), (8 * 16, 8), (2 * 48, 2), (4 * 80, 4)]


@pytest.mark.parametrize("n,blocks", _BLOCK_PLANS)
@pytest.mark.parametrize("m", [1, 8, 64])
def test_matmul_plan_over_ragged_blocks_covers_every_column_once(n, blocks, m):
    """matmul_plan's tiles run block by block, ceil(width / 256) a block:
    every column in exactly one tile, no tile across two blocks, every
    tile but a block's last 256 columns wide and the last a multiple of 16
    (split-K's unit); items count those tiles times the K splits."""
    plan = tint4.matmul_plan(m, 4096, n, 128, 132, _SPLITK_TILE_N, _splitk_blocks_per_sm(m), blocks)
    width = n // blocks
    per_block = -(-width // _SPLITK_TILE_N)
    cols = plan["columns"]
    assert plan["tiles"] == len(cols) == blocks * per_block and plan["items"] == plan["tiles"] * plan["splits"]
    assert cols[0][0] == 0 and cols[-1][1] == n and all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
    for b in range(blocks):
        mine = cols[b * per_block:(b + 1) * per_block]
        assert mine[0][0] == b * width and mine[-1][1] == (b + 1) * width
        assert all(c1 - c0 == _SPLITK_TILE_N for c0, c1 in mine[:-1])
        last = mine[-1][1] - mine[-1][0]
        assert 0 < last <= _SPLITK_TILE_N and last % 16 == 0
    if width % _SPLITK_TILE_N == 0:  # blocks of whole tiles: the whole weight's plan
        whole = tint4.matmul_plan(m, 4096, n, 128, 132, _SPLITK_TILE_N, _splitk_blocks_per_sm(m))
        assert {k: v for k, v in plan.items() if k != "blocks"} == {k: v for k, v in whole.items() if k != "blocks"}


# (k, n, blocks) whose blocks hold more split-K tiles than the whole
# weight: Qwen2.5-7B's qkv over {"model": 8} (8 x 576 columns: 24 tiles
# against 18) and its head (8 x 19,008: 600 against 594)
_MORE_TILES_BLOCKED = [(3584, 4608, 8), (3584, 152064, 8)]


@pytest.mark.parametrize("k,n,blocks", _MORE_TILES_BLOCKED)
@pytest.mark.parametrize("m", [1, 8, 64])
def test_blocked_products_take_the_whole_weights_split_count(k, n, blocks, m):
    """A product over column blocks plans the whole weight's K splits
    even where its blocks hold more tiles (so its launch's sums are the
    whole weight's, bit for bit): Qwen2.5-7B's qkv at 8 rows takes 8
    splits, which its 24 tiles alone would have made 7."""
    args = (m, k, n, 128, 132, _SPLITK_TILE_N, _splitk_blocks_per_sm(m))
    whole, blocked = tint4.matmul_plan(*args), tint4.matmul_plan(*args, blocks)
    assert blocked["tiles"] > whole["tiles"]
    assert (blocked["splits"], blocked["bounds"]) == (whole["splits"], whole["bounds"])
    if (n, m) == (4608, 8):
        assert whole["splits"] == 8
        assert tint4._splits_for(blocked["tiles"], k // 128, 132, 132 * _splitk_blocks_per_sm(m), m, 128) == 7


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32, 64])
def test_ragged_head_blocks_take_the_whole_heads_split_count(m):
    """The 8B head over {"model": 4} (4 x 32,064 columns: 504 tiles) takes
    the whole head's K split count (501 tiles): 5 splits up to 2 rows, one
    above (the sums written to out directly), so the blocks' launch can
    equal the whole weight's bit for bit; a process's pair of its blocks
    runs 2 x 126 tiles."""
    args = (m, 4096, 128256, 128, 132, _SPLITK_TILE_N, _splitk_blocks_per_sm(m))
    whole, blocked = tint4.matmul_plan(*args), tint4.matmul_plan(*args, 4)
    assert (whole["tiles"], blocked["tiles"]) == (501, 504)
    assert whole["splits"] == blocked["splits"] == (5 if m <= 2 else 1)
    assert tint4.matmul_plan(m, 4096, 64128, 128, 132, _SPLITK_TILE_N, _splitk_blocks_per_sm(m), 2)["tiles"] == 252


@pytest.mark.parametrize("m", [1, 2, 4, 8, 16, 32, 64])
def test_head_over_8_blocks_takes_the_whole_heads_split_count(m):
    """The 8B head over {"model": 8} (8 x 16,032 columns, a multiple of
    split-K's 16-column unit): 63 tiles a block, the last [15,872, 16,032)
    holding 160 columns, 504 in all as over {"model": 4}, so the plan
    takes the whole head's K splits (5 up to 2 rows, one above) and the
    blocks' launch can equal the whole head's bit for bit; blocks of 16
    and 48 columns are one tile each."""
    args = (m, 4096, 128256, 128, 132, _SPLITK_TILE_N, _splitk_blocks_per_sm(m))
    whole, blocked = tint4.matmul_plan(*args), tint4.matmul_plan(*args, 8)
    assert blocked["tiles"] == len(blocked["columns"]) == 504
    assert blocked["columns"][62] == (15872, 16032) and blocked["columns"][63] == (16032, 16288)
    assert blocked["columns"][-1] == (7 * 16032 + 15872, 128256)
    assert whole["splits"] == blocked["splits"] == (5 if m <= 2 else 1)
    for width, blocks in ((16, 8), (48, 2), (16, 1)):
        plan = tint4.matmul_plan(m, 4096, width * blocks, 128, 132, _SPLITK_TILE_N, _splitk_blocks_per_sm(m), blocks)
        assert plan["tiles"] == blocks
        assert plan["columns"] == [(b * width, (b + 1) * width) for b in range(blocks)]


@pytest.mark.parametrize("m", [1, 8, 40])
def test_int4_matmul_over_ragged_blocks_matches_jax_interpret(m):
    """The port's int4_matmul over 4 column blocks of 320 columns (2 x 128 +
    64: each block's last split-K item ragged) on the CPU against JAX's
    int4_matmul on the whole weight in interpret mode, and the sum of the
    ragged plan's K split partials in split order: fp32 rounding only,
    1e-5 + 1e-5*|jax| (the file's rule)."""
    rng = np.random.default_rng(300 + m)
    k, width, blocks, gs = 256, 320, 4, 128
    _, (jp, js), (tp, ts) = _weights(rng, k, blocks * width, gs)
    x = rng.standard_normal((m, k)).astype(np.float32)
    want = np.asarray(jint4.int4_matmul(jnp.asarray(x), jnp.asarray(jp), jnp.asarray(js), group_size=gs,
                                        interpret=True))
    cut = ([t[:, b * width:(b + 1) * width].contiguous() for b in range(blocks)] for t in (tp, ts))
    got = tint4.int4_matmul(torch.tensor(x), *cut, gs)
    assert tuple(got.shape) == (m, blocks * width)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    plan = tint4.matmul_plan(m, k, blocks * width, gs, 132, _SPLITK_TILE_N, _splitk_blocks_per_sm(m), blocks)
    assert plan["tiles"] == 8 and plan["splits"] == k // gs  # 8 tiles x 2 groups cannot fill 132 SMs
    split = tint4.split_partials_plain(torch.tensor(x), tp, ts, gs, plan["bounds"])
    np.testing.assert_allclose(split.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [1, 8, 40])
def test_splitk_partials_in_plan_order_match_jax(m):
    """The decode route's arithmetic on the CPU: fp32 partials over
    matmul_plan's K splits (here every group its own split: 2 tiles x 8
    groups cannot give 132 SMs an item each), summed in split order."""
    rng = np.random.default_rng(200 + m)
    k, n, gs = 512, 512, 64
    _, (jp, js), (tp, ts) = _weights(rng, k, n, gs)
    x = rng.standard_normal((m, k)).astype(np.float32)
    want = np.asarray(jint4.int4_matmul(jnp.asarray(x), jnp.asarray(jp), jnp.asarray(js), group_size=gs,
                                        interpret=True))
    plan = tint4.matmul_plan(m, k, n, gs, 132, _SPLITK_TILE_N, _splitk_blocks_per_sm(m))
    assert plan["splits"] == k // gs
    got = tint4.split_partials_plain(torch.tensor(x), tp, ts, gs, plan["bounds"])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fused_tail_gate_matches_jax():
    for args in [(4096, 14336, 128, 8), (4096, 14336, 128, 65), (256, 1024, 128, 8),
                 (512, 1024, 128, 64), (512, 1024, 64, 1)]:
        assert tint4.fused_tail_supported(*args) == jint4.fused_tail_supported(*args)


# ---------------------------------------------------------------- on a card
@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, ref, scaled=False):
    """The bf16 rule; ``scaled``: its absolute term scaled to max |plain|."""
    g, r = got.float().cpu().numpy(), ref.float().cpu().numpy()
    np.testing.assert_allclose(g, r, rtol=BF16_TOL, atol=BF16_TOL * (np.abs(r).max() if scaled else 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("m,d_in,d_out,gs", [(1, 256, 384, 128), (8, 512, 600, 128), (16, 128, 259, 64),
                                             (40, 512, 256, 128), (130, 512, 600, 128), (300, 1024, 512, 64)])
def test_int4_matmul_kernel_matches_plain(cuda_device, m, d_in, d_out, gs):
    rng = np.random.default_rng(m + d_out)
    _, _, (tp, ts) = _weights(rng, d_in, d_out, gs)
    tp, ts = tp.to(cuda_device), ts.to(cuda_device)
    x = torch.tensor(rng.standard_normal((m, d_in)), dtype=torch.float32, device=cuda_device)
    before = tint4.LAUNCHES.value
    got = tint4.int4_matmul(x, tp, ts, gs)
    torch.cuda.synchronize()
    assert tint4.LAUNCHES.value == before + 1
    _close(got, tint4.int4_matmul_plain(x, tp, ts, gs))


# every route's gates crossed: M = 64 / 65, N a multiple of 256, of 128
# only (384, 640), of 64 only (320, 192, 32064: a ragged last split-K item
# or wgmma tile) or of none (259, 600: mma_sync), group sizes 64 and 128, K of 2
# groups; N = 128256 at M = 8 and 33792 at M = 40 give every block slot a
# column tile, so the plan takes one K split (out written directly)
_ROUTE_CASES = [(1, 256, 256, 128, "splitk"), (8, 256, 512, 128, "splitk"), (8, 4096, 6144, 128, "splitk"),
                (8, 256, 128256, 128, "splitk"), (40, 256, 33792, 128, "splitk"),
                (16, 512, 256, 64, "splitk"), (40, 512, 768, 128, "splitk"), (64, 1024, 512, 64, "splitk"),
                (65, 512, 640, 128, "wgmma"), (130, 256, 384, 128, "wgmma"), (300, 1024, 256, 64, "wgmma"),
                (512, 4096, 1024, 128, "wgmma"), (8, 256, 259, 128, "mma_sync"), (64, 512, 600, 64, "mma_sync"),
                (64, 256, 384, 128, "splitk"), (8, 256, 320, 128, "splitk"), (40, 512, 192, 64, "splitk"),
                (8, 4096, 32064, 128, "splitk"), (65, 512, 600, 128, "mma_sync"), (130, 256, 259, 128, "mma_sync"),
                (130, 256, 320, 128, "wgmma")]


@pytest.mark.cuda
@pytest.mark.parametrize("m,d_in,d_out,gs,route", _ROUTE_CASES)
def test_int4_matmul_routes_match_plain(cuda_device, m, d_in, d_out, gs, route):
    rng = np.random.default_rng(m + d_in + d_out)
    _, _, (tp, ts) = _weights(rng, d_in, d_out, gs)
    tp, ts = tp.to(cuda_device), ts.to(cuda_device)
    x = torch.tensor(rng.standard_normal((m, d_in)), dtype=torch.float32, device=cuda_device)
    before = {r: c.value for r, c in tint4.ROUTE_LAUNCHES.items()}
    total = tint4.LAUNCHES.value
    got = tint4.int4_matmul(x, tp, ts, gs)
    torch.cuda.synchronize()
    assert tint4.LAUNCHES.value == total + 1
    assert {r: c.value - before[r] for r, c in tint4.ROUTE_LAUNCHES.items()} == {
        r: int(r == route) for r in tint4.ROUTE_LAUNCHES}
    _close(got, tint4.int4_matmul_plain(x, tp, ts, gs))
    if route == "splitk":  # the split order the kernel sums in, to fp32 rounding
        sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
        plan = tint4.matmul_plan(m, d_in, d_out, gs, sms, *tint4._splitk_geometry(cuda_device, m))
        assert plan["splits"] == 1 or d_out < 33792  # the wide cases run the one-split path
        ref = tint4.split_partials_plain(x, tp, ts, gs, plan["bounds"]).cpu().numpy()
        np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 16, 17, 64])
@pytest.mark.parametrize("act,unit_offset", [("silu", False), ("gelu_tanh", True), ("gelu", False)])
@pytest.mark.parametrize("hidden,inter", [(512, 1024), (1024, 2560)])
def test_fused_tail_kernel_matches_plain(cuda_device, m, act, unit_offset, hidden, inter):
    rng = np.random.default_rng(m)
    ctx, xres, nw, mats = _tail_inputs(rng, m, hidden, inter)
    tw = [a.to(cuda_device) for _, _, t in mats for a in t]
    args = [torch.tensor(a, device=cuda_device) for a in (ctx, xres, nw)] + tw
    kw = dict(group_size=128, eps=1e-5, unit_offset=unit_offset, act=act)
    before = tint4.TAIL_LAUNCHES.value
    got = tint4.int4_fused_layer_tail(*args, **kw)
    torch.cuda.synchronize()
    assert tint4.TAIL_LAUNCHES.value == before + 1
    # kernel and plain round xn and h to bf16 at the same points, but an fp32
    # sum in another order can flip one rounding, which the later products
    # carry: hence the rule scaled to the output's magnitude, as on the CPU
    _close(got, tint4.int4_fused_layer_tail_plain(*args, **kw), scaled=True)


# split-K column blocks narrower than a 128-column box or ending inside
# one, (width, blocks): K = 1,024 (8 groups) leaves every plan of <= 8
# tiles at 8 K splits, so the ticketed split sum runs over ragged tiles,
# and the whole weight (one tile) takes the same splits
_NARROW_BLOCKS = [(16, 8), (16, 2), (48, 4), (48, 2), (80, 2), (80, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("width,blocks", _NARROW_BLOCKS)
def test_int4_matmul_over_narrow_blocks_matches_plain(cuda_device, width, blocks, m):
    """int4_matmul over column blocks of 16, 48 and 80 columns (the split-K
    route's 16-column unit; a box past the block's edge, or wider than the
    block, TMA-filled with zeros): one splitk launch at more than one K
    split, within the bf16 rule of the plain version, and bit-equal to the
    launch over the concatenated weight at the same K splits."""
    rng = np.random.default_rng(500 + width + blocks + m)
    k, gs = 1024, 128
    _, _, (tp, ts) = _weights(rng, k, width * blocks, gs)
    tp, ts = tp.to(cuda_device), ts.to(cuda_device)
    x = torch.tensor(rng.standard_normal((m, k)), dtype=torch.float32, device=cuda_device)
    cut = ([t[:, b * width:(b + 1) * width].contiguous() for b in range(blocks)] for t in (tp, ts))
    assert tint4.int4_matmul_route(m, width * blocks, blocks) == "splitk"
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = functools.partial(tint4.matmul_plan, m, k, width * blocks, gs, sms, *tint4._splitk_geometry(cuda_device, m))
    assert plan(blocks)["splits"] == plan()["splits"] == k // gs
    before = tint4.ROUTE_LAUNCHES["splitk"].value
    got = tint4.int4_matmul(x, *cut, gs)
    torch.cuda.synchronize()
    assert tint4.ROUTE_LAUNCHES["splitk"].value == before + 1
    _close(got, tint4.int4_matmul_plain(x, tp, ts, gs))
    assert float((got - tint4.int4_matmul(x, tp, ts, gs)).abs().max()) == 0.0


# Qwen2.5-7B's qkv over {"model": 8} (K = 3,584, 8 blocks of 576 columns:
# five wgmma tiles a block, the last 64 columns), at a ragged and at a
# whole token tile, and at the 512-token prefill chunk of 8 prompts
@pytest.mark.cuda
@pytest.mark.parametrize("m", [65, 4096])
def test_int4_matmul_over_ragged_wgmma_blocks_matches_plain(cuda_device, m):
    """int4_matmul over column blocks off wgmma's 128-column tile, on its
    16-column block unit: one wgmma launch over ``wgmma_items``' tiles
    (the kernel's own count), within the bf16 rule of the plain version,
    and bit-equal to the launch over the concatenated weight (no K split:
    a column's sum does not depend on its tile)."""
    k, width, blocks, gs = 3584, 576, 8, 128
    gen = torch.Generator(device=cuda_device).manual_seed(700 + m)
    tp = torch.randint(-128, 128, (k // 2, width * blocks), generator=gen, device=cuda_device, dtype=torch.int8)
    ts = torch.empty(k // gs, width * blocks, device=cuda_device).uniform_(0.003, 0.006, generator=gen)
    x = torch.randn(m, k, generator=gen, device=cuda_device).to(torch.bfloat16)
    cut = ([t[:, b * width:(b + 1) * width].contiguous() for b in range(blocks)] for t in (tp, ts))
    assert tint4.int4_matmul_route(m, width * blocks, blocks) == tint4.int4_matmul_route(m, width * blocks) == "wgmma"
    assert tint4._lib().comorag_int4_matmul_wgmma_items(m, width * blocks, blocks) == tint4.wgmma_items(
        m, width * blocks, blocks) == -(-m // 128) * blocks * 5
    before = tint4.ROUTE_LAUNCHES["wgmma"].value
    got = tint4.int4_matmul(x, *cut, gs)
    torch.cuda.synchronize()
    assert tint4.ROUTE_LAUNCHES["wgmma"].value == before + 1
    _close(got, tint4.int4_matmul_plain(x, tp, ts, gs))
    assert float((got - tint4.int4_matmul(x, tp, ts, gs)).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,blocks,items", _WGMMA_ITEMS)
def test_wgmma_items_are_the_kernels(cuda_device, m, n, blocks, items):
    assert tint4._lib().comorag_int4_matmul_wgmma_items(m, n, blocks) == tint4.wgmma_items(m, n, blocks) == items


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 16, 17, 32, 33, 64])
def test_tail_geometry_is_the_kernels(cuda_device, m):
    assert tint4._tail_geometry(cuda_device, m) == (_TILE_N, _blocks_per_sm(m))
    lib = tint4._lib()
    assert (lib.comorag_int4_tail_tile_n(), lib.comorag_int4_block_unit(), lib.comorag_int4_tail_max_blocks(),
            lib.comorag_int4_matmul_max_blocks()) == (tint4.TAIL_TILE_N, tint4._BLOCK_UNIT, tint4.TAIL_MAX_BLOCKS,
                                                      tint4.TAIL_MAX_BLOCKS)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 16, 17, 32, 33, 64])
def test_splitk_geometry_is_the_kernels(cuda_device, m):
    assert tint4._splitk_geometry(cuda_device, m) == (_SPLITK_TILE_N, _splitk_blocks_per_sm(m))


@pytest.mark.cuda
def test_int4_kernels_reject_what_they_do_not_take(cuda_device):
    x = torch.zeros(4, 96, device=cuda_device)
    packed = torch.zeros(48, 64, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):  # group size 32 is no multiple of the kernel's 64-deep slab
        tint4.int4_matmul(x, packed, torch.zeros(3, 64, device=cuda_device), 32)
    for m in (8, 96):  # the split-K and wgmma routes' shapes refuse it too
        with pytest.raises(ValueError):
            tint4.int4_matmul(torch.zeros(m, 96, device=cuda_device), torch.zeros(48, 128, dtype=torch.int8,
                                                                                 device=cuda_device),
                              torch.zeros(3, 128, device=cuda_device), 32)
    for m in (8, 96):  # the split-K and wgmma routes' TMA copies refuse weights off 16 bytes
        p = torch.zeros(128 * 256 + 8, dtype=torch.int8, device=cuda_device)[8:].view(128, 256)
        sc = torch.zeros(2 * 256 + 2, device=cuda_device)[2:].view(2, 256)
        with pytest.raises(ValueError):
            tint4.int4_matmul(torch.zeros(m, 256, device=cuda_device), p, sc)
    lib, stream = tint4._lib(), torch.cuda.current_stream().cuda_stream
    # the C entries check their own gates: M above 64 on split-K, N off 16
    # on wgmma, a block width off 16 on split-K (96 columns in 4 blocks,
    # and a whole 40) and on wgmma (80 in 2), and more than 8 blocks,
    # before reading a block pointer; the wgmma item count refuses the same
    null_ptrs = (ctypes.c_void_p * 16)()
    assert lib.comorag_int4_matmul_splitk(None, null_ptrs, null_ptrs, 1, None, None, None, 65, 128, 128, 64, 1, 132,
                                          stream) != 0
    assert lib.comorag_int4_matmul_wgmma(None, null_ptrs, null_ptrs, 1, None, 128, 200, 128, 64, 132, stream) != 0
    assert lib.comorag_int4_matmul_splitk(None, null_ptrs, null_ptrs, 4, None, None, None, 8, 96, 128, 64, 1, 132,
                                          stream) != 0
    assert lib.comorag_int4_matmul_splitk(None, null_ptrs, null_ptrs, 1, None, None, None, 8, 40, 128, 64, 1, 132,
                                          stream) != 0
    assert lib.comorag_int4_matmul_splitk(None, null_ptrs, null_ptrs, 16, None, None, None, 8, 2048, 128, 64, 1, 132,
                                          stream) != 0
    assert lib.comorag_int4_matmul_wgmma(None, null_ptrs, null_ptrs, 2, None, 128, 80, 128, 64, 132, stream) != 0
    assert lib.comorag_int4_matmul_wgmma(None, null_ptrs, null_ptrs, 16, None, 128, 2048, 128, 64, 132, stream) != 0
    assert all(lib.comorag_int4_matmul_wgmma_items(*shape) < 0 for shape in ((128, 200, 1), (128, 80, 2),
                                                                             (128, 2048, 16), (0, 128, 1)))
    # the wrapper refuses blocks the rule refuses, and a block off x's card
    def cut(*widths):
        return ([torch.zeros(128, w, dtype=torch.int8, device=cuda_device) for w in widths],
                [torch.zeros(2, w, device=cuda_device) for w in widths])

    x8 = torch.zeros(8, 256, device=cuda_device)
    for widths in ((40,) * 2, (24,) * 4, (128,) * 16, (256, 128, 128)):  # off 16 (twice), > 8, unequal
        with pytest.raises(ValueError, match="no column blocks"):
            tint4.int4_matmul(x8, *cut(*widths))
    x96 = torch.zeros(96, 256, device=cuda_device)
    with pytest.raises(ValueError, match="no column blocks"):  # blocks off 16 above 64 rows
        tint4.int4_matmul(x96, *cut(40, 40))
    # blocks off wgmma's 128-column tile, on its 16: one launch, the last tile of each ragged
    for widths in ((192,) * 2, (16,) * 8, (48,) * 2):
        assert tint4.int4_matmul(x96, *cut(*widths)).shape == (96, sum(widths))
    # ragged split-K blocks, 8 blocks, blocks narrower than a 128-column box: one launch
    for widths in ((64,) * 4, (128,) * 3, (128,) * 8, (96,) * 2, (32,) * 4, (16,) * 8):
        assert tint4.int4_matmul(x8, *cut(*widths)).shape == (8, sum(widths))
    p2, s2 = cut(512, 512)
    with pytest.raises(ValueError):  # a block on the CPU
        tint4.int4_matmul(x8, [p2[0], p2[1].cpu()], [s2[0], s2[1].cpu()])
    assert tint4.int4_matmul(x8, p2, s2).shape == (8, 1024)  # two blocks of 512: one launch
    ctx = torch.zeros(65, 512, device=cuda_device)
    w = torch.zeros(256, 512, dtype=torch.int8, device=cuda_device)
    s = torch.zeros(4, 512, device=cuda_device)
    with pytest.raises(ValueError):  # M above 64
        tint4.int4_fused_layer_tail(ctx, ctx, torch.ones(512, device=cuda_device), w, s, w, s, w, s)
    # column blocks: 8 of 64 columns (off the 128-column tile, on the
    # 16-column block unit) launch; 3 unequal ones and 16 raise, as does a
    # scale list that does not match the packed one
    ctx, nw = torch.zeros(8, 512, device=cuda_device), torch.ones(512, device=cuda_device)
    gu = torch.zeros(256, 2048, dtype=torch.int8, device=cuda_device), torch.zeros(4, 2048, device=cuda_device)
    dn = torch.zeros(512, 512, dtype=torch.int8, device=cuda_device), torch.zeros(8, 512, device=cuda_device)

    def o_blocks(*widths):
        edges = np.cumsum((0,) + widths)
        return ([w[:, a:b].contiguous() for a, b in zip(edges[:-1], edges[1:])],
                [s[:, a:b].contiguous() for a, b in zip(edges[:-1], edges[1:])])

    assert tint4.int4_fused_layer_tail(ctx, ctx, nw, *o_blocks(*(64,) * 8), *gu, *dn).shape == (8, 512)
    for widths in ((256, 128, 128), (32,) * 16):
        with pytest.raises(ValueError, match="column blocks"):
            tint4.int4_fused_layer_tail(ctx, ctx, nw, *o_blocks(*widths), *gu, *dn)
    with pytest.raises(ValueError, match="as many scale blocks"):
        tint4.int4_fused_layer_tail(ctx, ctx, nw, [w[:, :256].contiguous(), w[:, 256:].contiguous()], [s], *gu, *dn)
