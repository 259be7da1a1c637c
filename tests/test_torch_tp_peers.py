"""The int4 kernels over a ``model`` axis on distinct cards.

JAX launches ``int4_fused_layer_tail`` once a layer on any mesh
(``comorag_tpu/models/decoder.py:606-621``, ``fused_ok``: int4 weights, a
TPU backend and ``fused_tail_supported``), and ``int4_matmul`` once a
product over its gathered column shards (``_int4_dot``, :377-397). The
port does the same over distinct cards with peer access: each launch runs
on the merge card, and its tensor maps and bulk copies read every column
shard where it lies (``decoder.tail_route``, ``decoder.product_route``,
``ops.int4.peer_readable``).

On the CPU the gates and the launch counts are checked with the shards
relabelled onto cards and ``peer_readable`` monkeypatched (the routes are
decided from shapes and devices alone, before any launch), and the
wrappers' refusal of a block they may not read. The CUDA-marked tests
hold the tail and ``int4_matmul`` over blocks on 2 and 4 cards bit-equal
(max |d| 0) to the same blocks on one card, and within the bf16 rule of
the plain version; they skip here and below their card count. This file
imports no JAX, so the card's lane runs it as it is.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from comorag_torch.models import decoder as tdec
from comorag_torch.ops import int4 as tint4
from comorag_torch.parallel.mesh import Sharded, build_mesh, split_blocks

CPU = torch.device("cpu")
CARDS = tuple(torch.device("cuda", i) for i in range(8))
# the fused tail's gate shape at a small width: 4 shards of 128 (o, down)
# and 512 (gate/up) columns, 2 layers
SMALL = tdec.DecoderArch(vocab_size=512, hidden_size=512, num_layers=2, num_heads=8, num_kv_heads=4,
                         intermediate_size=1024, max_seq_len=256)
LLAMA_8B = tdec.DecoderArch(vocab_size=128256, hidden_size=4096, num_layers=32, num_heads=32, num_kv_heads=8,
                            intermediate_size=14336, max_seq_len=131072)
# Qwen2.5-7B-Instruct's published config.json shapes (a qwen2-family arch: qkv bias)
QWEN25_7B = tdec.DecoderArch(vocab_size=152064, hidden_size=3584, num_layers=28, num_heads=28, num_kv_heads=4,
                             intermediate_size=18944, max_seq_len=32768, rope_theta=1e6, rms_norm_eps=1e-6,
                             qkv_bias=True)


@dataclasses.dataclass
class _Merge:
    """Stands in for ``params["embed"]``: the routes read only its device."""

    device: torch.device


def _on_cards(params, n: int, indices=None):
    """``params`` (split over a CPU mesh of n positions) with every split
    leaf's shards relabelled onto cuda:0..n-1 (``indices``: as a process's
    share of the axis) and the merge device cuda:0: the routes' view of a
    model axis over distinct cards."""
    def relabel(w):
        return dataclasses.replace(w, devices=CARDS[:n], indices=indices) if isinstance(w, Sharded) else w

    out = dict(params, embed=_Merge(CARDS[0]), layers={k: relabel(w) for k, w in params["layers"].items()})
    out["lm_head"] = relabel(params["lm_head"])
    return out


@pytest.fixture(scope="module")
def small_int4():
    params = tdec.init_params(SMALL, torch.Generator().manual_seed(0), CPU)
    return tdec.quantize_params_int4(params)


def _readable_except(monkeypatch, blocked=()):
    """``peer_readable`` as on a host whose cards all see each other, but
    for the (merge, card) index pairs in ``blocked``."""
    def readable(device, other):
        if device == other:
            return True
        return device.type == other.type == "cuda" and (device.index, other.index) not in blocked

    monkeypatch.setattr(tint4, "peer_readable", readable)


# (case, shards, blocked pairs, process indices) -> the decode route, qkv's
# route and the launches of a decode (M = 8) and a prefill (M = 65)
# forward, the head at each forward's own rows. At 2 layers and 4 shards
# (qkv 256 columns a shard, o and down 128, gate/up 512, the head 128)
# every product's blocks suit the kernel at both sizes (splitk's 64 and
# wgmma's 128-column units): over readable cards qkv once a layer and the
# head once (2 + 1) beside 2 tails, and at prefill 4 products a layer once
# (8 + 1). Across processes each process's own blocks take the same
# product routes, without the tail (9 at both sizes). A blocked pair puts
# every product once a shard (16 x 2 + 4). Over 8 shards (qkv 128 columns
# a shard, o and down 64, gate/up 256, the head 64) the tail takes o and
# down on their 16-column unit and gate/up on its 128, so at decode qkv
# and the head are one call each beside 2 tails (2 + 1), as over 4; at
# prefill wgmma takes every product once over its blocks (o, down and the
# head each one ragged 64-column tile a block): 9, as over 4.
_SMALL_CASES = [
    ("every peer readable", 4, (), None, tdec.FUSED_TAIL, tdec.BLOCKS, (3, 2), (9, 0)),
    ("cuda:2 not readable from cuda:0", 4, ((0, 2),), None, tdec.PER_PRODUCT, tdec.PER_SHARD, (36, 0), (36, 0)),
    ("across processes", 4, (), (0, 1, 2, 3), tdec.PER_PRODUCT, tdec.BLOCKS, (9, 0), (9, 0)),
    ("8 shards", 8, (), None, tdec.FUSED_TAIL, tdec.BLOCKS, (3, 2), (9, 0)),
]


@pytest.mark.parametrize("case,n,blocked,indices,route,qkv,decode,prefill", _SMALL_CASES,
                         ids=[c[0] for c in _SMALL_CASES])
def test_tail_route_over_distinct_cards(small_int4, monkeypatch, case, n, blocked, indices, route, qkv, decode,
                                        prefill):
    """tail_route, product_route and int4_forward_launches over {"model": n}
    on distinct cards: the fused tail, and int4_matmul once a product over
    its blocks, where every shard lies on a card the merge card may read;
    the per-product and per-shard routes where one may not and where
    blocks are off a kernel's unit; the per-product route across processes
    and above 64 tokens."""
    _readable_except(monkeypatch, blocked)
    params = _on_cards(tdec.shard_params(small_int4, build_mesh({"model": n}, [CPU] * n)), n, indices)
    assert tdec.tail_route(params, SMALL, 8) == route
    assert tdec.tail_route(params, SMALL, 65) == tdec.PER_PRODUCT
    assert tdec.product_route(params["layers"]["qkv_w"], 8, CARDS[0]) == qkv
    assert tdec.int4_forward_launches(params, SMALL, 8, 8) == decode
    assert tdec.int4_forward_launches(params, SMALL, 65, 65) == prefill


def _meta_8b(n: int, cards: int = 0, arch=LLAMA_8B):
    """The routes' view of Llama-3.1-8B's (``arch``'s) int4 tree over
    {"model": n} on cuda:0..n-1 (``cards`` = 1: every position on cuda:0):
    every product column-split into n blocks of meta tensors (shapes only;
    nothing is allocated), stacked over the layers."""
    gs = 128
    devices = CARDS[:n] if cards != 1 else (CARDS[0],) * n
    h, i, layers = arch.hidden_size, arch.intermediate_size, arch.num_layers
    q, kv = arch.num_heads * arch.head_dim, arch.num_kv_heads * arch.head_dim

    def split(k, width, lead=(layers,)):
        shards = tuple(tdec.Int4Weight(torch.empty(*lead, k // 2, width // n, dtype=torch.int8, device="meta"),
                                       torch.empty(*lead, k // gs, width // n, device="meta")) for _ in range(n))
        return Sharded(shards, "col", devices)

    return {"embed": _Merge(CARDS[0]),
            "layers": {"qkv_w": split(h, q + 2 * kv), "o_w": split(h, h), "gateup_w": split(h, 2 * i),
                       "down_w": split(i, h)},
            "lm_head": split(h, arch.vocab_size, lead=())}


# {"model": n} -> (decode, prefill) launches over readable cards, and with
# the pair (0, 1) blocked. Over 8 the head's 16,032-column shards are a
# multiple of split-K's 16-column unit: one launch at its 8 rows, as over
# 2 and 4
_MODEL_AXES_8B = [(4, (33, 32), (129, 0), (516, 0)), (2, (33, 32), (129, 0), (258, 0)),
                  (8, (33, 32), (129, 0), (1032, 0))]


@pytest.mark.parametrize("n,decode,prefill,per_shard", _MODEL_AXES_8B)
def test_int4_forward_launches_at_8b_width_over_distinct_cards(monkeypatch, n, decode, prefill, per_shard):
    """At Llama-3.1-8B width over {"model": n} on distinct cards with peer
    access, a decode forward (M = 8) launches the tail once a layer and
    int4_matmul once for qkv a layer and once for the head over the peer
    cards' blocks: (33, 32); a prefill forward (M = 8 x 512, the head at
    the last position's 8 rows) every product once over its blocks: (129,
    0). These are JAX's launches and the one-card axis's, over 2, 4 and 8
    cards (the 8-wide head's 16,032-column shards on split-K's 16-column
    unit). With the pair (0, 1) blocked, every product runs once a shard
    at decode too: ``per_shard``."""
    params = _meta_8b(n)
    _readable_except(monkeypatch)
    assert tdec.tail_route(params, LLAMA_8B, 8) == tdec.FUSED_TAIL
    assert all(tdec.product_route(params["layers"][name], m, CARDS[0]) == tdec.BLOCKS
               for name in ("qkv_w", "o_w", "gateup_w", "down_w") for m in (8, 4096))
    assert tdec.product_route(params["lm_head"], 8, CARDS[0]) == tdec.BLOCKS
    assert tdec.int4_forward_launches(params, LLAMA_8B, 8, 8) == decode
    assert tdec.int4_forward_launches(params, LLAMA_8B, 4096, 8) == prefill
    _readable_except(monkeypatch, blocked=((0, 1),))
    assert tdec.tail_route(params, LLAMA_8B, 8) == tdec.PER_PRODUCT
    assert tdec.product_route(params["layers"]["qkv_w"], 8, CARDS[0]) == tdec.PER_SHARD
    assert tdec.int4_forward_launches(params, LLAMA_8B, 8, 8) == per_shard
    assert tdec.int4_forward_launches(params, LLAMA_8B, 4096, 8) == per_shard


def test_int4_forward_launches_at_8b_width_over_model_8_on_one_card():
    """{"model": 8} of one card at Llama-3.1-8B width: every shard on the
    merge card, so the routes are those of 8 readable cards: the tail
    once a layer over the o / gate-up / down blocks (512 and 3,584 columns
    a shard) and int4_matmul once over qkv's (768) and over the head's
    eight 16,032-column shards at its 8 rows (split-K's 16-column unit):
    (33, 32) a decode forward, (129, 0) a prefill one, JAX's launches.
    A head of every position's logits (4,096 rows) is one wgmma launch
    over its blocks too, each block's last tile 32 columns: (129, 0)."""
    params = _meta_8b(8, cards=1)
    assert tdec.tail_route(params, LLAMA_8B, 8) == tdec.FUSED_TAIL
    assert tdec.product_route(params["layers"]["qkv_w"], 8, CARDS[0]) == tdec.BLOCKS
    assert tdec.product_route(params["lm_head"], 8, CARDS[0]) == tdec.BLOCKS
    assert tdec.product_route(params["lm_head"], 4096, CARDS[0]) == tdec.BLOCKS
    assert tdec.int4_forward_launches(params, LLAMA_8B, 8, 8) == (33, 32)
    assert tdec.int4_forward_launches(params, LLAMA_8B, 4096, 8) == (129, 0)
    assert tdec.int4_forward_launches(params, LLAMA_8B, 4096, 4096) == (129, 0)


@pytest.mark.parametrize("cards", [0, 1], ids=["distinct cards", "one card"])
def test_int4_forward_launches_at_qwen25_7b_width_over_model_8(monkeypatch, cards):
    """At Qwen2.5-7B width over {"model": 8}, on 8 readable cards or on
    one, the o and down shards are 448 columns (3.5 of the tail's
    128-column tiles; a multiple of its 16-column block unit), gate/up's
    4,736, qkv's 576 and the head's 19,008: a decode forward takes the
    tail once a layer over the blocks and int4_matmul once for qkv a layer
    and once for the head, (29, 28), JAX's launches; a prefill forward
    runs every product once over its blocks, qkv, o and down on wgmma with
    a ragged last tile a block (576 = 4 x 128 + 64, 448 = 3 x 128 + 64):
    (28 x 4 + 1, 0) = (113, 0), JAX's too."""
    params = _meta_8b(8, cards, QWEN25_7B)
    _readable_except(monkeypatch)
    assert [params["layers"][name].shards[0].packed.shape[-1] for name in ("qkv_w", "o_w", "gateup_w", "down_w")] \
        == [576, 448, 4736, 448]
    assert tdec.tail_route(params, QWEN25_7B, 8) == tdec.FUSED_TAIL
    assert tdec.tail_route(params, QWEN25_7B, 65) == tdec.PER_PRODUCT
    assert tdec.product_route(params["layers"]["qkv_w"], 8, CARDS[0]) == tdec.BLOCKS
    assert tdec.product_route(params["lm_head"], 8, CARDS[0]) == tdec.BLOCKS
    assert [tdec.product_route(params["layers"][name], 4096, CARDS[0]) for name in ("qkv_w", "o_w", "gateup_w",
                                                                                     "down_w")] == [tdec.BLOCKS] * 4
    assert tdec.product_route(params["lm_head"], 4096, CARDS[0]) == tdec.BLOCKS
    assert tdec.int4_forward_launches(params, QWEN25_7B, 8, 8) == (29, 28)
    assert tdec.int4_forward_launches(params, QWEN25_7B, 4096, 8) == (113, 0)
    assert tdec.int4_forward_launches(params, QWEN25_7B, 4096, 4096) == (113, 0)


# (leaf with its last block on cuda:4, which cuda:0 may not read) -> a
# decode and a prefill forward's launches at Llama-3.1-8B width, every
# other leaf over readable cuda:0-3: the head alone once a shard (32 + 4;
# 128 + 4); qkv once a shard (4 x 32 + 1; 7 x 32 + 1); down once a shard,
# which also takes the layer tail off the fused route (7 x 32 + 1 at both)
_UNREADABLE_LEAF = [("lm_head", (36, 32), (132, 0)), ("qkv_w", (129, 32), (225, 0)), ("down_w", (225, 0), (225, 0))]


@pytest.mark.parametrize("leaf,decode,prefill", _UNREADABLE_LEAF, ids=[c[0] for c in _UNREADABLE_LEAF])
def test_an_unreadable_card_changes_only_its_products_route(monkeypatch, leaf, decode, prefill):
    """A product's route is decided per leaf from its own shards' devices:
    with one leaf's last block on a card the merge card may not read, that
    product alone runs once a shard; every other product stays one launch
    over its blocks (the layer tail leaves the fused route only where the
    leaf is one of its o / gate-up / down weights)."""
    params = _meta_8b(4)
    moved = (*CARDS[:3], CARDS[4])
    if leaf == "lm_head":
        params["lm_head"] = dataclasses.replace(params["lm_head"], devices=moved)
    else:
        params["layers"][leaf] = dataclasses.replace(params["layers"][leaf], devices=moved)
    _readable_except(monkeypatch, blocked=((0, 4),))
    for name, w in [*params["layers"].items(), ("lm_head", params["lm_head"])]:
        assert tdec.product_route(w, 8, CARDS[0]) == (tdec.PER_SHARD if name == leaf else tdec.BLOCKS), name
    assert tdec.tail_route(params, LLAMA_8B, 8) == (tdec.PER_PRODUCT if leaf == "down_w" else tdec.FUSED_TAIL)
    assert tdec.int4_forward_launches(params, LLAMA_8B, 8, 8) == decode
    assert tdec.int4_forward_launches(params, LLAMA_8B, 4096, 8) == prefill


def test_peer_readable_on_one_device():
    assert tint4.peer_readable(CPU, CPU) and tint4.peer_readable(CARDS[0], CARDS[0])
    assert not tint4.peer_readable(CARDS[0], CPU) and not tint4.peer_readable(CPU, CARDS[1])


@pytest.mark.parametrize("name,unit", [("int4_matmul", 16), ("int4_fused_layer_tail o", 16),
                                       ("int4_fused_layer_tail gate/up", 128)])
def test_block_pointers_refuse_a_block_the_card_cannot_read(name, unit):
    """The kernels' block checks with x or ctx on cuda:0 and a block on the
    CPU: int4_matmul and the tail's o (split-K's 16-column unit) and the
    tail's gate/up (its 128-column tile) keep one rule
    (every block on that card or on a card it may read), and both raise
    naming the device before anything is launched."""
    packed, scales = tint4.quantize_int4_grouped(torch.ones(256, 512), 128)
    blocks = split_blocks(packed, -1, [CPU] * 4), split_blocks(scales, -1, [CPU] * 4)
    with pytest.raises(ValueError, match=f"{name}: a weight block lies on cpu, which a kernel on cuda:0 cannot read"):
        tint4._block_pointers(name, *blocks, 256, 512, 128, CARDS[0], unit)


# ----------------------------------------------------------------- the card
def _cards(n: int):
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards (a model axis over distinct devices)")
    return [torch.device("cuda", i) for i in range(n)]


def _tail_inputs_8b(m: int, seed: int, device, arch=LLAMA_8B):
    """ctx, x_res, norm_w and one layer's o, gate/up and down int4 weights
    at Llama-3.1-8B width (``arch``'s; random packed bytes, scales of a
    weight of std ~0.02), on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h, i = arch.hidden_size, arch.intermediate_size
    weights = []
    for k, n in ((h, h), (h, 2 * i), (i, h)):
        packed = torch.randint(-128, 128, (k // 2, n), generator=gen, device=device, dtype=torch.int8)
        weights.append((packed, torch.empty(k // 128, n, device=device).uniform_(0.003, 0.006, generator=gen)))
    ctx = torch.randn(m, h, generator=gen, device=device).to(torch.bfloat16)
    xres = torch.randn(m, h, generator=gen, device=device)
    nw = 1.0 + 0.1 * torch.randn(h, generator=gen, device=device)
    return ctx, xres, nw, weights


def _blocks(weights, devices):
    return [part for p, sc in weights for part in (split_blocks(p, -1, devices), split_blocks(sc, -1, devices))]


def _cycled(cards, blocks: int):
    """Block i of ``blocks`` on cards[i % len(cards)]: an 8-wide model
    axis over fewer cards, as ``build_mesh`` lays a repeated device list."""
    return [cards[i % len(cards)] for i in range(blocks)]


_PEER_TAIL_WIDTHS = {"llama-3.1-8b": LLAMA_8B, "qwen2.5-7b": QWEN25_7B}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("width,blocks", [("llama-3.1-8b", 0), ("llama-3.1-8b", 8), ("qwen2.5-7b", 8)],
                         ids=["a block a card", "8 blocks", "qwen2.5-7b 8 blocks"])
@pytest.mark.parametrize("n", [2, 4])
def test_fused_tail_over_peer_cards_equals_one_card(n, width, blocks, m):
    """One launch on cuda:0 over o / gate-up / down blocks on cuda:0..n-1
    (one block a card, or 8 blocks, TAIL_MAX_BLOCKS: {"model": 8}'s 512 /
    3,584 / 512 columns a block at Llama-3.1-8B width, 448 / 4,736 / 448
    at Qwen2.5-7B's, the o and down tiles ragged, block i on cuda:(i %
    n); read in place over NVLink): bit-equal to the launch over the
    same blocks on cuda:0 (the same plan on cuda:0's SM count, the same
    items and sums; max |d| printed), 8 blocks to the whole weights'
    launch too, and within the bf16 rule of the plain version."""
    cards = _cards(n)
    blocks = blocks or n
    ctx, xres, nw, weights = _tail_inputs_8b(m, 80 + m + blocks, cards[0], _PEER_TAIL_WIDTHS[width])
    spread = _blocks(weights, _cycled(cards, blocks))
    assert [p.device.index for p in spread[0]] == [i % n for i in range(blocks)]
    before = tint4.TAIL_LAUNCHES.value
    got = tint4.int4_fused_layer_tail(ctx, xres, nw, *spread, eps=1e-5)
    torch.cuda.synchronize()
    assert tint4.TAIL_LAUNCHES.value == before + 1
    local = _blocks(weights, [cards[0]] * blocks)
    ref = tint4.int4_fused_layer_tail_plain(ctx, xres, nw, *local, eps=1e-5)  # the plain version concatenates
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=2e-2, atol=2e-2)
    against = {"one card": local, **({"whole": [t for w in weights for t in w]} if blocks == 8 else {})}
    deltas = {tag: float((got - tint4.int4_fused_layer_tail(ctx, xres, nw, *args, eps=1e-5)).abs().max())
              for tag, args in against.items()}
    print(f"fused tail at {width} width over {blocks} blocks on {n} cards, M={m}: max |d| {deltas}")
    assert deltas == dict.fromkeys(against, 0.0)


@pytest.mark.cuda
def test_fused_tail_refuses_a_card_it_may_not_read(monkeypatch):
    """With cuda:1 unreadable from cuda:0 (peer_readable patched), the
    tail over blocks on cuda:0-1 raises naming cuda:1 and launches
    nothing; so does int4_matmul over o's blocks there."""
    cards = _cards(2)
    ctx, xres, nw, weights = _tail_inputs_8b(8, 90, cards[0])
    spread = _blocks(weights, cards)
    monkeypatch.setattr(tint4, "peer_readable", lambda device, other: device == other)
    before = tint4.TAIL_LAUNCHES.value, tint4.LAUNCHES.value
    with pytest.raises(ValueError, match="lies on cuda:1"):
        tint4.int4_fused_layer_tail(ctx, xres, nw, *spread, eps=1e-5)
    with pytest.raises(ValueError, match="lies on cuda:1"):
        tint4.int4_matmul(ctx, spread[0], spread[1])
    assert (tint4.TAIL_LAUNCHES.value, tint4.LAUNCHES.value) == before


# int4_matmul over Llama-3.1-8B products in column blocks on the cards:
# (name, K, N, M, blocks). One block a card (0): qkv at decode (splitk, K
# split), the head's ragged 32,064-column blocks over 4 cards (64,128 over
# 2) at M = 8 (splitk), gate/up at M = 128 (wgmma). 8 blocks
# ({"model": 8}): qkv at decode (768 columns a block, splitk), gate/up at
# M = 128 (3,584, wgmma), the head at decode (16,032 columns a block,
# splitk on its 16-column unit, one K split as the whole head).
# Qwen2.5-7B's qkv (K 3,584, 576 columns a block) and down (K 18,944, 448)
# over 8 blocks at M = 128 on wgmma, the last tile of each block ragged
_PEER_PRODUCTS = [("qkv", 4096, 6144, 1, 0), ("qkv", 4096, 6144, 8, 0), ("qkv", 4096, 6144, 64, 0),
                  ("lm_head", 4096, 128256, 8, 0), ("gate_up", 4096, 28672, 128, 0),
                  ("qkv", 4096, 6144, 8, 8), ("qkv", 4096, 6144, 64, 8), ("gate_up", 4096, 28672, 128, 8),
                  ("lm_head", 4096, 128256, 8, 8), ("qwen qkv", 3584, 4608, 128, 8), ("qwen down", 18944, 3584, 128, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,k,width,m,blocks", _PEER_PRODUCTS,
                         ids=[f"{c[0]}-M{c[3]}" + ("-8blocks" if c[4] else "") for c in _PEER_PRODUCTS])
@pytest.mark.parametrize("n", [2, 4])
def test_int4_matmul_over_peer_cards_equals_one_card(n, name, k, width, m, blocks):
    """One int4_matmul launch on cuda:0 over a weight's column blocks on
    cuda:0..n-1 (one block a card, or 8 blocks with block i on
    cuda:(i % n); read in place over NVLink): bit-equal to the launch over
    the same blocks on cuda:0 (the same plan on cuda:0's SM count, the
    same items and sums; max |d| printed), 8 blocks to the whole weight's
    launch too (the same route and K splits), and within the bf16 rule of
    the plain version."""
    cards = _cards(n)
    blocks = blocks or n
    gen = torch.Generator(device=cards[0]).manual_seed(100 + m + n + blocks)
    packed = torch.randint(-128, 128, (k // 2, width), generator=gen, device=cards[0], dtype=torch.int8)
    scales = torch.empty(k // 128, width, device=cards[0]).uniform_(0.003, 0.006, generator=gen)
    x = torch.randn(m, k, generator=gen, device=cards[0]).to(torch.bfloat16)
    spread = split_blocks(packed, -1, _cycled(cards, blocks)), split_blocks(scales, -1, _cycled(cards, blocks))
    local = split_blocks(packed, -1, [cards[0]] * blocks), split_blocks(scales, -1, [cards[0]] * blocks)
    assert [p.device.index for p in spread[0]] == [i % n for i in range(blocks)]
    route = tint4.int4_matmul_route(m, width, blocks)
    assert route == ("splitk" if m <= tint4.SPLITK_MAX_M else "wgmma")
    against = {"one card": local}
    if blocks == 8:
        assert route == tint4.int4_matmul_route(m, width)
        if route == "splitk":  # bit-equality with the whole weight needs its K splits
            plan = functools.partial(tint4.matmul_plan, m, k, width, 128, tint4._sm_count(cards[0]),
                                     *tint4._splitk_geometry(cards[0], m))
            assert plan(8)["splits"] == plan()["splits"]
        against["whole"] = (packed, scales)
    before = tint4.LAUNCHES.value, tint4.ROUTE_LAUNCHES[route].value
    got = tint4.int4_matmul(x, *spread)
    torch.cuda.synchronize()
    assert (tint4.LAUNCHES.value, tint4.ROUTE_LAUNCHES[route].value) == (before[0] + 1, before[1] + 1)
    ref = tint4.int4_matmul_plain(x, *local)  # the plain version concatenates
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=2e-2, atol=2e-2)
    deltas = {tag: float((got - tint4.int4_matmul(x, *args)).abs().max()) for tag, args in against.items()}
    print(f"int4_matmul {name} over {blocks} blocks on {n} cards, M={m} ({route}): max |d| {deltas}")
    assert deltas == dict.fromkeys(against, 0.0)
