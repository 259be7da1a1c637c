"""int4 (nibble-packed) weight products: the decoder's 4-bit weights.

Port of ``comorag_tpu/ops/pallas_int4.py`` (``int4_matmul`` :132 and
``int4_fused_layer_tail`` :365). The layout is the JAX package's, byte
for byte: a weight [in, out] is stored as packed [in/2, out] int8 with
interleaved input-row pairs, ``byte[r] = (w[2r+1] << 4) | (w[2r] & 0xF)``,
and fp32 scales [in/group_size, out].

``int4_matmul`` and ``int4_fused_layer_tail`` launch the hand-written
Hopper kernels (``csrc/int4.cu``) for CUDA tensors and run their plain
versions for CPU tensors; there is no fallback from one to the other.
``int4_matmul`` has three kernel routes, chosen by shape
(``int4_matmul_route``). ``int4_fused_layer_tail`` takes each weight whole
or as column blocks (a ``model`` axis's shards: o and down blocks of any
multiple of 16 columns, so Qwen2.5-7B's 448-column shards over 8 cards
are one launch; gate/up blocks of 128), and ``int4_matmul`` takes
column blocks on its ``splitk`` and ``wgmma`` routes
(``int4_matmul_blocks_supported``: blocks of any multiple of 16 columns
on both, so Llama-3.1-8B's head over 8 shards of 16,032 columns and
Qwen2.5-7B's qkv / o / down shards of 576 / 448 / 448 are one launch
too): the one launch on ctx's or x's card
reads every block in place, there or on a card it may read
(``peer_readable``: a ``model`` axis over distinct cards, the peers'
blocks over NVLink), up to ``TAIL_MAX_BLOCKS`` (8) blocks a weight: an
8-card node's axis.
The plain versions repeat the kernels' arithmetic: x rounded to bf16,
each group's product summed in fp32 (bf16 x bf16 products are exact in
fp32), times the group's scale row, added to the running fp32 sum.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from comorag_torch.ops import build

LAUNCHES = build.LaunchCounter("int4_matmul")  # every route's launches
# launches per int4_matmul route (int4_matmul_route)
ROUTE_LAUNCHES = {route: build.LaunchCounter(f"int4_matmul.{route}") for route in ("splitk", "wgmma", "mma_sync")}
TAIL_LAUNCHES = build.LaunchCounter("int4_fused_layer_tail")
SOURCE = "comorag_torch/csrc/int4.cu"
REPLACES = "comorag_tpu/ops/pallas_int4.py:132"
TAIL_REPLACES = "comorag_tpu/ops/pallas_int4.py:365"

_ACTS = {"silu": 0, "gelu_tanh": 1, "gelu": 2}
_KERNEL_K_STEP = 64  # the kernels stage K in slabs of 64: group_size must divide by it
_WGMMA_TILE_M = _WGMMA_TILE_N = 128  # tokens and output columns of a tile of the wgmma route
# a block's width unit (csrc/int4.cu BLOCK_UNIT): a block's last split-K item or wgmma tile may end anywhere on
# it. int4_matmul's split-K and wgmma blocks and the fused tail's o and down blocks take it
_BLOCK_UNIT = 16
SPLITK_MAX_M = 64  # the split-K route's most tokens (its token tiles: 8, 16, 32, 64)


def quantize_int4_grouped(w: torch.Tensor, group_size: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(input-group, out-channel) symmetric int4 quantization on w's
    device. w [..., in, out] (in divisible by group_size, group_size even)
    -> (packed [..., in/2, out] int8, scales [..., in/group_size, out] f32),
    as ``pallas_int4.quantize_int4_grouped``."""
    *lead, d_in, d_out = w.shape
    assert d_in % group_size == 0 and group_size % 2 == 0, (d_in, group_size)
    arr = w.to(torch.float32).reshape(*lead, d_in // group_size, group_size, d_out)
    amax = arr.abs().amax(dim=-2, keepdim=True)
    scale = amax / 7.0 + 1e-12
    q = torch.clamp(torch.round(arr / scale), -7, 7).to(torch.int32).reshape(*lead, d_in, d_out)
    lo, hi = q[..., 0::2, :], q[..., 1::2, :]  # even input rows -> low nibbles
    packed = ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.uint8).view(torch.int8)
    return packed.contiguous(), scale.squeeze(-2).contiguous()


def unpack_rows(packed: torch.Tensor) -> torch.Tensor:
    """int8 [..., R, C] -> int32 [..., 2R, C] with byte r's nibbles at rows
    (2r, 2r+1), both sign-extended."""
    v = packed.to(torch.int32)
    lo = ((v & 0xF) ^ 8) - 8
    hi = v >> 4
    *lead, r, c = packed.shape
    return torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * r, c)


def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor, group_size: int = 128) -> torch.Tensor:
    """[..., in/2, out] packed + [..., in/gs, out] scales -> [..., in, out] f32."""
    *lead, half, d_out = packed.shape
    w = unpack_rows(packed).to(torch.float32).reshape(*lead, -1, group_size, d_out)
    return (w * scales.to(torch.float32).unsqueeze(-2)).reshape(*lead, half * 2, d_out)


def group_size_of(packed: torch.Tensor, scales: torch.Tensor) -> int:
    return (packed.shape[-2] * 2) // scales.shape[-2]


def int4_matmul_plain(x: torch.Tensor, packed, scales, group_size: int = 128) -> torch.Tensor:
    """x [M, in] @ dequant(packed, scales) -> [M, out] f32 in the kernel's
    order: x rounded to bf16, per-group fp32 products, times the group's
    scale row, summed over groups first to last. The weight is one
    (packed, scales) pair or two sequences of its column blocks, as
    ``int4_matmul`` takes it: the blocks are concatenated by column first,
    so the result equals the whole weight's bit for bit."""
    packed, scales = _whole(packed, scales)
    m, d_in = x.shape
    xb = x.to(torch.bfloat16).to(torch.float32)
    rows = group_size // 2
    acc = None
    for g in range(d_in // group_size):
        w = unpack_rows(packed[g * rows:(g + 1) * rows]).to(torch.float32)
        d = torch.matmul(xb[:, g * group_size:(g + 1) * group_size], w) * scales[g].to(torch.float32)
        acc = d if acc is None else acc + d
    return acc


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_PTR, _I32, _PTRS = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)
# csrc/int4.cu's C entries: (name, restype, argtypes)
_C_ENTRIES = (
    ("comorag_int4_matmul", _I32, [_PTR] * 4 + [_I32] * 4 + [_PTR]),
    ("comorag_int4_matmul_max_blocks", _I32, []),
    ("comorag_int4_matmul_splitk", _I32, [_PTR, _PTRS, _PTRS, _I32] + [_PTR] * 3 + [_I32] * 6 + [_PTR]),
    ("comorag_int4_matmul_splitk_blocks_per_sm", _I32, [_I32]),
    ("comorag_int4_matmul_splitk_tile_n", _I32, []),
    ("comorag_int4_matmul_wgmma", _I32, [_PTR, _PTRS, _PTRS, _I32, _PTR] + [_I32] * 5 + [_PTR]),
    ("comorag_int4_matmul_wgmma_items", ctypes.c_longlong, [_I32] * 3),
    ("comorag_int4_fused_layer_tail", _I32,
     [_PTR] * 3 + [_PTRS, _PTRS, _I32] * 3 + [_PTR] * 3 + [_I32] * 7 + [ctypes.c_float, _I32, _I32, _I32, _PTR]),
    ("comorag_int4_tail_workspace_bytes", ctypes.c_longlong, [_I32] * 6),
    ("comorag_int4_tail_tile_n", _I32, []),
    ("comorag_int4_block_unit", _I32, []),
    ("comorag_int4_tail_max_blocks", _I32, []),
    ("comorag_int4_tail_blocks_per_sm", _I32, [_I32]),
    ("comorag_enable_peer_access", _I32, [_I32, _I32]),
)


def _lib() -> ctypes.CDLL:
    lib = build.load("int4")
    if lib.comorag_int4_matmul.argtypes is None:
        for name, restype, argtypes in _C_ENTRIES:
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
    return lib


def _check_weight(name: str, packed: torch.Tensor, scales: torch.Tensor, d_in: int, d_out: int,
                  group_size: int, device: torch.device) -> None:
    if packed.dtype != torch.int8 or tuple(packed.shape) != (d_in // 2, d_out):
        raise ValueError(f"{name}: packed must be int8 [{d_in // 2}, {d_out}], "
                         f"got {packed.dtype} {tuple(packed.shape)}")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (d_in // group_size, d_out):
        raise ValueError(f"{name}: scales must be float32 [{d_in // group_size}, {d_out}], "
                         f"got {scales.dtype} {tuple(scales.shape)}")
    for t in (packed, scales):
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: weights must be contiguous on {device}")
    if group_size % _KERNEL_K_STEP or d_in % group_size:
        raise ValueError(f"{name}: the kernel takes group_size a multiple of {_KERNEL_K_STEP} "
                         f"dividing in={d_in}, got group_size={group_size}")


def _bf16_rows(name: str, x: torch.Tensor) -> torch.Tensor:
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        raise ValueError(f"{name}: activation rows must be 16-byte aligned")
    return xb


def int4_matmul_route(m: int, n: int, blocks: int = 1) -> str:
    """The kernel route ``int4_matmul`` takes for a CUDA x of m rows and n
    output columns in ``blocks`` equal column blocks (a whole weight is one
    block; the first two routes copy packed and scales by TMA, which needs
    a block's rows on 16 bytes, and tile each block on its own, the last
    tile of a block holding its ragged rest, a multiple of 16 columns):
    - ``"splitk"``, decode (m <= 64, each block a multiple of 16 columns):
      one stage of the fused tail's split-K streaming code, over
      ``matmul_plan``'s items of 256 columns (160 of each of the 8B head's
      16,032-column shards in the last);
    - ``"wgmma"``, prefill (m > 64, each block a multiple of 16 columns):
      a warp-specialized wgmma kernel with the weights as its register
      operand, over ``wgmma_items``' tiles of 128 columns (64 of each of
      Qwen2.5-7B's 576-column qkv shards in the last, 64 of its 448-column
      o / down shards; 32 of the 8B head's 16,032);
    - ``"mma_sync"``, every other shape (a 259-token vocabulary, 600
      columns): the first design (mma.sync tiles), which takes a whole
      weight only."""
    if n % (blocks * _BLOCK_UNIT):
        return "mma_sync"
    return "splitk" if m <= SPLITK_MAX_M else "wgmma"


def int4_matmul_blocks_supported(m: int, widths) -> bool:
    """Whether ``int4_matmul``'s kernel takes a weight of column blocks of
    ``widths`` columns each at m rows in one launch: at most
    ``TAIL_MAX_BLOCKS`` blocks of equal width, each a multiple of 16
    columns, so that their route (``int4_matmul_route`` over the blocks)
    is ``splitk`` (m <= 64) or ``wgmma`` (above), whose TMA maps a block
    each."""
    widths = list(widths)
    return (1 <= len(widths) <= TAIL_MAX_BLOCKS and len(set(widths)) == 1
            and int4_matmul_route(m, sum(widths), len(widths)) != "mma_sync")


def int4_matmul(x: torch.Tensor, packed, scales, group_size: int = 128) -> torch.Tensor:
    """x [M, in] @ dequant(packed, scales) -> [M, out] f32. The weight is
    one (packed [in/2, out], scales [in/gs, out]) pair or two sequences of
    its column blocks in order (a ``model`` axis's column shards: block b
    holds columns [b out / S, (b + 1) out / S)); the output is written
    whole, once. CUDA tensors launch the kernel of ``int4_matmul_route``'s
    choosing (any M; ``in`` a multiple of group_size, group_size a multiple
    of 64) once on x's device, reading the blocks in place where
    ``int4_matmul_blocks_supported`` holds and raising where it does not
    (blocks of a width off 16 raise, at any m). On ``splitk`` and
    ``wgmma`` each block lies on x's device or
    on a card it may read (``peer_readable``; a block on any other device
    raises before the launch); ``mma_sync`` takes a whole weight on x's
    device. ``out``, the split-K workspace and its tickets stay on x's
    device, and the plan is its own, so the output equals the same blocks'
    on x's device bit for bit; split-K takes the whole weight's K splits
    (``matmul_plan``) and wgmma splits no K, so it equals the whole
    weight's too. CPU tensors run ``int4_matmul_plain``."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scales, group_size)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"int4_matmul: x must be [M, in], got {tuple(x.shape)}")
    packed, scales = _as_blocks(packed, scales)
    m, d_in = x.shape
    widths = [p.shape[-1] for p in packed]
    d_out = sum(widths)
    dev = x.device
    route = int4_matmul_route(m, d_out, len(packed))
    if len(packed) > 1 and not int4_matmul_blocks_supported(m, widths):
        raise ValueError(f"int4_matmul: M={m} takes no column blocks of widths {widths} (1 to {TAIL_MAX_BLOCKS} of "
                         f"equal width, each a multiple of {_BLOCK_UNIT}: splitk up to {SPLITK_MAX_M} rows, "
                         f"wgmma above)")
    if route == "mma_sync":
        _check_weight("int4_matmul", packed[0], scales[0], d_in, d_out, group_size, dev)
    else:  # the TMA copies need every block 16-byte aligned
        p_ptrs, s_ptrs, blocks = _block_pointers("int4_matmul", packed, scales, d_in, d_out, group_size, dev,
                                                 _BLOCK_UNIT)
    xb = _bf16_rows("int4_matmul", x)
    out = torch.empty(m, d_out, dtype=torch.float32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "splitk":
        tile_n, per_sm = _splitk_geometry(dev, m)
        splits = _plan_splits(m, d_in, d_out, group_size, _sm_count(dev), tile_n, per_sm)  # the whole weight's
        ws_ptr = tickets_ptr = None  # at one split the kernel writes out directly
        if splits > 1:
            workspace = torch.empty(splits * m * d_out, dtype=torch.float32, device=dev)
            tickets = _tickets_for(dev, stream, splitk_tiles(d_out, tile_n, blocks))
            ws_ptr, tickets_ptr = workspace.data_ptr(), tickets.data_ptr()
        rc = lib.comorag_int4_matmul_splitk(xb.data_ptr(), p_ptrs, s_ptrs, blocks, out.data_ptr(), ws_ptr,
                                            tickets_ptr, m, d_out, d_in, group_size, splits, _sm_count(dev), stream)
    elif route == "wgmma":
        rc = lib.comorag_int4_matmul_wgmma(xb.data_ptr(), p_ptrs, s_ptrs, blocks, out.data_ptr(), m, d_out, d_in,
                                           group_size, _sm_count(dev), stream)
    else:
        rc = lib.comorag_int4_matmul(xb.data_ptr(), packed[0].data_ptr(), scales[0].data_ptr(), out.data_ptr(),
                                     m, d_out, d_in, group_size, stream)
    build.check(lib, rc, f"int4_matmul ({route})")
    LAUNCHES.add()
    ROUTE_LAUNCHES[route].add()
    return out


@functools.lru_cache(maxsize=None)
def _splitk_geometry(device: torch.device, m: int) -> Tuple[int, int]:
    """(output columns of a work item, blocks an SM holds at m tokens) of
    the split-K route's kernel as the built kernel reports them on
    ``device``."""
    lib = _lib()
    with torch.cuda.device(device):
        blocks = lib.comorag_int4_matmul_splitk_blocks_per_sm(m)
    if blocks <= 0:
        build.check(lib, -blocks, "int4_matmul (splitk)")
    return lib.comorag_int4_matmul_splitk_tile_n(), blocks


# ---------------------------------------------------------------- fused tail
# output columns of a fused-tail work item (csrc/int4.cu splitk::BN), and the width unit of its gate/up blocks: an
# item pairs a gate box with its up box I columns on, each in one block. Its o and down blocks take _BLOCK_UNIT
TAIL_TILE_N = 128
TAIL_MAX_BLOCKS = 8  # column blocks a weight may arrive in, of the tail and of int4_matmul (splitk::MAX_BLOCKS)


def fused_tail_supported(hidden: int, intermediate: int, group_size: int, m: int,
                         tile_n: int = 512, blocks: int = 1) -> bool:
    """The JAX package's static shape gate (pallas_int4.py:234): decode-sized
    M and tile-aligned widths; and, for weights that arrive as ``blocks``
    column blocks each (a ``model`` axis's shards), at most
    ``TAIL_MAX_BLOCKS`` of them, o and down blocks each a multiple of
    ``_BLOCK_UNIT`` (16) columns wide and gate/up blocks of
    ``TAIL_TILE_N`` (128). The decoder takes the fused tail where this
    holds, as the TPU route does."""
    return (
        m <= 64
        and tile_n % group_size == 0
        and hidden % tile_n == 0
        and intermediate % tile_n == 0
        and hidden % group_size == 0
        and intermediate % group_size == 0
        and 1 <= blocks <= TAIL_MAX_BLOCKS
        and all(n % blocks == 0 and (n // blocks) % unit == 0
                for n, unit in ((hidden, _BLOCK_UNIT), (2 * intermediate, TAIL_TILE_N)))
    )


def activation(g: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return torch.nn.functional.silu(g)
    if act == "gelu_tanh":
        return torch.nn.functional.gelu(g, approximate="tanh")
    if act == "gelu":
        return torch.nn.functional.gelu(g, approximate="none")
    raise ValueError(f"unknown act {act!r}")


def _as_blocks(packed, scale) -> Tuple[list, list]:
    """A weight's column blocks: one (packed, scale) pair, or two sequences
    of the blocks' packed and scale tensors in column order."""
    if isinstance(packed, torch.Tensor):
        return [packed], [scale]
    packed, scale = list(packed), list(scale)
    if not packed or len(packed) != len(scale):
        raise ValueError(f"a blocked weight needs as many scale blocks as packed ones, got {len(packed)} "
                         f"and {len(scale)}")
    return packed, scale


def _whole(packed, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole weight of ``_as_blocks``'s blocks, concatenated by column
    (the plain version's view; the kernel reads the blocks in place)."""
    p, s = _as_blocks(packed, scale)
    return (p[0], s[0]) if len(p) == 1 else (torch.cat(p, dim=-1), torch.cat(s, dim=-1))


def int4_fused_layer_tail_plain(ctx, x_res, norm_w, o_packed, o_scale, gu_packed, gu_scale,
                                down_packed, down_scale, group_size: int = 128, eps: float = 1e-6,
                                unit_offset: bool = False, act: str = "silu") -> torch.Tensor:
    """x_res + FFN(RMSNorm(x_res + ctx @ O)) -> [M, H] f32 with the TPU
    kernel's rounding points: ctx -> bf16, xmid and the norm in f32,
    xn -> bf16, gate/up f32, h -> bf16, down f32 plus xmid. Each weight is
    one (packed, scale) pair or sequences of its column blocks, as
    ``int4_fused_layer_tail`` takes them: the blocks are concatenated by
    column first, so the result equals the whole weight's bit for bit."""
    o_packed, o_scale = _whole(o_packed, o_scale)
    gu_packed, gu_scale = _whole(gu_packed, gu_scale)
    down_packed, down_scale = _whole(down_packed, down_scale)
    inter = down_packed.shape[0] * 2
    xmid = x_res.to(torch.float32) + int4_matmul_plain(ctx, o_packed, o_scale, group_size)
    var = (xmid * xmid).mean(dim=-1, keepdim=True)
    normed = xmid * torch.rsqrt(var + eps)
    w32 = norm_w.to(torch.float32)
    xn = normed * (1.0 + w32) if unit_offset else normed * w32
    gu = int4_matmul_plain(xn, gu_packed, gu_scale, group_size)  # xn -> bf16 inside
    h = activation(gu[:, :inter], act) * gu[:, inter:]
    return xmid + int4_matmul_plain(h, down_packed, down_scale, group_size)  # h -> bf16 inside


TAIL_MAX_M = 64


def split_bounds(k: int, group_size: int, splits: int) -> list:
    """The [k0, k1) input ranges of a stage's K splits: split s holds the
    scale groups [s * G // splits, (s + 1) * G // splits) of G = k /
    group_size, as the kernel's Cursor cuts them."""
    groups = k // group_size
    return [((s * groups // splits) * group_size, ((s + 1) * groups // splits) * group_size)
            for s in range(splits)]


def _splits_for(tiles: int, groups: int, sm_count: int, slots: int, m: int, group_size: int) -> int:
    """The K split count of one stage: enough (tile, split) items to give
    every SM one, and among those the count that costs the busiest of the
    card's block slots the fewest bytes per output column: its items'
    weight bytes (one group added per item for its fill) plus the last
    split's read of every partial (splits x m fp32). Ties go to fewer
    splits. A stage whose tiles x groups cannot reach sm_count takes every
    group as its own split."""
    best = None
    for s in range(1, groups + 1):
        if tiles * s < sm_count:
            continue
        cost = -(-tiles * s // slots) * (-(-groups // s) + 1) * (group_size // 2) + s * m * 4
        if best is None or cost < best[0]:
            best = (cost, s)
    return groups if best is None else best[1]


def splitk_tiles(n: int, tile_n: int, blocks: int = 1) -> int:
    """Column tiles of a split-K product of n columns in ``blocks`` equal
    column blocks: ceil(n / blocks / tile_n) a block, laid out block by
    block (n // tile_n where each block is a multiple of tile_n)."""
    return blocks * -(-(n // blocks) // tile_n)


def wgmma_items(m: int, n: int, blocks: int = 1) -> int:
    """Work items of a wgmma-route launch of m rows over n columns in
    ``blocks`` equal column blocks (the C entry
    ``comorag_int4_matmul_wgmma_items``' count): each 128-token tile times
    ceil(n / blocks / 128) column tiles a block, laid out block by block,
    the last of a block ragged. Qwen2.5-7B's qkv over 8 blocks at M =
    4,096: 32 x 8 x 5 = 1,280, against the whole weight's 32 x 36 =
    1,152."""
    return -(-m // _WGMMA_TILE_M) * splitk_tiles(n, _WGMMA_TILE_N, blocks)


@functools.lru_cache(maxsize=None)
def _plan_splits(m: int, k: int, n: int, group_size: int, sm_count: int, tile_n: int, blocks_per_sm: int) -> int:
    """The K splits of one [k, n] product of split-K items (``_splits_for``
    over the whole weight's n / tile_n column tiles and ``k // group_size``
    groups). A launch over the weight's column blocks takes them too, so
    its sums are the whole weight's, bit for bit."""
    return _splits_for(splitk_tiles(n, tile_n), k // group_size, sm_count, sm_count * blocks_per_sm, m, group_size)


def matmul_plan(m: int, k: int, n: int, group_size: int, sm_count: int, tile_n: int, blocks_per_sm: int,
                blocks: int = 1) -> dict:
    """Work items of one split-K product (``int4_matmul``'s decode route,
    and each stage of the fused tail): its K, its column tiles of up to
    ``tile_n`` outputs, laid out block by block over ``blocks`` equal
    column blocks (``columns``: each tile's [c0, c1) output columns; a
    block's last tile holds what is left of it), and its K splits on group
    boundaries, the whole weight's (``_plan_splits``), chosen for a card of
    ``sm_count`` SMs of ``blocks_per_sm`` block slots each."""
    splits = _plan_splits(m, k, n, group_size, sm_count, tile_n, blocks_per_sm)
    tiles, width = splitk_tiles(n, tile_n, blocks), n // blocks
    columns = [(b * width + c, b * width + min(c + tile_n, width)) for b in range(blocks)
               for c in range(0, width, tile_n)]
    return {"m": m, "k": k, "n": n, "k_step": _KERNEL_K_STEP, "tile_n": tile_n, "blocks": blocks, "tiles": tiles,
            "columns": columns, "splits": splits, "items": tiles * splits,
            "bounds": split_bounds(k, group_size, splits)}


_TAIL_STAGES = ("o", "gate_up", "down")


def _tail_shapes(hidden: int, inter: int) -> tuple:
    """(K, N) of the fused tail's stages; gate/up's N counts one of its
    two column blocks (an item holds ``tile_n`` columns of each)."""
    return (hidden, hidden), (hidden, inter), (inter, hidden)


def _tail_splits(m: int, hidden: int, inter: int, group_size: int, sm_count: int, tile_n: int,
                 blocks_per_sm: int) -> Tuple[int, int, int]:
    """The stages' K splits, the whole weights' (``_plan_splits``)."""
    return tuple(_plan_splits(m, k, n, group_size, sm_count, tile_n, blocks_per_sm)
                 for k, n in _tail_shapes(hidden, inter))


def tail_plan(m: int, hidden: int, inter: int, group_size: int, sm_count: int, tile_n: int,
              blocks_per_sm: int, blocks: int = 1) -> dict:
    """Work items of the fused-tail kernel over weights in ``blocks``
    column blocks: per stage, ``matmul_plan`` of its product (the whole
    weights' K splits), o and down tiled block by block (a block's last
    tile ragged), gate/up over the whole I (``tile_n`` columns of each
    half an item, whatever the blocks). The kernel reports its ``tile_n``
    and ``blocks_per_sm`` (``_tail_geometry``)."""
    stages = {name: matmul_plan(m, k, n, group_size, sm_count, tile_n, blocks_per_sm,
                                1 if name == "gate_up" else blocks)
              for name, (k, n) in zip(_TAIL_STAGES, _tail_shapes(hidden, inter))}
    return {"m": m, "k_step": _KERNEL_K_STEP, "tile_n": tile_n, "blocks": blocks, "stages": stages}


@functools.lru_cache(maxsize=None)
def _tail_geometry(device: torch.device, m: int) -> Tuple[int, int]:
    """(output columns of a work item, blocks an SM holds at m tokens) as
    the built kernel reports them on ``device``."""
    lib = _lib()
    with torch.cuda.device(device):
        blocks = lib.comorag_int4_tail_blocks_per_sm(m)
    if blocks <= 0:
        build.check(lib, -blocks, "int4_fused_layer_tail")
    return lib.comorag_int4_tail_tile_n(), blocks


def split_partials_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, group_size: int,
                         bounds) -> torch.Tensor:
    """x [M, k] @ dequant(W) as the kernel forms it: one fp32 partial per
    K split (``int4_matmul_plain`` over the split's rows), summed in split
    order."""
    acc = None
    for k0, k1 in bounds:
        g0, g1 = k0 // group_size, k1 // group_size
        part = int4_matmul_plain(x[:, k0:k1], packed[k0 // 2:k1 // 2], scales[g0:g1], group_size)
        acc = part if acc is None else acc + part
    return acc


_tickets: dict = {}


def _tickets_for(device: torch.device, stream: int, count: int) -> torch.Tensor:
    """The split-K kernels' per-tile tickets for one (device, stream), shared
    by the fused tail and the decode-route product (launches on one stream
    run in order): zeroed once; each launch leaves them zero again."""
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < count:
        t = torch.zeros(count, dtype=torch.int32, device=device)
        _tickets[key] = t
    return t


def peer_readable(device: torch.device, other: torch.device) -> bool:
    """Whether a kernel launched on ``device`` may read ``other``'s memory
    in place: the same device, or two cards with peer access
    (``torch.cuda.can_device_access_peer``; on an H100 host, any two cards
    joined by NVLink)."""
    if device == other:
        return True
    return device.type == other.type == "cuda" and _can_access_peer(device.index, other.index)


@functools.lru_cache(maxsize=None)
def _can_access_peer(device: int, other: int) -> bool:
    return torch.cuda.can_device_access_peer(device, other)


_peers_enabled: set = set()


def _peer_block(name: str, card: torch.device, device: torch.device) -> None:
    """Lets ``device``'s kernels read a weight block on ``card`` in place
    (the C entry once a pair, then cached), or raises where
    ``peer_readable`` says it may not."""
    if not peer_readable(device, card):
        raise ValueError(f"{name}: a weight block lies on {card}, which a kernel on {device} cannot read "
                         f"(no peer access)")
    pair = (device.index, card.index)
    if pair not in _peers_enabled:
        lib = _lib()
        build.check(lib, lib.comorag_enable_peer_access(*pair), f"{name}: peer access from {device} to {card}")
        _peers_enabled.add(pair)


def _block_pointers(name: str, packed: list, scales: list, d_in: int, d_out: int, group_size: int,
                    device: torch.device, unit: int) -> tuple:
    """The C entry's arrays of block pointers for one weight of ``d_out``
    columns in ``len(packed)`` column blocks, after checking every block's
    dtype, shape, device (``device``, x's or ctx's, or a card it may read,
    whose peer access is then enabled), contiguity and 16-byte alignment,
    and that the blocks are at most ``TAIL_MAX_BLOCKS`` of equal width, a
    multiple of ``unit`` (the tail's gate/up ``TAIL_TILE_N``;
    ``int4_matmul``'s and the tail's o and down 16)."""
    n = len(packed)
    if n > TAIL_MAX_BLOCKS or d_out % n or (d_out // n) % unit:
        raise ValueError(f"{name}: the kernel takes 1 to {TAIL_MAX_BLOCKS} column blocks of equal width, a multiple "
                         f"of {unit}; got {n} blocks of {d_out} columns")
    width = d_out // n
    p_shape, s_shape = (d_in // 2, width), (d_in // group_size, width)
    p_ptrs, s_ptrs = [], []
    for p, sc in zip(packed, scales):  # one pass of cheap checks a block; _check_weight words a failure
        pp, sp, card = p.data_ptr(), sc.data_ptr(), p.device
        if (p.dtype != torch.int8 or sc.dtype != torch.float32 or p.shape != p_shape or sc.shape != s_shape
                or sc.device != card or not (p.is_contiguous() and sc.is_contiguous())):
            _check_weight(name, p, sc, d_in, width, group_size, card)
        if card != device:
            _peer_block(name, card, device)
        if (pp | sp) % 16:
            raise ValueError(f"{name}: every weight block must be 16-byte aligned (TMA copies)")
        p_ptrs.append(pp)
        s_ptrs.append(sp)
    if group_size % _KERNEL_K_STEP or d_in % group_size:
        raise ValueError(f"{name}: the kernel takes group_size a multiple of {_KERNEL_K_STEP} "
                         f"dividing in={d_in}, got group_size={group_size}")
    array = ctypes.c_void_p * n
    return array(*p_ptrs), array(*s_ptrs), n


def int4_fused_layer_tail(
    ctx: torch.Tensor,          # [M, H] float (attention output, pre-o-proj)
    x_res: torch.Tensor,        # [M, H] float (residual into the attention add)
    norm_w: torch.Tensor,       # [H] ffn_norm weight
    o_packed, o_scale,          # [H/2, H] int8 + [H/gs, H] f32, or sequences of column blocks
    gu_packed, gu_scale,        # [H/2, 2I] + [H/gs, 2I], or sequences of column blocks
    down_packed, down_scale,    # [I/2, H] + [I/gs, H], or sequences of column blocks
    group_size: int = 128,
    eps: float = 1e-6,
    unit_offset: bool = False,
    act: str = "silu",
) -> torch.Tensor:
    """x_res + FFN(norm(x_res + ctx @ o)) -> [M, H] f32. Each weight is
    one (packed, scale) pair or two sequences of its column blocks in
    order (a ``model`` axis's column shards: block b holds columns [b N /
    S, (b + 1) N / S); o and down blocks a multiple of 16 columns,
    gate/up blocks of 128, as ``fused_tail_supported`` asks). CUDA tensors
    run one cooperative kernel launch (M <= 64) on ctx's device that reads
    every block in place, there or on a card it may read
    (``peer_readable``: a ``model`` axis over distinct cards; a block on
    any other device, or blocks of other widths, raise); CPU tensors the
    plain version."""
    if ctx.device.type == "cpu":
        return int4_fused_layer_tail_plain(ctx, x_res, norm_w, o_packed, o_scale, gu_packed, gu_scale,
                                           down_packed, down_scale, group_size, eps, unit_offset, act)
    if ctx.device.type != "cuda":
        raise ValueError(f"int4_fused_layer_tail: unsupported device {ctx.device}")
    if act not in _ACTS:
        raise ValueError(f"unknown act {act!r}")
    o, gu, down = _as_blocks(o_packed, o_scale), _as_blocks(gu_packed, gu_scale), _as_blocks(down_packed, down_scale)
    m, hidden = ctx.shape
    inter = down[0][0].shape[0] * 2
    if m > TAIL_MAX_M or hidden % 512 or inter % 512:
        raise ValueError(f"int4_fused_layer_tail: the kernel takes M <= {TAIL_MAX_M} and H, I multiples of "
                         f"512, got M={m}, H={hidden}, I={inter}")
    dev = ctx.device
    o_ptrs = _block_pointers("int4_fused_layer_tail o", *o, hidden, hidden, group_size, dev, _BLOCK_UNIT)
    gu_ptrs = _block_pointers("int4_fused_layer_tail gate/up", *gu, hidden, 2 * inter, group_size, dev, TAIL_TILE_N)
    down_ptrs = _block_pointers("int4_fused_layer_tail down", *down, inter, hidden, group_size, dev, _BLOCK_UNIT)
    ctx_b = _bf16_rows("int4_fused_layer_tail", ctx)
    xres = x_res.to(torch.float32).contiguous()
    nw = norm_w.to(torch.float32).contiguous()
    if tuple(xres.shape) != (m, hidden) or nw.numel() != hidden or xres.device != dev or nw.device != dev:
        raise ValueError("int4_fused_layer_tail: x_res must be [M, H] and norm_w [H] on ctx's device")
    if xres.data_ptr() % 16:
        raise ValueError("int4_fused_layer_tail: x_res must be 16-byte aligned")
    tile_n, blocks = _tail_geometry(dev, m)
    splits = _tail_splits(m, hidden, inter, group_size, _sm_count(dev), tile_n, blocks)
    lib = _lib()
    out = torch.empty(m, hidden, dtype=torch.float32, device=dev)
    workspace = torch.empty(lib.comorag_int4_tail_workspace_bytes(m, hidden, inter, *splits),
                            dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # a ticket a tile: o and down tiled block by block, gate/up over the whole I
    tickets = _tickets_for(dev, stream, splitk_tiles(hidden, tile_n, o_ptrs[2]) + inter // tile_n
                           + splitk_tiles(hidden, tile_n, down_ptrs[2]))
    rc = lib.comorag_int4_fused_layer_tail(
        ctx_b.data_ptr(), xres.data_ptr(), nw.data_ptr(), *o_ptrs, *gu_ptrs, *down_ptrs,
        out.data_ptr(), workspace.data_ptr(), tickets.data_ptr(), m, hidden, inter, group_size, *splits,
        float(eps), int(bool(unit_offset)), _ACTS[act], _sm_count(dev), stream,
    )
    build.check(lib, rc, "int4_fused_layer_tail")
    TAIL_LAUNCHES.add()
    return out
