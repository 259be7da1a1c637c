"""comorag_torch's tensor-parallel generation against the JAX package's.

The JAX side places its parameters with ``param_shardings`` on meshes over
the conftest's virtual CPU devices (``jax.devices()[:n]``); the port splits
them with ``shard_params`` over one CPU device repeated n times. Every input
comes from numpy with a fixed seed (JAX's ``init_params`` converted with
``params_from_jax``, or the trained tiny checkpoint). Tolerances:
- ``shard_params``: the same blocks on the same mesh positions, exactly;
- fp32 logits and KV caches, float and int8 weights, the int8 KV cache:
  1e-4 (tests/test_torch_decoder.py's, sums in another order), port TP
  against JAX TP and against the port unsharded;
- int4 weights: the bf16 rule scaled to max |logit| (2e-2 * max|logit| +
  2e-2 * |logit|) and top-1 equal on >= 95 % of the positions, as
  test_int4_forward_close_to_jax_with_same_top1 (the port rounds the
  activations to bf16 before each int4 product as the TPU kernel does);
- greedy tokens, lengths and step counts: equal;
- the fused tail and int4_matmul over column blocks (a model axis's
  shards) against the whole weight: bit-equal on the CPU (the plain
  versions concatenate the blocks), and so is an int4 forward whose every
  product takes the blocks against the unsharded forward; on the card the
  bf16 rule against the plain version and bit-equal to the whole-weight
  launch (the same items, splits and sums).
The CUDA-marked tests hold the int4 kernels on the shards on the card and
skip here.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comorag_torch.models import curriculum as tcur
from comorag_torch.models import decoder as tdec
from comorag_torch.ops import int4 as tint4
from comorag_torch.parallel.mesh import Sharded, build_mesh, split_blocks
from comorag_tpu.llm.jax_offline import ByteTokenizer
from comorag_tpu.models import curriculum as jcur
from comorag_tpu.models import decoder as jdec
from comorag_tpu.parallel.mesh import build_mesh as jax_build_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=128, max_seq_len=256)
ARCHS = {
    "gqa": {},
    "qkv_bias": dict(qkv_bias=True),
    "qk_norm": dict(qk_norm=True, head_dim_override=32),
    "gemma": dict(embed_scale=True, rms_unit_offset=True, mlp_act="gelu_tanh", tie_embeddings=True),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(shape):
    n = int(np.prod(list(shape.values())))
    return build_mesh(shape, [CPU] * n), jax_build_mesh(shape, devices=jax.devices()[:n])


def _archs(name="gqa", **over):
    kw = dict(TINY, **ARCHS[name], **over)
    return jdec.DecoderArch(**kw), tdec.DecoderArch(**kw)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_params(jarch, seed=0, kind="float"):
    params = jdec.init_params(jax.random.PRNGKey(seed), jarch)
    rng = np.random.default_rng(seed)
    for name in ("attn_norm", "ffn_norm", "q_norm", "k_norm"):  # ones would hide a misplaced norm
        if name in params["layers"]:
            w = params["layers"][name]
            params["layers"][name] = w + 0.1 * rng.standard_normal(w.shape).astype(np.float32)
    if kind == "int8":
        return jdec.quantize_params(params)
    if kind == "int4":
        return jdec.quantize_params_int4(params)
    return params


def _jax_tp(params, jmesh, jarch, kind="float"):
    quantized = {"float": False, "int8": True, "int4": "int4"}[kind]
    shardings = jdec.param_shardings(jmesh, arch=jarch, quantized=quantized)
    return jax.tree_util.tree_map(lambda p, s: jax.device_put(p, s), params, shardings)


def _prompt_batch(rng, b=2, p=12, vocab=97):
    ids = rng.integers(1, vocab, size=(b, p)).astype(np.int32)
    mask = np.ones((b, p), np.int32)
    mask[1, : p // 3] = 0
    ids[mask == 0] = 0
    return ids, mask


def _jax_forward(jarch, jparams, ids, mask, kv_dtype=None):
    b, p = ids.shape
    positions = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    attn = np.tril(np.ones((p, p), bool))[None] & mask.astype(bool)[:, None, :]
    cache = jdec.make_kv_cache(jarch, b, p, jnp.float32, kv_dtype)
    logits, cache = jdec.decoder_forward(jparams, jnp.asarray(ids), jnp.asarray(positions), jnp.asarray(attn),
                                         cache, jnp.int32(0), jarch)
    return np.asarray(logits), cache


def _torch_forward(tarch, tparams, ids, mask, kv_dtype=None):
    b, p = ids.shape
    positions = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
    attn = np.tril(np.ones((p, p), bool))[None] & mask.astype(bool)[:, None, :]
    cache = tdec.make_kv_cache(tarch, b, p, torch.float32, kv_dtype, device="cpu")
    with torch.no_grad():
        logits, cache = tdec.decoder_forward(tparams, torch.as_tensor(ids).long(), torch.as_tensor(positions),
                                             torch.as_tensor(attn), cache, 0, tarch)
    return logits.numpy(), cache


# ------------------------------------------------------------- the shard rule
def _port_blocks(node, path, n):
    """The port's block of a JAX leaf at each of the n positions of the
    model axis, and whether the port split it."""
    if isinstance(node, Sharded):
        assert len(node.shards) == n
        return [_port_blocks(s, path, 1)[0][0] for s in node.shards], True
    if not path:
        return [node] * n, False
    key = path[0]
    child = node[key.key] if hasattr(key, "key") else getattr(node, key.name)
    return _port_blocks(child, path[1:], n)


SHAPES = [{"model": 2}, {"model": 4}, {"data": 2, "model": 2}, {"corpus": 4}]


@pytest.mark.parametrize("vocab", [259, 256])  # an int4 head that stays whole (_int4_col), one that splits
@pytest.mark.parametrize("kind", ["float", "int8", "int4"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: ",".join(f"{k}={v}" for k, v in s.items()))
def test_shard_params_matches_param_shardings(shape, kind, vocab):
    """Every leaf of the port's tree holds, at each position of the model
    axis, the block that JAX's sharding puts on that device (a whole leaf:
    every JAX index is the whole array); a split leaf's blocks are
    contiguous tensors of their own, 16-byte aligned; a mesh without the
    axis splits nothing."""
    jarch, _ = _archs("qk_norm", qkv_bias=True, vocab_size=vocab)
    params = _np_tree(_jax_params(jarch, kind=kind))
    tmesh, jmesh = _meshes(shape)
    shardings = jdec.param_shardings(jmesh, arch=jarch, quantized={"float": False, "int8": True, "int4": "int4"}[kind])
    port = tdec.shard_params(tdec.params_from_jax(params, device="cpu"), tmesh)
    at = tuple(slice(None) if a == "model" else 0 for a in jmesh.axis_names)
    jdevices = list(np.asarray(jmesh.devices)[at].reshape(-1)) if "model" in shape else [jmesh.devices.flat[0]]
    n = len(jdevices)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    specs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    assert len(flat) == len(specs)
    n_split = 0
    for (path, leaf), sharding in zip(flat, specs):
        index = sharding.devices_indices_map(leaf.shape)
        blocks, split = _port_blocks(port, path, n)
        full = all(i == slice(None) or i == slice(0, d) for idx in index.values() for i, d in zip(idx, leaf.shape))
        assert split == (not full), jax.tree_util.keystr(path)
        n_split += split
        for dev, block in zip(jdevices, blocks):
            np.testing.assert_array_equal(block.numpy(), leaf[index[dev]], err_msg=jax.tree_util.keystr(path))
            if split:
                assert block.is_contiguous() and block.storage_offset() == 0 and block.data_ptr() % 16 == 0
    if "model" not in shape:
        assert n_split == 0
    elif kind == "int4":  # every matmul weight column-parallel; the head where the vocab divides
        assert n_split == 2 * 4 + (vocab % n == 0) * 2 + 1  # packed + scale of 4 weights (+ head), qkv_b
    else:
        assert n_split == {"float": 5, "int8": 7}[kind]  # qkv, gateup (q, scale), o, down (q), qkv_b


def test_split_blocks_refuses_a_width_the_axis_does_not_divide():
    from comorag_torch.parallel.mesh import split_blocks

    with pytest.raises(ValueError, match="not divisible by the model axis size 4"):
        split_blocks(torch.zeros(2, 6), -1, [CPU] * 4)


def test_a_mesh_of_mixed_device_types_is_refused(monkeypatch):
    """No shard falls back to the CPU: a mesh over a card and the CPU raises
    (the card is simulated; the error comes before any CUDA call)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="must be of one type"):
        build_mesh({"model": 2}, [torch.device("cuda", 0), CPU])


# --------------------------------------------------------------- the forward
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_fp32_under_tp_matches_jax(name, n):
    jarch, tarch = _archs(name)
    params = _jax_params(jarch, seed=1)
    ids, mask = _prompt_batch(np.random.default_rng(2))
    tmesh, jmesh = _meshes({"model": n})
    tparams = tdec.params_from_jax(_np_tree(params), device="cpu")
    jl, jc = _jax_forward(jarch, _jax_tp(params, jmesh, jarch), ids, mask)
    tl, tc = _torch_forward(tarch, tdec.shard_params(tparams, tmesh), ids, mask)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), rtol=1e-4, atol=1e-4)
    ul, uc = _torch_forward(tarch, tparams, ids, mask)
    np.testing.assert_allclose(tl, ul, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc.k.numpy(), uc.k.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [2, 4])
def test_int8_weights_and_int8_kv_cache_under_tp_match_jax(n):
    """int8 weights: the row-parallel o/down scale multiplies the summed
    product on the merge device, where JAX keeps it replicated."""
    jarch, tarch = _archs("gqa")
    params = _jax_params(jarch, seed=3, kind="int8")
    ids, mask = _prompt_batch(np.random.default_rng(4))
    tmesh, jmesh = _meshes({"model": n})
    tparams = tdec.params_from_jax(_np_tree(params), device="cpu")
    sharded = tdec.shard_params(tparams, tmesh)
    assert isinstance(sharded["layers"]["o_w"].q, Sharded) and not isinstance(sharded["layers"]["o_w"].scale, Sharded)
    jtp = _jax_tp(params, jmesh, jarch, "int8")
    for kv_dtype in (None, "int8"):
        jl, jc = _jax_forward(jarch, jtp, ids, mask, kv_dtype)
        tl, tc = _torch_forward(tarch, sharded, ids, mask, kv_dtype)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        ul, _ = _torch_forward(tarch, tparams, ids, mask, kv_dtype)
        np.testing.assert_allclose(tl, ul, rtol=1e-4, atol=1e-4)
    assert isinstance(tc, tdec.QuantKVCache)
    np.testing.assert_allclose(tc.k_scale.numpy(), np.asarray(jc.k_scale), rtol=1e-5)
    assert np.abs(tc.k.numpy().astype(int) - np.asarray(jc.k).astype(int)).max() <= 1


def _counted_int4(monkeypatch) -> dict:
    """Counts the decoder's int4_matmul and int4_fused_layer_tail calls."""
    calls = {"matmul": 0, "tail": 0}
    matmul, tail = tint4.int4_matmul, tint4.int4_fused_layer_tail

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(tint4, "int4_matmul", counted("matmul", matmul))
    monkeypatch.setattr(tint4, "int4_fused_layer_tail", counted("tail", tail))
    return calls


def _product_calls(w, m, device=CPU):
    """int4_matmul calls of one product of m rows: one for a whole weight
    or a BLOCKS column split, one a shard for a PER_SHARD one."""
    if not isinstance(w, Sharded) or tdec.product_route(w, m, device) == tdec.BLOCKS:
        return 1
    return len(w.shards)


def _forward_calls(params, arch, m):
    """The int4 calls of one forward of m tokens (the head over all of
    them), as tail_route and product_route route them."""
    layers = params["layers"]
    tail = tdec.tail_route(params, arch, m) == tdec.FUSED_TAIL
    names = ("qkv_w",) if tail else ("qkv_w", "o_w", "gateup_w", "down_w")
    return {"matmul": arch.num_layers * sum(_product_calls(layers[n], m) for n in names)
            + _product_calls(params["lm_head"], m), "tail": arch.num_layers * tail}


def _int4_tp_against_jax(hidden, inter, n, monkeypatch):
    """The int4 forward over {"model": n} against JAX's over the same mesh
    (the file's int4 rule, top-1 on >= 95 % of the positions); returns the
    port's int4 calls so far (a live count), the calls product_route and
    tail_route give, its arch, its unsharded params and the batch."""
    jarch, tarch = _archs("gqa", hidden_size=hidden, intermediate_size=inter, num_heads=8, vocab_size=96)
    params = _jax_params(jarch, seed=5, kind="int4")
    ids, mask = _prompt_batch(np.random.default_rng(6), b=2, p=8, vocab=96)
    tmesh, jmesh = _meshes({"model": n})
    tparams = tdec.params_from_jax(_np_tree(params), device="cpu")
    sharded = tdec.shard_params(tparams, tmesh)
    calls = _counted_int4(monkeypatch)
    jl, _ = _jax_forward(jarch, _jax_tp(params, jmesh, jarch, "int4"), ids, mask)
    tl, _ = _torch_forward(tarch, sharded, ids, mask)
    np.testing.assert_allclose(tl, jl, rtol=2e-2, atol=2e-2 * np.abs(jl).max())
    assert (tl.argmax(-1) == jl.argmax(-1)).mean() >= 0.95
    return calls, _forward_calls(sharded, tarch, ids.size), tarch, tparams, ids, mask


@pytest.mark.parametrize("hidden,inter", [(64, 128), (512, 1024)])  # unfused, the fused tail's gate
def test_int4_under_tp_close_to_jax_with_same_top1(hidden, inter, monkeypatch):
    """Over {"model": 2}, int4_matmul is called as product_route routes
    each column split: at the fused-gate shape each layer's o / gate-up /
    down half is one fused-tail call over the column shards, qkv (two
    384-column shards) one call over its shards and the head (two 48-column
    shards, a multiple of split-K's 16-column unit) one call over its
    shards: layers + 1; below the gate each product runs on its own, one
    call over its shards (gate/up 128 columns a shard; qkv, o, down and
    the head 48, 32, 32 and 48), as JAX launches it once. The unsharded
    engine takes the tail at the gate shape too."""
    calls, want, tarch, tparams, ids, mask = _int4_tp_against_jax(hidden, inter, 2, monkeypatch)
    layers = tarch.num_layers
    assert calls == want
    if hidden == 512:
        assert want == {"matmul": layers + 1, "tail": layers}
    else:
        assert want == {"matmul": 4 * layers + 1, "tail": 0}
    _torch_forward(tarch, tparams, ids, mask)
    assert calls["tail"] == (2 * layers if hidden == 512 else 0)


def test_int4_over_model_4_takes_the_fused_tail_close_to_jax(monkeypatch):
    """{"model": 4} at the fused gate's shape: 128-column o and down blocks
    and 512-column gate/up blocks, one fused-tail call a layer over them;
    qkv's 192-column shards are a multiple of the split-K route's 16-column
    unit (one call a layer over them, the last item of each block ragged),
    the head's 24-column shards are not, so product_route takes the head
    once a shard (layers + 4 int4_matmul calls); within the file's int4
    rule of JAX's forward over the same mesh."""
    calls, want, tarch, *_ = _int4_tp_against_jax(512, 1024, 4, monkeypatch)
    assert calls == want == {"matmul": tarch.num_layers + 4, "tail": tarch.num_layers}


# every product's shards at a multiple of 128 columns over {"model": 2} and
# {"model": 4}: qkv 1024, o 512, gate/up 2048, down 512, head 512
_BLOCKS_ARCH = dict(hidden_size=512, intermediate_size=1024, num_heads=8, num_kv_heads=4, vocab_size=512,
                    qkv_bias=True)


@pytest.mark.parametrize("n", [2, 4])
def test_int4_forward_over_blocks_equals_the_unsharded_forward(n, monkeypatch):
    """Where every int4 product takes its column shards in one call
    (product_route BLOCKS) and qkv_b is added once on the merged columns,
    the forward over a [cpu] * n mesh equals the unsharded port forward bit
    for bit (logits and KV cache), at a decode-sized chunk (the fused tail
    over the shards) and at a prefill-sized one (every product one call):
    the plain versions concatenate the blocks. The calls are those of the
    unsharded forward."""
    jarch, tarch = _archs("gqa", **_BLOCKS_ARCH)
    tparams = tdec.params_from_jax(_np_tree(_jax_params(jarch, seed=7, kind="int4")), device="cpu")
    sharded = tdec.shard_params(tparams, build_mesh({"model": n}, [CPU] * n))
    calls = _counted_int4(monkeypatch)
    for p in (8, 40):  # 16 tokens, 80 tokens
        ids, mask = _prompt_batch(np.random.default_rng(8 + p), b=2, p=p, vocab=512)
        m = ids.size
        for name in ("qkv_w", "o_w", "gateup_w", "down_w"):
            assert tdec.product_route(sharded["layers"][name], m, CPU) == tdec.BLOCKS, name
        assert tdec.product_route(sharded["lm_head"], m, CPU) == tdec.BLOCKS
        before = dict(calls)
        got, got_cache = _torch_forward(tarch, sharded, ids, mask)
        mid = dict(calls)
        want, want_cache = _torch_forward(tarch, tparams, ids, mask)
        sharded_calls = {k: mid[k] - before[k] for k in calls}
        assert sharded_calls == {k: calls[k] - mid[k] for k in calls} == _forward_calls(sharded, tarch, m)
        assert sharded_calls["tail"] == (tarch.num_layers if m <= tint4.TAIL_MAX_M else 0)
        np.testing.assert_array_equal(got, want)
        assert torch.equal(got_cache.k, want_cache.k) and torch.equal(got_cache.v, want_cache.v)


@pytest.mark.parametrize("m", [1, 8, 64, 320])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_int4_matmul_over_column_blocks_equals_the_whole_weight(n, m):
    """int4_matmul with the weight as n column blocks (split_blocks, as
    shard_params cuts them) equals the whole weight's product bit for bit,
    through the wrapper's CPU dispatch and the plain version alike; no
    launch."""
    rng = np.random.default_rng(50 + m + n)
    w = torch.tensor(rng.standard_normal((512, 1024)) * 0.05, dtype=torch.float32)
    packed, scales = tint4.quantize_int4_grouped(w, 128)
    x = torch.tensor(rng.standard_normal((m, 512)), dtype=torch.float32)
    blocks = split_blocks(packed, -1, [CPU] * n), split_blocks(scales, -1, [CPU] * n)
    before = tint4.LAUNCHES.value
    want = tint4.int4_matmul_plain(x, packed, scales, 128)
    for fn in (tint4.int4_matmul, tint4.int4_matmul_plain):
        got = fn(x, *blocks, 128)
        assert got.dtype == torch.float32 and tuple(got.shape) == (m, 1024) and torch.equal(got, want)
    assert tint4.LAUNCHES.value == before


def _int4_sharded(widths, device=CPU):
    """An int4 column split of K = 128 inputs into shards of the given
    widths, every position on ``device``."""
    packed, scales = tint4.quantize_int4_grouped(torch.ones(128, sum(widths)), 128)
    bounds = np.cumsum([0] + list(widths))
    shards = tuple(tdec.Int4Weight(packed[:, a:b].contiguous(), scales[:, a:b].contiguous())
                   for a, b in zip(bounds[:-1], bounds[1:]))
    return Sharded(shards, "col", (device,) * len(widths))


@pytest.mark.parametrize("widths,m,ok", [
    ([256, 256], 8, True), ([256, 256], 65, True),  # splitk, wgmma
    ([64128, 64128], 8, True),  # the 8B head at {"model": 2}: each block's last item holds one box
    ([1536] * 4, 8, True), ([7168] * 4, 4096, True),  # the 8B qkv at decode, gate/up at prefill
    ([128] * 3, 65, True),  # wgmma takes 384 columns
    ([64] * 4, 8, True),  # 64-column blocks at decode: one ragged split-K item a block
    ([32064] * 4, 8, True),  # the 8B head at {"model": 4}: each block's last item holds 64 columns
    ([32064] * 2, 8, True),  # a process's two blocks of that head
    ([32] * 4, 8, True), ([96] * 2, 8, True),  # multiples of the split-K route's 16-column unit
    ([24] * 4, 8, False), ([40] * 2, 8, False),  # widths off it
    ([16] * 8, 8, True), ([48] * 2, 64, True),  # blocks narrower than a 128-column box
    ([192] * 2, 65, True), ([32064] * 4, 65, True),  # ragged blocks above 64 rows: wgmma's last tile a block ragged
    ([40] * 2, 65, False), ([24] * 4, 4096, False),  # widths off 16 above 64 rows
    ([128] * 8, 8, True),  # 8 blocks (TAIL_MAX_BLOCKS): an 8-card node's model axis
    ([768] * 8, 8, True), ([3584] * 8, 4096, True),  # the 8B qkv at decode, gate/up at prefill, {"model": 8}
    ([16032] * 8, 8, True), ([16032] * 8, 4096, True),  # the 8B head at {"model": 8}: splitk, wgmma (ragged)
    ([576] * 8, 4096, True), ([448] * 8, 4096, True),  # Qwen2.5-7B's qkv, o / down at {"model": 8}: wgmma (ragged)
    ([128] * 16, 8, False),  # more than TAIL_MAX_BLOCKS
    ([256, 128, 128], 65, False),  # unequal blocks
    ([128] * 3, 8, True),  # 384 columns at decode: splitk, the last item of each block half full
    ([128] * 2, 8, True),  # 256 columns at decode: splitk, an item a block
])
def test_int4_matmul_blocks_rule_and_the_decoders_route(widths, m, ok):
    """int4_matmul_blocks_supported's cases, and product_route, which
    follows it for a column split on the merge device."""
    assert tint4.TAIL_TILE_N == 128 and tint4.TAIL_MAX_BLOCKS == 8
    assert tint4.int4_matmul_blocks_supported(m, widths) == ok
    assert tdec.product_route(_int4_sharded(widths), m, CPU) == (tdec.BLOCKS if ok else tdec.PER_SHARD)


# a tiny int4 decoder whose head splits over {"model": 4} into ragged
# blocks: 320 = 2 x 128 + 64 columns a shard
_RAGGED_HEAD_ARCH = dict(hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=2, vocab_size=1280)


@pytest.mark.parametrize("m", [2, 16])
def test_int4_forward_launches_one_head_launch_over_ragged_blocks(m):
    """int4_forward_launches over {"model": 4} of one device when the
    head's 320-column shards are a multiple of 64 but not of 128: the head
    is one launch over its 4 blocks (product_route BLOCKS), and a
    process's share of the axis (2 of the 4 blocks, ``Sharded.indices``)
    is one launch too; at 80 rows too (wgmma, each block's last tile 64
    columns)."""
    jarch, tarch = _archs("gqa", **_RAGGED_HEAD_ARCH)
    tparams = tdec.params_from_jax(_np_tree(_jax_params(jarch, seed=9, kind="int4")), device="cpu")
    sharded = tdec.shard_params(tparams, build_mesh({"model": 4}, [CPU] * 4))
    head = sharded["lm_head"]
    assert [sh.packed.shape[-1] for sh in head.shards] == [320] * 4
    assert tdec.product_route(head, m, CPU) == tdec.BLOCKS
    # no fused tail (hidden 256 is off its 512-column tile): 4 products a
    # layer and the head, each once over its blocks, as the whole weights
    want = (4 * tarch.num_layers + 1, 0)
    assert tdec.int4_forward_launches(sharded, tarch, m, m) == tdec.int4_forward_launches(tparams, tarch, m, m) == want
    share = dataclasses.replace(head, shards=head.shards[2:], devices=head.devices[2:], indices=(2, 3))
    assert tdec.product_route(share, m, CPU) == tdec.BLOCKS
    assert tdec._product_launches(share, m, CPU) == 1
    assert tdec._product_launches(head, 80, CPU) == 1 and tdec._product_launches(share, 80, CPU) == 1


@pytest.mark.parametrize("p", [8, 40])  # 32 tokens, 160 tokens
def test_int4_forward_over_readable_cards_matches_jax(p, monkeypatch):
    """{"model": 4} with the shards relabelled onto (cpu, cuda:1, cuda:2,
    cuda:3) and peer_readable patched so that the merge device may read
    every card: the routes' view of four distinct cards with peer access
    (the plain versions run on the CPU, where the blocks lie; a per-shard
    product would move x to a card and fail). Every int4 product is one
    int4_matmul call over its blocks and a decode-sized forward takes the
    fused tail, as JAX launches each kernel once over its gathered shards
    (layers + 1 calls and a tail a layer at 32 tokens, 4 x layers + 1 at
    160, as int4_forward_launches gives them); the logits are within the
    file's int4 rule of JAX's forward over the same mesh (4 rows, so that
    the 95 % top-1 share is a share of 32 positions and not all of 16: a
    random 512-token head has top twos closer than the logits' rounding
    differences) and equal the unsharded port forward's bit for bit (the
    plain versions concatenate the blocks)."""
    jarch, tarch = _archs("gqa", **_BLOCKS_ARCH)
    params = _jax_params(jarch, seed=11, kind="int4")
    tparams = tdec.params_from_jax(_np_tree(params), device="cpu")
    tmesh, jmesh = _meshes({"model": 4})
    cards = (CPU, *(torch.device("cuda", i) for i in (1, 2, 3)))

    def relabel(w):
        return dataclasses.replace(w, devices=cards) if isinstance(w, Sharded) else w

    sharded = tdec.shard_params(tparams, tmesh)
    sharded = dict(sharded, layers={k: relabel(w) for k, w in sharded["layers"].items()},
                   lm_head=relabel(sharded["lm_head"]))
    monkeypatch.setattr(tint4, "peer_readable", lambda device, other: device == other or other.type == "cuda")
    ids, mask = _prompt_batch(np.random.default_rng(12 + p), b=4, p=p, vocab=512)
    m, layers = ids.size, tarch.num_layers
    assert tdec.int4_forward_launches(sharded, tarch, m, m) == ((layers + 1, layers) if m <= tint4.TAIL_MAX_M
                                                                else (4 * layers + 1, 0))
    calls = _counted_int4(monkeypatch)
    got, _ = _torch_forward(tarch, sharded, ids, mask)
    assert (calls["matmul"], calls["tail"]) == tdec.int4_forward_launches(sharded, tarch, m, m)
    jl, _ = _jax_forward(jarch, _jax_tp(params, jmesh, jarch, "int4"), ids, mask)
    np.testing.assert_allclose(got, jl, rtol=2e-2, atol=2e-2 * np.abs(jl).max())
    assert (got.argmax(-1) == jl.argmax(-1)).mean() >= 0.95
    np.testing.assert_array_equal(got, _torch_forward(tarch, tparams, ids, mask)[0])


# every product's shards over {"model": 8} on each kernel's unit: qkv 256
# columns a shard, o and down 128 (the tail's tile), gate/up 256, head 128
_MODEL_8_ARCH = dict(hidden_size=1024, intermediate_size=1024, num_heads=8, num_kv_heads=4, vocab_size=1024)


def _model_8_against_jax(p, monkeypatch, vocab_size=1024, seed=13, arch=_MODEL_8_ARCH):
    """The int4 forward of ``arch`` (with ``vocab_size``) over {"model": 8}
    against JAX's over the same mesh of 8 virtual devices, on a batch of 4 prompts of p tokens: the calls equal
    ``int4_forward_launches`` (layers + 1 and a tail a layer up to 64
    tokens: JAX's), the logits within the file's int4 rule of JAX's, top-1
    on >= 95 % of the positions, and equal to the unsharded port forward's
    bit for bit (the plain versions concatenate the blocks). Returns the
    split tree and the forward's (int4_matmul, fused tail) calls."""
    jarch, tarch = _archs("gqa", **dict(arch, vocab_size=vocab_size))
    params = _jax_params(jarch, seed=seed, kind="int4")
    tparams = tdec.params_from_jax(_np_tree(params), device="cpu")
    tmesh, jmesh = _meshes({"model": 8})
    sharded = tdec.shard_params(tparams, tmesh)
    ids, mask = _prompt_batch(np.random.default_rng(seed + 1 + p), b=4, p=p, vocab=vocab_size)
    m, layers = ids.size, tarch.num_layers
    if m <= tint4.TAIL_MAX_M:
        assert tdec.int4_forward_launches(sharded, tarch, m, m) == (layers + 1, layers)
    calls = _counted_int4(monkeypatch)
    got, _ = _torch_forward(tarch, sharded, ids, mask)
    launches = (calls["matmul"], calls["tail"])
    assert launches == tdec.int4_forward_launches(sharded, tarch, m, m)
    jl, _ = _jax_forward(jarch, _jax_tp(params, jmesh, jarch, "int4"), ids, mask)
    np.testing.assert_allclose(got, jl, rtol=2e-2, atol=2e-2 * np.abs(jl).max())
    assert (got.argmax(-1) == jl.argmax(-1)).mean() >= 0.95
    np.testing.assert_array_equal(got, _torch_forward(tarch, tparams, ids, mask)[0])
    return sharded, launches


@pytest.mark.parametrize("p", [8, 40])  # 32 tokens, 160 tokens
def test_int4_forward_over_model_8_matches_jax(p, monkeypatch):
    """{"model": 8}, an 8-card node's axis, at widths whose shards suit
    every kernel unit: every int4 product is one int4_matmul call over its
    8 blocks and a decode-sized forward takes the fused tail over them, as
    JAX launches each kernel once over its gathered shards
    (``_model_8_against_jax``): layers + 1 calls and a tail a layer at 32
    tokens, 4 x layers + 1 at 160."""
    sharded, calls = _model_8_against_jax(p, monkeypatch)
    layers = TINY["num_layers"]
    assert calls == ((layers + 1, layers) if p == 8 else (4 * layers + 1, 0))
    widths = {name: sharded["layers"][name].shards[0].packed.shape[-1] for name in ("qkv_w", "o_w", "gateup_w",
                                                                                    "down_w")}
    assert widths == {"qkv_w": 256, "o_w": 128, "gateup_w": 256, "down_w": 128}
    assert sharded["lm_head"].shards[0].packed.shape[-1] == 128


def test_int4_forward_over_model_8_with_80_column_head_shards_matches_jax(monkeypatch):
    """The same arch with a 640-token vocabulary: the head splits into
    eight 80-column shards, a multiple of split-K's 16-column unit and of
    neither 32 nor 64, so at 32 tokens the head is one int4_matmul call
    over its 8 blocks (product_route BLOCKS), as the 8B head's 16,032-column
    shards; the calls, the logits against JAX's forward and the unsharded
    port forward as ``_model_8_against_jax`` holds them."""
    sharded, _ = _model_8_against_jax(8, monkeypatch, vocab_size=640, seed=15)
    head = sharded["lm_head"]
    assert [sh.packed.shape[-1] for sh in head.shards] == [80] * 8
    assert tdec.product_route(head, 32, CPU) == tdec.BLOCKS


# qwen2-family widths (qkv bias) whose o / down shards over {"model": 8} are
# off the tail's 128-column tile, on its 16-column block unit: hidden ->
# (the arch, o / down columns a shard), each at ``_model_8_against_jax``'s
# 1,024-token vocabulary (the head 128 columns a shard). H = 512:
# ``_BLOCKS_ARCH``'s layers, 64 columns (qkv 128, gate/up 256); H = 1,536:
# 192 columns (qkv 320, gate/up 128; 1.5 tiles: the ragged o / down tiles
# of Qwen2.5-7B's 448 in small)
_QWEN_BLOCKS = {512: (_BLOCKS_ARCH, 64),
                1536: (dict(hidden_size=1536, intermediate_size=512, num_heads=12, num_kv_heads=4, qkv_bias=True),
                       192)}


@pytest.mark.parametrize("p", [8, 40])  # 32 tokens, 160 tokens
@pytest.mark.parametrize("hidden", sorted(_QWEN_BLOCKS))
def test_int4_forward_over_model_8_with_ragged_tail_blocks_matches_jax(hidden, p, monkeypatch):
    """A qwen2-family arch over {"model": 8} with o / down shards of 64 or
    192 columns (off the 128-column tile of the tail and of wgmma; on
    their 16-column block unit): a decode-sized forward (32 tokens) takes
    the fused tail over the blocks, (layers + 1, layers) calls, and a
    prefill-sized one (160 tokens) every product once over its blocks on
    wgmma (qkv's 128 or 320 columns too), (4 x layers + 1, 0) calls, as
    JAX launches; the logits, JAX's forward and the unsharded port
    forward as ``_model_8_against_jax`` holds them."""
    arch, width = _QWEN_BLOCKS[hidden]
    sharded, calls = _model_8_against_jax(p, monkeypatch, seed=17, arch=arch)
    layers, m = TINY["num_layers"], 4 * p  # 4 prompts of p tokens
    assert [sharded["layers"][name].shards[0].packed.shape[-1] for name in ("o_w", "down_w")] == [width, width]
    tarch = _archs("gqa", **dict(arch, vocab_size=1024))[1]
    assert tdec.tail_route(sharded, tarch, m) == (tdec.FUSED_TAIL if p == 8 else tdec.PER_PRODUCT)
    products = [sharded["layers"][name] for name in ("qkv_w", "o_w", "gateup_w", "down_w")] + [sharded["lm_head"]]
    assert [tdec.product_route(w, m, CPU) for w in products] == [tdec.BLOCKS] * 5
    assert calls == ((layers + 1, layers) if p == 8 else (4 * layers + 1, 0))


def test_product_route_takes_no_blocks_off_the_merge_device_or_outside_int4_columns():
    """The per-shard route for shards on a device the merge device may not
    read (a card, from the CPU; the CPU, from a card), float and int8
    column splits, and row splits."""
    w = _int4_sharded([256, 256])
    assert tdec.product_route(w, 8, CPU) == tdec.BLOCKS
    assert tdec.product_route(Sharded(w.shards, "col", (CPU, torch.device("cuda", 1))), 8, CPU) == tdec.PER_SHARD
    assert tdec.product_route(w, 8, torch.device("cuda", 0)) == tdec.PER_SHARD
    floats = Sharded((torch.zeros(256, 256), torch.zeros(256, 256)), "col", (CPU, CPU))
    assert tdec.product_route(floats, 8, CPU) == tdec.PER_SHARD
    assert tdec.product_route(Sharded(floats.shards, "row", (CPU, CPU)), 8, CPU) == tdec.PER_SHARD
    q8 = Sharded(tuple(tdec.QuantWeight(torch.zeros(256, 256, dtype=torch.int8), torch.ones(256))
                       for _ in range(2)), "col", (CPU, CPU))
    assert tdec.product_route(q8, 8, CPU) == tdec.PER_SHARD


def _blocked_tail_inputs(rng, m=8, hidden=512, inter=1024, gs=128):
    """ctx, x_res, norm_w and the o, gate/up and down int4 weights
    (quantized from seeded numpy weights) of one fused tail."""
    ctx, xres = (torch.tensor(rng.standard_normal((m, hidden)), dtype=torch.float32) for _ in range(2))
    nw = torch.tensor(1.0 + 0.1 * rng.standard_normal(hidden), dtype=torch.float32)
    weights = [tint4.quantize_int4_grouped(torch.tensor(rng.standard_normal((k, n)) * 0.05, dtype=torch.float32), gs)
               for k, n in ((hidden, hidden), (hidden, 2 * inter), (inter, hidden))]
    return ctx, xres, nw, weights


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
@pytest.mark.parametrize("unit_offset", [False, True])
def test_plain_tail_over_column_blocks_equals_the_whole_weight(n, act, unit_offset):
    """The fused tail with each weight as n column blocks (split_blocks, as
    shard_params cuts them) equals the whole weight's bit for bit, through
    the wrapper's CPU dispatch and the plain version alike; no launch."""
    ctx, xres, nw, weights = _blocked_tail_inputs(np.random.default_rng(30 + n))
    blocked = [part for p, sc in weights for part in (split_blocks(p, -1, [CPU] * n), split_blocks(sc, -1, [CPU] * n))]
    whole = [t for w in weights for t in w]
    kw = dict(group_size=128, eps=1e-5, unit_offset=unit_offset, act=act)
    before = tint4.TAIL_LAUNCHES.value
    want = tint4.int4_fused_layer_tail_plain(ctx, xres, nw, *whole, **kw)
    for fn in (tint4.int4_fused_layer_tail, tint4.int4_fused_layer_tail_plain):
        got = fn(ctx, xres, nw, *blocked, **kw)
        assert got.dtype == torch.float32 and torch.equal(got, want)
    assert tint4.TAIL_LAUNCHES.value == before


def test_fused_tail_gate_refuses_blocks_off_the_tile():
    """fused_tail_supported's block condition, and the decoder's route that
    follows it: o and down blocks of a multiple of the kernel's 16-column
    block unit, gate/up blocks of its 128-column tile, at most
    TAIL_MAX_BLOCKS of them, all on the merge device, at most 64 tokens."""
    assert tint4.TAIL_TILE_N == 128 and tint4.TAIL_MAX_BLOCKS == 8 and tint4._BLOCK_UNIT == 16
    assert tint4.fused_tail_supported(512, 1024, 128, 8, blocks=4)  # 128-column o / down blocks
    assert tint4.fused_tail_supported(512, 1024, 128, 8, blocks=8)  # 64 columns: off the tile, on the unit
    assert not tint4.fused_tail_supported(512, 1024, 128, 65, blocks=8)  # above 64 tokens
    assert not tint4.fused_tail_supported(1536, 1536, 128, 8, blocks=5)  # 1536 / 5 is no whole width
    assert tint4.fused_tail_supported(4096, 14336, 128, 8, blocks=8)  # 512-column blocks: {"model": 8}
    assert not tint4.fused_tail_supported(4096, 14336, 128, 8, blocks=16)  # 256-column blocks, but 16 of them
    assert tint4.fused_tail_supported(4096, 14336, 128, 8, blocks=4)  # phase 14's {"model": 4}
    assert tint4.fused_tail_supported(3584, 18944, 128, 8, blocks=8)  # Qwen2.5-7B: 448 / 4,736 / 448
    # gate/up blocks off the 128-column tile (a 128-column gate tile: 2 x 384 / 8 = 96 columns), o / down on
    # the unit (48); over 2 blocks gate/up's 384 is 3 tiles
    assert not tint4.fused_tail_supported(384, 384, 128, 8, tile_n=128, blocks=8)
    assert tint4.fused_tail_supported(384, 384, 128, 8, tile_n=128, blocks=2)
    # o / down blocks off the 16-column unit (a 64-column gate tile: 320 / 8 = 40 columns), gate/up on the tile
    assert not tint4.fused_tail_supported(320, 512, 64, 8, tile_n=64, blocks=8)
    assert tint4.fused_tail_supported(320, 512, 64, 8, tile_n=64, blocks=4)
    jarch, tarch = _archs("gqa", hidden_size=512, intermediate_size=1024, num_heads=8, vocab_size=96)
    tparams = tdec.params_from_jax(_np_tree(_jax_params(jarch, seed=5, kind="int4")), device="cpu")
    routes = {}
    for n in (2, 4, 8):
        sharded = tdec.shard_params(tparams, build_mesh({"model": n}, [CPU] * n))
        routes[n] = [tdec.tail_route(sharded, tarch, m) for m in (16, 65)]
    assert routes == {2: [tdec.FUSED_TAIL, tdec.PER_PRODUCT], 4: [tdec.FUSED_TAIL, tdec.PER_PRODUCT],
                      8: [tdec.FUSED_TAIL, tdec.PER_PRODUCT]}
    # a shard on a device the merge device cannot read (a card, from the
    # CPU) takes the per-product route
    sharded = tdec.shard_params(tparams, build_mesh({"model": 2}, [CPU] * 2))
    elsewhere = (CPU, torch.device("cuda", 1))
    sharded["layers"] = {k: Sharded(w.shards, w.dim, elsewhere) if isinstance(w, Sharded) else w
                         for k, w in sharded["layers"].items()}
    assert tdec.tail_route(sharded, tarch, 16) == tdec.PER_PRODUCT


# ------------------------------------------------------------ generation
_JAX_GENERATE = jax.jit(jdec.generate, static_argnames=(
    "arch", "max_new_tokens", "eos_id", "pad_id", "temperature", "compute_dtype", "kv_dtype"))


@pytest.fixture(scope="module")
def tiny():
    jparams, jarch = jcur.load_tiny_checkpoint(jcur.default_checkpoint_path())
    tparams, tarch = tcur.load_tiny_checkpoint(tcur.default_checkpoint_path())
    assert dataclasses.asdict(jarch) == dataclasses.asdict(tarch)
    return jparams, jarch, tdec.params_from_jax(tparams, device="cpu"), tarch


def _prompts(n_rows, task, seed):
    tok = ByteTokenizer()
    rng = np.random.default_rng(seed)
    rows = [[tok.bos_token_id] + tok.encode(jcur.make_sample(rng, task)["prompt"]) for _ in range(n_rows)]
    p = max(len(r) for r in rows)
    ids = np.full((len(rows), p), tok.pad_token_id, np.int32)
    mask = np.zeros((len(rows), p), np.int32)
    for i, r in enumerate(rows):
        ids[i, p - len(r):], mask[i, p - len(r):] = r, 1
    return ids, mask


def test_generate_under_tp_matches_jax_on_the_trained_checkpoint(tiny):
    """Greedy tokens, lengths and step counts over a {"model": 2} mesh equal
    JAX's over the same mesh; the port's speculative decode over the mesh
    equals its plain one."""
    jparams, jarch, tparams, tarch = tiny
    tmesh, jmesh = _meshes({"model": 2})
    tok = ByteTokenizer()
    kw = dict(max_new_tokens=64, eos_id=tok.eos_token_id, pad_id=tok.pad_token_id)
    ids, mask = _prompts(2, "ner", 0)
    j = _JAX_GENERATE(_jax_tp(jax.tree_util.tree_map(jnp.asarray, jparams), jmesh, jarch), jnp.asarray(ids),
                      jnp.asarray(mask), arch=jarch, **kw)
    sharded = tdec.shard_params(tparams, tmesh)
    args = (sharded, torch.as_tensor(ids).long(), torch.as_tensor(mask), tarch)
    with torch.no_grad():
        t = tdec.generate(*args, **kw)
        spec = tdec.generate_speculative(*args, **kw)
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
    np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))
    assert t.steps == int(j.steps)
    np.testing.assert_array_equal(spec.tokens.numpy(), t.tokens.numpy())
    np.testing.assert_array_equal(spec.lengths.numpy(), t.lengths.numpy())


def test_get_llm_over_a_model_axis_shards_the_engine(tmp_path):
    """get_llm's jax-tiny route over {"model": 2} builds the engine on the
    mesh's first device with qkv_w split in two, and it answers as the
    unsharded engine does."""
    from comorag_torch.config import ComoConfig
    from comorag_torch.llm import get_llm

    config = ComoConfig(llm_name="jax-tiny", save_dir=str(tmp_path))
    mesh = build_mesh({"model": 2}, [CPU] * 2)
    sharded, whole = get_llm(config, mesh=mesh), get_llm(config, device="cpu")
    qkv = sharded.engine.params["layers"]["qkv_w"]
    assert sharded.engine.mesh is mesh and sharded.engine.device == CPU
    assert isinstance(qkv, Sharded) and qkv.dim == "col" and len(qkv.shards) == 2
    messages = [{"role": "user", "content": "Who kept the lantern on the hill?"}]
    a, b = (llm.infer(messages, max_tokens=24) for llm in (sharded, whole))
    assert a.text == b.text and a.metadata == b.metadata
    sharded.close()
    whole.close()


def test_cli_over_a_model_mesh_answers_as_without_one(tmp_path):
    """``python -m comorag_torch.cli.run --llm_name jax-tiny --mesh_shape
    model=2 --device cpu`` reaches the sharded engine: on moonlantern's
    corpus and its first question (one meta-loop iteration), the OpenIE
    index and the answer equal the same run's without a mesh (both runs
    at once; most of each run is the tiny engine's OpenIE over the five
    chunks)."""
    src = os.path.join(REPO, "dataset", "moonlantern", "moonlantern_1")
    data = tmp_path / "moonlantern_q0"
    data.mkdir()
    with open(os.path.join(src, "corpus.jsonl")) as f:
        (data / "corpus.jsonl").write_text(f.read())
    with open(os.path.join(src, "qas.jsonl")) as f:
        (data / "qas.jsonl").write_text(f.readline())
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    procs = {}
    for tag, extra in (("mesh", ["--mesh_shape", "model=2"]), ("whole", [])):
        cmd = [sys.executable, "-m", "comorag_torch.cli.run", "--base_path", str(data),
               "--llm_name", "jax-tiny", "--embedding_model_name", "hash", "--device", "cpu",
               "--max_meta_loop_iterations", "1",
               "--output_dir", str(tmp_path / tag / "out"), "--save_dir", str(tmp_path / tag / "save"), *extra]
        procs[tag] = subprocess.Popen(cmd, cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
    answers, openie = {}, {}
    for tag, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        (results,) = (tmp_path / tag / "out").rglob("results.json")
        answers[tag] = [r["output"] for r in json.loads(results.read_text())]
        (cache,) = (tmp_path / tag / "save").rglob("openie_results_ner_jax-tiny.json")
        openie[tag] = json.loads(cache.read_text())
    assert len(answers["mesh"]) == 1 and all(answers["mesh"])
    assert answers["mesh"] == answers["whole"]
    assert openie["mesh"] == openie["whole"]


# ----------------------------------------------------------------- the card
def _llama_width(layers):
    """Llama-3.1-8B-Instruct's published widths at ``layers`` layers."""
    return tdec.DecoderArch(vocab_size=128256, hidden_size=4096, num_layers=layers, num_heads=32, num_kv_heads=8,
                            intermediate_size=14336, max_seq_len=131072, rope_theta=500000.0, rms_norm_eps=1e-5,
                            rope_scaling=("llama3", 8.0, 1.0, 4.0, 8192.0))


def _logits_ratio(got, ref):
    """Worst |got - ref| over 2e-2 * max|ref| + 2e-2 * |ref| (above 1 fails)."""
    return float(((got - ref).abs() / (2e-2 * ref.abs().max() + 2e-2 * ref.abs())).max())


def _prefill_and_step(engine, ids, mask):
    """Last-prompt and first-decode-step logits in fp32 compute."""
    b, p = ids.shape
    with torch.no_grad():
        last, cache, slot_valid, row_len = tdec._prefill_batch(engine.params, ids, mask, engine.arch, p + 1, None,
                                                               torch.float32)
        slot_valid[:, p] = True
        step, _ = tdec.decoder_forward(engine.params, last.argmax(-1)[:, None], row_len[:, None],
                                       slot_valid[:, None, :], cache, p, engine.arch, torch.float32)
    return torch.cat([last, step[:, 0]]).float().cpu()


@pytest.mark.cuda
def test_int4_shards_launch_the_kernel_once_a_product_on_the_card():
    """A {"model": 2} mesh of one card at the fused tail's gate shape, whose
    every shard is a multiple of 128 columns: the prefill (M = 320)
    launches int4_matmul once a product over the column shards (4 x layers
    + 1, the head at the last position's 8 rows); the decode step (M = 8)
    launches the fused tail once a layer and int4_matmul once for qkv and
    once for the head (layers + 1). Every kernel then launches as the
    unsharded engine's does, so the logits equal the unsharded engine's
    (max |d| printed, 0 expected); the assertion is the bf16 rule scaled
    to max |logit|."""
    from comorag_torch.llm.offline import TorchOfflineLLM

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    arch = tdec.DecoderArch(vocab_size=512, hidden_size=512, num_layers=2, num_heads=8, num_kv_heads=4,
                            intermediate_size=1024, max_seq_len=512)
    params = tdec.init_params(arch, torch.Generator(device=dev).manual_seed(0), dev)
    engines = [TorchOfflineLLM(params=params, arch=arch, param_dtype="int4", mesh=mesh, device=dev)
               for mesh in (build_mesh({"model": 2}, [dev] * 2), None)]
    sharded = engines[0].params
    assert tdec.tail_route(sharded, arch, 8) == tdec.FUSED_TAIL
    for m in (8, 320):
        assert all(tdec.product_route(sharded["layers"][name], m, dev) == tdec.BLOCKS
                   for name in ("qkv_w", "o_w", "gateup_w", "down_w"))
    assert tdec.product_route(sharded["lm_head"], 8, dev) == tdec.BLOCKS
    ids = torch.randint(0, 256, (8, 40), generator=torch.Generator().manual_seed(1)).to(dev)
    mask = torch.ones_like(ids)
    before = (tint4.LAUNCHES.value, tint4.TAIL_LAUNCHES.value)
    got = _prefill_and_step(engines[0], ids, mask)
    layers = arch.num_layers
    assert tint4.LAUNCHES.value - before[0] == (4 * layers + 1) + (layers + 1)  # prefill + step
    assert tint4.TAIL_LAUNCHES.value - before[1] == layers  # the step
    ref = _prefill_and_step(engines[1], ids, mask)
    print(f"{{'model': 2}} int4 engine against the unsharded one: max |d| of the logits "
          f"{float((got - ref).abs().max())}")
    assert _logits_ratio(got, ref) <= 1.0


def _int4_weight_8b(gen, device, k, n):
    """Random packed bytes and group-128 scales for a [k, n] weight of std
    ~0.02 (chip_smoke.py's)."""
    packed = torch.randint(-128, 128, (k // 2, n), generator=gen, device=device, dtype=torch.int8)
    return packed, torch.empty(k // 128, n, device=device).uniform_(0.003, 0.006, generator=gen)


# Llama-3.1-8B's products as a one-card model axis splits them: qkv and
# gate/up over 2, 4 and 8 shards, the head over {"model": 2}'s 2 (64,128
# columns: an odd multiple of 128, so each block's last split-K item
# holds one box) and over {"model": 4}'s 4 (32,064 columns: a multiple of
# 64 only, so each block's last item holds 64 columns); a process's pair
# of those blocks (64,128 columns in 2), one 32,064-column shard alone
# (a distinct card's), and the head over {"model": 8}'s 8 (16,032 columns:
# a multiple of split-K's 16-column unit, each block's last item 160
# columns, so one launch up to 64 rows; above, one wgmma launch, each
# block's last tile 32 columns);
# and Qwen2.5-7B's qkv over {"model": 8}'s 8 (K = 3,584, 576 columns a
# block: 24 split-K tiles against the whole weight's 18; at 8 rows the
# blocks' tiles alone would take 7 K splits where the whole weight takes 8)
_BLOCKED_8B = [("qkv", 6144, 2), ("qkv", 6144, 4), ("gate_up", 28672, 2), ("gate_up", 28672, 4),
               ("lm_head", 128256, 2), ("lm_head", 128256, 4), ("lm_head pair", 64128, 2),
               ("lm_head shard", 32064, 1), ("qkv", 6144, 8), ("gate_up", 28672, 8), ("lm_head", 128256, 8),
               ("qwen qkv", 4608, 8)]
_BLOCKED_K = {"qwen qkv": 3584}  # K of a case; Llama-3.1-8B's 4,096 elsewhere


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 64, 320])  # splitk, splitk, splitk, wgmma
@pytest.mark.parametrize("name,n,blocks", _BLOCKED_8B, ids=lambda v: str(v))
def test_int4_matmul_over_column_blocks_on_the_card(name, n, blocks, m):
    """int4_matmul over a weight's column blocks (split_blocks, as
    shard_params cuts a one-card model axis's shards) at Llama-3.1-8B
    widths: one launch, within the bf16 rule of the plain version, and
    bit-equal to the whole weight's launch (the same K splits and sums;
    max |d| printed). Blocks off 128 columns above 64 rows take wgmma,
    the last tile of a block ragged; a single 32,064-column shard takes
    split-K up to 64 rows and wgmma above. The head over 8 blocks takes
    the whole head's K splits (504 tiles against 501), and so does
    Qwen2.5-7B's qkv at its K of 3,584 (24 tiles against 18)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(60 + m + blocks)
    k = _BLOCKED_K.get(name, 4096)
    packed, scales = _int4_weight_8b(gen, dev, k, n)
    x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
    cut = split_blocks(packed, -1, [dev] * blocks), split_blocks(scales, -1, [dev] * blocks)
    route = tint4.int4_matmul_route(m, n, blocks)
    assert blocks == 1 or tint4.int4_matmul_blocks_supported(m, [p.shape[-1] for p in cut[0]])
    if route == "splitk":  # bit-equality needs the whole weight's K splits
        plan = functools.partial(tint4.matmul_plan, m, k, n, 128, tint4._sm_count(dev),
                                 *tint4._splitk_geometry(dev, m))
        assert plan(blocks)["splits"] == plan()["splits"]
    before = (tint4.LAUNCHES.value, tint4.ROUTE_LAUNCHES[route].value)
    got = tint4.int4_matmul(x, *cut)
    torch.cuda.synchronize()
    assert (tint4.LAUNCHES.value, tint4.ROUTE_LAUNCHES[route].value) == (before[0] + 1, before[1] + 1)
    ref = tint4.int4_matmul_plain(x, packed, scales)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=2e-2, atol=2e-2)
    delta = float((got - tint4.int4_matmul(x, packed, scales)).abs().max())
    print(f"int4_matmul {name} over {blocks} column blocks, M={m} ({route}): max |blocks - whole| = {delta}")
    assert delta == 0.0


@pytest.mark.cuda
def test_column_split_bias_is_added_once_on_the_merged_blocks():
    """A qwen2-class qkv with its bias split as its columns, over 2 blocks
    of one card at Llama-3.1-8B width, M = 8: the blocks route adds the
    bias once on the merged output; it equals the whole weight's product
    plus the whole bias bit for bit, and the per-shard route (each shard's
    product plus its bias block, gathered) within the bf16 rule."""
    from comorag_torch.parallel.mesh import sharded_matmul

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(70)
    packed, scales = _int4_weight_8b(gen, dev, 4096, 6144)
    bias = torch.randn(6144, generator=gen, device=dev)
    x = torch.randn(1, 8, 4096, generator=gen, device=dev)
    devices = (dev, dev)
    w = Sharded(tuple(tdec.Int4Weight(p, sc) for p, sc in zip(split_blocks(packed, -1, devices),
                                                                split_blocks(scales, -1, devices))), "col", devices)
    b = Sharded(split_blocks(bias, -1, devices), "col", devices)
    assert tdec.product_route(w, 8, dev) == tdec.BLOCKS
    before = tint4.LAUNCHES.value
    got = tdec._dot(x, w, torch.float32, b)
    torch.cuda.synchronize()
    assert tint4.LAUNCHES.value == before + 1
    whole = tdec._dot(x, tdec.Int4Weight(packed, scales), torch.float32, bias)
    assert torch.equal(got, whole)
    per_shard = sharded_matmul(x, w, lambda xs, shard, bs: tdec._dot(xs, shard, torch.float32, bs), b)
    np.testing.assert_allclose(got.cpu().numpy(), per_shard.cpu().numpy(), rtol=2e-2, atol=2e-2)


def _tail_weights_8b(gen, device, h=4096, inter=14336):
    """One layer's o, gate/up and down int4 weights at Llama-3.1-8B width
    (H = h, I = inter)."""
    return [_int4_weight_8b(gen, device, k, n) for k, n in ((h, h), (h, 2 * inter), (inter, h))]


# the fused tail's widths over a one-card model axis, (H, I, blocks): Llama-3.1-8B over 2, 4 and 8 (o / down
# 2,048, 1,024 and 512 columns a block: whole tiles); Qwen2.5-7B over 8 (448 / 4,736 / 448: each block's last
# o / down tile 64 columns); H = 512 and 1,536 over 8 (64 and 192 columns: a block narrower than a tile, and
# one and a half tiles)
_TAIL_BLOCK_WIDTHS = [(4096, 14336, 2), (4096, 14336, 4), (4096, 14336, 8), (3584, 18944, 8), (512, 1024, 8),
                      (1536, 512, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("h,inter,n", _TAIL_BLOCK_WIDTHS, ids=[f"H{c[0]}-I{c[1]}-{c[2]}" for c in _TAIL_BLOCK_WIDTHS])
def test_fused_tail_over_column_blocks_on_the_card(h, inter, n, m):
    """The fused-tail kernel over n column blocks of each weight (one card's
    model axis) at Llama-3.1-8B, Qwen2.5-7B and small widths (o / down
    blocks off the 128-column tile, on its 16-column block unit, among
    them): within the bf16 rule of its plain version (chip_smoke.py's rule
    for row 6), and bit-equal to the launch over the whole weights (the
    same K splits and sums; max |d| printed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(40 + m + h)
    weights = _tail_weights_8b(gen, dev, h, inter)
    ctx = torch.randn(m, h, generator=gen, device=dev).to(torch.bfloat16)
    xres = torch.randn(m, h, generator=gen, device=dev)
    nw = 1.0 + 0.1 * torch.randn(h, generator=gen, device=dev)
    whole = [t for w in weights for t in w]
    blocked = [part for p, sc in weights for part in (split_blocks(p, -1, [dev] * n), split_blocks(sc, -1, [dev] * n))]
    before = tint4.TAIL_LAUNCHES.value
    got = tint4.int4_fused_layer_tail(ctx, xres, nw, *blocked, eps=1e-5)
    torch.cuda.synchronize()
    assert tint4.TAIL_LAUNCHES.value == before + 1
    ref = tint4.int4_fused_layer_tail_plain(ctx, xres, nw, *blocked, eps=1e-5)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=2e-2, atol=2e-2)
    delta = float((got - tint4.int4_fused_layer_tail(ctx, xres, nw, *whole, eps=1e-5)).abs().max())
    print(f"fused tail H={h} I={inter} over {n} column blocks, M={m}: max |blocks - whole| = {delta}")
    assert delta == 0.0


@pytest.mark.cuda
def test_tp_over_distinct_cards_matches_one_card():
    """A {"model": 4} mesh over four distinct cards at Llama-3.1-8B width
    (2 layers, int4 group 128, then bf16 weights): every shard on its own
    card, the int4 decode step's fused tail once a layer and qkv's
    int4_matmul once a layer on cuda:0 over the peer cards' shards, and
    the fp32-compute last-prompt and
    decode-step logits within the bf16 rule scaled to max |logit| of the
    same mesh on one card and of the unsharded engine."""
    from comorag_torch.llm.offline import TorchOfflineLLM

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (a model axis over distinct devices)")
    dev = torch.device("cuda", 0)
    arch = _llama_width(2)
    params = tdec.init_params(arch, torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16)
    ids = torch.randint(0, 256, (8, 128), generator=torch.Generator().manual_seed(1)).to(dev)
    mask = torch.ones_like(ids)
    cards = build_mesh({"model": 4}, [torch.device("cuda", i) for i in range(4)])
    # the decode step's route: the fused tail over the shards, on one card
    # or read from the peer cards; so is qkv's one launch over its shards
    routes = {"cards": tdec.FUSED_TAIL, "one_card": tdec.FUSED_TAIL, "whole": tdec.FUSED_TAIL}
    for param_dtype in ("int4", torch.bfloat16):
        logits = {}
        for tag, mesh in (("cards", cards), ("one_card", build_mesh({"model": 4}, [dev] * 4)), ("whole", None)):
            engine = TorchOfflineLLM(params=params, arch=arch, param_dtype=param_dtype, mesh=mesh, device=dev)
            if tag == "cards":
                qkv = engine.params["layers"]["qkv_w"]
                first = qkv.shards[0].packed if param_dtype == "int4" else qkv.shards[0]
                assert [d.index for d in qkv.devices] == [0, 1, 2, 3] and first.device == dev
            int4 = param_dtype == "int4"
            if mesh is not None:
                qkv_route = tdec.product_route(engine.params["layers"]["qkv_w"], 8, dev)
                assert qkv_route == (tdec.BLOCKS if int4 else tdec.PER_SHARD)
            assert tdec.tail_route(engine.params, arch, 8) == (routes[tag] if int4 else tdec.PER_PRODUCT)
            tails = tint4.TAIL_LAUNCHES.value
            logits[tag] = _prefill_and_step(engine, ids, mask)
            assert tint4.TAIL_LAUNCHES.value - tails == (arch.num_layers if routes[tag] == tdec.FUSED_TAIL and int4
                                                         else 0)
            del engine
        assert _logits_ratio(logits["cards"], logits["one_card"]) <= 1.0
        assert _logits_ratio(logits["cards"], logits["whole"]) <= 1.0
