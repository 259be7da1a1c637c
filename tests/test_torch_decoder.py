"""comorag_torch.models.decoder against comorag_tpu.models.decoder.

The same weights (JAX's ``init_params``, converted with ``params_from_jax``,
or the trained tiny checkpoint) and the same numpy inputs go through both:
- fp32 ``decoder_forward`` logits agree to 1e-4 (sums in another order) on
  tiny archs with GQA, qkv bias, qk_norm with a head_dim override, llama3
  and linear RoPE scaling, and the gemma knobs; int8 weights and the int8
  KV cache too;
- int4 logits: the port rounds the activations to bf16 before each int4
  product as the TPU kernel does (JAX's CPU route does not), so the bf16
  rule scaled to max |logit|, and the same top-1 token;
- greedy ``generate`` tokens and step counts are identical on the trained
  tiny checkpoint, guided (token table) and with a prefix cache, and past
  one 512-token prefill chunk; ``generate_speculative`` equals ``generate``;
- the HF llama loader matches ``LlamaForCausalLM`` on a local random config
  (2e-4 + 2e-3 relative, the JAX package's own bound for this check).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comorag_torch.models import curriculum as tcur
from comorag_torch.models import decoder as tdec
from comorag_tpu.llm.guided import JSON_TEMPLATES, compile_json_schema, make_token_table
from comorag_tpu.llm.jax_offline import ByteTokenizer
from comorag_tpu.models import curriculum as jcur
from comorag_tpu.models import decoder as jdec

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Decoding runs thousands of tiny ops: one intra-op thread is fastest,
    and it keeps this file from contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            intermediate_size=128, max_seq_len=256)
ARCHS = {
    "gqa": {},
    "qkv_bias": dict(qkv_bias=True),
    "qk_norm": dict(qk_norm=True, head_dim_override=32),
    "llama3": dict(rope_scaling=("llama3", 8.0, 1.0, 4.0, 16.0)),
    "linear": dict(rope_scaling=("linear", 4.0)),
    "gemma": dict(embed_scale=True, rms_unit_offset=True, mlp_act="gelu_tanh", tie_embeddings=True),
    "gelu": dict(mlp_act="gelu"),
}


def _archs(name, **over):
    kw = dict(TINY, **ARCHS[name], **over)
    return jdec.DecoderArch(**kw), tdec.DecoderArch(**kw)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _jax_params(jarch, seed=0, perturb_norms=True):
    params = jdec.init_params(jax.random.PRNGKey(seed), jarch)
    if perturb_norms:  # ones would hide a norm applied to the wrong axis
        rng = np.random.default_rng(seed)
        for name in ("attn_norm", "ffn_norm", "q_norm", "k_norm"):
            if name in params["layers"]:
                w = params["layers"][name]
                params["layers"][name] = w + 0.1 * rng.standard_normal(w.shape).astype(np.float32)
    return params


def _prompt_batch(rng, b=2, p=12, vocab=97, pad=0):
    """Left-padded ids and masks, the second row shorter."""
    ids = rng.integers(1, vocab, size=(b, p)).astype(np.int32)
    mask = np.ones((b, p), np.int32)
    mask[1, : p // 3] = 0
    ids[mask == 0] = pad
    return ids, mask


def _forward_both(jarch, tarch, jparams, tparams, ids, mask, kv_dtype=None):
    b, p = ids.shape
    positions = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    attn = np.tril(np.ones((p, p), bool))[None] & mask.astype(bool)[:, None, :]
    jcache = jdec.make_kv_cache(jarch, b, p, jnp.float32, kv_dtype)
    jl, jc = jdec.decoder_forward(jparams, jnp.asarray(ids), jnp.asarray(positions), jnp.asarray(attn), jcache,
                                  jnp.int32(0), jarch)
    tcache = tdec.make_kv_cache(tarch, b, p, torch.float32, kv_dtype, device="cpu")
    tl, tc = tdec.decoder_forward(tparams, torch.as_tensor(ids).long(), torch.as_tensor(positions).long(),
                                  torch.as_tensor(attn), tcache, 0, tarch)
    return np.asarray(jl), tl.numpy(), jc, tc


def test_params_from_jax_carries_every_leaf():
    jarch, _ = _archs("qkv_bias")
    params = _jax_params(jarch)
    for tree in (params, jdec.quantize_params(params), jdec.quantize_params_int4(params)):
        flat = jax.tree_util.tree_flatten_with_path(_np_tree(tree))[0]
        port = tdec.params_from_jax(_np_tree(tree), device="cpu")
        for path, leaf in flat:
            node = port
            for key in path:
                node = node[key.key] if hasattr(key, "key") else getattr(node, key.name)
            assert node.dtype == torch.from_numpy(np.array(leaf)).dtype
            np.testing.assert_array_equal(node.numpy(), leaf)
    port = tdec.params_from_jax(_np_tree(jdec.quantize_params_int4(params)), device="cpu")
    assert isinstance(port["layers"]["down_w"], tdec.Int4Weight)
    port = tdec.params_from_jax(_np_tree(jdec.quantize_params(params)), device="cpu")
    assert isinstance(port["lm_head"], tdec.QuantWeight)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_fp32_matches_jax(name):
    jarch, tarch = _archs(name)
    params = _jax_params(jarch, seed=1)
    ids, mask = _prompt_batch(np.random.default_rng(2))
    tparams = tdec.params_from_jax(_np_tree(params), device="cpu")
    jl, tl, jc, tc = _forward_both(jarch, tarch, params, tparams, ids, mask)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=1e-4, atol=1e-4)


def test_rope_inv_freq_matches_jax():
    for scaling in (None, ("linear", 4.0), ("llama3", 8.0, 1.0, 4.0, 8192.0)):
        np.testing.assert_allclose(tdec._rope_inv_freq(128, 500000.0, scaling).numpy(),
                                   np.asarray(jdec._rope_inv_freq(128, 500000.0, scaling)), rtol=1e-6)


def test_int8_weights_and_int8_kv_cache_match_jax():
    jarch, tarch = _archs("gqa")
    params = _jax_params(jarch, seed=3)
    ids, mask = _prompt_batch(np.random.default_rng(4))
    jq = jdec.quantize_params(params)
    tq = tdec.quantize_params(tdec.params_from_jax(_np_tree(params), device="cpu"))
    np.testing.assert_array_equal(tq["layers"]["qkv_w"].q.numpy(), np.asarray(jq["layers"]["qkv_w"].q))
    np.testing.assert_allclose(tq["lm_head"].scale.numpy(), np.asarray(jq["lm_head"].scale), rtol=1e-7)
    jl, tl, _, _ = _forward_both(jarch, tarch, jq, tq, ids, mask)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    tparams = tdec.params_from_jax(_np_tree(params), device="cpu")
    jl, tl, jc, tc = _forward_both(jarch, tarch, params, tparams, ids, mask, kv_dtype="int8")
    assert isinstance(tc, tdec.QuantKVCache)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc.k_scale.numpy(), np.asarray(jc.k_scale), rtol=1e-5)
    # int8 codes agree up to a rounding tie in another summation order
    assert np.abs(tc.k.numpy().astype(int) - np.asarray(jc.k).astype(int)).max() <= 1


@pytest.mark.parametrize("hidden,inter", [(64, 128), (512, 1024)])  # unfused, fused tail
def test_int4_forward_close_to_jax_with_same_top1(hidden, inter):
    jarch, tarch = _archs("gqa", hidden_size=hidden, intermediate_size=inter, num_heads=8)
    params = _jax_params(jarch, seed=5)
    ids, mask = _prompt_batch(np.random.default_rng(6), b=2, p=8)
    j4 = jdec.quantize_params_int4(params)
    t4 = tdec.params_from_jax(_np_tree(j4), device="cpu")
    if hidden == 512:  # the fused tail's gate holds at decode-sized M
        assert tdec.int4_ops.fused_tail_supported(hidden, inter, 128, ids.size)
    jl, tl, _, _ = _forward_both(jarch, tarch, j4, t4, ids, mask)
    np.testing.assert_allclose(tl, jl, rtol=2e-2, atol=2e-2 * np.abs(jl).max())
    assert (tl.argmax(-1) == jl.argmax(-1)).mean() >= 0.95


# --------------------------------------------------------- trained checkpoint
_JAX_GENERATE = jax.jit(jdec.generate, static_argnames=(
    "arch", "max_new_tokens", "eos_id", "pad_id", "temperature", "compute_dtype", "kv_dtype"))


@pytest.fixture(scope="module")
def tiny():
    jparams, jarch = jcur.load_tiny_checkpoint(jcur.default_checkpoint_path())
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    tparams, tarch = tcur.load_tiny_checkpoint(tcur.default_checkpoint_path())
    assert dataclasses.asdict(jarch) == dataclasses.asdict(tarch)
    return jparams, jarch, tdec.params_from_jax(tparams, device="cpu"), tarch


def _prompts(tok, n_rows, task, seed):
    rng = np.random.default_rng(seed)
    rows = [[tok.bos_token_id] + tok.encode(jcur.make_sample(rng, task)["prompt"]) for _ in range(n_rows)]
    return _left_pad(rows, tok.pad_token_id)


def _left_pad(rows, pad):
    p = max(len(r) for r in rows)
    ids = np.full((len(rows), p), pad, np.int32)
    mask = np.zeros((len(rows), p), np.int32)
    for i, r in enumerate(rows):
        ids[i, p - len(r):], mask[i, p - len(r):] = r, 1
    return ids, mask


def _generate_both(tiny, ids, mask, max_new, table=None, prefix_ids=None, spec=False):
    jparams, jarch, tparams, tarch = tiny
    tok = ByteTokenizer()
    kw = dict(max_new_tokens=max_new, eos_id=tok.eos_token_id, pad_id=tok.pad_token_id)
    jprefix = tprefix = None
    if prefix_ids is not None:
        jprefix = jdec.prefill_prefix(jparams, jnp.asarray(prefix_ids, jnp.int32), jarch)
        tprefix = tdec.prefill_prefix(tparams, list(prefix_ids), tarch)
    j = _JAX_GENERATE(jparams, jnp.asarray(ids), jnp.asarray(mask), arch=jarch, prefix=jprefix,
                      token_table=None if table is None else jnp.asarray(table), **kw)
    tgen = tdec.generate_speculative if spec else tdec.generate
    with torch.no_grad():
        t = tgen(tparams, torch.as_tensor(ids).long(), torch.as_tensor(mask), tarch, prefix=tprefix,
                 token_table=None if table is None else torch.as_tensor(table), **kw)
    return j, t


def test_generate_greedy_matches_jax_on_the_trained_checkpoint(tiny):
    ids, mask = _prompts(ByteTokenizer(), 2, "qa", 0)
    j, t = _generate_both(tiny, ids, mask, 64)
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
    np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))
    assert t.steps == int(j.steps)


def test_generate_guided_with_prefix_cache_matches_jax(tiny):
    tok = ByteTokenizer()
    table = make_token_table(compile_json_schema(JSON_TEMPLATES["ner"]), tok.token_bytes(),
                             eos_token_id=tok.eos_token_id)
    rng = np.random.default_rng(1)
    samples = [jcur.make_sample(rng, "ner") for _ in range(2)]
    rows = [[tok.bos_token_id] + tok.encode(s["prompt"]) for s in samples]
    common = 0
    while rows[0][common] == rows[1][common]:
        common += 1
    p0 = (common // 64) * 64  # the engine's rule: the shared header floored to 64 tokens
    assert p0 >= 64
    ids, mask = _left_pad([r[p0:] for r in rows], tok.pad_token_id)
    j, t = _generate_both(tiny, ids, mask, 64, table=table, prefix_ids=rows[0][:p0])
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
    assert t.steps == int(j.steps)


def test_chunked_prefill_past_512_tokens_matches_jax(tiny):
    tok = ByteTokenizer()
    rng = np.random.default_rng(7)
    text = " ".join(jcur.make_passage(rng)[0] for _ in range(8))
    row = ([tok.bos_token_id] + tok.encode(text))[:700]
    assert len(row) > 512
    ids, mask = np.asarray([row], np.int32), np.ones((1, len(row)), np.int32)
    j, t = _generate_both(tiny, ids, mask, 16)
    np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))


def test_speculative_equals_plain_greedy(tiny):
    _, _, tparams, tarch = tiny
    tok = ByteTokenizer()
    ids, mask = (torch.as_tensor(a).long() for a in _prompts(tok, 2, "qa", 3))
    with torch.no_grad():
        spec = tdec.generate_speculative(tparams, ids, mask, tarch, 64, tok.eos_token_id, tok.pad_token_id)
        plain = tdec.generate(tparams, ids, mask, tarch, 64, tok.eos_token_id, tok.pad_token_id)
    np.testing.assert_array_equal(spec.tokens.numpy(), plain.tokens.numpy())
    np.testing.assert_array_equal(spec.lengths.numpy(), plain.lengths.numpy())
    assert spec.steps < plain.steps  # the trained model echoes its prompt: drafts are accepted


def test_sampling_is_seeded_and_stays_in_the_grammar(tiny):
    _, _, tparams, tarch = tiny
    tok = ByteTokenizer()
    table = make_token_table(compile_json_schema(JSON_TEMPLATES["ner"]), tok.token_bytes(),
                             eos_token_id=tok.eos_token_id)
    ids, mask = _prompts(tok, 2, "ner", 4)
    dfa = compile_json_schema(JSON_TEMPLATES["ner"])
    outs = []
    for _ in range(2):
        with torch.no_grad():
            r = tdec.generate(tparams, torch.as_tensor(ids).long(), torch.as_tensor(mask), tarch, 64,
                              tok.eos_token_id, tok.pad_token_id, temperature=1.0,
                              rng=torch.Generator().manual_seed(11), token_table=torch.as_tensor(table))
        outs.append(r.tokens.numpy())
        for row, n in zip(r.tokens.numpy(), r.lengths.numpy()):
            text = bytes(int(x) for x in row[:n] if x < 256)
            assert dfa.walk(text) >= 0
    np.testing.assert_array_equal(outs[0], outs[1])


def test_hf_llama_loader_matches_transformers(tmp_path):
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
                      rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
                      rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                                    "high_freq_factor": 4.0, "original_max_position_embeddings": 32})
    torch.manual_seed(3)
    model = LlamaForCausalLM(cfg).eval()
    model.save_pretrained(tmp_path / "tiny_llama3")
    params, arch = tdec.load_hf_decoder_checkpoint(str(tmp_path / "tiny_llama3"), device="cpu")
    assert arch.num_kv_heads == 2 and arch.rope_scaling == ("llama3", 8.0, 1.0, 4.0, 32.0)
    prompt = np.random.default_rng(5).integers(0, 128, size=48).tolist()
    with torch.no_grad():
        ref = model(torch.tensor([prompt])).logits[0].numpy()
        n = len(prompt)
        logits, _ = tdec.decoder_forward(params, torch.tensor([prompt]), torch.arange(n)[None],
                                         torch.tril(torch.ones(1, n, n, dtype=torch.bool)),
                                         tdec.KVCache.zeros(arch, 1, n, device="cpu"), 0, arch)
    np.testing.assert_allclose(logits[0].numpy(), ref, atol=2e-4, rtol=2e-3)


def test_init_params_is_seeded_and_shaped():
    arch = tdec.DecoderArch.tiny()
    a = tdec.init_params(arch, torch.Generator().manual_seed(0), device="cpu")
    b = tdec.init_params(arch, torch.Generator().manual_seed(0), device="cpu")
    ref = jdec.init_params(jax.random.PRNGKey(0), jdec.DecoderArch.tiny())
    for (path, leaf) in jax.tree_util.tree_flatten_with_path(ref)[0]:
        keys = [k.key for k in path]
        node_a, node_b = a, b
        for key in keys:
            node_a, node_b = node_a[key], node_b[key]
        assert tuple(node_a.shape) == leaf.shape
        assert torch.equal(node_a, node_b)
    assert abs(float(a["layers"]["qkv_w"].std()) - 0.02) < 2e-3


def test_sampling_distributions_match_the_model():
    """Temperature > 0: torch.Generator noise cannot reproduce jax.random's
    draws, so both decode loops are held to the model's own distribution
    (tests/test_offline_llm.py's check): the empirical joint of the first
    two tokens, sequential and speculative (rejection-sampled drafts),
    within 0.08 total variation of the exact joint, and drafts accepted."""
    arch = tdec.DecoderArch(vocab_size=6, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                            intermediate_size=64, max_seq_len=64)
    params = tdec.init_params(arch, torch.Generator().manual_seed(7), device="cpu")
    temp, eos, pad = 0.7, 5, 0
    prompt = [1, 2, 3, 1, 2, 3, 1, 2]  # repetitive: the 2-gram lookup finds drafts
    b, p = 4096, len(prompt)
    ids = torch.tensor(prompt).repeat(b, 1)
    mask = torch.ones(b, p, dtype=torch.int64)

    def last_probs(seq):
        n = len(seq)
        with torch.no_grad():
            lg, _ = tdec.decoder_forward(params, torch.tensor([seq]), torch.arange(n)[None],
                                         torch.tril(torch.ones(1, n, n, dtype=torch.bool)),
                                         tdec.KVCache.zeros(arch, 1, n, device="cpu"), 0, arch)
        return torch.softmax(lg[0, -1] / temp, -1).numpy()

    p1 = last_probs(prompt)
    exact = {}
    for t1 in range(arch.vocab_size):
        if t1 == eos:
            exact[(t1, -1)] = float(p1[t1])
            continue
        p2 = last_probs(prompt + [t1])
        for t2 in range(arch.vocab_size):
            exact[(t1, t2)] = float(p1[t1] * p2[t2])

    def tv(gen_fn, seed, **kw):
        with torch.no_grad():
            res = gen_fn(params, ids, mask, arch, 4, eos, pad, temperature=temp,
                         rng=torch.Generator().manual_seed(seed), **kw)
        toks, lens = res.tokens.numpy(), res.lengths.numpy()
        counts = {}
        for i in range(b):
            t1 = int(toks[i, 0])
            key = (t1, int(toks[i, 1]) if lens[i] >= 2 and t1 != eos else -1)
            counts[key] = counts.get(key, 0) + 1
        keys = set(counts) | set(exact)
        return 0.5 * sum(abs(counts.get(k, 0) / b - exact.get(k, 0.0)) for k in keys), res

    tv_seq, _ = tv(tdec.generate, 100)
    tv_spec, _ = tv(tdec.generate_speculative, 200, draft_len=3)
    assert tv_seq < 0.08, tv_seq
    assert tv_spec < 0.08, tv_spec
    multi = 0  # single-row runs that committed more tokens than loop steps
    for seed in range(32):
        with torch.no_grad():
            r = tdec.generate_speculative(params, ids[:1], mask[:1], arch, 4, eos, pad, draft_len=3,
                                          temperature=temp, rng=torch.Generator().manual_seed(5000 + seed))
        multi += int(r.lengths[0]) > r.steps
    assert multi > 0, "no sampled draft was accepted in 32 runs"
