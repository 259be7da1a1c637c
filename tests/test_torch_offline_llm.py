"""comorag_torch.llm.offline (TorchOfflineLLM), .serving and the get_llm
routes against comorag_tpu's JaxOfflineLLM on the CPU.

On the trained tiny checkpoint (``jax-tiny``) both engines give the same
texts and the same ``llm.*`` counter deltas for guided and unguided
prompts (greedy, fp32: exact). The KV admission budget is the same
number; the adaptive speculative fallback fires and changes no text; the
GenerationServer answers concurrent callers as the engine alone does, and
per-request failures come back as ``finish_reason: "error"`` rows.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comorag_torch.config import ComoConfig as TorchConfig
from comorag_torch.llm import get_llm
from comorag_torch.llm.offline import ByteTokenizer, TorchOfflineLLM, render_chat
from comorag_torch.llm.serving import GenerationServer
from comorag_torch.models import curriculum as tcur
from comorag_torch.utils import trace as torch_trace
from comorag_tpu.llm.jax_offline import JaxOfflineLLM
from comorag_tpu.models import curriculum as jcur
from comorag_tpu.utils import trace as jax_trace


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Decoding runs thousands of tiny ops: one intra-op thread is fastest,
    and it keeps this file from contending with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    jparams, jarch = jcur.load_tiny_checkpoint(jcur.default_checkpoint_path())
    tparams, tarch = tcur.load_tiny_checkpoint(tcur.default_checkpoint_path())
    return (TorchOfflineLLM(params=tparams, arch=tarch, max_new_tokens=384, device="cpu"),
            JaxOfflineLLM(params=jparams, arch=jarch, max_new_tokens=384))


def _llm_counters(trace):
    return {k: v for k, v in trace.summary()["counters"].items() if k.startswith("llm.")}


def _delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def test_jax_tiny_texts_and_counters_match_jax(engines):
    t, j = engines
    rng = np.random.default_rng(5)
    ner = [tcur.make_sample(rng, "ner") for _ in range(2)]
    qa = [tcur.make_sample(rng, "qa")]
    for samples, template, max_tokens in ((ner, "ner", 96), (qa, None, 160)):
        tb, jb = _llm_counters(torch_trace), _llm_counters(jax_trace)
        got = t._generate_batch([s["prompt"] for s in samples], max_tokens, template, 0.0)
        want = j._generate_batch([s["prompt"] for s in samples], max_tokens, template, 0.0)
        assert [r.text for r in got] == [r.text for r in want]
        assert [r.metadata for r in got] == [r.metadata for r in want]
        assert _delta(tb, _llm_counters(torch_trace)) == _delta(jb, _llm_counters(jax_trace))
    assert all(json.loads(r.text)["named_entities"] for r in t._generate_batch([ner[0]["prompt"]], 96, "ner", 0.0))


def test_chat_framing_and_tokenizer_match_jax():
    from comorag_tpu.llm.jax_offline import ByteTokenizer as JaxTok
    from comorag_tpu.llm.jax_offline import render_chat as jax_render

    msgs = [{"role": "system", "content": "be brief"}, {"role": "user", "content": "héllo — ∀x"}]
    assert render_chat(msgs) == jax_render(msgs)
    assert ByteTokenizer().encode(render_chat(msgs)) == JaxTok().encode(render_chat(msgs))
    assert ByteTokenizer().token_bytes() == JaxTok().token_bytes()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_slot_row_budget_matches_jax(kv_dtype):
    budget = 64 << 20
    t = TorchOfflineLLM(seed=0, kv_budget_bytes=budget, kv_dtype=kv_dtype, device="cpu")
    j = JaxOfflineLLM(seed=0, kv_budget_bytes=budget, kv_dtype=kv_dtype)
    assert t._slot_row_budget == j._slot_row_budget
    tb = TorchOfflineLLM(seed=0, compute_dtype=torch.bfloat16, kv_budget_bytes=budget, device="cpu")
    jb = JaxOfflineLLM(seed=0, compute_dtype=jnp.bfloat16, kv_budget_bytes=budget)
    assert tb._slot_row_budget == jb._slot_row_budget


def test_token_budget_splits_long_prompt_batches():
    llm = TorchOfflineLLM(seed=3, device="cpu")
    llm._slot_row_budget = 4 * llm.max_model_len
    calls = []
    orig = llm._generate_batch

    def spy(prompts, *a, **k):
        calls.append(len(prompts))
        return orig(prompts, *a, **k)

    llm.__dict__["_generate_batch"] = spy
    long = "x " * llm.max_model_len
    out = llm.batch_infer([[{"role": "user", "content": long}] for _ in range(8)], max_tokens=4)
    assert len(out) == 8 and all(r.metadata.get("finish_reason") != "error" for r in out)
    assert len(calls) >= 2 and max(calls) <= 4, calls


def test_adaptive_spec_fallback_is_output_transparent():
    plain = TorchOfflineLLM(seed=7, device="cpu")
    spec = TorchOfflineLLM(seed=7, speculative=True, draft_len=5, spec_fallback_ratio=1e9, device="cpu")
    msgs = [[{"role": "user", "content": f"note {i}: the owl waits."}] for i in range(2)]
    texts = [[r.text for r in spec.batch_infer(msgs, max_tokens=16)] for _ in range(4)]
    assert not spec._spec_active, "fallback never fired"
    ref = [r.text for r in plain.batch_infer(msgs, max_tokens=16)]
    assert all(t == ref for t in texts)
    assert plain._spec_eff_ema is None


def test_batch_infer_isolates_bad_rows_and_templates():
    llm = TorchOfflineLLM(seed=0, device="cpu")
    out = llm.batch_infer([[{"role": "user", "content": "fine"}], [{"content": "no role"}]], max_tokens=4)
    assert out[0].metadata["finish_reason"] in ("stop", "length")
    assert out[1].metadata["finish_reason"] == "error"
    out = llm.batch_infer([[{"role": "user", "content": "x"}]], json_template="nope")
    assert out[0].metadata["finish_reason"] == "error"


def test_generation_server_batches_concurrent_callers():
    engine = TorchOfflineLLM(seed=0, device="cpu")
    with GenerationServer(engine, window_ms=25.0, max_batch=16) as server:
        def ask(i):
            return server.infer([{"role": "user", "content": f"question {i}"}], max_tokens=8)

        with ThreadPoolExecutor(max_workers=12) as pool:
            results = list(pool.map(ask, range(12)))
        direct = engine.infer([{"role": "user", "content": "question 3"}], max_tokens=8)
        assert results[3].text == direct.text
        assert all(r.metadata.get("finish_reason") in ("stop", "length") for r in results)
        assert any(r.metadata["batched_with"] > 0 for r in results)
        assert server.supports_guided_json
    with pytest.raises(RuntimeError):
        server.submit([{"role": "user", "content": "late"}])


def test_get_llm_routes(tmp_path):
    def cfg(name):
        return TorchConfig(llm_name=name, save_dir=str(tmp_path), output_dir=str(tmp_path))

    for name in ("jax-offline", "jax-tiny"):
        llm = get_llm(cfg(name), device="cpu")
        assert isinstance(llm, GenerationServer) and isinstance(llm.engine, TorchOfflineLLM)
        assert llm.engine.device == torch.device("cpu")
        assert llm.engine.arch.hidden_size == (256 if name == "jax-tiny" else 64)
        llm.close()
    assert type(get_llm(cfg("fake"), device="cpu")).__name__ == "FakeLLM"


def test_get_llm_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        get_llm(TorchConfig(llm_name="jax-offline", save_dir=str(tmp_path)), device="cuda")


def test_hf_checkpoint_route_generates(tmp_path):
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
                      tie_word_embeddings=False)
    torch.manual_seed(0)
    LlamaForCausalLM(cfg).eval().save_pretrained(tmp_path / "llama")
    engine = TorchOfflineLLM(model_name_or_path=str(tmp_path / "llama"), tokenizer=ByteTokenizer(),
                             device="cpu")
    assert engine.arch.vocab_size == 300
    out = engine.infer([{"role": "user", "content": "hi"}], max_tokens=6)
    assert out.metadata["completion_tokens"] > 0


def test_save_and_load_tiny_checkpoint_roundtrip(tmp_path):
    from comorag_torch.models import decoder

    arch = decoder.DecoderArch.tiny()
    params = decoder.init_params(arch, torch.Generator().manual_seed(0), device="cpu")
    path = str(tmp_path / "ckpt.npz")
    tcur.save_tiny_checkpoint(path, params, arch)
    loaded, arch2 = tcur.load_tiny_checkpoint(path)
    assert arch2 == arch
    np.testing.assert_array_equal(loaded["layers"]["qkv_w"],
                                  params["layers"]["qkv_w"].numpy().astype(np.float16).astype(np.float32))
    jparams, jarch = jcur.load_tiny_checkpoint(path)  # the JAX package reads the port's file
    np.testing.assert_array_equal(jparams["lm_head"], loaded["lm_head"])
