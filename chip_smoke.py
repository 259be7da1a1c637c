"""Smoke run of comorag_torch's main paths on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, one line each (any failed check raises and the exit code is not 0):
  1. device: require CUDA; the card's name and power limit from nvidia-smi;
  2. build the four Hopper kernel sources from csrc/ with nvcc, in
     parallel, timed;
  3. the encoder kernels against their plain PyTorch versions at main-path
     shapes in bf16 (attention q/k/v [64, 512, 768] with 12 heads and a
     ragged mask; FFN [64*512, 768] -> 3072 -> 768; then both at the
     slice's usual index batch of 32 texts x 32 tokens), tolerance
     |d| <= 2e-2 + 2e-2*|plain| (the repo's bf16 tolerance,
     tests/test_tpu_compiled.py), and the median of 20 CUDA-event-timed
     samples of 10 calls each; attention beside SDPA with the same additive
     mask, its bound counting k and v up to each row's last valid key (the
     kernel skips the key tiles after it: they add exactly 0); the FFN
     beside its two products alone as torch.matmul runs them (a yardstick
     of the tensor-core rate the port never calls), with its K splits and
     the wrapper's host time per call (200 calls, no sync);
  4. the bert-base encoder (encode_pooled, B=64, S=512, seeded random
     weights) through the kernels vs the plain path: per-row cosine >= 0.999,
     texts/s of both;
  5. the index-and-answer slice: ComoRAG (fake LLM, bf16 bert-base encoder,
     default retrieval) indexes a seeded 2,000-chunk synthetic corpus and
     answers 16 questions; every store and the graph are non-empty, 16
     answers come back, and both encoder kernels' launch counts grew; the
     two_pass.* counters of the index and QA and the graph.* spans;
  6. the streaming top-k kernels (fp32 and int8 rows) against their plain
     versions on bench.py's corpus (100,000 x 1024, normalized, seed 0),
     k = 50, P = 16 and 256: scores to 1e-5 + 1e-5*|plain|, ids equal at
     every rank separated from its neighbours by more than 1e-5
     (ops/mips.check_topk); median ms of kernel and plain;
  7. retrieval serving at bench shape: MipsIndex.topk_many over 100
     distinct host batches of 16 queries, k = 50, best of 4 interleaved
     rounds, for fp32 single-pass, the default (int8 two-pass; also with
     device-resident batches), bf16 two-pass, bf16 and int8 storage and the
     kernel route (method="pallas") over fp32 and int8; overlap with a
     float64 numpy oracle (1.0 for every exact variant), each kernel route
     against its plain route; qps and rescued batches on one JSON line;
  8. the meta loop on the top-k kernels: ComoRAG with topk_method="pallas"
     indexes a seeded 12,000-chunk corpus (episodic layer >= 512 rows) and
     answers 16 questions, then a second ComoRAG with embedding_dtype="int8"
     reuses the stores and answers them again; the fp32 kernel's launch
     count grew in the first run and the int8 kernel's in the second. Every
     top-k kernel call of each run is recorded and then held against its
     plain version at those inputs (as phase 6; both timed), and the graph
     build's synonymy sweep is replayed on the default route (int8 two-pass)
     and on fp32 single-pass to attribute the graph span.
  9. the int4 kernels against their plain versions at Llama-3.1-8B's shapes
     in bf16 (random packed weights, scales for weights of std ~0.02):
     int4_matmul at M = 8 (qkv 4096->6144, lm_head 4096->128256) and
     M = 4096 (qkv, o 4096->4096, gate/up 4096->28672, down 14336->4096),
     int4_fused_layer_tail at M = 8 and 64, under the bf16 rule; kernel ms
     (cycling through 32 layers' weights, past the 50 MB L2), plain ms,
     bound ms and what sets it, roofline share;
 10. the generation server at Llama-3.1-8B width (32 layers, seeded random
     bf16 weights made on the card, int4 with group 128):
     GenerationServer(TorchOfflineLLM(param_dtype="int4", bf16 compute))
     answers 8 requests submitted from 8 threads at once (512-token prompt
     bucket, 64 new tokens); no response is an error, every response has
     completion tokens, both int4 kernels launched; prefill and decode
     tok/s and the llm.* counters, then the same batch on the int4 plain
     path and on bf16 weights (torch.matmul); the requests' last-prompt
     logits (int4_matmul) and first decode step's logits (the fused tail)
     through the kernels against the plain versions in fp32 compute
     (2e-2 * max|logit| + 2e-2 * |logit|), also on two more weight seeds;
     the served bf16 logits' distance and the share of identical greedy
     tokens (reported: bf16 roundings that flip between the routes
     compound over 32 random layers), and, as the witness, the same served
     comparison and a bf16 decode step held under the rule at 2 and 4
     layers;
 11. the jax-tiny route on the card: ``python -m comorag_torch.cli.run
     --llm_name jax-tiny --device cuda`` over dataset/moonlantern (answers
     back, entity and fact stores non-empty), the tiny engine on int4
     weights (int4_matmul launches, the fused tail's gate is false at
     H = 256), speculative decoding equal to plain greedy.
Then it checks that no module of jax or of the JAX package was loaded, and
prints the kernels JSON line (every kernel with its launches on the main
path, max_abs_err, ms, plain_ms, bound_ms, bound_by and library_ms), the
nvidia-smi line, and the result line.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from comorag_torch import ComoConfig, trace
from comorag_torch.cli import run as cli_run
from comorag_torch.comorag import ComoRAG
from comorag_torch.llm import serving
from comorag_torch.llm.fake import FakeLLM
from comorag_torch.llm.offline import TorchOfflineLLM
from comorag_torch.models import bge, curriculum, decoder
from comorag_torch.ops import attention, build, ffn, int4, mips
from comorag_torch.ops.topk import dense_scores, int8_scores, quantize_int8
from comorag_torch.retrieval import index as index_mod
from comorag_torch.retrieval.index import MipsIndex

BF16_TOL = 2e-2
SEED = 0
N_CHUNKS = 2000
N_QUESTIONS = 16
N_META_CHUNKS = 12_000  # timeline window 20: 600 episodic rows, over the kernels' 512
BENCH_N, BENCH_DIM, BENCH_K = 100_000, 1024, 50  # bench.py:34-37
SERVE_BATCHES, SERVE_P, SERVE_ROUNDS = 100, 16, 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM: NVIDIA's published peaks (dense, 700 W)
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}
REPO = os.path.dirname(os.path.abspath(__file__))


def bound(n_bytes: float, n_ops: float, kind: str) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — this run needs a CUDA card")
    return torch.device("cuda", 0)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, runs: int = 20, reps: int = 10, warmup: int = 3) -> float:
    """Median over ``runs`` samples of the device time per call of ``fn``,
    each sample ``reps`` back-to-back calls between two CUDA events (so
    the host's launch work overlaps the device's, as on the main path)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def rule_ratio(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst |got - ref| / (2e-2 + 2e-2 * |ref|): the bf16 rule holds at <= 1."""
    g, r = got.float(), ref.float()
    return float(((g - r).abs() / (BF16_TOL + BF16_TOL * r.abs())).max())


def compare(got: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """Max |got - ref|; raises unless |d| <= 2e-2 + 2e-2 * |ref| everywhere."""
    g, r = got.float(), ref.float()
    if not (torch.isfinite(g).all() and torch.isfinite(r).all()):
        raise AssertionError(f"{what}: non-finite output")
    diff = (g - r).abs()
    worst = rule_ratio(g, r)
    if worst > 1.0:
        raise AssertionError(f"{what}: |kernel - plain| exceeds 2e-2 + 2e-2*|plain| "
                             f"(max abs {float(diff.max()):.4g}, worst ratio {worst:.3f})")
    return float(diff.max())


def ragged_mask(b: int, s: int, gen: torch.Generator, device) -> torch.Tensor:
    lengths = torch.randint(1, s + 1, (b,), generator=gen)
    lengths[0] = s
    return (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32).to(device)


# ------------------------------------------------------------------ phase 3
def host_us(fn, calls: int = 200) -> float:
    """Host wall time per call of ``calls`` back-to-back calls with no
    sync (what the wrapper costs the thread that launches it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def ffn_inputs(n: int, device, h: int = 768, inter: int = 3072) -> tuple:
    """encoder_ffn's arguments for n rows of bert-base activations: xres,
    w1, w2 bf16 (weights of std 0.02), the vectors fp32, seeded."""
    gen = torch.Generator().manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    xres = randn(n, h).to(torch.bfloat16)
    w1, w2 = randn(h, inter, scale=0.02).to(torch.bfloat16), randn(inter, h, scale=0.02).to(torch.bfloat16)
    b1, b2 = randn(inter, scale=0.02), randn(h, scale=0.02)
    s1, n1, s2, n2 = 1.0 + randn(h, scale=0.1), randn(h, scale=0.1), 1.0 + randn(h, scale=0.1), randn(h, scale=0.1)
    return xres, s1, n1, w1, b1, w2, b2, s2, n2


def ffn_bound(n: int, h: int, inter: int) -> dict:
    """x read and out written in bf16, both weights in bf16, vectors fp32;
    two products."""
    return bound(2 * n * h * 2 + 2 * h * inter * 2 + (5 * h + inter) * 4, 4 * n * h * inter, "bf16")


def phase_kernels(device, b: int, s: int) -> dict:
    """Both kernels vs their plain versions on a [b, s] batch of bert-base
    activations (h 768, 12 heads, FFN 3072)."""
    gen = torch.Generator().manual_seed(SEED)
    h, heads, inter = 768, 12, 3072

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    q, k, v = (randn(b, s, h).to(torch.bfloat16) for _ in range(3))
    mask = ragged_mask(b, s, gen, device)
    got = attention.encoder_attention(q, k, v, mask, heads)
    ref = attention.encoder_attention_plain(q, k, v, mask, heads)
    dh = h // heads
    qh, kh, vh = (t.reshape(b, s, heads, dh).transpose(1, 2).contiguous() for t in (q, k, v))
    bias = torch.where(mask.bool(), 0.0, -1e30).to(torch.bfloat16)[:, None, None, :]
    # keys after a row's last valid key add exactly 0 (exp of -1e30 below the
    # row max): this data needs k and v up to there and the products over them
    last = torch.where(mask > 0, torch.arange(s, device=device), -1).amax(dim=1)
    keys = int(torch.where(last >= 0, last + 1, s).sum())
    attn = {
        "max_abs_err": compare(got, ref, "encoder_attention"),
        "ms": median_ms(lambda: attention.encoder_attention(q, k, v, mask, heads)),
        "plain_ms": median_ms(lambda: attention.encoder_attention_plain(q, k, v, mask, heads)),
        # the yardstick: one PyTorch call on the same inputs, heads-major, same additive mask
        "library_ms": median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)),
        # q read and ctx written in bf16, k and v up to each row's last valid key, the
        # mask; QK^T and PV at 2*S*keys*dh each per (row, head)
        **bound(2 * b * s * h * 2 + 2 * keys * h * 2 + b * s * 4, 4 * heads * s * keys * dh, "bf16"),
        "keys_needed": keys,
    }
    attn["roofline_share"] = attn["bound_ms"] / attn["ms"]
    # every key valid: the kernel skips no tile, so this is the wgmma + TMA
    # core alone beside SDPA (whose time does not depend on the mask)
    full = torch.ones_like(mask)
    zero_bias = torch.zeros_like(bias)
    got = attention.encoder_attention(q, k, v, full, heads)
    ref = attention.encoder_attention_plain(q, k, v, full, heads)
    full_bound = bound(3 * b * s * h * 2 + b * s * h * 2 + b * s * 4, 4 * heads * s * s * dh * b, "bf16")
    attn.update({
        "full_mask_max_abs_err": compare(got, ref, "encoder_attention, full mask"),
        "full_mask_ms": median_ms(lambda: attention.encoder_attention(q, k, v, full, heads)),
        "full_mask_library_ms": median_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=zero_bias)),
        "full_mask_bound_ms": full_bound["bound_ms"], "full_mask_bound_by": full_bound["bound_by"],
    })
    attn["max_abs_err"] = max(attn["max_abs_err"], attn["full_mask_max_abs_err"])
    del got, ref, q, k, v, qh, kh, vh

    args = ffn_inputs(b * s, device)
    got = ffn.encoder_ffn(*args)
    ref = ffn.encoder_ffn_plain(*args)
    xres, s1, n1, w1, b1, w2 = args[:6]
    x1 = ffn.layer_norm(xres.float(), s1, n1, 1e-12).to(torch.bfloat16)
    mid = torch.nn.functional.gelu(torch.matmul(x1, w1).float() + b1).to(torch.bfloat16)
    mlp = {
        "max_abs_err": compare(got, ref, "encoder_ffn"),
        "ms": median_ms(lambda: ffn.encoder_ffn(*args)),
        "plain_ms": median_ms(lambda: ffn.encoder_ffn_plain(*args)),
        "library_ms": None,  # no single PyTorch call computes LN-FFN-residual-LN
        # the yardstick of the tensor-core rate: the two products alone, as torch.matmul runs them
        "products_library_ms": median_ms(lambda: (torch.matmul(x1, w1), torch.matmul(mid, w2))),
        "host_us": host_us(lambda: ffn.encoder_ffn(*args)),
        "splits": ffn.ffn_plan(b * s, h, inter, ffn._sm_count(device), *ffn._tiles())["splits"],
        **ffn_bound(b * s, h, inter),
    }
    mlp["roofline_share"] = mlp["bound_ms"] / mlp["ms"]
    del got, ref, x1, mid, args
    print(f"phase 3 kernels vs plain (bf16, tol 2e-2 + 2e-2*|plain|): "
          f"attention [{b},{s},{h}]x{heads} heads max_abs_err={attn['max_abs_err']:.4g} "
          f"kernel {attn['ms']:.4f} ms plain {attn['plain_ms']:.4f} ms sdpa {attn['library_ms']:.4f} ms "
          f"bound {attn['bound_ms']:.4f} ms ({attn['bound_by']}; {keys} of {b * s} keys needed) "
          f"share {attn['roofline_share']:.3f}; full mask kernel {attn['full_mask_ms']:.4f} ms "
          f"sdpa {attn['full_mask_library_ms']:.4f} ms bound {attn['full_mask_bound_ms']:.4f} ms "
          f"({attn['full_mask_bound_by']}) | "
          f"ffn [{b * s},{h}]->{inter} max_abs_err={mlp['max_abs_err']:.4g} "
          f"kernel {mlp['ms']:.4f} ms plain {mlp['plain_ms']:.4f} ms "
          f"bound {mlp['bound_ms']:.4f} ms ({mlp['bound_by']}) share {mlp['roofline_share']:.3f} "
          f"products alone (torch.matmul) {mlp['products_library_ms']:.4f} ms; {mlp['splits']} K split(s); "
          f"wrapper host {mlp['host_us']:.1f} us a call", flush=True)
    return {"encoder_attention": attn, "encoder_ffn": mlp}


# ------------------------------------------------------------------ phase 4
def bert_base(device) -> bge.Encoder:
    arch = bge.EncoderArch()  # bert-base: 30522 vocab, 768 hidden, 12 layers, 12 heads
    return bge.init_params(arch, torch.Generator().manual_seed(SEED)).to(device)


def phase_encoder(device) -> dict:
    gen = torch.Generator().manual_seed(SEED + 1)
    b, s = 64, 512
    kernel_model = bert_base(device).cast_matrices_(torch.bfloat16)
    ids = torch.randint(2, kernel_model.arch.vocab_size, (b, s), generator=gen).to(device)
    mask = ragged_mask(b, s, gen, device)

    def run(route):
        with torch.no_grad():
            return bge.encode_pooled(kernel_model, ids, mask, torch.bfloat16, attention=route)

    got, ref = run("kernel"), run("plain")
    cos = torch.nn.functional.cosine_similarity(got.float(), ref.float(), dim=-1)
    if not (torch.isfinite(got).all() and got.shape == (b, kernel_model.arch.hidden_size)):
        raise AssertionError("encode_pooled: non-finite or misshapen output")
    if float(cos.min()) < 0.999:
        raise AssertionError(f"encode_pooled: kernel vs plain cosine {float(cos.min()):.6f} < 0.999")
    out = {
        "min_cosine": float(cos.min()),
        "kernel_texts_per_s": b / (median_ms(lambda: run("kernel"), runs=5, reps=2, warmup=1) / 1e3),
        "plain_texts_per_s": b / (median_ms(lambda: run("plain"), runs=5, reps=2, warmup=1) / 1e3),
    }
    print(f"phase 4 bert-base encode_pooled B=64 S=512 bf16: min cosine {out['min_cosine']:.6f}; "
          f"kernels {out['kernel_texts_per_s']:.1f} texts/s, plain {out['plain_texts_per_s']:.1f} texts/s",
          flush=True)
    return out


# ------------------------------------------------------------------ phase 5
NAMES = ["Arden", "Brisa", "Corin", "Davet", "Elwyn", "Fiora", "Garrick", "Halla",
         "Isolde", "Joren", "Kestrel", "Lumen", "Maris", "Nerin", "Orla", "Petra"]
SURNAMES = ["Veyl", "Marsh", "Okonkwo", "Ibarra", "Tanaka", "Lindqvist", "Moreau", "Castellan",
            "Drummond", "Ferro", "Galloway", "Hartwell", "Ivers", "Jansson", "Kovacs", "Larkspur",
            "Mendel", "Norcross", "Oakes", "Pryce", "Quill", "Rothgar", "Severin", "Thistle",
            "Underhill", "Vance", "Walden", "Xanthe", "Yarrow", "Zephyrin", "Ashdown", "Briarwood"]
PLACES = ["mill", "harbor", "orchard", "quarry", "archive", "forge", "lighthouse", "granary"]
ITEMS = ["ledger", "compass", "seedchest", "ironkey", "starchart", "bronzebell", "anvil", "lantern"]


def make_corpus(n: int, n_gold: int, seed: int = 7):
    """Synthetic narrative with planted gold facts (the generator of
    scripts/bench_e2e.py:49): full names give a real entity graph."""
    rng = np.random.default_rng(seed)
    chunks = []
    for i in range(n):
        a = f"{NAMES[rng.integers(len(NAMES))]} {SURNAMES[rng.integers(len(SURNAMES))]}"
        a2 = f"{NAMES[rng.integers(len(NAMES))]} {SURNAMES[rng.integers(len(SURNAMES))]}"
        b = PLACES[rng.integers(len(PLACES))]
        c = ITEMS[rng.integers(len(ITEMS))]
        d = int(rng.integers(1, 365))
        chunks.append(f"Record {i}: {a} visited the {b} on day {d} with {a2} and catalogued the {c} "
                      f"before returning along the river road at dusk.")
    queries = []
    for gi, cid in enumerate(rng.choice(n, size=n_gold, replace=False)):
        token = f"relic{gi:03d}"
        chunks[cid] = (f"Record {cid}: the hidden {token} was sealed inside the "
                       f"{PLACES[gi % len(PLACES)]} vault by the wandering cartographer Quintessa.")
        queries.append(f"Where was the hidden {token} sealed by Quintessa?")
    return chunks, queries


def slice_config(workdir: str, **retrieval) -> ComoConfig:
    return ComoConfig(llm_name="fake", compute_dtype="bfloat16", need_cluster=True,
                      embedding_model_name="bge:bert-base-random",
                      save_dir=f"{workdir}/outputs", output_dir=f"{workdir}/results", **retrieval)


def bert_base_encoder(device) -> bge.BGETorchEncoder:
    model = bert_base("cpu")
    encoder = bge.BGETorchEncoder(params=model, tokenizer=bge.SimpleHashTokenizer(model.arch.vocab_size),
                                  max_seq_len=512, batch_size=ComoConfig().embedding_batch_size,
                                  device=device, compute_dtype=torch.bfloat16)
    if encoder.attention != "kernel":
        raise AssertionError("the bf16 encoder on CUDA must route through the kernels")
    return encoder


def run_slice(rag: ComoRAG, docs, queries, counters) -> dict:
    """Index ``docs`` and answer ``queries`` with every launch count set to
    0 just before and read just after; checks stores and answers."""
    trace.reset()
    for counter in counters:
        counter.reset()
    t0 = time.perf_counter()
    rag.index(docs)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    index_two_pass = two_pass_counters()
    t1 = time.perf_counter()
    solutions = rag.try_answer(queries)
    torch.cuda.synchronize()
    qa_s = time.perf_counter() - t1
    launches = {c.name: c.value for c in counters}
    sizes = {name: len(getattr(rag, name)) for name in
             ("ver_store", "entity_store", "fact_store", "sem_store", "epi_store")}
    if sizes["ver_store"] != len(docs) or min(sizes.values()) <= 0:
        raise AssertionError(f"empty or short store: {sizes}")
    if rag.graph is None or rag.graph.n_arcs <= 0:
        raise AssertionError("the graph has no arcs")
    answers = [s.answer for s in solutions]
    if len(answers) != len(queries) or not all(answers):
        raise AssertionError(f"{sum(bool(a) for a in answers)}/{len(queries)} answers came back")
    vecs = rag.ver_store.matrix
    if vecs.shape != (len(docs), 768) or not np.isfinite(vecs).all():
        raise AssertionError(f"chunk embeddings: shape {vecs.shape}, finite {np.isfinite(vecs).all()}")
    if not np.allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-3):
        raise AssertionError("chunk embeddings are not L2-normalized")
    spans = {k: v["total_s"] for k, v in trace.summary()["spans"].items()
             if k.startswith(("index.", "graph.", "qa.", "retrieve."))}
    total_two_pass = two_pass_counters()
    return {"index_s": index_s, "qa_s": qa_s, "questions_per_s": len(queries) / qa_s,
            "stores": sizes, "graph_arcs": int(rag.graph.n_arcs), "launches": launches, "spans_s": spans,
            "two_pass": {"index": index_two_pass,
                         "qa": {k: v - index_two_pass.get(k, 0) for k, v in total_two_pass.items()}}}


def two_pass_counters() -> dict:
    """The certified two-pass counters since the last ``trace.reset()``."""
    return {k: v for k, v in trace.summary()["counters"].items() if k.startswith("two_pass.")}


def phase_slice(device, n_chunks: int, n_questions: int, workdir: str) -> dict:
    docs, queries = make_corpus(n_chunks, n_questions)
    rag = ComoRAG(slice_config(workdir), encoder=bert_base_encoder(device), device=device)
    out = run_slice(rag, docs, queries, (attention.LAUNCHES, ffn.LAUNCHES))
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: {out['launches']}")
    print(f"phase 5 slice ({n_chunks} chunks, {n_questions} questions): index wall {out['index_s']:.3f} s, "
          f"QA {out['qa_s']:.3f} s = {out['questions_per_s']:.3f} questions/s; stores {out['stores']}; "
          f"graph arcs {out['graph_arcs']}; kernel launches {out['launches']}; "
          f"two_pass counters {json.dumps(out['two_pass'])}; spans_s {json.dumps(out['spans_s'])}", flush=True)
    return out


# ------------------------------------------------------------------ phase 6
def bench_data(n_queries: int):
    """bench.py:53-59's generator (seed 0, normalized rows), then queries."""
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((BENCH_N, BENCH_DIM)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.standard_normal((n_queries, BENCH_DIM)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return corpus, queries


def phase_topk_kernels(device, corpus: np.ndarray, queries: np.ndarray) -> dict:
    """Both top-k kernels vs their plain versions at P = 16 and 256."""
    c32 = torch.tensor(corpus, device=device)
    cq, sc = (torch.tensor(a, device=device) for a in quantize_int8(corpus))
    out = {"mips_topk": {}, "mips_topk_int8": {}}
    for p in (16, 256):
        q = torch.tensor(queries[:p], device=device)
        runs = {
            "mips_topk": (lambda: mips.mips_topk(q, c32, BENCH_K), lambda: mips.mips_topk_plain(q, c32, BENCH_K),
                          lambda: dense_scores(q, c32)),
            "mips_topk_int8": (lambda: mips.mips_topk_int8(q, cq, sc, BENCH_K),
                               lambda: mips.mips_topk_int8_plain(q, cq, sc, BENCH_K),
                               lambda: int8_scores(q, cq, sc)),
        }
        for name, (kernel, plain, scores) in runs.items():
            s, i = kernel()
            torch.cuda.synchronize()
            err = mips.check_topk(s, i, scores(), f"{name} P={p}")
            row_bytes = BENCH_DIM * (4 if name == "mips_topk" else 1) + (0 if name == "mips_topk" else 4)
            out[name][p] = {"max_abs_err": err, "ms": median_ms(kernel), "plain_ms": median_ms(plain),
                            # no single PyTorch call ranks a fused top-k over the corpus
                            "library_ms": None,
                            # rows (and scales) read once, queries read, (score, id) lists written;
                            # P*N*d multiply-adds: fp32 x fp32 for the fp32 rows, bf16 queries x
                            # int8 rows (exact in bf16, fp32 sums; pallas_topk.py:187-190) for int8
                            **bound(BENCH_N * row_bytes + p * BENCH_DIM * 4 + p * BENCH_K * 12,
                                    2 * p * BENCH_N * BENCH_DIM, "fp32" if name == "mips_topk" else "bf16")}
    del c32, cq, sc
    print("phase 6 top-k kernels vs plain (N=100000, d=1024, k=50; scores 1e-5 + 1e-5*|plain|, ids "
          "equal where separated by > 1e-5): " + "; ".join(
              f"{name} P={p} max_abs_err={r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              for name, by_p in out.items() for p, r in by_p.items()), flush=True)
    return out


# ------------------------------------------------------------------ phase 7
def oracle_ids(corpus: np.ndarray, queries: np.ndarray, k: int) -> np.ndarray:
    """Exact top-k ids in float64 (numpy), in query chunks."""
    c64 = corpus.astype(np.float64)
    out = np.empty((len(queries), k), np.int64)
    for lo in range(0, len(queries), 200):
        s = queries[lo : lo + 200].astype(np.float64) @ c64.T
        part = np.argpartition(-s, k, axis=1)[:, :k]
        order = np.argsort(-np.take_along_axis(s, part, axis=1), axis=1, kind="stable")
        out[lo : lo + 200] = np.take_along_axis(part, order, axis=1)
    return out


def overlap(ids: np.ndarray, ref: np.ndarray) -> float:
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / ref.shape[1] for a, b in zip(ids, ref)]))


def phase_serving(device, corpus: np.ndarray, serve_queries: np.ndarray) -> dict:
    """Retrieval serving through MipsIndex.topk_many at bench shape."""
    configs = {
        "fp32": dict(scan_dtype=None),
        "two_pass_int8": dict(),  # the default: scan_dtype="auto"
        "two_pass_bf16": dict(scan_dtype="bfloat16"),
        "bf16": dict(dtype="bfloat16"),
        "int8": dict(dtype="int8"),
        "pallas_fp32": dict(method="pallas"),
        "pallas_int8": dict(method="pallas", dtype="int8"),
    }
    t0 = time.perf_counter()
    indexes = {name: MipsIndex(corpus, device=device, **kw) for name, kw in configs.items()}
    build_s = time.perf_counter() - t0
    routes = {name: (ix.method, ix.scan_dtype) for name, ix in indexes.items()}
    if routes["two_pass_int8"] != ("xla", "int8") or routes["pallas_int8"] != ("pallas", None):
        raise AssertionError(f"unexpected routes: {routes}")
    host = [serve_queries[i * SERVE_P : (i + 1) * SERVE_P].copy() for i in range(SERVE_BATCHES)]
    dev = [torch.tensor(q, device=device) for q in host]
    variants = {name: (ix, host) for name, ix in indexes.items()}
    variants["two_pass_int8_device"] = (indexes["two_pass_int8"], dev)

    def rescued() -> int:
        return int(trace.summary()["counters"].get("two_pass.rescued_batches", 0))

    ids, best, n_rescued = {}, {name: 0.0 for name in variants}, {name: 0 for name in variants}
    for name, (ix, batches) in variants.items():  # warm-up and the results that are checked
        ids[name] = np.concatenate([i for _, i in ix.topk_many(batches, k=BENCH_K)])
    launches = {}
    for _ in range(SERVE_ROUNDS):
        for name, (ix, batches) in variants.items():
            r0 = rescued()
            for counter in (mips.LAUNCHES, mips.INT8_LAUNCHES):
                counter.reset()
            torch.cuda.synchronize()
            start = time.perf_counter()
            ix.topk_many(batches, k=BENCH_K)
            torch.cuda.synchronize()
            best[name] = max(best[name], SERVE_BATCHES * SERVE_P / (time.perf_counter() - start))
            n_rescued[name] += rescued() - r0
            launches[name] = {c.name: c.value for c in (mips.LAUNCHES, mips.INT8_LAUNCHES)}
    if launches["pallas_fp32"]["mips_topk"] <= 0 or launches["pallas_int8"]["mips_topk_int8"] <= 0:
        raise AssertionError(f"a kernel route did not launch its kernel: {launches}")
    ref = oracle_ids(corpus, serve_queries, BENCH_K)
    overlaps = {name: overlap(i, ref) for name, i in ids.items()}
    exact = ("fp32", "two_pass_int8", "two_pass_int8_device", "two_pass_bf16", "pallas_fp32")
    if min(overlaps[name] for name in exact) < 1.0:
        raise AssertionError(f"an exact variant missed the float64 oracle: {overlaps}")
    if not np.array_equal(ids["two_pass_int8_device"], ids["two_pass_int8"]):
        raise AssertionError("device-resident batches gave other ids than host batches")
    # each kernel route against its plain route (the tie-tolerant rule)
    q0 = torch.tensor(host[0], device=device)
    for kernel_name, plain_name, scores in (
            ("pallas_fp32", "fp32", lambda ix: dense_scores(q0, ix.corpus)),
            ("pallas_int8", "int8", lambda ix: int8_scores(q0, ix.corpus, ix.scales))):
        s, i = indexes[kernel_name].topk(host[0], BENCH_K)
        mips.check_topk(torch.tensor(s, device=device), torch.tensor(i, device=device),
                        scores(indexes[plain_name]), f"{kernel_name} vs {plain_name}")
    out = {"qps": {k: round(v, 1) for k, v in best.items()}, "rescued_batches": n_rescued,
           "overlap_vs_float64": overlaps, "routes": {k: list(v) for k, v in routes.items()},
           "index_build_s": round(build_s, 3),
           "kernel_launches_per_round": {k: v for k, v in launches.items() if k.startswith("pallas")}}
    del indexes, variants, dev
    torch.cuda.empty_cache()
    print("phase 7 serving 100000x1024, 100 batches x 16 queries, k=50, best of 4 rounds: "
          + json.dumps(out), flush=True)
    return out


# ------------------------------------------------------------------ phase 8
@contextlib.contextmanager
def recorded_topk_calls():
    """Keeps the arguments of every top-k kernel call made inside the block
    (the wrappers run unchanged), so that the kernels can be held against
    their plain versions afterwards at exactly the main path's inputs."""
    calls = []
    fp32, int8 = mips.mips_topk, mips.mips_topk_int8

    def fp32_recorded(q, corpus, k):
        calls.append((mips.LAUNCHES.name, q.clone(), (corpus,), k))
        return fp32(q, corpus, k)

    def int8_recorded(q, corpus_q, scales, k):
        calls.append((mips.INT8_LAUNCHES.name, q.clone(), (corpus_q, scales), k))
        return int8(q, corpus_q, scales, k)

    mips.mips_topk, mips.mips_topk_int8 = fp32_recorded, int8_recorded
    try:
        yield calls
    finally:
        mips.mips_topk, mips.mips_topk_int8 = fp32, int8


def check_recorded_calls(calls, tag: str) -> list:
    """Each recorded kernel call again, held against the plain score matrix
    with the tie-tolerant rule (ops/mips.check_topk), with both timed."""
    out = []
    for name, q, rows, k in calls:
        if name == mips.LAUNCHES.name:
            kernel, plain, scores = mips.mips_topk, mips.mips_topk_plain, dense_scores
        else:
            kernel, plain, scores = mips.mips_topk_int8, mips.mips_topk_int8_plain, int8_scores
        s, i = kernel(q, *rows, k)
        torch.cuda.synchronize()
        (p, d), n = q.shape, rows[0].shape[0]
        out.append({"name": name, "P": p, "N": n, "d": d, "k": k,
                    "max_abs_err": mips.check_topk(s, i, scores(q, *rows), f"{name} {tag} P={p} N={n} k={k}"),
                    "ms": median_ms(lambda: kernel(q, *rows, k)), "plain_ms": median_ms(lambda: plain(q, *rows, k))})
    return out


def synonymy_replay(rag: ComoRAG, device) -> dict:
    """The graph build's synonymy sweep (graph/builder.py add_synonymy_edges:
    every entity against the entity matrix, query batches of 1,000) again,
    through the default route ("auto": the int8 two-pass at >= 1,024 rows)
    and through fp32 single-pass: index build and sweep seconds (best of 2,
    interleaved), two_pass.* counter deltas; both are exact, so the scores
    must agree rank by rank to 1e-5."""
    cfg = rag.config
    embs = rag.entity_store.matrix
    texts = rag.entity_store.get_all_texts()
    k = min(cfg.synonymy_edge_topk, len(embs), 100 + 2 + sum(1 for t in texts if not t))
    step = cfg.synonymy_edge_query_batch_size
    batches = [embs[i : i + step] for i in range(0, len(embs), step)]
    best, scores, counts, routes = {}, {}, {}, {}
    for name in ("auto", "fp32", "fp32", "auto"):
        before = two_pass_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = MipsIndex(embs, device=device, **({} if name == "auto" else {"scan_dtype": None}))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs = index.topk_many(batches, k=k)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        scores[name] = np.concatenate([s for s, _ in outs])
        routes[name] = [index.method, index.scan_dtype]
        after = two_pass_counters()
        counts[name] = {c: v - before.get(c, 0) for c, v in after.items() if v != before.get(c, 0)}
        prev = best.get(name, (float("inf"), float("inf")))
        best[name] = (min(prev[0], t1 - t0), min(prev[1], t2 - t1))
    if not np.allclose(scores["auto"], scores["fp32"], atol=1e-5, rtol=0):
        raise AssertionError("synonymy sweep: the two-pass and fp32 scores differ beyond 1e-5")
    return {"entities": len(embs), "k": k, "routes": routes,
            "build_s": {n: round(b[0], 4) for n, b in best.items()},
            "sweep_s": {n: round(b[1], 4) for n, b in best.items()}, "two_pass_counters_per_sweep": counts}


def phase_meta_loop(device, workdir: str) -> dict:
    """The meta loop with the episodic (and any >= 512-row) layer on the
    top-k kernels: fp32 rows, then int8 rows over the same stores. Every
    top-k kernel call of each run is then held against its plain version
    at the run's own inputs."""
    docs, queries = make_corpus(N_META_CHUNKS, N_QUESTIONS, seed=11)
    encoder = bert_base_encoder(device)
    counters = (attention.LAUNCHES, ffn.LAUNCHES, mips.LAUNCHES, mips.INT8_LAUNCHES)
    runs = {}
    for tag, retrieval in (("fp32", dict(topk_method="pallas")),
                           ("int8", dict(topk_method="pallas", embedding_dtype="int8"))):
        rag = ComoRAG(slice_config(workdir, **retrieval), encoder=encoder, device=device)
        with recorded_topk_calls() as calls:
            runs[tag] = run_slice(rag, docs, queries, counters)
        runs[tag]["kernel_checks"] = check_recorded_calls(calls, f"meta loop {tag}")
        if tag == "fp32":
            runs[tag]["synonymy_replay"] = synonymy_replay(rag, device)
        engine = rag.engine
        if (engine.epi_index is None or engine.epi_index.n < index_mod.PALLAS_MIN_ROWS
                or engine.epi_index.method != "pallas"):
            raise AssertionError(f"the episodic layer is not on the kernel route: "
                                 f"{None if engine.epi_index is None else (engine.epi_index.n, engine.epi_index.method)}")
        runs[tag]["kernel_route_layers"] = {
            name: ix.n for name, ix in (("semantic", engine.sem_index), ("episodic", engine.epi_index))
            if ix is not None and ix.method == "pallas"}
    if runs["fp32"]["launches"][mips.LAUNCHES.name] <= 0:
        raise AssertionError(f"the fp32 run did not launch mips_topk: {runs['fp32']['launches']}")
    if runs["int8"]["launches"][mips.INT8_LAUNCHES.name] <= 0:
        raise AssertionError(f"the int8 run did not launch mips_topk_int8: {runs['int8']['launches']}")
    for tag, r in runs.items():
        for counter in (mips.LAUNCHES, mips.INT8_LAUNCHES):
            checked = sum(c["name"] == counter.name for c in r["kernel_checks"])
            if checked != r["launches"][counter.name]:
                raise AssertionError(f"{tag}: {checked} of {r['launches'][counter.name]} {counter.name} "
                                     f"launches were checked against plain")
        print(f"phase 8 meta loop on the top-k kernels, {tag} rows ({N_META_CHUNKS} chunks, {N_QUESTIONS} "
              f"questions): index wall {r['index_s']:.3f} s, QA {r['qa_s']:.3f} s = "
              f"{r['questions_per_s']:.3f} questions/s; stores {r['stores']}; kernel-route layers "
              f"{r['kernel_route_layers']}; kernel launches {r['launches']}; "
              f"kernel vs plain at the run's own inputs {json.dumps(r['kernel_checks'])}; "
              f"two_pass counters {json.dumps(r['two_pass'])}; spans_s {json.dumps(r['spans_s'])}", flush=True)
    print(f"phase 8 synonymy sweep replay (fp32 run's entity store): {json.dumps(runs['fp32']['synonymy_replay'])}",
          flush=True)
    return runs


# ------------------------------------------------------------------ phase 9
def llama_8b(layers: int = 32) -> decoder.DecoderArch:
    """Llama-3.1-8B-Instruct's published config.json shapes."""
    return decoder.DecoderArch(vocab_size=128256, hidden_size=4096, num_layers=layers, num_heads=32,
                               num_kv_heads=8, intermediate_size=14336, max_seq_len=131072,
                               rope_theta=500000.0, rms_norm_eps=1e-5,
                               rope_scaling=("llama3", 8.0, 1.0, 4.0, 8192.0))


def cycling(fn, n: int):
    """A call that walks ``fn(0), fn(1), ...`` round-robin over n layers'
    weights, so a timing does not run out of the 50 MB L2."""
    state = [0]

    def call():
        i = state[0] % n
        state[0] += 1
        return fn(i)

    return call


def int4_bound(m: int, k: int, n: int, gs: int = 128) -> dict:
    # x read in bf16, packed weights and fp32 scales read once, fp32 out written
    return bound(m * k * 2 + k // 2 * n + k // gs * n * 4 + m * n * 4, 2 * m * k * n, "bf16")


def tail_bound(m: int, h: int, i: int, gs: int = 128) -> dict:
    weights = sum(k // 2 * n + k // gs * n * 4 for k, n in ((h, h), (h, 2 * i), (i, h)))
    return bound(m * h * (2 + 4 + 4) + h * 4 + weights, 2 * m * (h * h + h * 2 * i + i * h), "bf16")


def phase_int4_kernels(device) -> dict:
    """Both int4 kernels against their plain versions at Llama-3.1-8B's
    shapes (random packed weights, scales giving weights of std ~0.02):
    int4_matmul at decode (M = 8: qkv, lm_head) and prefill (M = 4096: qkv,
    o, gate/up, down), the fused tail at M = 8 and 64. Kernel times cycle
    through 32 layers' weights."""
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    arch = llama_8b()
    h, inter, layers = arch.hidden_size, arch.intermediate_size, arch.num_layers
    qkv_out = (arch.num_heads + 2 * arch.num_kv_heads) * arch.head_dim

    def weights(k, n, count):
        packed = torch.randint(-128, 128, (count, k // 2, n), generator=gen, device=device, dtype=torch.int8)
        scales = torch.empty(count, k // 128, n, device=device).uniform_(0.003, 0.006, generator=gen)
        return packed, scales

    w = {"qkv": weights(h, qkv_out, layers), "o": weights(h, h, layers),
         "gate_up": weights(h, 2 * inter, layers), "down": weights(inter, h, layers),
         "lm_head": weights(h, arch.vocab_size, 1)}
    mm = []
    for m, name in ((8, "qkv"), (8, "lm_head"), (4096, "qkv"), (4096, "o"), (4096, "gate_up"), (4096, "down")):
        packed, scales = w[name]
        k, n = packed.shape[1] * 2, packed.shape[2]
        x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
        got = int4.int4_matmul(x, packed[0], scales[0])
        ref = int4.int4_matmul_plain(x, packed[0], scales[0])
        torch.cuda.synchronize()
        r = {"M": m, "weight": name, "K": k, "N": n,
             "max_abs_err": compare(got, ref, f"int4_matmul M={m} {name}"),
             "ms": median_ms(cycling(lambda i: int4.int4_matmul(x, packed[i], scales[i]), packed.shape[0])),
             "plain_ms": median_ms(lambda: int4.int4_matmul_plain(x, packed[0], scales[0]), runs=3, reps=1, warmup=1),
             "library_ms": None, **int4_bound(m, k, n)}
        r["roofline_share"] = r["bound_ms"] / r["ms"]
        mm.append(r)
        del got, ref, x
    tail = []
    for m in (8, 64):
        ctx = torch.randn(m, h, generator=gen, device=device).to(torch.bfloat16)
        xres = torch.randn(m, h, generator=gen, device=device)
        nw = 1.0 + 0.1 * torch.randn(h, generator=gen, device=device)

        def args(i):
            return (ctx, xres, nw, w["o"][0][i], w["o"][1][i], w["gate_up"][0][i], w["gate_up"][1][i],
                    w["down"][0][i], w["down"][1][i])

        got = int4.int4_fused_layer_tail(*args(0), eps=1e-5)
        ref = int4.int4_fused_layer_tail_plain(*args(0), eps=1e-5)
        torch.cuda.synchronize()
        r = {"M": m, "H": h, "I": inter,
             "max_abs_err": compare(got, ref, f"int4_fused_layer_tail M={m}"), "rule_ratio": rule_ratio(got, ref),
             "ms": median_ms(cycling(lambda i: int4.int4_fused_layer_tail(*args(i), eps=1e-5), layers)),
             "plain_ms": median_ms(lambda: int4.int4_fused_layer_tail_plain(*args(0), eps=1e-5), runs=3, reps=1,
                                   warmup=1),
             "library_ms": None, **tail_bound(m, h, inter)}
        r["roofline_share"] = r["bound_ms"] / r["ms"]
        tail.append(r)
    del w
    torch.cuda.empty_cache()
    for r in mm + tail:
        what = (f"int4_matmul M={r['M']} {r['weight']} {r['K']}->{r['N']}" if "weight" in r
                else f"int4_fused_layer_tail M={r['M']} H={r['H']} I={r['I']}")
        ratio = f" (worst ratio to the rule {r['rule_ratio']:.3f})" if "rule_ratio" in r else ""
        print(f"phase 9 {what}: max_abs_err={r['max_abs_err']:.4g}{ratio} kernel {r['ms']:.4f} ms plain "
              f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms ({r['bound_by']}) roofline share "
              f"{r['roofline_share']:.3f}", flush=True)
    return {"int4_matmul": mm, "int4_fused_layer_tail": tail}


# ----------------------------------------------------------------- phase 10
SERVER_TOPICS = ["lighthouse", "granary", "archive", "harbor", "orchard", "forge", "quarry", "mill"]


def server_prompts(n: int = 8, size: int = 440) -> list:
    """n distinct user messages of ``size`` bytes (with the chat framing
    and BOS about 470 tokens: the 512-token prompt bucket)."""
    rng = np.random.default_rng(SEED + 10)
    out = []
    for i in range(n):
        words = [f"Request {i} about the {SERVER_TOPICS[i % len(SERVER_TOPICS)]}:"]
        while len(" ".join(words)) < size:
            words.append(f"{NAMES[rng.integers(len(NAMES))]} {SURNAMES[rng.integers(len(SURNAMES))]} visited the "
                         f"{PLACES[rng.integers(len(PLACES))]} on day {int(rng.integers(1, 365))}.")
        out.append([{"role": "user", "content": " ".join(words)[:size]}])
    return out


@contextlib.contextmanager
def error_responses():
    """Records every response the generation server hands out with
    ``finish_reason: "error"`` (the server and the engine turn exceptions
    into such responses, one per request): a phase fails on any of them, so
    a kernel fault cannot hide behind the per-request isolation."""
    errors = []
    resolve = serving._resolve

    def recording(fut, result):
        if result.metadata.get("finish_reason") == "error" or "error" in result.metadata:
            errors.append(result.metadata.get("error"))
        return resolve(fut, result)

    serving._resolve = recording
    try:
        yield errors
    finally:
        serving._resolve = resolve


@contextlib.contextmanager
def timed_generation():
    """Times every decoder.generate call and its prefill (synchronized), and
    keeps each call's input ids, last-prompt logits and tokens."""
    rec = {"prefill_s": 0.0, "generate_s": 0.0, "logits": [], "tokens": []}
    generate, prefill = decoder.generate, decoder._prefill_batch

    def timed_prefill(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(*a, **kw)
        torch.cuda.synchronize()
        rec["prefill_s"] += time.perf_counter() - t0
        rec["logits"].append((a[1].cpu(), out[0].float().cpu()))
        return out

    def timed_generate(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(*a, **kw)
        torch.cuda.synchronize()
        rec["generate_s"] += time.perf_counter() - t0
        rec["tokens"].append((a[1].cpu(), out.tokens.cpu(), out.lengths.cpu()))
        return out

    decoder.generate, decoder._prefill_batch = timed_generate, timed_prefill
    try:
        yield rec
    finally:
        decoder.generate, decoder._prefill_batch = generate, prefill


@contextlib.contextmanager
def plain_int4():
    """The int4 engine's plain path on the card: the decoder's int4 products
    and fused tails go to the plain PyTorch versions for the block."""
    mm, tail = int4.int4_matmul, int4.int4_fused_layer_tail
    int4.int4_matmul, int4.int4_fused_layer_tail = int4.int4_matmul_plain, int4.int4_fused_layer_tail_plain
    try:
        yield
    finally:
        int4.int4_matmul, int4.int4_fused_layer_tail = mm, tail


def serve_concurrently(engine, prompts, max_tokens: int) -> list:
    """A GenerationServer over ``engine`` answering one request per thread,
    all submitted at once (the window holds until all have arrived)."""
    server = serving.GenerationServer(engine, window_ms=5000.0, max_batch=len(prompts))
    results = [None] * len(prompts)

    def ask(i):
        results[i] = server.infer(prompts[i], max_tokens=max_tokens)

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    server.close()
    return results


def serve_route(engine, prompts, max_tokens: int, route: str) -> dict:
    trace.reset()
    for counter in (int4.LAUNCHES, int4.TAIL_LAUNCHES):
        counter.reset()
    with error_responses() as errors, timed_generation() as rec, \
            (plain_int4() if route == "int4_plain" else contextlib.nullcontext()):
        t0 = time.perf_counter()
        responses = serve_concurrently(engine, prompts, max_tokens)
        wall = time.perf_counter() - t0
    launches = {c.name: c.value for c in (int4.LAUNCHES, int4.TAIL_LAUNCHES)}
    if errors or len(responses) != len(prompts) or any(r is None for r in responses):
        raise AssertionError(f"{route}: {len(errors)} error responses ({errors[:2]}) of {len(prompts)} requests")
    recorded = {name: len(by_row(rec[name])) for name in ("logits", "tokens")}
    if min(recorded.values()) < len(prompts):  # the patched decoder names were not reached
        raise AssertionError(f"{route}: the recorded generation calls hold {recorded} distinct rows "
                             f"for {len(prompts)} prompts")
    completions = [r.metadata["completion_tokens"] for r in responses]
    if min(completions) <= 0:
        raise AssertionError(f"{route}: a response without completion tokens: {completions}")
    counters = {k: v for k, v in trace.summary()["counters"].items() if k.startswith("llm.")}
    decode_s = rec["generate_s"] - rec["prefill_s"]
    return {"wall_s": wall, "prefill_s": rec["prefill_s"], "decode_s": decode_s,
            "prefill_tok_s": counters["llm.prompt_tokens"] / rec["prefill_s"],
            "decode_tok_s": counters["llm.completion_tokens"] / decode_s,
            "completion_tokens": completions, "launches": launches, "llm_counters": counters,
            "logits": rec["logits"], "tokens": rec["tokens"]}


def by_row(records) -> dict:
    """{input-id row: tensor row} over the recorded calls of one route."""
    out = {}
    for call in records:
        ids, rest = call[0], call[1:]
        for i in range(ids.shape[0]):
            out[tuple(ids[i].tolist())] = tuple(t[i] for t in rest)
    return out


def logits_ratio(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst |got - ref| over the bf16 rule scaled to max |logit|:
    2e-2 * max|ref| + 2e-2 * |ref| (above 1 fails)."""
    return float(((got - ref).abs() / (BF16_TOL * ref.abs().max() + BF16_TOL * ref.abs())).max())


def checked_logits(got: torch.Tensor, ref: torch.Tensor, what: str) -> dict:
    """Kernel-route logits against plain-route logits under the bf16 rule
    scaled to max |logit|; fails above it or on a non-finite value."""
    out = {"max_abs_err": float((got - ref).abs().max()), "worst_ratio": logits_ratio(got, ref),
           "top1_equal": float((got.argmax(-1) == ref.argmax(-1)).float().mean())}
    if not torch.isfinite(got).all() or out["worst_ratio"] > 1.0:
        raise AssertionError(f"{what}, kernels vs plain: {out} (rule 2e-2 * max|logit| + 2e-2 * |logit|)")
    return out


def route_logits(engine, prompts, compute_dtype) -> dict:
    """The requests' last-prompt logits (prefill of 8 x ~470 rows: int4_matmul
    only) and the next decode step's logits (M = 8: the fused tail in every
    layer) through the kernels and through the plain versions, each route
    on its own KV cache and both fed the plain route's greedy token; both
    held under the bf16 rule scaled to max |logit|. In fp32 compute the two
    routes differ only by the kernels' summation order and the roundings
    inside the fused tail, so the rule holds at full depth; in bf16 compute
    every product's output is rounded too."""
    pad, _ = engine._special_ids()
    rows = [engine._ids(*engine._render(m)) for m in prompts]
    p = max(len(r) for r in rows)
    ids = torch.full((len(rows), p), pad, dtype=torch.int64)
    mask = torch.zeros((len(rows), p), dtype=torch.int64)
    for i, r in enumerate(rows):
        ids[i, p - len(r):], mask[i, p - len(r):] = torch.tensor(r), 1
    ids, mask = ids.to(engine.device), mask.to(engine.device)

    def run(tok=None):
        with torch.no_grad():
            last, cache, slot_valid, row_len = decoder._prefill_batch(
                engine.params, ids, mask, engine.arch, p + 1, None, compute_dtype, engine.kv_dtype)
            tok = last.argmax(-1) if tok is None else tok
            slot_valid[:, p] = True  # generate's first decode step: slot p, position row_len
            step, _ = decoder.decoder_forward(engine.params, tok[:, None], row_len[:, None], slot_valid[:, None, :],
                                              cache, p, engine.arch, compute_dtype)
        return last, step[:, 0], tok

    with plain_int4():
        ref_last, ref_step, tok = run()
    tails = int4.TAIL_LAUNCHES.value
    got_last, got_step, _ = run(tok)
    torch.cuda.synchronize()
    tails = int4.TAIL_LAUNCHES.value - tails
    if tails != engine.arch.num_layers:
        raise AssertionError(f"the decode step took {tails} fused tails for {engine.arch.num_layers} layers")
    name = str(compute_dtype).replace("torch.", "")
    return {"prefill": checked_logits(got_last, ref_last, f"last-prompt logits in {name} compute"),
            "decode_step": checked_logits(got_step, ref_step, f"decode-step logits in {name} compute")}


def served_comparison(kernel_run: dict, plain_run: dict) -> dict:
    """The served last-prompt logits of both routes (as recorded around
    decoder._prefill_batch) and the share of identical greedy tokens."""
    kernel_logits, plain_logits = by_row(kernel_run["logits"]), by_row(plain_run["logits"])
    out = {"max_abs_err": 0.0, "worst_ratio": 0.0, "rel_l2": 0.0}
    for key, (got,) in kernel_logits.items():
        (ref,) = plain_logits[key]
        out["max_abs_err"] = max(out["max_abs_err"], float((got - ref).abs().max()))
        out["worst_ratio"] = max(out["worst_ratio"], logits_ratio(got, ref))
        out["rel_l2"] = max(out["rel_l2"], float((got - ref).norm() / ref.norm()))
    kernel_tokens, plain_tokens = by_row(kernel_run["tokens"]), by_row(plain_run["tokens"])
    same = total = 0
    for key, (tok, n) in kernel_tokens.items():
        ptok, pn = plain_tokens[key]
        m = int(min(n, pn))
        same += int((tok[:m] == ptok[:m]).sum())
        total += int(max(n, pn))
    out["greedy_token_share"] = same / max(total, 1)
    return out


def int4_engine(arch, seed: int, device) -> TorchOfflineLLM:
    """The int4 engine (bf16 compute) over seeded random weights made on the
    card in bf16; the bf16 copy is dropped once quantized."""
    params = decoder.init_params(arch, torch.Generator(device=device).manual_seed(seed), device, torch.bfloat16)
    return TorchOfflineLLM(params=params, arch=arch, param_dtype="int4", compute_dtype=torch.bfloat16,
                           device=device)


def logit_witnesses(device, prompts, max_tokens: int) -> dict:
    """Why the served comparison at full depth is only reported: at 2 and 4
    layers, where a flipped bf16 rounding has little depth to grow through,
    the served last-prompt logits of both routes and a bf16 decode step are
    held under the rule; at 32 layers the fp32-compute check runs on two
    more weight seeds."""
    out = {"fp32_32_layers": {}, "bf16_shallow": {}}
    for seed in (SEED + 20, SEED + 21):
        engine = int4_engine(llama_8b(), seed, device)
        out["fp32_32_layers"][f"seed {seed}"] = route_logits(engine, prompts, torch.float32)
        del engine
        torch.cuda.empty_cache()
    for depth in (2, 4):
        engine = int4_engine(llama_8b(depth), SEED + 10, device)
        served = served_comparison(serve_route(engine, prompts, max_tokens, "int4_kernels"),
                                   serve_route(engine, prompts, max_tokens, "int4_plain"))
        if served["worst_ratio"] > 1.0:
            raise AssertionError(f"served last-prompt logits at {depth} layers, kernels vs plain in bf16 compute: "
                                 f"{served} (rule 2e-2 * max|logit| + 2e-2 * |logit|)")
        out["bf16_shallow"][f"{depth} layers"] = {"served": served, **route_logits(engine, prompts, torch.bfloat16)}
        del engine
        torch.cuda.empty_cache()
    return out


def phase_server(device, layers: int = 32, max_tokens: int = 64) -> dict:
    """GenerationServer over the int4 engine at Llama-3.1-8B width: 8
    concurrent requests in the 512-token bucket, 64 new tokens each, on the
    kernels, then on the int4 plain path and on bf16 weights (torch.matmul);
    the kernel path's last-prompt logits and greedy tokens against the
    plain path's."""
    arch = llama_8b(layers)
    t0 = time.perf_counter()
    params = decoder.init_params(arch, torch.Generator(device=device).manual_seed(SEED + 10), device,
                                 torch.bfloat16)
    engine = TorchOfflineLLM(params=params, arch=arch, param_dtype="int4", compute_dtype=torch.bfloat16,
                             device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompts = server_prompts()
    runs = {"int4_kernels": serve_route(engine, prompts, max_tokens, "int4_kernels")}
    launches = runs["int4_kernels"]["launches"]
    if min(launches.values()) <= 0:
        raise AssertionError(f"an int4 kernel was not launched in the server run: {launches}")
    runs["int4_plain"] = serve_route(engine, prompts, max_tokens, "int4_plain")
    checked = route_logits(engine, prompts, torch.float32)
    del engine
    torch.cuda.empty_cache()
    bf16_engine = TorchOfflineLLM(params=params, arch=arch, param_dtype=torch.bfloat16,
                                  compute_dtype=torch.bfloat16, device=device)
    runs["bf16_matmul"] = serve_route(bf16_engine, prompts, max_tokens, "bf16_matmul")
    del bf16_engine, params
    torch.cuda.empty_cache()

    # the served (bf16-compute) logits at full depth are reported; the
    # witnesses below hold them where depth cannot compound a rounding flip
    served = served_comparison(runs["int4_kernels"], runs["int4_plain"])
    out = {"layers": layers, "build_s": build_s, "served_logits_bf16": served, "logits_fp32": checked,
           "witnesses": logit_witnesses(device, prompts, max_tokens), "launches": launches,
           "runs": {k: {f: v for f, v in r.items() if f not in ("logits", "tokens")} for k, r in runs.items()}}
    for name, r in out["runs"].items():
        print(f"phase 10 server {name} (Llama-3.1-8B width, {layers} layers, 8 requests x {max_tokens} tokens, "
              f"512-token bucket): prefill {r['prefill_tok_s']:.1f} tok/s, decode {r['decode_tok_s']:.1f} tok/s, "
              f"wall {r['wall_s']:.3f} s; kernel launches {r['launches']}; {json.dumps(r['llm_counters'])}",
              flush=True)
    print(f"phase 10 weights made and quantized in {build_s:.3f} s; kernels vs plain, logits of the 8 requests "
          f"at {layers} layers: fp32 compute, last prompt and first decode step (checked) {json.dumps(checked)}; "
          f"as served in bf16 compute (reported) {json.dumps(served)}", flush=True)
    print(f"phase 10 witnesses (fp32 compute at {layers} layers on two more weight seeds; served and decode-step "
          f"logits in bf16 compute at 2 and 4 layers, all checked): {json.dumps(out['witnesses'])}", flush=True)
    return out


# ----------------------------------------------------------------- phase 11
def phase_tiny(device, workdir: str) -> dict:
    """The jax-tiny route on the card: the CLI's meta loop over
    dataset/moonlantern (answers back, guided OpenIE fills the entity and
    fact stores), the tiny engine on int4 weights (int4_matmul launches; the
    fused tail's gate is false at H = 256), and speculative decoding giving
    plain greedy's texts."""
    out_dir, save_dir = os.path.join(workdir, "out"), os.path.join(workdir, "save")
    trace.reset()
    argv = sys.argv
    sys.argv = ["comorag_torch.cli.run", "--base_path", os.path.join(REPO, "dataset", "moonlantern"),
                "--llm_name", "jax-tiny", "--device", device.type, "--embedding_model_name", "hash",
                "--output_dir", out_dir, "--save_dir", save_dir]
    t0 = time.perf_counter()
    try:
        with error_responses() as errors:
            cli_run.main()
    finally:
        sys.argv = argv
    cli_s = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"jax-tiny CLI: {len(errors)} error responses: {errors[:2]}")
    with open(os.path.join(out_dir, "moonlantern_1", "results.json"), encoding="utf-8") as f:
        results = json.load(f)
    if not results or not all(r["output"] for r in results):
        raise AssertionError(f"jax-tiny CLI: {sum(bool(r['output']) for r in results)}/{len(results)} answers")
    llm_counters = {k: v for k, v in trace.summary()["counters"].items() if k.startswith("llm.")}
    config = ComoConfig(llm_name="jax-tiny", embedding_model_name="hash",
                        save_dir=os.path.join(save_dir, "moonlantern_1"), output_dir=out_dir)
    rag = ComoRAG(config, llm=FakeLLM(), device=device)  # reads the stores the CLI wrote
    stores = {name: len(getattr(rag, name)) for name in ("entity_store", "fact_store")}
    if min(stores.values()) <= 0:
        raise AssertionError(f"jax-tiny CLI: guided OpenIE left a store empty: {stores}")

    params, arch = curriculum.load_tiny_checkpoint(curriculum.default_checkpoint_path())
    rng = np.random.default_rng(SEED + 11)
    samples = [curriculum.make_sample(rng, task) for task in ("qa", "qa", "ner", "triples")]
    batches = [([s["prompt"] for s in samples[:2]], None), ([samples[2]["prompt"]], "ner"),
               ([samples[3]["prompt"]], "triples")]

    def texts(engine):
        return [r.text for prompts, tmpl in batches for r in engine._generate_batch(prompts, 256, tmpl, 0.0)]

    for counter in (int4.LAUNCHES, int4.TAIL_LAUNCHES):
        counter.reset()
    int4_texts = texts(TorchOfflineLLM(params=params, arch=arch, param_dtype="int4", max_new_tokens=384,
                                       device=device))
    int4_launches = {c.name: c.value for c in (int4.LAUNCHES, int4.TAIL_LAUNCHES)}
    if int4_launches[int4.LAUNCHES.name] <= 0 or int4_launches[int4.TAIL_LAUNCHES.name] != 0:
        raise AssertionError(f"tiny int4 engine: expected int4_matmul launches and no fused tail "
                             f"(H = {arch.hidden_size}): {int4_launches}")
    trace.reset()
    plain = texts(TorchOfflineLLM(params=params, arch=arch, max_new_tokens=384, device=device))
    plain_steps = trace.summary()["counters"]["llm.decode_steps"]
    trace.reset()
    spec = texts(TorchOfflineLLM(params=params, arch=arch, max_new_tokens=384, speculative=True, device=device))
    spec_steps = trace.summary()["counters"]["llm.decode_steps"]
    if spec != plain:
        raise AssertionError("speculative decoding gave other texts than plain greedy on the tiny checkpoint")
    out = {"cli_s": cli_s, "answers": len(results), "stores": stores, "cli_llm_counters": llm_counters,
           "int4_launches": int4_launches, "int4_same_texts_as_fp32": sum(a == b for a, b in zip(int4_texts, plain)),
           "texts": len(plain), "plain_decode_steps": plain_steps, "spec_decode_steps": spec_steps}
    print(f"phase 11 jax-tiny on the card: {json.dumps(out)}", flush=True)
    return out


def main() -> None:
    device = require_cuda()
    smi = nvidia_smi_line()
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    sources = ("encoder_attention", "encoder_ffn", "mips_topk", "int4")
    build.load_all(sources)
    print(f"phase 2 build: {len(sources)} kernel sources built in parallel and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    kernels = phase_kernels(device, 64, 512)  # bert-base at full length (phase 4's batch)
    small = phase_kernels(device, 32, 32)  # the slice's usual index batch (32 texts, 32 tokens)
    phase_encoder(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        slice_out = phase_slice(device, N_CHUNKS, N_QUESTIONS, workdir)
    corpus, queries = bench_data(256 + SERVE_BATCHES * SERVE_P)
    topk = phase_topk_kernels(device, corpus, queries[:256])
    phase_serving(device, corpus, queries[256:])
    del corpus, queries
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        meta = phase_meta_loop(device, workdir)
    int4_kernels = phase_int4_kernels(device)
    server = phase_server(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        phase_tiny(device, workdir)

    entries = []
    for mod in (attention, ffn):
        name = mod.LAUNCHES.name
        entries.append({"name": name, "route": "cuda", "source": mod.SOURCE, "replaces": mod.REPLACES,
                        "launches": slice_out["launches"][name], **kernels[name],
                        "max_abs_err": max(kernels[name]["max_abs_err"], small[name]["max_abs_err"]),
                        **{f"small_batch_{k}": small[name][k]
                           for k in ("ms", "plain_ms", "bound_ms", "products_library_ms", "host_us", "splits")
                           if k in small[name]}})
    for counter, replaces, run in ((mips.LAUNCHES, mips.REPLACES, "fp32"),
                                   (mips.INT8_LAUNCHES, mips.INT8_REPLACES, "int8")):
        name = counter.name
        main_path = [{k: v for k, v in c.items() if k != "name"}
                     for c in meta[run]["kernel_checks"] if c["name"] == name]
        entries.append({"name": name, "route": "cuda", "source": mips.SOURCE, "replaces": replaces,
                        "launches": meta[run]["launches"][name], **topk[name][16],
                        "max_abs_err": max([r["max_abs_err"] for r in topk[name].values()]
                                           + [c["max_abs_err"] for c in main_path]),
                        "p256_ms": topk[name][256]["ms"], "p256_plain_ms": topk[name][256]["plain_ms"],
                        "p256_bound_ms": topk[name][256]["bound_ms"], "main_path_calls": main_path})
    for counter, replaces, rows in ((int4.LAUNCHES, int4.REPLACES, int4_kernels["int4_matmul"]),
                                    (int4.TAIL_LAUNCHES, int4.TAIL_REPLACES, int4_kernels["int4_fused_layer_tail"])):
        head = rows[0]  # decode, M = 8: the serving loop's shape
        entries.append({"name": counter.name, "route": "cuda", "source": int4.SOURCE, "replaces": replaces,
                        "launches": server["launches"][counter.name],
                        "max_abs_err": max(r["max_abs_err"] for r in rows),
                        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                        "shapes": rows})

    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "comorag_tpu"))
    if foreign:
        raise AssertionError(f"the port loaded jax or the JAX package: {foreign[:5]}")

    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
