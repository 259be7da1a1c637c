"""Smoke run of comorag_torch's main paths on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, one line each (any failed check raises and the exit code is not 0):
  1. device: require CUDA; the card's name and power limit from nvidia-smi;
  2. build the three Hopper kernel sources from csrc/ with nvcc, in
     parallel, timed;
  3. the encoder kernels against their plain PyTorch versions at main-path
     shapes in bf16 (attention q/k/v [64, 512, 768] with 12 heads and a
     ragged mask; FFN [64*512, 768] -> 3072 -> 768; then both at the
     slice's usual index batch of 32 texts x 32 tokens), tolerance
     |d| <= 2e-2 + 2e-2*|plain| (the repo's bf16 tolerance,
     tests/test_tpu_compiled.py), and the median of 20 CUDA-event-timed
     samples of 10 calls each;
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
Then it checks that no jax module was loaded, and prints the kernels JSON
line, the nvidia-smi line, and the result line.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from comorag_torch import ComoConfig, trace
from comorag_torch.comorag import ComoRAG
from comorag_torch.models import bge
from comorag_torch.ops import attention, build, ffn, mips
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


def compare(got: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """Max |got - ref|; raises unless |d| <= 2e-2 + 2e-2 * |ref| everywhere."""
    g, r = got.float(), ref.float()
    if not (torch.isfinite(g).all() and torch.isfinite(r).all()):
        raise AssertionError(f"{what}: non-finite output")
    diff = (g - r).abs()
    worst = float((diff / (BF16_TOL + BF16_TOL * r.abs())).max())
    if worst > 1.0:
        raise AssertionError(f"{what}: |kernel - plain| exceeds 2e-2 + 2e-2*|plain| "
                             f"(max abs {float(diff.max()):.4g}, worst ratio {worst:.3f})")
    return float(diff.max())


def ragged_mask(b: int, s: int, gen: torch.Generator, device) -> torch.Tensor:
    lengths = torch.randint(1, s + 1, (b,), generator=gen)
    lengths[0] = s
    return (torch.arange(s)[None, :] < lengths[:, None]).to(torch.int32).to(device)


# ------------------------------------------------------------------ phase 3
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
    attn = {
        "max_abs_err": compare(got, ref, "encoder_attention"),
        "ms": median_ms(lambda: attention.encoder_attention(q, k, v, mask, heads)),
        "plain_ms": median_ms(lambda: attention.encoder_attention_plain(q, k, v, mask, heads)),
    }
    del got, ref, q, k, v

    xres = randn(b * s, h).to(torch.bfloat16)
    w1, w2 = randn(h, inter, scale=0.02).to(torch.bfloat16), randn(inter, h, scale=0.02).to(torch.bfloat16)
    b1, b2 = randn(inter, scale=0.02), randn(h, scale=0.02)
    s1, n1, s2, n2 = 1.0 + randn(h, scale=0.1), randn(h, scale=0.1), 1.0 + randn(h, scale=0.1), randn(h, scale=0.1)
    args = (xres, s1, n1, w1, b1, w2, b2, s2, n2)
    got = ffn.encoder_ffn(*args)
    ref = ffn.encoder_ffn_plain(*args)
    mlp = {
        "max_abs_err": compare(got, ref, "encoder_ffn"),
        "ms": median_ms(lambda: ffn.encoder_ffn(*args)),
        "plain_ms": median_ms(lambda: ffn.encoder_ffn_plain(*args)),
    }
    print(f"phase 3 kernels vs plain (bf16, tol 2e-2 + 2e-2*|plain|): "
          f"attention [{b},{s},{h}]x{heads} heads max_abs_err={attn['max_abs_err']:.4g} "
          f"kernel {attn['ms']:.4f} ms plain {attn['plain_ms']:.4f} ms | "
          f"ffn [{b * s},{h}]->{inter} max_abs_err={mlp['max_abs_err']:.4g} "
          f"kernel {mlp['ms']:.4f} ms plain {mlp['plain_ms']:.4f} ms", flush=True)
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
            out[name][p] = {"max_abs_err": err, "ms": median_ms(kernel), "plain_ms": median_ms(plain)}
    del c32, cq, sc
    print("phase 6 top-k kernels vs plain (N=100000, d=1024, k=50; scores 1e-5 + 1e-5*|plain|, ids "
          "equal where separated by > 1e-5): " + "; ".join(
              f"{name} P={p} max_abs_err={r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms"
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


def main() -> None:
    device = require_cuda()
    smi = nvidia_smi_line()
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    sources = ("encoder_attention", "encoder_ffn", "mips_topk")
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

    jax_modules = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    if jax_modules:
        raise AssertionError(f"the port loaded jax: {jax_modules[:5]}")

    entries = []
    for mod in (attention, ffn):
        name = mod.LAUNCHES.name
        entries.append({"name": name, "route": "cuda", "source": mod.SOURCE, "replaces": mod.REPLACES,
                        "launches": slice_out["launches"][name], **kernels[name],
                        "max_abs_err": max(kernels[name]["max_abs_err"], small[name]["max_abs_err"]),
                        "small_batch_ms": small[name]["ms"], "small_batch_plain_ms": small[name]["plain_ms"]})
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
                        "main_path_calls": main_path})
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
