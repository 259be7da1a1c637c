"""Smoke run of comorag_torch's main path on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, one line each (any failed check raises and the exit code is not 0):
  1. device: require CUDA; the card's name and power limit from nvidia-smi;
  2. build both Hopper kernels from csrc/ with nvcc, timed;
  3. each kernel against its plain PyTorch version at main-path shapes in
     bf16 (attention q/k/v [64, 512, 768] with 12 heads and a ragged mask;
     FFN [64*512, 768] -> 3072 -> 768; then both at the slice's usual index
     batch of 32 texts x 32 tokens), tolerance |d| <= 2e-2 + 2e-2*|plain|
     (the repo's bf16 tolerance, tests/test_tpu_compiled.py), and the median
     of 20 CUDA-event-timed samples of 10 calls each;
  4. the bert-base encoder (encode_pooled, B=64, S=512, seeded random
     weights) through the kernels vs the plain path: per-row cosine >= 0.999,
     texts/s of both;
  5. the slice: ComoRAG (fake LLM, bf16 bert-base encoder, default retrieval)
     indexes a seeded 2,000-chunk synthetic corpus and answers 16 questions;
     every store and the graph are non-empty, 16 answers come back, and both
     kernels' launch counts grew during this phase.
Then it checks that no jax module was loaded, and prints the kernels JSON
line, the nvidia-smi line, and the result line.
"""

from __future__ import annotations

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
from comorag_torch.ops import attention, build, ffn

BF16_TOL = 2e-2
SEED = 0
N_CHUNKS = 2000
N_QUESTIONS = 16


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


def phase_slice(device, n_chunks: int, n_questions: int, workdir: str) -> dict:
    config = ComoConfig(llm_name="fake", compute_dtype="bfloat16", need_cluster=True,
                        embedding_model_name="bge:bert-base-random",
                        save_dir=f"{workdir}/outputs", output_dir=f"{workdir}/results")
    model = bert_base("cpu")
    encoder = bge.BGETorchEncoder(params=model, tokenizer=bge.SimpleHashTokenizer(model.arch.vocab_size),
                                  max_seq_len=512, batch_size=config.embedding_batch_size,
                                  device=device, compute_dtype=torch.bfloat16)
    if encoder.attention != "kernel":
        raise AssertionError("the bf16 encoder on CUDA must route through the kernels")
    docs, queries = make_corpus(n_chunks, n_questions)
    rag = ComoRAG(config, encoder=encoder, device=device)
    trace.reset()
    for counter in (attention.LAUNCHES, ffn.LAUNCHES):
        counter.reset()
    t0 = time.perf_counter()
    rag.index(docs)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    solutions = rag.try_answer(queries)
    torch.cuda.synchronize()
    qa_s = time.perf_counter() - t1
    launches = {"encoder_attention": attention.LAUNCHES.value, "encoder_ffn": ffn.LAUNCHES.value}

    sizes = {name: len(getattr(rag, name)) for name in
             ("ver_store", "entity_store", "fact_store", "sem_store", "epi_store")}
    if sizes["ver_store"] != n_chunks or min(sizes.values()) <= 0:
        raise AssertionError(f"empty or short store: {sizes}")
    if rag.graph is None or rag.graph.n_arcs <= 0:
        raise AssertionError("the graph has no arcs")
    answers = [s.answer for s in solutions]
    if len(answers) != n_questions or not all(answers):
        raise AssertionError(f"{sum(bool(a) for a in answers)}/{n_questions} answers came back")
    vecs = rag.ver_store.matrix
    if vecs.shape != (n_chunks, 768) or not np.isfinite(vecs).all():
        raise AssertionError(f"chunk embeddings: shape {vecs.shape}, finite {np.isfinite(vecs).all()}")
    if not np.allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-3):
        raise AssertionError("chunk embeddings are not L2-normalized")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    spans = {k: v["total_s"] for k, v in trace.summary()["spans"].items()
             if k.startswith(("index.", "qa.", "retrieve."))}
    out = {"index_s": index_s, "qa_s": qa_s, "questions_per_s": n_questions / qa_s,
           "stores": sizes, "graph_arcs": int(rag.graph.n_arcs), "launches": launches}
    print(f"phase 5 slice ({n_chunks} chunks, {n_questions} questions): index wall {index_s:.3f} s, "
          f"QA {qa_s:.3f} s = {out['questions_per_s']:.3f} questions/s; stores {sizes}; "
          f"graph arcs {out['graph_arcs']}; kernel launches {launches}; spans_s {json.dumps(spans)}",
          flush=True)
    return out


def main() -> None:
    device = require_cuda()
    smi = nvidia_smi_line()
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    for name in ("encoder_attention", "encoder_ffn"):
        build.load(name)
    print(f"phase 2 build: both kernels built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)

    kernels = phase_kernels(device, 64, 512)  # bert-base at full length (phase 4's batch)
    small = phase_kernels(device, 32, 32)  # the slice's usual index batch (32 texts, 32 tokens)
    phase_encoder(device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        slice_out = phase_slice(device, N_CHUNKS, N_QUESTIONS, workdir)

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
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
