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
     k = 50, P = 16, 32 and 256: scores to 1e-5 + 1e-5*|plain|, ids equal
     at every rank separated from its neighbours by more than 1e-5
     (ops/mips.check_topk); each call's scan route (ops/mips.scan_route;
     the fp32 calls must launch the 3xTF32 "tf32" scan, the int8 calls the
     bf16 "mma" scan); median ms of kernel and plain, the bound (fp32: three
     tf32 products of each multiply-add at the TF32 peak) and roofline
     share, and a yardstick that is not one library call: fp32
     torch.matmul (TF32 off) then torch.topk for fp32 rows; torch.topk over
     torch.matmul of the bf16 queries by the bf16-converted rows, times the
     scales, for int8;
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
     count grew in the first run, there on the "tf32" scan route, and the
     int8 kernel's in the second, there on the "mma" route (launches per
     route are counted and printed). Every
     top-k kernel call of each run is recorded and then held against its
     plain version at those inputs (as phase 6; both timed), and the graph
     build's synonymy sweep is replayed on the default route (int8 two-pass)
     and on fp32 single-pass to attribute the graph span.
  9. the int4 kernels against their plain versions at Llama-3.1-8B's shapes
     in bf16 (random packed weights, scales for weights of std ~0.02):
     int4_matmul at M = 8 (qkv 4096->6144, lm_head 4096->128256) and
     M = 4096 (qkv, o 4096->4096, gate/up 4096->28672, down 14336->4096),
     and at phase 11's tiny lm_head (256->259, the mma_sync route) at M = 2
     and 512, int4_fused_layer_tail at M = 8 and 64, under the bf16 rule; kernel ms
     (cycling through 32 layers' weights, past the 50 MB L2), plain ms,
     bound ms and what sets it, roofline share; for int4_matmul also its
     route (ops/int4.int4_matmul_route) and K splits, the wrapper's host
     time per call (200 calls, no sync) and two yardsticks that are not the
     same function: bf16 torch.matmul on the dequantized weight and
     torch._weight_int4pack_mm (bf16 scales and output) where this torch
     has it, else "none" and why; that one is int4_matmul's library_ms;
 10. the generation server at Llama-3.1-8B width (32 layers, seeded random
     bf16 weights made on the card, int4 with group 128):
     GenerationServer(TorchOfflineLLM(param_dtype="int4", bf16 compute))
     answers 8 requests submitted from 8 threads at once (512-token prompt
     bucket, 64 new tokens); no response is an error, every response has
     completion tokens, both int4 kernels launched; prefill and decode
     tok/s, int4_matmul's launches per route and the llm.* counters, then the same batch on the int4 plain
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
     weights (int4_matmul launches on its mma_sync route among others, the
     fused tail's gate is false at H = 256; the first call of each route
     and shape is held against int4_matmul_plain at its own inputs),
     speculative decoding equal to plain greedy;
 12. training: (a) the encoder's contrastive step (models/train.py) at
     bert-base width and depth, B = 32 pairs of phase 5's corpus, S = 128,
     10 steps in fp32 and 10 in bf16 compute: finite losses, the step
     counter at 10, pairs/s over steps 2-10; (b) the causal-LM step
     (models/train_lm.py) at Llama-3.1-8B width cut to 2 layers (fp32
     masters and AdamW moments, bf16 compute, remat), B = 4, S = 512 with
     padded tails, 5 steps on one batch: the loss falls; tokens/s over
     steps 2-5 and peak memory. Neither step launches any of the six
     kernels (their counts stay 0: the kernels have no backward). (c)
     ``python -m comorag_torch.cli.train --init random --device cuda`` for
     20 steps on phase 5's pairs, its checkpoint loaded into a bf16
     BGETorchEncoder on the kernels: 256 chunks encoded, both encoder
     kernels launched, per-row cosine >= 0.999 against the plain route;
     then ``python -m comorag_torch.eval.qa_eval`` over phase 11's results
     (ExactMatch and F1 printed);
 13. the corpus-sharded serving path on meshes whose positions all sit on
     the one card (``parallel/mesh.py``; no multi-card speed is read from
     them): (a) phase 7's corpus, batches and k through MipsIndex(mesh=)
     over [card] x 4 for fp32, the default int8 two-pass, bf16 two-pass
     and the kernel route over fp32 and int8 rows: scores to 1e-5 and
     ids equal to phase 7's unsharded ones at every rank separated by more
     than 1e-5 (a two-pass breaks a rescore tie by pool order, a merge by
     shard order), the exact variants at overlap 1.0 with its float64
     oracle, the kernel routes launching 4 times phase 7's count a round
     on "tf32" / "mma"; qps beside phase 7's; (b) top-k-min and full
     scores on phase 8's veridical matrix and PPR, seed -> PPR -> top-k on
     phase 8's graph, sharded against single-device (scores to 1e-5, ranks
     to 1e-6, positions equal where separated by more than that); (c) the meta loop over a
     {"data": 2, "corpus": 4} mesh on phase 8's stores (no indexing): 16
     answers (printed beside phase 8's), the veridical index in 4 shards,
     the top-k and both encoder kernels launched, veridical top-k ids equal
     an unsharded index's over the same query embeddings (as in (a)), and the
     data-axis query embeddings at cosine >= 0.999 against the unsharded
     encoder's;
 14. tensor-parallel generation over {"model": 4} of the one card
     (``decoder.shard_params``; no multi-card speed is read from it), on
     phase 10's weights, arch and 8 requests: (a) int4 weights, every
     product column-parallel: no error response; each forward's launches
     checked (``decoder.tail_route``: a forward of <= 64 tokens, a decode
     step, launches the fused tail once a layer over the o, gate/up and
     down column shards, read in place, and int4_matmul 4 x (layers + 1)
     times for qkv and the head; a prefill chunk int4_matmul 4 x (4 x
     layers + 1) times, no tail; per route, beside phase 10's); the
     last-prompt and first-decode-step logits in fp32 compute against the
     unsharded engine on the same weights and against the plain versions
     on the same shards, under phase 10's rule; the served bf16 logits and
     greedy tokens beside phase 10's and prefill and decode tok/s
     (reported); (b) the same with bf16 weights (o/down row-parallel,
     partial sums on the merge device, no int4 launch); (c) int4_matmul at
     qkv's and the head's shard shapes of a decode step (M = 8: qkv
     4096->1536, lm_head 4096->32064, and 4096->64128 at {"model": 2}) and
     the fused tail over the 4 column shards at M = 8 and 64 (held against
     its plain version under the bf16 rule and against the whole-weight
     launch) as phase 9 times its shapes;
 15. dp x tp training over {"data": 2, "model": 2} of the one card
     (``models/train.py`` and ``train_lm.py`` with ``mesh=``; no
     multi-card speed is read from it): (a) bert-base with phase 12a's
     seed and batches, the first fp32 step against the unsharded step on
     the same state and batch (loss to rtol 1e-5, every gradient to rtol
     1e-4 with atol 1e-6 * max |g|, every parameter finite and within
     2 * lr, the most a first AdamW step can move it), then 10 steps in
     fp32 (each loss within 1e-4, relative, of 12a's at the same step) and
     in bf16 compute beside phase 12a's pairs/s; (b) phase
     12b's LM steps over the mesh, each loss within 2e-2 (relative) of
     12b's at the same step and falling, tokens/s and peak memory beside
     12b's; (c) (a)'s fp32 state saved and loaded into an unsharded state
     (bit-equal tensors), served by a bf16 BGETorchEncoder on the kernels
     (256 chunks, both encoder kernels launched, cosine >= 0.999 against
     plain); (d) ``__graft_entry__.dryrun_multichip``'s sequence at its
     arches: an encoder and an LM step, the trained decoder served with
     int8 weights split over the model axis (guided JSON sampled, then
     speculative at temperature 0) and with int4 weights (int4_matmul
     once per column shard of each product a forward), the qwen3- and
     gemma-class families, the corpus-sharded index and PPR. None of the
     six kernels launches in the training steps of (a), (b) and (d).
 16. the tiny decoder's training recipe (scripts/torch_train_tiny_lm.py,
     its own functions) on the card: (a) its arch (vocab 259, H 256, 6
     layers), B = 16, S = 2048, fp32, remat, AdamW under its warmup-cosine
     schedule, for as many of its 3,000 steps as 240 s hold at the step
     time of a profiled throwaway run (the count and the reason printed):
     steps/s, tokens/s, peak memory, the host's batch-making ms a step, the
     device's busy time and idle share over 20 profiled steps, no kernel
     launched, the loss falling (the last 20 steps' mean under 0.8 x the
     first's); (b) the checkpoint saved (fp16), reloaded and served on int4
     weights on phase 11's prompts (int4_matmul on its mma_sync route, no
     fused tail, each first call of a route and shape held against
     int4_matmul_plain); (c) the meta loop over dataset/moonlantern with the
     trained engine behind the generation server (every question answered,
     both stores non-empty); (d) the recipe's evaluate() table of the
     trained and of the committed assets/tiny_lm.npz, held to
     tests/test_torch_tiny_trained.py's golden floors after a full run.
Then it checks that no module of jax or of the JAX package was loaded, and
prints the kernels JSON line (every kernel with its launches on the main
path, max_abs_err, ms, plain_ms, bound_ms, bound_by and library_ms,
``mesh_training_step_launches`` and ``tiny_recipe_step_launches``, 0, and
``trained_tiny_launches``, phase 16b's), the
nvidia-smi line, and the result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
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
from comorag_torch.models import bge, curriculum, decoder, train, train_lm
from comorag_torch.ops import attention, build, ffn, int4, mips, ppr
from comorag_torch.parallel.mesh import Sharded, build_mesh, merge_blocks, split_blocks
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
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12, "tf32": 494.7e12}
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


def device_ms(fn, runs: int = 20, reps: int = 10, warmup: int = 3) -> float:
    """``median_ms`` with the host kept ahead of the card: a sleep kernel
    (~2.5 ms) holds the stream while the ``reps`` calls are enqueued, so
    the events time the kernels alone where the host's launch work per
    call exceeds a kernel's time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
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
    return bge.init_params(arch, torch.Generator().manual_seed(SEED), device)


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


def bert_base_encoder(device, model=None, mesh=None) -> bge.BGETorchEncoder:
    model = model if model is not None else bert_base("cpu")
    encoder = bge.BGETorchEncoder(params=model, tokenizer=bge.SimpleHashTokenizer(model.arch.vocab_size),
                                  max_seq_len=512, batch_size=ComoConfig().embedding_batch_size,
                                  device=None if mesh is not None else device, compute_dtype=torch.bfloat16,
                                  mesh=mesh)
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
    return {"index_s": index_s, "qa_s": qa_s, "questions_per_s": len(queries) / qa_s, "answers": answers,
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


def route_of(q: torch.Tensor, rows: torch.Tensor, k: int) -> str:
    """The scan route the wrapper takes for this call (ops/mips.scan_route)."""
    return mips.scan_route(q.shape[0], q.shape[1], k, rows.dtype,
                           q.data_ptr() % 16 == 0 and rows.data_ptr() % 16 == 0)


def routed(fn, route: str):
    """fn()'s result; raises unless it launched once, on ``route``."""
    before = {r: c.value for r, c in mips.ROUTE_LAUNCHES.items()}
    out = fn()
    torch.cuda.synchronize()
    delta = {r: c.value - before[r] for r, c in mips.ROUTE_LAUNCHES.items()}
    if delta != {r: int(r == route) for r in mips.SCAN_ROUTES}:
        raise AssertionError(f"expected one launch on the {route} scan route, got {delta}")
    return out


def phase_topk_kernels(device, corpus: np.ndarray, queries: np.ndarray) -> dict:
    """Both top-k kernels vs their plain versions at P = 16, 32 and 256."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("fp32 torch.matmul must run without TF32 (comorag_torch/device.py)")
    c32 = torch.tensor(corpus, device=device)
    cq, sc = (torch.tensor(a, device=device) for a in quantize_int8(corpus))
    c16 = cq.to(torch.bfloat16)  # the yardstick's rows, converted once (exact)
    out = {"mips_topk": {}, "mips_topk_int8": {}}
    for p in (16, 32, 256):
        q = torch.tensor(queries[:p], device=device)
        qb = q.to(torch.bfloat16)
        runs = {
            "mips_topk": (lambda: mips.mips_topk(q, c32, BENCH_K), lambda: mips.mips_topk_plain(q, c32, BENCH_K),
                          lambda: dense_scores(q, c32), route_of(q, c32, BENCH_K),
                          # two calls, not one library call: fp32 products (TF32 off), then the top-k
                          lambda: torch.topk(torch.matmul(q, c32.T), BENCH_K, dim=1)),
            "mips_topk_int8": (lambda: mips.mips_topk_int8(q, cq, sc, BENCH_K),
                               lambda: mips.mips_topk_int8_plain(q, cq, sc, BENCH_K),
                               lambda: int8_scores(q, cq, sc), route_of(q, cq, BENCH_K),
                               # two calls: bf16 products (bf16 output), then the top-k
                               lambda: torch.topk(torch.matmul(qb, c16.T).float() * sc, BENCH_K, dim=1)),
        }
        for name, want in (("mips_topk", "tf32"), ("mips_topk_int8", "mma")):
            if runs[name][3] != want:
                raise AssertionError(f"{name} at P={p} took the {runs[name][3]} route, not {want}")
        for name, (kernel, plain, scores, route, yardstick) in runs.items():
            s, i = routed(kernel, route)
            err = mips.check_topk(s, i, scores(), f"{name} P={p}")
            row_bytes = BENCH_DIM * (4 if name == "mips_topk" else 1) + (0 if name == "mips_topk" else 4)
            r = out[name][p] = {
                "max_abs_err": err, "ms": median_ms(kernel), "plain_ms": median_ms(plain), "scan_route": route,
                # no single PyTorch call ranks a fused top-k over the corpus
                "library_ms": None, "yardstick_ms": median_ms(yardstick),
                # rows (and scales) read once, queries read, (score, id) lists written;
                # P*N*d multiply-adds: fp32-exact for fp32 rows, which this card does as three
                # tf32 tensor-core products (3xTF32); bf16 queries x int8 rows (exact in bf16,
                # fp32 sums; pallas_topk.py:187-190) for int8
                **(bound(BENCH_N * row_bytes + p * BENCH_DIM * 4 + p * BENCH_K * 12,
                         3 * 2 * p * BENCH_N * BENCH_DIM, "tf32") if name == "mips_topk" else
                   bound(BENCH_N * row_bytes + p * BENCH_DIM * 4 + p * BENCH_K * 12,
                         2 * p * BENCH_N * BENCH_DIM, "bf16"))}
            r["roofline_share"] = r["bound_ms"] / r["ms"]
    del c32, cq, sc, c16
    print("phase 6 top-k kernels vs plain (N=100000, d=1024, k=50; scores 1e-5 + 1e-5*|plain|, ids "
          "equal where separated by > 1e-5): " + "; ".join(
              f"{name} P={p} route {r['scan_route']} max_abs_err={r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms "
              f"plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
              f"share {r['roofline_share']:.3f} yardstick ("
              + ("fp32 matmul" if name == "mips_topk" else "bf16 matmul")
              + f" + torch.topk) {r['yardstick_ms']:.4f} ms"
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

    ids, top_scores = {}, {}
    best, n_rescued = {name: 0.0 for name in variants}, {name: 0 for name in variants}
    for name, (ix, batches) in variants.items():  # warm-up and the results that are checked
        outs = ix.topk_many(batches, k=BENCH_K)
        ids[name], top_scores[name] = np.concatenate([i for _, i in outs]), np.concatenate([s for s, _ in outs])
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
    out["ids"], out["scores"], out["oracle"] = ids, top_scores, ref  # for phase 13's sharded variants
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
        route = route_of(q, rows[0], k)
        s, i = routed(lambda: kernel(q, *rows, k), route)
        (p, d), n = q.shape, rows[0].shape[0]
        out.append({"name": name, "P": p, "N": n, "d": d, "k": k, "scan_route": route,
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
    counters = (attention.LAUNCHES, ffn.LAUNCHES, mips.LAUNCHES, mips.INT8_LAUNCHES, *mips.ROUTE_LAUNCHES.values())
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
    if runs["int8"]["launches"][mips.ROUTE_LAUNCHES["mma"].name] <= 0:
        raise AssertionError(f"the int8 run did not launch the mma scan: {runs['int8']['launches']}")
    if runs["fp32"]["launches"][mips.ROUTE_LAUNCHES["tf32"].name] <= 0:
        raise AssertionError(f"the fp32 run did not launch the tf32 scan: {runs['fp32']['launches']}")
    for tag, r in runs.items():
        for counter in (mips.LAUNCHES, mips.INT8_LAUNCHES):
            checked = sum(c["name"] == counter.name for c in r["kernel_checks"])
            if checked != r["launches"][counter.name]:
                raise AssertionError(f"{tag}: {checked} of {r['launches'][counter.name]} {counter.name} "
                                     f"launches were checked against plain")
        print(f"phase 8 meta loop on the top-k kernels, {tag} rows ({N_META_CHUNKS} chunks, {N_QUESTIONS} "
              f"questions): index wall {r['index_s']:.3f} s, QA {r['qa_s']:.3f} s = "
              f"{r['questions_per_s']:.3f} questions/s; stores {r['stores']}; kernel-route layers "
              f"{r['kernel_route_layers']}; kernel launches {r['launches']}; launches per scan route "
              f"{ {route: r['launches'][c.name] for route, c in mips.ROUTE_LAUNCHES.items()} }; "
              f"kernel vs plain at the run's own inputs {json.dumps(r['kernel_checks'])}; "
              f"two_pass counters {json.dumps(r['two_pass'])}; spans_s {json.dumps(r['spans_s'])}", flush=True)
    print(f"phase 8 synonymy sweep replay (fp32 run's entity store): {json.dumps(runs['fp32']['synonymy_replay'])}",
          flush=True)
    runs["questions"] = queries
    return runs


# ------------------------------------------------------------------ phase 9
def llama_8b(layers: int = 32) -> decoder.DecoderArch:
    """Llama-3.1-8B-Instruct's published config.json shapes."""
    return decoder.DecoderArch(vocab_size=128256, hidden_size=4096, num_layers=layers, num_heads=32,
                               num_kv_heads=8, intermediate_size=14336, max_seq_len=131072,
                               rope_theta=500000.0, rms_norm_eps=1e-5,
                               rope_scaling=("llama3", 8.0, 1.0, 4.0, 8192.0))


# int4_matmul's main-path shapes: (M, weight) at decode and at prefill
INT4_MATMUL_SHAPES = ((8, "qkv"), (8, "lm_head"), (4096, "qkv"), (4096, "o"), (4096, "gate_up"), (4096, "down"))
# phase 11's tiny engine's lm_head (hidden 256 -> a 259-token vocabulary:
# the mma_sync route) at decode (a batch of 2) and a 512-token prefill chunk
TINY_HEAD_SHAPES = ((2, "tiny_lm_head"), (512, "tiny_lm_head"))


def int4_matmul_dims(arch, name: str) -> tuple:
    """(K, N) of one of the decoder's int4 products at ``arch``'s widths."""
    h, inter = arch.hidden_size, arch.intermediate_size
    qkv = (arch.num_heads + 2 * arch.num_kv_heads) * arch.head_dim
    return {"qkv": (h, qkv), "o": (h, h), "gate_up": (h, 2 * inter), "down": (inter, h),
            "lm_head": (h, arch.vocab_size), "tiny_lm_head": (256, 259)}[name]


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


def matmul_splits(device, m: int, k: int, n: int, route: str) -> int:
    """K splits of the route's launch: matmul_plan's on the split-K route, else 1."""
    if route != "splitk":
        return 1
    return int4.matmul_plan(m, k, n, 128, int4._sm_count(device), *int4._splitk_geometry(device, m))["splits"]


def int4_yardsticks(x, packed, scales, ref, gs: int = 128) -> dict:
    """Two PyTorch calls beside int4_matmul, neither the same function: bf16
    torch.matmul on the dequantized weight (rounds the weight, and sums
    across groups, otherwise), and torch._weight_int4pack_mm (tinygemm:
    scales rounded to bf16, bf16 output) where this torch has it for CUDA,
    else "none" and why. Times of one weight (not cycled)."""
    wd = int4.dequantize_int4(packed, scales, gs).to(torch.bfloat16)
    out = {"bf16_matmul_ms": median_ms(lambda: torch.matmul(x, wd), runs=10)}
    del wd
    if packed.shape[1] % 8:
        out["int4pack_mm"] = f"none (tinygemm packs 8-column tiles; N = {packed.shape[1]} is no multiple of 8)"
        out["int4pack_mm_ms"] = None
        return out
    try:
        q = (int4.unpack_rows(packed) + 8).t().contiguous()  # [N, K] in 0..15: w = (q - 8) * scale
        w_uint8 = ((q[:, 0::2] << 4) | q[:, 1::2]).to(torch.uint8).contiguous()
        wq = torch._convert_weight_to_int4pack(w_uint8, 8)
        sz = torch.stack([scales.to(torch.bfloat16), torch.zeros_like(scales, dtype=torch.bfloat16)], -1).contiguous()
        got = torch._weight_int4pack_mm(x, wq, gs, sz)
        torch.cuda.synchronize()
        ms = median_ms(lambda: torch._weight_int4pack_mm(x, wq, gs, sz), runs=10)
        out["int4pack_mm"] = (f"{ms:.4f} ms (max abs diff from plain {float((got.float() - ref).abs().max()):.4g}, "
                              f"worst ratio to the bf16 rule {rule_ratio(got, ref):.3f})")
        out["int4pack_mm_ms"] = ms
        del q, w_uint8, wq, got
    except Exception as e:  # a yardstick only: its absence is reported, never fatal
        out["int4pack_mm"] = f"none ({type(e).__name__}: {str(e)[:120]})"
        out["int4pack_mm_ms"] = None
    return out


def int4_weights(gen, device, k: int, n: int, count: int) -> tuple:
    """``count`` layers of random packed [k/2, n] weights and group-128
    scales giving weights of std ~0.02."""
    packed = torch.randint(-128, 128, (count, k // 2, n), generator=gen, device=device, dtype=torch.int8)
    scales = torch.empty(count, k // 128, n, device=device).uniform_(0.003, 0.006, generator=gen)
    return packed, scales


def time_int4_matmul(device, gen, m: int, name: str, packed: torch.Tensor, scales: torch.Tensor) -> dict:
    """int4_matmul at M = m against its plain version on the first layer's
    weight (the bf16 rule), timed cycling through every layer's weight,
    with its route, K splits, host time, yardsticks and bound."""
    k, n = packed.shape[1] * 2, packed.shape[2]
    x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
    got = int4.int4_matmul(x, packed[0], scales[0])
    ref = int4.int4_matmul_plain(x, packed[0], scales[0])
    torch.cuda.synchronize()
    route = int4.int4_matmul_route(m, n)
    r = {"M": m, "weight": name, "K": k, "N": n, "route": route, "splits": matmul_splits(device, m, k, n, route),
         "max_abs_err": compare(got, ref, f"int4_matmul M={m} {name}"),
         "ms": median_ms(cycling(lambda i: int4.int4_matmul(x, packed[i], scales[i]), packed.shape[0])),
         "plain_ms": median_ms(lambda: int4.int4_matmul_plain(x, packed[0], scales[0]), runs=3, reps=1, warmup=1),
         "host_us": host_us(lambda: int4.int4_matmul(x, packed[0], scales[0])),
         **int4_yardsticks(x, packed[0], scales[0], ref), **int4_bound(m, k, n)}
    # the library call: tinygemm, the same formula ((q - 8) * scale a group) with bf16 scales and output
    r["library_ms"] = r["int4pack_mm_ms"]
    r["roofline_share"] = r["bound_ms"] / r["ms"]
    del got, ref, x
    torch.cuda.empty_cache()
    return r


def int4_matmul_line(r: dict) -> str:
    return (f"int4_matmul M={r['M']} {r['weight']} {r['K']}->{r['N']} route {r['route']} ({r['splits']} K split(s)): "
            f"max_abs_err={r['max_abs_err']:.4g} kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) roofline share {r['roofline_share']:.3f}; wrapper host "
            f"{r['host_us']:.1f} us a call; yardsticks (not this function): bf16 torch.matmul on the dequantized "
            f"weight {r['bf16_matmul_ms']:.4f} ms, torch._weight_int4pack_mm {r['int4pack_mm']}")


def phase_int4_kernels(device) -> dict:
    """Both int4 kernels against their plain versions at Llama-3.1-8B's
    shapes (random packed weights, scales giving weights of std ~0.02):
    int4_matmul at decode (M = 8: qkv, lm_head) and prefill (M = 4096: qkv,
    o, gate/up, down), and at the tiny engine's lm_head (the mma_sync
    route); the fused tail at M = 8 and 64. Kernel times cycle through 32
    layers' weights."""
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    arch = llama_8b()
    h, inter, layers = arch.hidden_size, arch.intermediate_size, arch.num_layers
    w = {name: int4_weights(gen, device, *int4_matmul_dims(arch, name), 1 if name.endswith("lm_head") else layers)
         for name in ("qkv", "o", "gate_up", "down", "lm_head", "tiny_lm_head")}
    mm = [time_int4_matmul(device, gen, m, name, *w[name]) for m, name in INT4_MATMUL_SHAPES + TINY_HEAD_SHAPES]
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
             "device_ms": device_ms(cycling(lambda i: int4.int4_fused_layer_tail(*args(i), eps=1e-5), layers)),
             "plain_ms": median_ms(lambda: int4.int4_fused_layer_tail_plain(*args(0), eps=1e-5), runs=3, reps=1,
                                   warmup=1),
             "host_us": host_us(lambda: int4.int4_fused_layer_tail(*args(0), eps=1e-5)),
             "library_ms": None, **tail_bound(m, h, inter)}
        r["roofline_share"] = r["bound_ms"] / r["ms"]
        tail.append(r)
    del w
    torch.cuda.empty_cache()
    for r in mm:
        print(f"phase 9 {int4_matmul_line(r)}", flush=True)
    for r in tail:
        print(f"phase 9 int4_fused_layer_tail M={r['M']} H={r['H']} I={r['I']}: max_abs_err={r['max_abs_err']:.4g} "
              f"(worst ratio to the rule {r['rule_ratio']:.3f}) kernel {r['ms']:.4f} ms (device alone "
              f"{r['device_ms']:.4f}) plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
              f"roofline share {r['roofline_share']:.3f}; wrapper host {r['host_us']:.1f} us a call", flush=True)
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
    for counter in (int4.LAUNCHES, int4.TAIL_LAUNCHES, *int4.ROUTE_LAUNCHES.values()):
        counter.reset()
    with error_responses() as errors, timed_generation() as rec, \
            (plain_int4() if route == "int4_plain" else contextlib.nullcontext()):
        t0 = time.perf_counter()
        responses = serve_concurrently(engine, prompts, max_tokens)
        wall = time.perf_counter() - t0
    launches = {c.name: c.value for c in (int4.LAUNCHES, int4.TAIL_LAUNCHES)}
    route_launches = {c.name: c.value for c in int4.ROUTE_LAUNCHES.values()}
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
            "completion_tokens": completions, "launches": launches, "route_launches": route_launches,
            "llm_counters": counters,
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
    """Logits against reference logits under the bf16 rule scaled to max
    |logit|; fails above it or on a non-finite value."""
    out = {"max_abs_err": float((got - ref).abs().max()), "worst_ratio": logits_ratio(got, ref),
           "top1_equal": float((got.argmax(-1) == ref.argmax(-1)).float().mean())}
    if not torch.isfinite(got).all() or out["worst_ratio"] > 1.0:
        raise AssertionError(f"{what}: {out} (rule 2e-2 * max|logit| + 2e-2 * |logit|)")
    return out


def forward_logits(engine, prompts, compute_dtype, tok=None) -> tuple:
    """The requests' last-prompt logits (one prefill chunk of 8 x ~470
    rows) and the next decode step's logits (M = 8) in ``compute_dtype``
    on a KV cache of their own, the step fed ``tok`` (else the greedy
    token): (last, step, tok)."""
    pad, _ = engine._special_ids()
    rows = [engine._ids(*engine._render(m)) for m in prompts]
    p = max(len(r) for r in rows)
    ids = torch.full((len(rows), p), pad, dtype=torch.int64)
    mask = torch.zeros((len(rows), p), dtype=torch.int64)
    for i, r in enumerate(rows):
        ids[i, p - len(r):], mask[i, p - len(r):] = torch.tensor(r), 1
    ids, mask = ids.to(engine.device), mask.to(engine.device)
    with torch.no_grad():
        last, cache, slot_valid, row_len = decoder._prefill_batch(
            engine.params, ids, mask, engine.arch, p + 1, None, compute_dtype, engine.kv_dtype)
        tok = last.argmax(-1) if tok is None else tok
        slot_valid[:, p] = True  # generate's first decode step: slot p, position row_len
        step, _ = decoder.decoder_forward(engine.params, tok[:, None], row_len[:, None], slot_valid[:, None, :],
                                          cache, p, engine.arch, compute_dtype)
    torch.cuda.synchronize()
    return last, step[:, 0], tok


def checked_pair(got: tuple, ref: tuple, what: str, compute_dtype) -> dict:
    """``checked_logits`` on the last-prompt and the decode-step logits."""
    name = str(compute_dtype).replace("torch.", "")
    return {"prefill": checked_logits(got[0], ref[0], f"last-prompt logits in {name} compute, {what}"),
            "decode_step": checked_logits(got[1], ref[1], f"decode-step logits in {name} compute, {what}")}


def route_logits(engine, prompts, compute_dtype) -> dict:
    """The requests' last-prompt logits (prefill: int4_matmul only) and the
    next decode step's logits (the fused tail in every layer) through the
    kernels and through the plain versions, each route on its own KV cache
    and both fed the plain route's greedy token; both held under the bf16
    rule scaled to max |logit|. In fp32 compute the two routes differ only
    by the kernels' summation order and the roundings inside the fused
    tail, so the rule holds at full depth; in bf16 compute every product's
    output is rounded too."""
    with plain_int4():
        ref = forward_logits(engine, prompts, compute_dtype)
    tails = int4.TAIL_LAUNCHES.value
    got = forward_logits(engine, prompts, compute_dtype, ref[2])
    tails = int4.TAIL_LAUNCHES.value - tails
    if tails != engine.arch.num_layers:
        raise AssertionError(f"the decode step took {tails} fused tails for {engine.arch.num_layers} layers")
    return checked_pair(got, ref, "kernels vs plain", compute_dtype)


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
           "route_launches": runs["int4_kernels"]["route_launches"],
           "runs": {k: {f: v for f, v in r.items() if f not in ("logits", "tokens")} for k, r in runs.items()},
           "served": {k: {f: r[f] for f in ("logits", "tokens")} for k, r in runs.items()}}  # for phase 14
    for name, r in out["runs"].items():
        print(f"phase 10 server {name} (Llama-3.1-8B width, {layers} layers, 8 requests x {max_tokens} tokens, "
              f"512-token bucket): prefill {r['prefill_tok_s']:.1f} tok/s, decode {r['decode_tok_s']:.1f} tok/s, "
              f"wall {r['wall_s']:.3f} s; kernel launches {r['launches']}, int4_matmul by route "
              f"{r['route_launches']}; {json.dumps(r['llm_counters'])}", flush=True)
    tok_s = {name: {"prefill": r["prefill_tok_s"], "decode": r["decode_tok_s"]}
             for name, r in out["runs"].items()}
    print(f"phase 10 tok/s, int4 kernels beside int4 plain and bf16 weights: {json.dumps(tok_s)}", flush=True)
    print(f"phase 10 weights made and quantized in {build_s:.3f} s; kernels vs plain, logits of the 8 requests "
          f"at {layers} layers: fp32 compute, last prompt and first decode step (checked) {json.dumps(checked)}; "
          f"as served in bf16 compute (reported) {json.dumps(served)}", flush=True)
    print(f"phase 10 witnesses (fp32 compute at {layers} layers on two more weight seeds; served and decode-step "
          f"logits in bf16 compute at 2 and 4 layers, all checked): {json.dumps(out['witnesses'])}", flush=True)
    return out


# ----------------------------------------------------------------- phase 11
@contextlib.contextmanager
def recorded_int4_calls():
    """Keeps the arguments of the first int4_matmul call of each (route, M,
    K, N) made inside the block (the wrapper runs unchanged), so that each
    can be held against int4_matmul_plain afterwards at the main path's
    own inputs."""
    calls = {}
    kernel = int4.int4_matmul

    def recorded(x, packed, scales, group_size=128):
        key = (int4.int4_matmul_route(x.shape[0], packed.shape[-1]), x.shape[0], x.shape[1], packed.shape[-1])
        if key not in calls:
            calls[key] = (x.clone(), packed, scales, group_size)
        return kernel(x, packed, scales, group_size)

    int4.int4_matmul = recorded
    try:
        yield calls
    finally:
        int4.int4_matmul = kernel


def tiny_batches() -> list:
    """The tiny engine's prompts (phases 11 and 16b): two QA prompts, one
    guided NER and one guided triples prompt of the curriculum, as
    (prompts, guided template) batches."""
    rng = np.random.default_rng(SEED + 11)
    samples = [curriculum.make_sample(rng, task) for task in ("qa", "qa", "ner", "triples")]
    return [([s["prompt"] for s in samples[:2]], None), ([samples[2]["prompt"]], "ner"),
            ([samples[3]["prompt"]], "triples")]


def tiny_texts(engine, batches) -> list:
    return [r.text for prompts, tmpl in batches for r in engine._generate_batch(prompts, 256, tmpl, 0.0)]


def tiny_int4(params, arch, device, batches, what: str) -> dict:
    """A tiny checkpoint served on int4 weights over ``batches``, the int4
    counts set to 0 just before and read just after: int4_matmul must
    launch (its mma_sync route among them) and the fused tail must not (its
    gate is false at H = 256, as in JAX); the first call of each route and
    shape is then held against int4_matmul_plain at its own inputs."""
    counters = (int4.LAUNCHES, int4.TAIL_LAUNCHES, *int4.ROUTE_LAUNCHES.values())
    for counter in counters:
        counter.reset()
    with recorded_int4_calls() as calls:
        texts = tiny_texts(TorchOfflineLLM(params=params, arch=arch, param_dtype="int4", max_new_tokens=384,
                                           device=device), batches)
    launches = {c.name: c.value for c in counters}
    if (launches[int4.LAUNCHES.name] <= 0 or launches[int4.TAIL_LAUNCHES.name] != 0
            or launches[int4.ROUTE_LAUNCHES["mma_sync"].name] <= 0):
        raise AssertionError(f"{what}: expected int4_matmul launches (its mma_sync route among them) "
                             f"and no fused tail (H = {arch.hidden_size}): {launches}")
    checks = []
    for (route, m, k, n), (x, packed, scales, gs) in sorted(calls.items()):
        got = int4.int4_matmul(x, packed, scales, gs)
        torch.cuda.synchronize()
        checks.append({"route": route, "M": m, "K": k, "N": n, "max_abs_err": compare(
            got, int4.int4_matmul_plain(x, packed, scales, gs), f"{what}: int4_matmul {route} M={m} {k}->{n}")})
    return {"texts": texts, "launches": launches, "checks": checks}


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
    batches = tiny_batches()
    served = tiny_int4(params, arch, device, batches, "tiny int4 engine")
    int4_texts, int4_launches, int4_checks = served["texts"], served["launches"], served["checks"]
    trace.reset()
    plain = tiny_texts(TorchOfflineLLM(params=params, arch=arch, max_new_tokens=384, device=device), batches)
    plain_steps = trace.summary()["counters"]["llm.decode_steps"]
    trace.reset()
    spec = tiny_texts(TorchOfflineLLM(params=params, arch=arch, max_new_tokens=384, speculative=True, device=device),
                      batches)
    spec_steps = trace.summary()["counters"]["llm.decode_steps"]
    if spec != plain:
        raise AssertionError("speculative decoding gave other texts than plain greedy on the tiny checkpoint")
    out = {"cli_s": cli_s, "answers": len(results), "stores": stores, "cli_llm_counters": llm_counters,
           "int4_launches": int4_launches, "int4_matmul_vs_plain": int4_checks,
           "int4_same_texts_as_fp32": sum(a == b for a, b in zip(int4_texts, plain)),
           "texts": len(plain), "plain_decode_steps": plain_steps, "spec_decode_steps": spec_steps}
    print(f"phase 11 jax-tiny on the card: {json.dumps(out)}", flush=True)
    return out


# ----------------------------------------------------------------- phase 12
TRAIN_B, TRAIN_S, TRAIN_STEPS = 32, 128, 10  # cli/train.py's defaults: --batch 32 --max_seq_len 128
LM_B, LM_S, LM_STEPS, LM_LAYERS, LM_LR = 4, 512, 5, 2, 1e-4
CLI_STEPS, ROUNDTRIP_CHUNKS = 20, 256
KERNEL_COUNTERS = (attention.LAUNCHES, ffn.LAUNCHES, mips.LAUNCHES, mips.INT8_LAUNCHES, int4.LAUNCHES,
                   int4.TAIL_LAUNCHES)


def training_pairs(docs) -> list:
    """(query, passage) pairs over phase 5's corpus: a passage is a chunk,
    its query ten of the chunk's words after "Record <i>:"."""
    return [{"query": " ".join(doc.split()[2:12]), "passage": doc} for doc in docs]


def hash_tokens(tokenizer, texts, s: int, device) -> tuple:
    """ids and mask padded to ``s`` as cli/train.py tokenizes them."""
    rows, _ = tokenizer(texts, s)
    ids = np.zeros((len(texts), s), np.int64)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = r
    mask = (ids != 0).astype(np.int64)
    mask[:, 0] = 1
    return torch.as_tensor(ids, device=device), torch.as_tensor(mask, device=device)


def timed_steps(step, state, batches) -> tuple:
    """Runs one step per batch; the first is a warm-up, the rest are timed
    (host clock, synchronized). Returns the state, every loss, the seconds
    of the first step and of the timed ones."""
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        state, loss = step(state, batch)
        losses.append(loss)
        if i == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    return state, losses, t1 - t0, t2 - t1


def encoder_batches(pairs, device) -> list:
    """TRAIN_STEPS distinct batches of TRAIN_B of phase 5's pairs, hash-tokenized."""
    tokenizer = bge.SimpleHashTokenizer(bge.EncoderArch().vocab_size)
    batches = []
    for i in range(TRAIN_STEPS):
        take = pairs[i * TRAIN_B:(i + 1) * TRAIN_B]
        q_ids, q_mask = hash_tokens(tokenizer, [p["query"] for p in take], TRAIN_S, device)
        p_ids, p_mask = hash_tokens(tokenizer, [p["passage"] for p in take], TRAIN_S, device)
        batches.append({"q_ids": q_ids, "q_mask": q_mask, "p_ids": p_ids, "p_mask": p_mask})
    return batches


def encoder_steps(device, pairs, compute_dtype) -> dict:
    """12a: TRAIN_STEPS contrastive steps of bert-base (seeded random
    weights, fp32 masters) over distinct batches of phase 5's pairs."""
    arch = bge.EncoderArch()
    state = train.create_train_state(arch, torch.Generator().manual_seed(SEED), device=device)
    batches = encoder_batches(pairs, device)
    step = train.make_train_step(arch, compute_dtype=compute_dtype)
    state, losses, first_s, rest_s = timed_steps(step, state, batches)
    if state.step != TRAIN_STEPS:
        raise AssertionError(f"encoder step counter {state.step} != {TRAIN_STEPS}")
    return {"losses": losses, "first_step_s": first_s,
            "pairs_per_s": TRAIN_B * (TRAIN_STEPS - 1) / rest_s}


def lm_batch(arch, device) -> dict:
    """12b's batch: LM_B seeded random rows of LM_S tokens with padded tails."""
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    ids = torch.randint(1, arch.vocab_size, (LM_B, LM_S), generator=gen, device=device)
    lengths = torch.tensor([LM_S, LM_S - 37, LM_S - 200, LM_S // 2], device=device)
    return {"ids": ids, "mask": (torch.arange(LM_S, device=device)[None] < lengths[:, None]).long()}


def lm_steps(device) -> dict:
    """12b: LM_STEPS causal-LM steps at Llama-3.1-8B width and LM_LAYERS
    layers (fp32 masters and AdamW moments, bf16 compute, remat) on one
    seeded batch with padded tails; the loss must fall."""
    arch = llama_8b(LM_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = decoder.init_params(arch, torch.Generator(device=device).manual_seed(SEED + 12), device)
    state = train.TrainState(params, train.make_optimizer(LM_LR)(params), 0)
    n_params = sum(p.numel() for _, p, _ in train.named_leaves(params))
    step = train_lm.make_lm_train_step(arch, compute_dtype=torch.bfloat16)  # lm_loss recomputes each layer
    state, losses, first_s, rest_s = timed_steps(step, state, [lm_batch(arch, device)] * LM_STEPS)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the LM loss did not fall on a repeated batch: {losses}")
    out = {"params": n_params, "losses": losses, "first_step_s": first_s,
           "tokens_per_s": LM_B * LM_S * (LM_STEPS - 1) / rest_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del state, params
    torch.cuda.empty_cache()
    return out


def trained_encoder(checkpoint: str, device, route: str) -> bge.BGETorchEncoder:
    """The CLI's checkpoint loaded into a serving encoder (bf16 compute)."""
    arch = bge.EncoderArch()
    fresh = train.create_train_state(arch, torch.Generator().manual_seed(SEED), device=device)
    restored = train.load_checkpoint(checkpoint, fresh)
    if restored.step != CLI_STEPS:
        raise AssertionError(f"checkpoint step {restored.step} != {CLI_STEPS}")
    return bge.BGETorchEncoder(params=restored.params, tokenizer=bge.SimpleHashTokenizer(arch.vocab_size),
                               max_seq_len=TRAIN_S, device=device, compute_dtype=torch.bfloat16,
                               attention=route)


def run_module(module: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"python -m {module} exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout


def cli_roundtrip(device, pairs, workdir: str) -> dict:
    """12c: the train CLI on the card, its checkpoint encoded through both
    encoder kernels and held against the plain route (phase 4's rule)."""
    pairs_path, ckpt_dir = os.path.join(workdir, "pairs.jsonl"), os.path.join(workdir, "train_ckpt")
    with open(pairs_path, "w", encoding="utf-8") as f:
        f.writelines(json.dumps(p) + "\n" for p in pairs)
    t0 = time.perf_counter()
    run_module("comorag_torch.cli.train", "--pairs", pairs_path, "--output_dir", ckpt_dir, "--init", "random",
               "--steps", str(CLI_STEPS), "--batch", str(TRAIN_B), "--max_seq_len", str(TRAIN_S),
               "--device", "cuda")
    cli_s = time.perf_counter() - t0
    with open(os.path.join(ckpt_dir, "train_summary.json"), encoding="utf-8") as f:
        summary = json.load(f)
    chunks = [p["passage"] for p in pairs[:ROUNDTRIP_CHUNKS]]
    for counter in (attention.LAUNCHES, ffn.LAUNCHES):
        counter.reset()
    got = trained_encoder(summary["checkpoint"], device, "kernel").encode(chunks)
    launches = {c.name: c.value for c in (attention.LAUNCHES, ffn.LAUNCHES)}
    ref = trained_encoder(summary["checkpoint"], device, "plain").encode(chunks)
    if min(launches.values()) <= 0:
        raise AssertionError(f"the trained encoder did not launch both encoder kernels: {launches}")
    if got.shape != (ROUNDTRIP_CHUNKS, bge.EncoderArch().hidden_size) or not np.isfinite(got).all():
        raise AssertionError(f"trained encoder: shape {got.shape}, finite {np.isfinite(got).all()}")
    cos = (got * ref).sum(axis=1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    if float(cos.min()) < 0.999:
        raise AssertionError(f"trained encoder: kernel vs plain cosine {float(cos.min()):.6f} < 0.999")
    return {"cli_s": cli_s, "summary": summary, "launches": launches, "min_cosine": float(cos.min())}


def phase_training(device, workdir: str, smi: str) -> dict:
    """Phase 12: the two training steps at full width and the train CLI's
    round trip into the serving encoder, then the eval CLI over phase 11's
    results (``workdir`` is phase 11's)."""
    pairs = training_pairs(make_corpus(N_CHUNKS, N_QUESTIONS)[0])
    for counter in KERNEL_COUNTERS:
        counter.reset()
    enc = {name: encoder_steps(device, pairs, dtype) for name, dtype in (("fp32", torch.float32),
                                                                         ("bf16", torch.bfloat16))}
    lm = lm_steps(device)
    train_launches = {c.name: c.value for c in KERNEL_COUNTERS}
    if any(train_launches.values()):
        raise AssertionError(f"the training steps launched a kernel that has no backward: {train_launches}")
    for name, r in enc.items():
        print(f"phase 12a bert-base contrastive step B={TRAIN_B} S={TRAIN_S}, {name} compute: "
              f"{r['pairs_per_s']:.1f} pairs/s over steps 2-{TRAIN_STEPS} (first step {r['first_step_s']:.3f} s); "
              f"losses {json.dumps(r['losses'])}; card {smi}", flush=True)
    print(f"phase 12b LM step at Llama-3.1-8B width, {LM_LAYERS} layers ({lm['params']} parameters), B={LM_B} "
          f"S={LM_S}, bf16 compute, remat: {lm['tokens_per_s']:.1f} tokens/s over steps 2-{LM_STEPS} "
          f"(first step {lm['first_step_s']:.3f} s), peak memory {lm['peak_gib']:.3f} GiB; "
          f"losses {json.dumps(lm['losses'])}; card {smi}", flush=True)
    cli = cli_roundtrip(device, pairs, workdir)
    evaluated = json.loads(run_module("comorag_torch.eval.qa_eval", os.path.join(workdir, "out")))
    print(f"phase 12c train CLI ({CLI_STEPS} steps, --init random, B={TRAIN_B} S={TRAIN_S}, fp32) in "
          f"{cli['cli_s']:.3f} s: {json.dumps(cli['summary'])}; trained encoder on the kernels vs plain over "
          f"{ROUNDTRIP_CHUNKS} chunks (bf16): min cosine {cli['min_cosine']:.6f}, kernel launches "
          f"{cli['launches']}; eval CLI over phase 11's results: ExactMatch {evaluated['ExactMatch']}, "
          f"F1 {evaluated['F1']}; card {smi}", flush=True)
    return {"encoder": enc, "lm": lm, "cli": cli, "eval": evaluated, "train_launches": train_launches}

# ----------------------------------------------------------------- phase 13
SHARDS = 4
MESH_TOL = 1e-5  # tests/test_torch_parallel.py: scores; PPR ranks 1e-6
PPR_TOL = 1e-6


def card_mesh(device, shape: dict):
    """A mesh whose positions all sit on the one card (parallel/mesh.py):
    every shard-local program, per-shard launch and merge runs on the
    card; it gives no multi-card speed."""
    return build_mesh(shape, [device] * math.prod(shape.values()))


def sharded_serving(device, corpus: np.ndarray, serve_queries: np.ndarray, serving: dict) -> dict:
    """13a: phase 7's corpus, host batches and k through MipsIndex(mesh=)
    over [card] x 4: the same ranking as phase 7's unsharded index of the
    same variant (``same_ranking``), the exact ones at overlap 1.0 with phase 7's float64 oracle; each
    kernel-route call launches once per shard, on the tf32 / mma route."""
    mesh = card_mesh(device, {"corpus": SHARDS})
    configs = {"fp32": dict(scan_dtype=None), "two_pass_int8": dict(), "two_pass_bf16": dict(scan_dtype="bfloat16"),
               "pallas_fp32": dict(method="pallas"), "pallas_int8": dict(method="pallas", dtype="int8")}
    indexes = {name: MipsIndex(corpus, mesh=mesh, **kw) for name, kw in configs.items()}
    shards = {name: ix.n_shards for name, ix in indexes.items()}
    if set(shards.values()) != {SHARDS}:
        raise AssertionError(f"an index did not shard: {shards}")
    host = [serve_queries[i * SERVE_P : (i + 1) * SERVE_P].copy() for i in range(SERVE_BATCHES)]
    counters = (mips.LAUNCHES, mips.INT8_LAUNCHES, *mips.ROUTE_LAUNCHES.values())
    ids, swaps = {}, {}
    for name, ix in indexes.items():
        outs = ix.topk_many(host, k=BENCH_K)
        ids[name] = np.concatenate([i for _, i in outs])
        swaps[name] = same_ranking(np.concatenate([s for s, _ in outs]), ids[name], serving["scores"][name],
                                   serving["ids"][name], name)
    best, launches, n_rescued = {name: 0.0 for name in indexes}, {}, {name: 0 for name in indexes}
    for _ in range(SERVE_ROUNDS):
        for name, ix in indexes.items():
            for counter in counters:
                counter.reset()
            r0 = trace.summary()["counters"].get("two_pass.rescued_batches", 0)
            torch.cuda.synchronize()
            start = time.perf_counter()
            ix.topk_many(host, k=BENCH_K)
            torch.cuda.synchronize()
            best[name] = max(best[name], SERVE_BATCHES * SERVE_P / (time.perf_counter() - start))
            launches[name] = {c.name: c.value for c in counters}
            n_rescued[name] += int(trace.summary()["counters"].get("two_pass.rescued_batches", 0) - r0)
    overlaps = {name: overlap(i, serving["oracle"]) for name, i in ids.items()}
    if min(overlaps[name] for name in ("fp32", "two_pass_int8", "two_pass_bf16", "pallas_fp32")) < 1.0:
        raise AssertionError(f"a sharded exact variant missed the float64 oracle: {overlaps}")
    for name, counter, route in (("pallas_fp32", mips.LAUNCHES, "tf32"), ("pallas_int8", mips.INT8_LAUNCHES, "mma")):
        unsharded = serving["kernel_launches_per_round"][name][counter.name]
        got = launches[name]
        if got[counter.name] != SHARDS * unsharded or got[mips.ROUTE_LAUNCHES[route].name] != got[counter.name]:
            raise AssertionError(f"{name}: {got} launches a round, expected {SHARDS} x {unsharded} on {route}")
    return {"qps": {k: round(v, 1) for k, v in best.items()},
            "unsharded_qps_phase_7": {k: serving["qps"][k] for k in indexes}, "rescued_batches": n_rescued,
            "unsharded_rescued_batches_phase_7": {k: serving["rescued_batches"][k] for k in indexes},
            "overlap_vs_float64": overlaps,
            "tie_swaps_vs_unsharded": swaps,
            "shard_rows": {name: [len(c) for c in ix.corpus] for name, ix in indexes.items()},
            "kernel_launches_per_round": {k: v for k, v in launches.items() if k.startswith("pallas")}}


def same_ranking(s: np.ndarray, i: np.ndarray, ref_s: np.ndarray, ref_i: np.ndarray, what: str,
                 tol: float = MESH_TOL) -> int:
    """Hold a sharded top-k against the unsharded one (ops/mips.check_topk's
    rule): scores rank by rank to ``tol``, ids equal at every rank whose
    unsharded score is more than ``tol`` from both neighbours. Returns the
    number of ranks whose ids differ inside a near-tie (the two-pass breaks
    an exact rescore tie by pool order, a merge by shard order)."""
    if np.abs(s - ref_s).max() > tol:
        raise AssertionError(f"{what}: sharded scores differ from unsharded beyond {tol}")
    inf = np.full((len(ref_s), 1), np.inf, np.float32)
    gaps = np.concatenate([inf, ref_s[:, :-1] - ref_s[:, 1:], inf], axis=1)
    determined = (gaps[:, :-1] > tol) & (gaps[:, 1:] > tol)
    if ((i != ref_i) & determined).any():
        raise AssertionError(f"{what}: sharded ids differ from unsharded at a rank separated by more than {tol}")
    return int((i != ref_i).sum())


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sharded_programs(device, rag: ComoRAG, mesh, q: torch.Tensor) -> dict:
    """13b: top-k-min and full scores on phase 8's veridical matrix, PPR and
    seed -> PPR -> top-k on phase 8's graph, each sharded over the mesh's
    corpus axis against its single-device counterpart on the card."""
    out = {}
    ver = rag.ver_store.matrix
    sharded, single = MipsIndex(ver, mesh=mesh), MipsIndex(ver, device=device)
    if sharded.n_shards != SHARDS:
        raise AssertionError(f"the veridical matrix did not shard: {sharded.n_shards}")
    (s1, i1, m1), (s2, i2, m2) = sharded.topk_min_async(q, 50).result(), single.topk_min_async(q, 50).result()
    out["topk_min_tie_swaps"] = same_ranking(s1, i1, s2, i2, "sharded top-k-min")
    out["topk_min_max_abs_err"] = float(max(np.abs(s1 - s2).max(), np.abs(m1 - m2).max()))
    out["scores_max_abs_err"] = float(np.abs(sharded.scores(q) - single.scores(q)).max())
    if max(out["topk_min_max_abs_err"], out["scores_max_abs_err"]) > MESH_TOL:
        raise AssertionError(f"sharded scores beyond {MESH_TOL}: {out}")
    g, cfg = rag.graph, rag.config
    kw = dict(max_iters=cfg.ppr_max_iterations, tol=cfg.ppr_tolerance, backend="device")
    graphs = {"sharded": ppr.PPRGraph(g.src, g.dst, g.weights, g.n_nodes, mesh=mesh, **kw),
              "single": ppr.PPRGraph(g.src, g.dst, g.weights, g.n_nodes, device=device, **kw)}
    rng = np.random.default_rng(SEED)
    resets = (rng.random((16, g.n_nodes)) * (rng.random((16, g.n_nodes)) > 0.999)).astype(np.float32)
    resets[:, 0] += 1e-3  # no all-zero row
    passages = np.asarray([g.name_to_idx[k] for k in rag.ver_store.get_all_ids()], np.int64)
    seed_idx = rng.integers(0, g.n_nodes, (16, 8)).astype(np.int32)
    seed_w = rng.random((16, 8)).astype(np.float32)
    prior = torch.tensor(rng.random((16, len(passages))).astype(np.float32) * 0.005, device=device)
    ranks, topk, secs = {}, {}, {}
    for name, graph in graphs.items():
        ranks[name], secs[f"{name}_query_s"] = timed(lambda: graph.query(resets))
        topk[name], secs[f"{name}_query_topk_s"] = timed(lambda: graph.query_topk(seed_idx, seed_w, passages,
                                                                                  prior, k=50))
    out["ppr_max_abs_err"] = float(np.abs(ranks["sharded"] - ranks["single"]).max())
    out["ppr_topk_max_abs_err"] = float(np.abs(topk["sharded"][0] - topk["single"][0]).max())
    out["ppr_topk_tie_swaps"] = same_ranking(*topk["sharded"], *topk["single"], "sharded seed -> PPR -> top-k",
                                             tol=PPR_TOL)
    if max(out["ppr_max_abs_err"], out["ppr_topk_max_abs_err"]) > PPR_TOL:
        raise AssertionError(f"sharded PPR beyond {PPR_TOL}: {out}")
    out.update(graph_nodes=int(g.n_nodes), graph_arcs=int(g.n_arcs),
               arcs_per_shard=[len(a[0]) for a in graphs["sharded"]._arcs],
               **{k: round(v, 4) for k, v in secs.items()})
    return out


def sharded_meta_loop(device, workdir: str, meta: dict) -> dict:
    """13c: the meta loop over a {"data": 2, "corpus": 4} mesh on the card,
    on phase 8's stores (no indexing): 16 answers, the veridical index in 4
    shards, the top-k kernel and both encoder kernels launched; veridical
    top-k equal to an unsharded index's over the same query embeddings;
    the data-axis query embeddings at cosine >= 0.999 against the
    unsharded encoder's (phase 4's rule: the FFN's split-K plan follows
    the row count, so a sub-batch may round differently)."""
    mesh = card_mesh(device, {"data": 2, "corpus": SHARDS})
    model = bert_base("cpu")
    encoder = bert_base_encoder(device, model, mesh)
    rag = ComoRAG(slice_config(workdir, topk_method="pallas"), encoder=encoder, mesh=mesh)
    questions = meta["questions"]
    counters = (attention.LAUNCHES, ffn.LAUNCHES, mips.LAUNCHES, mips.INT8_LAUNCHES, *mips.ROUTE_LAUNCHES.values())
    trace.reset()
    for counter in counters:
        counter.reset()
    solutions, qa_s = timed(lambda: rag.try_answer(questions))
    launches = {c.name: c.value for c in counters}
    answers = [s.answer for s in solutions]
    if len(answers) != len(questions) or not all(answers):
        raise AssertionError(f"{sum(bool(a) for a in answers)}/{len(questions)} answers came back over the mesh")
    engine = rag.engine
    if engine.ver_index.n_shards != SHARDS:
        raise AssertionError(f"the veridical index has {engine.ver_index.n_shards} shards")
    if min(launches[c.name] for c in (attention.LAUNCHES, ffn.LAUNCHES, mips.LAUNCHES)) <= 0:
        raise AssertionError(f"a kernel was not launched over the mesh: {launches}")
    q = engine.encode_queries(questions)["passage"]
    k = rag.config.qa_ver_top_k
    single = MipsIndex(rag.ver_store.matrix, device=device, method="pallas")
    (s_sharded, i_sharded), (s_single, i_single) = engine.ver_index.topk(q, k), single.topk(q, k)
    veridical_swaps = same_ranking(s_sharded, i_sharded, s_single, i_single, "veridical top-k over the mesh")
    plain = bert_base_encoder(device, model)
    a, b = encoder.encode_device(questions), plain.encode_device(questions)
    cosine = float(torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=1).min())
    if cosine < 0.999:
        raise AssertionError(f"data-axis query embeddings at cosine {cosine} against the unsharded encoder")
    programs = sharded_programs(device, rag, mesh, q)
    return {"qa_s": qa_s, "questions_per_s": len(questions) / qa_s, "launches": launches,
            "index_shards": {name: getattr(engine, name).n_shards
                             for name in ("ver_index", "fact_index", "sem_index", "epi_index")
                             if getattr(engine, name) is not None},
            "ppr_arc_shards": len(engine.ppr._arcs) if engine.ppr is not None else 0,
            "min_query_cosine": cosine, "veridical_k": k, "veridical_tie_swaps": veridical_swaps,
            "programs": programs,
            "answers_equal_phase_8": sum(x == y for x, y in zip(answers, meta["fp32"]["answers"])),
            "answers": answers, "phase_8_answers": meta["fp32"]["answers"]}


def phase_sharded(device, corpus, serve_queries, serving: dict, workdir: str, meta: dict, smi: str) -> dict:
    serve = sharded_serving(device, corpus, serve_queries, serving)
    print(f"phase 13a sharded serving, 4 shards on one card ({smi}), 100000x1024, 100 batches x 16 queries, "
          f"k=50, best of 4 rounds, beside phase 7's unsharded qps of this run: {json.dumps(serve)}", flush=True)
    loop = sharded_meta_loop(device, workdir, meta)
    print(f"phase 13b sharded programs vs single-device on the card (4 shards on one card): "
          f"{json.dumps(loop['programs'])}", flush=True)
    print(f"phase 13c meta loop over a {{'data': 2, 'corpus': 4}} mesh on one card ({smi}), phase 8's stores, "
          f"{len(meta['questions'])} questions: QA {loop['qa_s']:.3f} s = {loop['questions_per_s']:.3f} questions/s "
          f"(phase 8 fp32: {meta['fp32']['questions_per_s']:.3f}); kernel launches {loop['launches']}; shards "
          f"{loop['index_shards']}, PPR arc shards {loop['ppr_arc_shards']}; veridical top-{loop['veridical_k']} ids "
          f"equal an unsharded index's ({loop['veridical_tie_swaps']} swaps inside near-ties); "
          f"min query cosine vs the unsharded encoder {loop['min_query_cosine']:.6f}; "
          f"answers equal to phase 8's: {loop['answers_equal_phase_8']}/{len(loop['answers'])}", flush=True)
    final = lambda a: a.split("### Final Answer")[-1].strip()[:120]  # noqa: E731
    print("phase 13c final answers beside phase 8's: " + json.dumps(
        [[final(a), final(b)] for a, b in zip(loop["answers"], loop["phase_8_answers"])]), flush=True)
    return {"serving": serve, "meta_loop": loop}


# ----------------------------------------------------------------- phase 14
TP = 4
# int4_matmul's column shards of a TP decode step (M = 8) at Llama-3.1-8B
# widths over {"model": 4}: qkv and the head (o, gate/up and down run in
# the fused tail over their shards); the last is the head's shard over
# {"model": 2}
TP_SHARD_SHAPES = (("qkv", 4096, 1536), ("lm_head", 4096, 32064), ("lm_head_model_2", 4096, 64128))
TP_ROUTES = (f"{decoder.FUSED_TAIL} where every shard lies on the merge device (this mesh of one card): one "
             f"launch a layer of <= 64 tokens reads the o, gate/up and down column shards in place; "
             f"{decoder.PER_PRODUCT} over distinct cards (the kernel reads one card's memory) and above 64 "
             f"tokens: int4_matmul per shard, the norm, activation and residuals in PyTorch")


def tp_shard_timings(device) -> list:
    """(c) int4_matmul at qkv's and the head's shard shapes of a TP decode
    step, timed as phase 9 times its shapes (32 layers' weights cycled,
    plain, bound, tinygemm as the library call)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    rows = []
    for name, k, n in TP_SHARD_SHAPES:
        packed, scales = int4_weights(gen, device, k, n, 1 if name.startswith("lm_head") else llama_8b().num_layers)
        rows.append(time_int4_matmul(device, gen, 8, f"{name} shard", packed, scales))
        del packed, scales
    torch.cuda.empty_cache()
    return rows


def tp_tail_timings(device) -> list:
    """(c) the fused tail over the column shards of {"model": 4} at
    Llama-3.1-8B width, M = 8 and 64, timed as phase 9 times the whole
    tail (32 layers' shards cycled, plain, bound): held against its plain
    version under the bf16 rule, and against the launch over the whole
    weights (the same plan: bit-equal expected, the max |d| reported)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    arch = llama_8b()
    h, inter, layers = arch.hidden_size, arch.intermediate_size, arch.num_layers
    devices = [device] * TP
    whole = [int4_weights(gen, device, k, n, layers) for k, n in ((h, h), (h, 2 * inter), (inter, h))]
    # each layer's shards, cut as decoder.shard_params cuts them (contiguous
    # tensors of their own): [layer][weight] -> (packed blocks, scale blocks)
    shards = [[(split_blocks(p[i], -1, devices), split_blocks(sc[i], -1, devices)) for p, sc in whole]
              for i in range(layers)]
    rows = []
    for m in (8, 64):
        ctx = torch.randn(m, h, generator=gen, device=device).to(torch.bfloat16)
        xres = torch.randn(m, h, generator=gen, device=device)
        nw = 1.0 + 0.1 * torch.randn(h, generator=gen, device=device)

        def args(i):
            return (ctx, xres, nw, *(t for pair in shards[i] for t in pair))

        got = int4.int4_fused_layer_tail(*args(0), eps=1e-5)
        ref = int4.int4_fused_layer_tail_plain(*args(0), eps=1e-5)
        whole_out = int4.int4_fused_layer_tail(ctx, xres, nw, *(t[0] for pair in whole for t in pair), eps=1e-5)
        torch.cuda.synchronize()
        r = {"M": m, "H": h, "I": inter, "blocks": TP,
             "max_abs_err": compare(got, ref, f"int4_fused_layer_tail over {TP} shards M={m}"),
             "rule_ratio": rule_ratio(got, ref), "max_abs_diff_vs_whole_kernel": float((got - whole_out).abs().max()),
             "ms": median_ms(cycling(lambda i: int4.int4_fused_layer_tail(*args(i), eps=1e-5), layers)),
             "device_ms": device_ms(cycling(lambda i: int4.int4_fused_layer_tail(*args(i), eps=1e-5), layers)),
             "whole_device_ms": device_ms(cycling(lambda i: int4.int4_fused_layer_tail(
                 ctx, xres, nw, *(t[i] for pair in whole for t in pair), eps=1e-5), layers)),
             "plain_ms": median_ms(lambda: int4.int4_fused_layer_tail_plain(*args(0), eps=1e-5), runs=3, reps=1,
                                   warmup=1),
             "host_us": host_us(lambda: int4.int4_fused_layer_tail(*args(0), eps=1e-5)),
             "library_ms": None, **tail_bound(m, h, inter)}
        r["roofline_share"] = r["bound_ms"] / r["ms"]
        rows.append(r)
        del got, ref, whole_out
    del whole, shards
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def forward_launches():
    """Records each decoder_forward call's tokens (batch x chunk) and the
    int4_matmul and fused-tail launches it made."""
    rec = []
    forward = decoder.decoder_forward

    def counted(params, input_ids, *a, **kw):
        before = int4.LAUNCHES.value, int4.TAIL_LAUNCHES.value
        out = forward(params, input_ids, *a, **kw)
        rec.append((input_ids.numel(), int4.LAUNCHES.value - before[0], int4.TAIL_LAUNCHES.value - before[1]))
        return out

    decoder.decoder_forward = counted
    try:
        yield rec
    finally:
        decoder.decoder_forward = forward


def checked_forwards(rec, arch, int4_kernels: bool, what: str) -> dict:
    """Each recorded forward's (int4_matmul, fused tail) launches over
    {"model": TP} of one card: at <= 64 tokens TP x (layers + 1), qkv and
    the head per shard, and one fused tail a layer over the shards; above,
    TP x (4 x layers + 1), every product per shard, no tail; none with
    bf16 weights. Returns the forwards by kind and their launch counts."""
    layers, out = arch.num_layers, {}
    for m, matmuls, tails in rec:
        kind = "le_64_tokens" if m <= int4.TAIL_MAX_M else "gt_64_tokens"
        want = (0, 0) if not int4_kernels else (TP * (layers + 1), layers) if kind == "le_64_tokens" else (
            TP * (4 * layers + 1), 0)
        if (matmuls, tails) != want:
            raise AssertionError(f"tp {what}: a forward of {m} tokens made (int4_matmul, fused tail) launches "
                                 f"{(matmuls, tails)}, expected {want}")
        entry = out.setdefault(kind, {"forwards": 0, "int4_matmul_each": matmuls, "fused_tail_each": tails})
        entry["forwards"] += 1
    return out


def tp_generation(device, params, arch, mesh, name: str, param_dtype, server: dict, max_tokens: int) -> dict:
    """(a) int4 or (b) bf16 weights split over the mesh's model axis:
    phase 10's 8 requests through the GenerationServer (no error; int4:
    every forward's launches as ``checked_forwards`` expects them, the
    fused tail over the shards at decode), then the last-prompt and
    first-decode-step logits in fp32 compute against the unsharded engine
    on the same weights (and, int4, against the plain versions on the same
    shards) under phase 10's rule; the served bf16 logits and greedy
    tokens beside phase 10's are reported."""
    t0 = time.perf_counter()
    engine = TorchOfflineLLM(params=params, arch=arch, param_dtype=param_dtype, compute_dtype=torch.bfloat16,
                             device=device, mesh=mesh)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0}
    prompts = server_prompts()
    int4_kernels = param_dtype == "int4"
    out["decode_route"] = decoder.tail_route(engine.params, arch, len(prompts))
    if out["decode_route"] != (decoder.FUSED_TAIL if int4_kernels else decoder.PER_PRODUCT):
        raise AssertionError(f"tp {name}: a decode step of the one-card mesh takes {out['decode_route']}")
    with forward_launches() as rec:
        run = serve_route(engine, prompts, max_tokens, f"tp_{name}")
    out["forwards"] = checked_forwards(rec, arch, int4_kernels, name)
    launches = run["launches"]
    if (launches["int4_matmul"], launches["int4_fused_layer_tail"]) != (sum(r[1] for r in rec), sum(r[2] for r in rec)):
        raise AssertionError(f"tp {name}: launches {launches} outside the recorded forwards {rec}")
    unsharded = "int4_kernels" if int4_kernels else "bf16_matmul"
    out.update(served_vs_phase_10=served_comparison(run, server["served"][unsharded]),
               **{k: run[k] for k in ("prefill_tok_s", "decode_tok_s", "wall_s", "launches", "route_launches",
                                      "llm_counters")},
               phase_10={k: server["runs"][unsharded][k] for k in ("prefill_tok_s", "decode_tok_s", "route_launches")})

    whole = TorchOfflineLLM(params=params, arch=arch, param_dtype=param_dtype, compute_dtype=torch.bfloat16,
                            device=device)
    ref = forward_logits(whole, prompts, torch.float32)
    del whole
    torch.cuda.empty_cache()
    with forward_launches() as rec:  # the prefill chunk and one decode step
        got = forward_logits(engine, prompts, torch.float32, ref[2])
    checked_forwards(rec, arch, int4_kernels, f"{name} fp32 forwards")
    if [m <= int4.TAIL_MAX_M for m, _, _ in rec] != [False, True]:
        raise AssertionError(f"tp {name} fp32 forwards: {rec}, expected one prefill chunk and one decode step")
    out["logits_fp32_vs_unsharded"] = checked_pair(got, ref, f"{TP} {name} shards vs unsharded", torch.float32)
    if int4_kernels:
        with plain_int4():
            plain = forward_logits(engine, prompts, torch.float32, ref[2])
        out["logits_fp32_vs_shard_plain"] = checked_pair(got, plain, f"{TP} int4 shards, kernels vs plain",
                                                         torch.float32)
    qkv = engine.params["layers"]["qkv_w"]
    out["qkv_shard"] = {"count": len(qkv.shards), "dim": qkv.dim, "devices": [str(d) for d in qkv.devices]}
    del engine
    torch.cuda.empty_cache()
    return out


def phase_tp(device, server: dict, smi: str, max_tokens: int = 64) -> dict:
    """Tensor-parallel generation over {"model": 4} on the one card (the
    four shards of every product on one device: what per-shard launches
    and merges cost, no multi-card speed), on phase 10's weights and
    requests: (a) int4, (b) bf16 weights, (c) the shard shapes timed."""
    arch = llama_8b()
    mesh = card_mesh(device, {"model": TP})
    params = decoder.init_params(arch, torch.Generator(device=device).manual_seed(SEED + 10), device,
                                 torch.bfloat16)  # phase 10's weights
    out = {name: tp_generation(device, params, arch, mesh, name, dtype, server, max_tokens)
           for name, dtype in (("int4", "int4"), ("bf16", torch.bfloat16))}
    del params
    torch.cuda.empty_cache()
    out["shards"] = tp_shard_timings(device)
    out["tail_shards"] = tp_tail_timings(device)
    for tag, name in (("a", "int4"), ("b", "bf16")):
        r = out[name]
        logits = {k: v for k, v in r.items() if k.startswith("logits")}
        print(f"phase 14{tag} TP generation, {name} weights over {{'model': {TP}}} on one card ({smi}), Llama-3.1-8B "
              f"width, {arch.num_layers} layers, 8 requests x {max_tokens} tokens, 512-token bucket: prefill {r['prefill_tok_s']:.1f} "
              f"tok/s, decode {r['decode_tok_s']:.1f} tok/s (phase 10 unsharded: {r['phase_10']['prefill_tok_s']:.1f}, "
              f"{r['phase_10']['decode_tok_s']:.1f}), wall {r['wall_s']:.3f} s, build {r['build_s']:.3f} s; launches "
              f"{r['launches']}, int4_matmul by route {r['route_launches']} (phase 10: {r['phase_10']['route_launches']})"
              f"; per forward (checked) {json.dumps(r['forwards'])}; decode route {r['decode_route']} (routes: "
              f"{TP_ROUTES}); qkv_w {r['qkv_shard']}; fp32-compute logits (checked) "
              f"{json.dumps(logits)}; served bf16 logits and greedy tokens beside phase 10's (reported) "
              f"{json.dumps(r['served_vs_phase_10'])}; {json.dumps(r['llm_counters'])}", flush=True)
    for r in out["shards"]:
        print(f"phase 14c {int4_matmul_line(r)}", flush=True)
    for r in out["tail_shards"]:
        print(f"phase 14c int4_fused_layer_tail over {r['blocks']} column shards M={r['M']} H={r['H']} I={r['I']} "
              f"({smi}): max_abs_err={r['max_abs_err']:.4g} (worst ratio to the rule {r['rule_ratio']:.3f}), max |d| "
              f"against the whole-weight launch {r['max_abs_diff_vs_whole_kernel']:.4g}; kernel {r['ms']:.4f} ms, "
              f"device alone {r['device_ms']:.4f} ms (whole weights: {r['whole_device_ms']:.4f}) plain "
              f"{r['plain_ms']:.4f} ms bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) roofline share {r['roofline_share']:.3f}; wrapper host "
              f"{r['host_us']:.1f} us a call", flush=True)
    return out


# ----------------------------------------------------------------- phase 15
MESH_SHAPE = {"data": 2, "model": 2}  # __graft_entry__._factor_mesh(4)
TRAIN_LR = 2e-5  # train.make_optimizer's default, the CLI's --lr
MESH_LM_RTOL = 2e-2  # the bf16 rule, relative: a mesh LM loss against phase 12b's at the same step
# fp32, relative: a mesh encoder loss against phase 12a's at the same step
# over TRAIN_STEPS steps (rounding only; a wrong gradient moves the loss by
# percents within a step or two)
MESH_ENC_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # tests/test_torch_train.py's gradient rule: atol times max |g|


def whole_tensor(leaf) -> torch.Tensor:
    """A parameter as one tensor (a split one's blocks joined on its first device)."""
    return merge_blocks(leaf, leaf.devices[0]) if isinstance(leaf, Sharded) else leaf.detach()


def whole_grad(leaf) -> torch.Tensor:
    """The gradient the last step applied to a parameter, as one tensor."""
    if isinstance(leaf, Sharded):
        return whole_tensor(dataclasses.replace(leaf, shards=tuple(s.grad for s in leaf.shards)))
    return leaf.grad


def step_against(a, b) -> dict:
    """State ``a`` against state ``b`` of one model (either split) after
    one step from the same parameters: the gradients each step applied
    (mismatches under GRAD_RTOL and GRAD_ATOL * max |g_b|), max |Δ| of
    the parameters, and the non-finite elements of ``a``."""
    others = dict(train.whole_leaves(b))
    scale = max(float(whole_grad(leaf).abs().max()) for leaf in others.values())
    out = {"grad_mismatches": 0, "max_grad_diff": 0.0, "grad_scale": scale, "max_param_diff": 0.0, "non_finite": 0}
    with torch.no_grad():
        for name, leaf in train.whole_leaves(a):
            p, g, g_ref = whole_tensor(leaf), whole_grad(leaf), whole_grad(others[name])
            d = (g - g_ref).abs()
            out["non_finite"] += int((~torch.isfinite(p)).sum()) + int((~torch.isfinite(g)).sum())
            out["grad_mismatches"] += int((d > GRAD_RTOL * g_ref.abs() + GRAD_ATOL * scale).sum())
            out["max_grad_diff"] = max(out["max_grad_diff"], float(d.max()))
            out["max_param_diff"] = max(out["max_param_diff"], float((p - whole_tensor(others[name])).abs().max()))
    return out


def training_launches() -> dict:
    return {c.name: c.value for c in KERNEL_COUNTERS}


def mesh_encoder_steps(device, mesh, batches, phase_12a: dict) -> tuple:
    """15a: bert-base with phase 12a's seed and batches over the mesh: the
    first step against the unsharded step on the same state and batch
    (loss to rtol 1e-5; every gradient under GRAD_RTOL / GRAD_ATOL; every
    parameter finite and within 2 * lr, which the first Adam step cannot
    exceed), then TRAIN_STEPS steps in fp32 (each loss within
    MESH_ENC_RTOL of phase 12a's at the same step) and in bf16 compute,
    beside phase 12a's pairs/s. Returns the report and the fp32 state
    after its steps."""
    arch = bge.EncoderArch()
    gen = lambda: torch.Generator().manual_seed(SEED)  # noqa: E731
    whole, whole_loss = train.make_train_step(arch)(train.create_train_state(arch, gen(), device=device), batches[0])
    split, loss = train.make_train_step(arch, mesh=mesh)(train.create_train_state(arch, gen(), mesh=mesh), batches[0])
    out = {"first_loss": float(loss), "unsharded_first_loss": float(whole_loss),
           "loss_rel_diff": abs(float(loss) - float(whole_loss)) / abs(float(whole_loss)),
           **step_against(split.params, whole.params), "param_rule": 2 * TRAIN_LR}
    if (not out["loss_rel_diff"] <= 1e-5 or out["grad_mismatches"] or out["non_finite"]
            or not out["max_param_diff"] <= 2 * TRAIN_LR):
        raise AssertionError(f"15a: the mesh step departs from the unsharded step: {out}")
    del whole, split
    torch.cuda.empty_cache()
    state = None
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        run = train.create_train_state(arch, gen(), mesh=mesh)
        run, losses, first_s, rest_s = timed_steps(train.make_train_step(arch, compute_dtype=dtype, mesh=mesh), run,
                                                   batches)
        if run.step != TRAIN_STEPS:
            raise AssertionError(f"15a {name}: step counter {run.step} != {TRAIN_STEPS}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, phase_12a[name]["losses"])]
        out[name] = {"losses": losses, "rel_diff_12a": rel, "first_step_s": first_s,
                     "pairs_per_s": TRAIN_B * (TRAIN_STEPS - 1) / rest_s,
                     "phase_12a_pairs_per_s": phase_12a[name]["pairs_per_s"]}
        if name == "fp32":
            if not max(rel) <= MESH_ENC_RTOL:
                raise AssertionError(f"15a fp32: mesh losses {losses} against phase 12a's {phase_12a[name]['losses']}")
            state = run
    torch.cuda.empty_cache()
    return out, state


def mesh_lm_steps(device, mesh, phase_12b: dict) -> dict:
    """15b: phase 12b's LM steps (its seed, weights, batch, optimizer,
    remat, bf16 compute) over the mesh: each loss within MESH_LM_RTOL of
    12b's loss at the same step, and the loss falls; tokens/s and peak
    memory beside 12b's."""
    arch = llama_8b(LM_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    state = train_lm.create_lm_train_state(arch, torch.Generator(device=device).manual_seed(SEED + 12),
                                           train.make_optimizer(LM_LR), mesh=mesh)
    step = train_lm.make_lm_train_step(arch, compute_dtype=torch.bfloat16, mesh=mesh)
    state, losses, first_s, rest_s = timed_steps(step, state, [lm_batch(arch, device)] * LM_STEPS)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, phase_12b["losses"])]
    out = {"losses": losses, "phase_12b_losses": phase_12b["losses"], "rel_diff": rel, "first_step_s": first_s,
           "tokens_per_s": LM_B * LM_S * (LM_STEPS - 1) / rest_s, "phase_12b_tokens_per_s": phase_12b["tokens_per_s"],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "phase_12b_peak_gib": phase_12b["peak_gib"]}
    if max(rel) > MESH_LM_RTOL or not losses[-1] < losses[0]:
        raise AssertionError(f"15b: mesh LM losses {losses} against phase 12b's {phase_12b['losses']}")
    del state
    torch.cuda.empty_cache()
    return out


def mesh_checkpoint(device, state, pairs, workdir: str) -> dict:
    """15c: 15a's mesh-trained state saved, loaded into an unsharded state
    (every tensor equal to the state's, bit for bit) and served by a bf16
    BGETorchEncoder on the kernels: ROUNDTRIP_CHUNKS chunks encoded, both
    encoder kernels launched, per-row cosine >= 0.999 against the plain
    route."""
    arch = bge.EncoderArch()
    path = os.path.join(workdir, "mesh_train_state")
    train.save_checkpoint(path, state)

    def load():
        restored = train.load_checkpoint(path, train.create_train_state(
            arch, torch.Generator().manual_seed(SEED + 1), device=device))
        if restored.step != TRAIN_STEPS:
            raise AssertionError(f"15c: checkpoint step {restored.step} != {TRAIN_STEPS}")
        return restored.params

    params = load()
    trained = dict(train.whole_leaves(state.params))
    unequal = [n for n, leaf in train.whole_leaves(params) if not torch.equal(leaf.detach(), whole_tensor(trained[n]))]
    if unequal:
        raise AssertionError(f"15c: loaded tensors differ from the mesh-trained state's: {unequal[:5]}")

    def serve(model, route):
        return bge.BGETorchEncoder(params=model, tokenizer=bge.SimpleHashTokenizer(arch.vocab_size),
                                   max_seq_len=TRAIN_S, device=device, compute_dtype=torch.bfloat16,
                                   attention=route).encode([p["passage"] for p in pairs[:ROUNDTRIP_CHUNKS]])

    for counter in (attention.LAUNCHES, ffn.LAUNCHES):
        counter.reset()
    got = serve(params, "kernel")
    launches = {c.name: c.value for c in (attention.LAUNCHES, ffn.LAUNCHES)}
    ref = serve(load(), "plain")
    if min(launches.values()) <= 0:
        raise AssertionError(f"15c: the mesh-trained encoder did not launch both encoder kernels: {launches}")
    if got.shape != (ROUNDTRIP_CHUNKS, arch.hidden_size) or not np.isfinite(got).all():
        raise AssertionError(f"15c: shape {got.shape}, finite {np.isfinite(got).all()}")
    cos = (got * ref).sum(axis=1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    if float(cos.min()) < 0.999:
        raise AssertionError(f"15c: kernel vs plain cosine {float(cos.min()):.6f} < 0.999")
    return {"tensors_equal": len(trained), "launches": launches, "min_cosine": float(cos.min())}


def mesh_dryrun(device, mesh) -> dict:
    """15d: ``__graft_entry__.dryrun_multichip`` step for step at its
    arches (:151-157, :178-181) over the mesh: an encoder and an LM step
    (returns their kernel launches separately), the trained decoder served
    with int8 weights split over the model axis (guided JSON sampled, then
    speculative at temperature 0), with int4 weights (int4_matmul once per
    column shard of each product a forward), the qwen3- and gemma-class
    families, the corpus-sharded index (auto two-pass, top-k, top-k-min)
    and the edge-sharded PPR."""
    b = max(8, mesh.shape["data"] * 4)
    for counter in KERNEL_COUNTERS:
        counter.reset()
    arch = bge.EncoderArch(vocab_size=512, hidden_size=64, num_layers=2, num_heads=8, intermediate_size=128,
                           max_position=64)
    ones = torch.ones((b, 16), dtype=torch.int64, device=device)
    state = train.create_train_state(arch, torch.Generator().manual_seed(0), mesh=mesh)
    _, loss = train.make_train_step(arch, mesh=mesh)(state, {"q_ids": ones, "q_mask": ones, "p_ids": ones,
                                                            "p_mask": ones})
    dec_arch = decoder.DecoderArch(vocab_size=259, hidden_size=64, num_layers=2, num_heads=8, num_kv_heads=4,
                                   intermediate_size=128, max_seq_len=128, qkv_bias=True)
    lm_state = train_lm.create_lm_train_state(dec_arch, torch.Generator(device=device).manual_seed(1), mesh=mesh)
    lm_state, lm_loss = train_lm.make_lm_train_step(dec_arch, mesh=mesh)(lm_state, {"ids": ones, "mask": ones})
    out = {"loss": float(loss), "lm_loss": float(lm_loss), "train_launches": training_launches()}
    if not (np.isfinite(out["loss"]) and np.isfinite(out["lm_loss"])):
        raise AssertionError(f"15d: non-finite losses {out}")

    messages = [{"role": "user", "content": "dryrun"}]
    llm = TorchOfflineLLM(params=lm_state.params, arch=dec_arch, mesh=mesh, temperature=0.8, speculative=True,
                          param_dtype="int8")
    qkv = llm.params["layers"]["qkv_w"]
    if not (isinstance(qkv, Sharded) and qkv.shards[0].q.dtype == torch.int8):
        raise AssertionError(f"15d: the int8 qkv_w is not split over the model axis: {type(qkv).__name__}")
    gen = llm.infer(messages, max_tokens=8, json_template="ner")
    spec = llm.infer(messages, max_tokens=8, json_template="ner", temperature=0)
    if not isinstance(gen.text, str) or spec.metadata.get("decode_steps", 0) < 1:
        raise AssertionError(f"15d: int8 generation {gen.text!r}, speculative {spec.metadata}")
    int4.LAUNCHES.reset()
    llm4 = TorchOfflineLLM(params=lm_state.params, arch=dec_arch, mesh=mesh, param_dtype="int4")
    qkv4 = llm4.params["layers"]["qkv_w"]
    gen4 = llm4.infer(messages, max_tokens=8)
    tp = mesh.shape["model"]
    per_forward = dec_arch.num_layers * 4 * tp + 1  # four column-split products a layer; the 259-column head whole
    expected = per_forward * gen4.metadata["decode_steps"]
    if not (isinstance(qkv4, Sharded) and len(qkv4.shards) == tp and isinstance(gen4.text, str)
            and int4.LAUNCHES.value == expected):
        raise AssertionError(f"15d: int4 over the model axis launched int4_matmul {int4.LAUNCHES.value} times, "
                             f"expected {expected}; text {gen4.text!r}")
    out.update(int8_text_bytes=len(gen.text), speculative_decode_steps=spec.metadata["decode_steps"],
               int4_matmul_launches=int4.LAUNCHES.value, int4_decode_steps=gen4.metadata["decode_steps"])
    for fam_arch in (dataclasses.replace(dec_arch, qkv_bias=False, qk_norm=True, head_dim_override=16),
                     dataclasses.replace(dec_arch, qkv_bias=False, num_kv_heads=1, embed_scale=True,
                                         rms_unit_offset=True, mlp_act="gelu_tanh", tie_embeddings=True)):
        fam = TorchOfflineLLM(params=decoder.init_params(fam_arch, torch.Generator(device=device).manual_seed(2),
                                                         device), arch=fam_arch, mesh=mesh)
        if not isinstance(fam.infer(messages, max_tokens=4).text, str):
            raise AssertionError(f"15d: no text from {fam_arch}")

    n = math.prod(mesh.shape.values())
    corpus_mesh = card_mesh(device, {"corpus": n})
    rng = np.random.default_rng(0)
    index = MipsIndex(rng.standard_normal((n * 256, 32)).astype(np.float32), mesh=corpus_mesh)
    if index.mesh is None or index.scan_dtype != "int8":
        raise AssertionError(f"15d: the corpus index is not sharded on the two-pass: {index.scan_dtype}")
    _, idx = index.topk(rng.standard_normal((4, 32)).astype(np.float32), k=8)
    _, _, row_min = index.topk_min_async(rng.standard_normal((4, 32)).astype(np.float32), k=8).result()
    src = np.arange(0, 64, dtype=np.int32)
    dst = (src + 1) % 64
    graph = ppr.PPRGraph(np.concatenate([src, dst]), np.concatenate([dst, src]), np.ones(128, np.float32), 64,
                         backend="device", mesh=corpus_mesh)
    scores = graph.query(np.ones(64, np.float32))
    if np.asarray(idx).shape != (4, 8) or not np.isfinite(row_min).all() or not np.isfinite(scores).all():
        raise AssertionError("15d: sharded top-k or PPR gave no finite result")
    out.update(topk_shape=list(np.asarray(idx).shape), ppr_sum=float(scores.sum()))
    return out


def phase_mesh_training(device, pairs, training: dict, smi: str) -> dict:
    """Phase 15: dp x tp training over {"data": 2, "model": 2} of the one
    card (every position on the card: no multi-card speed), (a)-(d)."""
    mesh = card_mesh(device, MESH_SHAPE)
    for counter in KERNEL_COUNTERS:
        counter.reset()
    enc, state = mesh_encoder_steps(device, mesh, encoder_batches(pairs, device), training["encoder"])
    lm = mesh_lm_steps(device, mesh, training["lm"])
    train_launches = training_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        roundtrip = mesh_checkpoint(device, state, pairs, workdir)
    del state
    torch.cuda.empty_cache()
    dry = mesh_dryrun(device, mesh)
    train_launches = {k: v + dry["train_launches"][k] for k, v in train_launches.items()}
    if any(train_launches.values()):
        raise AssertionError(f"the mesh training steps launched a kernel that has no backward: {train_launches}")
    for name in ("fp32", "bf16"):
        r = enc[name]
        print(f"phase 15a bert-base contrastive step over {MESH_SHAPE} on one card ({smi}), B={TRAIN_B} S={TRAIN_S}, "
              f"{name} compute: {r['pairs_per_s']:.1f} pairs/s over steps 2-{TRAIN_STEPS} (phase 12a unsharded: "
              f"{r['phase_12a_pairs_per_s']:.1f}; first step {r['first_step_s']:.3f} s); losses "
              f"{json.dumps(r['losses'])}, max rel diff from 12a's {max(r['rel_diff_12a']):.3g} "
              f"({f'rule {MESH_ENC_RTOL}' if name == 'fp32' else 'reported'})", flush=True)
    print(f"phase 15a first step against the unsharded step, fp32: loss {enc['first_loss']} vs "
          f"{enc['unsharded_first_loss']} (rel {enc['loss_rel_diff']:.3g}, rule 1e-5); gradients: "
          f"{enc['grad_mismatches']} mismatches, max |diff| {enc['max_grad_diff']:.3g} (rule rtol {GRAD_RTOL}, atol "
          f"{GRAD_ATOL} * max |g| = {GRAD_ATOL * enc['grad_scale']:.3g}); max |param diff| "
          f"{enc['max_param_diff']:.3g} (rule 2 * lr = {enc['param_rule']:.3g}); non-finite {enc['non_finite']}",
          flush=True)
    print(f"phase 15b LM step at Llama-3.1-8B width, {LM_LAYERS} layers, over {MESH_SHAPE} on one card ({smi}), B={LM_B} "
          f"S={LM_S}, bf16 compute, remat: {lm['tokens_per_s']:.1f} tokens/s over steps 2-{LM_STEPS} (phase 12b: "
          f"{lm['phase_12b_tokens_per_s']:.1f}; first step {lm['first_step_s']:.3f} s), peak memory "
          f"{lm['peak_gib']:.3f} GiB (phase 12b: {lm['phase_12b_peak_gib']:.3f}); losses {json.dumps(lm['losses'])} "
          f"against 12b's {json.dumps(lm['phase_12b_losses'])}, max rel diff {max(lm['rel_diff']):.3g} "
          f"(rule {MESH_LM_RTOL})", flush=True)
    print(f"phase 15c mesh-trained checkpoint into an unsharded bf16 encoder: {roundtrip['tensors_equal']} tensors "
          f"equal bit for bit, {ROUNDTRIP_CHUNKS} chunks, kernel launches {roundtrip['launches']}, min cosine vs plain "
          f"{roundtrip['min_cosine']:.6f}", flush=True)
    print(f"phase 15d dryrun_multichip's sequence over {MESH_SHAPE} on one card: {json.dumps(dry)}; training-step "
          f"kernel launches (a, b, d) {train_launches}", flush=True)
    return {"encoder": enc, "lm": lm, "roundtrip": roundtrip, "dryrun": dry, "train_launches": train_launches}


# ----------------------------------------------------------------- phase 16
TINY_B, TINY_S, TINY_LR, TINY_FULL_STEPS = 16, 2048, 6e-4, 3000  # the recipe's defaults
TINY_BUDGET_S = 240.0  # the training run's share of the smoke run's 1,200 s
TINY_PROFILE_STEPS = 20
# tests/test_torch_tiny_trained.py's golden floors (at N = 4 samples a task) as rates
TINY_FLOORS = {"ner_parse_rate": 0.75, "ner_entity_recall": 0.6, "triples_parse_rate": 0.75,
               "triples_nonempty_rate": 0.6, "qa_marker_rate": 0.75, "qa_answer_rate": 0.5}


def load_script(name: str):
    """scripts/<name>.py as a module: phase 16 runs the recipe's own
    functions and measures with torch_train_profile's."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def recipe_profile(recipe, arch, device) -> dict:
    """The recipe's loop on a throwaway state at its batch and window: 3
    warm-up steps, TINY_PROFILE_STEPS steps timed (the step time that sizes
    the run, the host's batch-making ms a step), then as many under
    torch.profiler: the device's busy time a step and its idle share
    against the unprofiled wall."""
    state = recipe.create_state(arch, TINY_LR, TINY_FULL_STEPS, SEED, device)
    step = train_lm.make_lm_train_step(arch)
    quiet = lambda line: None  # noqa: E731
    state, _ = recipe.train(state, step, 3, TINY_B, TINY_S, SEED, device, log=quiet)
    state, timed = recipe.train(state, step, TINY_PROFILE_STEPS, TINY_B, TINY_S, SEED, device, log=quiet)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        state, _ = recipe.train(state, step, TINY_PROFILE_STEPS, TINY_B, TINY_S, SEED, device, log=quiet)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    busy_s = load_script("torch_train_profile").busy_us(events) / 1e6
    step_s = timed["wall_s"] / TINY_PROFILE_STEPS
    del state
    torch.cuda.empty_cache()
    return {"step_s": step_s, "host_batch_ms": timed["host_batch_ms"],
            "device_busy_ms_per_step": busy_s / TINY_PROFILE_STEPS * 1e3,
            "idle_share": 1 - busy_s / TINY_PROFILE_STEPS / step_s,
            "device_events_per_step": len(events) / TINY_PROFILE_STEPS}


def recipe_training(recipe, device) -> tuple:
    """16a: the recipe at its full arch, batch and window for as many of its
    3,000 steps as TINY_BUDGET_S holds at the profiled step time (the
    schedule over that many steps), none of the six kernels launched; the
    loss must fall (the last 20 steps' mean under 0.8 x the first's)."""
    arch = recipe.build_arch(TINY_S)
    profile = recipe_profile(recipe, arch, device)
    steps = min(TINY_FULL_STEPS, int(TINY_BUDGET_S / profile["step_s"]))
    reason = ("the recipe's full run" if steps == TINY_FULL_STEPS else
              f"{TINY_FULL_STEPS} steps at {profile['step_s']:.4f} s a step would take "
              f"{TINY_FULL_STEPS * profile['step_s']:.1f} s, over the phase's {TINY_BUDGET_S:.0f} s")
    for counter in KERNEL_COUNTERS:
        counter.reset()
    torch.cuda.reset_peak_memory_stats()
    state = recipe.create_state(arch, TINY_LR, steps, SEED, device)
    lines = []
    state, run = recipe.train(state, train_lm.make_lm_train_step(arch), steps, TINY_B, TINY_S, SEED, device,
                              log=lines.append)
    launches = {c.name: c.value for c in KERNEL_COUNTERS}
    if any(launches.values()):
        raise AssertionError(f"the tiny recipe's steps launched a kernel that has no backward: {launches}")
    losses = run.pop("losses")
    first, last20 = losses[0], statistics.fmean(losses[-20:])
    if not (np.isfinite(losses).all() and last20 < 0.8 * first):
        raise AssertionError(f"the tiny recipe's loss did not fall: first {first}, mean of the last 20 {last20}")
    out = {**run, "reason": reason, "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "profile": profile,
           "first_loss": first, "last20_mean_loss": last20, "log": lines, "launches": launches}
    return state, arch, out


def recipe_meta_loop(params, arch, device, workdir: str) -> dict:
    """16c: the meta loop over dataset/moonlantern with the trained engine
    behind the generation server (the jax-tiny route's engine settings):
    every question answered, guided OpenIE leaving both stores non-empty,
    no error response."""
    base = os.path.join(REPO, "dataset", "moonlantern", "moonlantern_1")
    docs = [d["contents"] for d in cli_run.load_jsonl(os.path.join(base, "corpus.jsonl"))]
    queries = [s["question"] for s in cli_run.load_jsonl(os.path.join(base, "qas.jsonl"))]
    config = ComoConfig(llm_name="jax-tiny", embedding_model_name="hash", save_dir=os.path.join(workdir, "save"),
                        output_dir=os.path.join(workdir, "out"))
    config.corpus_len = len(docs)
    server = serving.GenerationServer(TorchOfflineLLM(params=params, arch=arch, temperature=0.0, max_new_tokens=384,
                                                      device=device))
    trace.reset()
    t0 = time.perf_counter()
    try:
        with error_responses() as errors:
            rag = ComoRAG(config, llm=server, device=device)
            rag.index(docs)
            answers = [s.answer for s in rag.try_answer(queries)]
    finally:
        server.close()
    wall_s = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"trained tiny meta loop: {len(errors)} error responses: {errors[:2]}")
    stores = {name: len(getattr(rag, name)) for name in ("entity_store", "fact_store")}
    if not answers or not all(answers) or min(stores.values()) <= 0:
        raise AssertionError(f"trained tiny meta loop: {sum(map(bool, answers))}/{len(queries)} answers, "
                             f"stores {stores}")
    return {"wall_s": wall_s, "answers": len(answers), "questions": len(queries), "stores": stores,
            "llm_counters": {k: v for k, v in trace.summary()["counters"].items() if k.startswith("llm.")}}


def phase_recipe(device, smi: str) -> dict:
    """Phase 16: the tiny decoder's training recipe on the card, then its
    checkpoint saved, reloaded and served: (a) training, (b) int4 serving
    on phase 11's prompts, (c) the meta loop, (d) the evaluation tables of
    the trained and the committed checkpoints."""
    recipe = load_script("torch_train_tiny_lm")
    state, arch, training = recipe_training(recipe, device)
    print(f"phase 16a tiny recipe on the card ({smi}): {training['steps']} steps ({training['reason']}), "
          f"B={TINY_B} S={TINY_S} fp32, remat: {training['steps_per_s']:.4f} steps/s, "
          f"{training['tokens_per_s']:.1f} tokens/s, wall {training['wall_s']:.1f} s, peak memory "
          f"{training['peak_gib']:.3f} GiB, host batch making {training['host_batch_ms']:.3f} ms a step; "
          f"over {TINY_PROFILE_STEPS} profiled steps: {json.dumps(training['profile'])}; loss {training['first_loss']:.4f} "
          f"-> mean of the last 20 {training['last20_mean_loss']:.4f} (rule < 0.8x); kernel launches "
          f"{training['launches']}; log {json.dumps(training['log'])}", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        path = os.path.join(workdir, "tiny_lm_torch.npz")
        curriculum.save_tiny_checkpoint(path, state.params, arch)
        del state
        torch.cuda.empty_cache()
        params, loaded_arch = curriculum.load_tiny_checkpoint(path)
        if loaded_arch != arch:
            raise AssertionError(f"the reloaded checkpoint's arch {loaded_arch} is not the trained {arch}")
        served = tiny_int4(params, arch, device, tiny_batches(), "trained tiny int4 engine")
        served.pop("texts")
        print(f"phase 16b trained checkpoint reloaded ({os.path.getsize(path)} bytes) and served on int4 weights, "
              f"phase 11's prompts: {json.dumps(served)}", flush=True)
        meta = recipe_meta_loop(params, arch, device, workdir)
        print(f"phase 16c meta loop over dataset/moonlantern on the trained engine: {json.dumps(meta)}", flush=True)
    committed = curriculum.load_tiny_checkpoint(curriculum.default_checkpoint_path())
    tables = {"trained": recipe.evaluate(params, arch, device=device),
              "committed": recipe.evaluate(*committed, device=device)}
    full = training["steps"] == TINY_FULL_STEPS
    below = {k: tables["trained"][k] for k, floor in TINY_FLOORS.items() if tables["trained"][k] < floor}
    # the floors bind a run of all 3,000 steps only: on the H100 (~0.29 s a
    # step) the phase's budget holds ~800, so there this check never fires
    # and the full recipe's table is recorded from the script's own run
    verdict = ("held" if not below else f"below: {json.dumps(below)}") if full else \
        (f"not applied: {training['steps']} of {TINY_FULL_STEPS} steps, the floors bind the full run only "
         f"(below at this step count: {json.dumps(below)})")
    print(f"phase 16d evaluate() (12 a task, seed 987654) of the trained checkpoint beside the committed "
          f"assets/tiny_lm.npz: {json.dumps(tables)}; golden floors {json.dumps(TINY_FLOORS)} {verdict}", flush=True)
    if full and below:
        raise AssertionError(f"the full recipe's checkpoint is below the golden floors: {below}")
    return {"training": training, "served": served, "meta_loop": meta, "eval": tables}


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
    serving = phase_serving(device, corpus, queries[256:])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as meta_dir:
        meta = phase_meta_loop(device, meta_dir)
        int4_kernels = phase_int4_kernels(device)
        server = phase_server(device)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            tiny = phase_tiny(device, workdir)
            training = phase_training(device, workdir, smi)
        sharded = phase_sharded(device, corpus, queries[256:], serving, meta_dir, meta, smi)
    del corpus, queries
    tp = phase_tp(device, server, smi)
    mesh_training = phase_mesh_training(device, training_pairs(make_corpus(N_CHUNKS, N_QUESTIONS)[0]), training, smi)
    tiny_recipe = phase_recipe(device, smi)

    entries = []
    for mod in (attention, ffn):
        name = mod.LAUNCHES.name
        entries.append({"name": name, "route": "cuda", "source": mod.SOURCE, "replaces": mod.REPLACES,
                        "launches": slice_out["launches"][name],
                        "trained_encoder_launches": training["cli"]["launches"][name],
                        "mesh_trained_encoder_launches": mesh_training["roundtrip"]["launches"][name],
                        "mesh_meta_loop_launches": sharded["meta_loop"]["launches"][name], **kernels[name],
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
                        **{f"p{p}_{k}": topk[name][p][k] for p in (32, 256)
                           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "roofline_share", "scan_route",
                                     "yardstick_ms", "max_abs_err")},
                        "launches_by_route": {r: meta[run]["launches"][c.name]
                                              for r, c in mips.ROUTE_LAUNCHES.items()},
                        "mesh_meta_loop_launches": sharded["meta_loop"]["launches"][name],
                        "mesh_serving_launches_per_round": sharded["serving"]["kernel_launches_per_round"][
                            "pallas_fp32" if run == "fp32" else "pallas_int8"][name],
                        "main_path_calls": main_path})
    for counter, replaces, rows in ((int4.LAUNCHES, int4.REPLACES, int4_kernels["int4_matmul"]),
                                    (int4.TAIL_LAUNCHES, int4.TAIL_REPLACES, int4_kernels["int4_fused_layer_tail"])):
        head = rows[0]  # decode, M = 8: the serving loop's shape
        tiny_checks = (tiny["int4_matmul_vs_plain"] + tiny_recipe["served"]["checks"]) if counter is int4.LAUNCHES else []
        entries.append({"name": counter.name, "route": "cuda", "source": int4.SOURCE, "replaces": replaces,
                        "launches": server["launches"][counter.name],
                        "trained_tiny_launches": tiny_recipe["served"]["launches"][counter.name],
                        **({"launches_by_route": server["route_launches"], "tiny_engine_checks": tiny_checks,
                            "trained_tiny_launches_by_route": {r: tiny_recipe["served"]["launches"][c.name]
                                                               for r, c in int4.ROUTE_LAUNCHES.items()},
                            "tp_launches": tp["int4"]["launches"][counter.name],
                            "tp_launches_by_route": tp["int4"]["route_launches"], "tp_shard_shapes": tp["shards"],
                            "mesh_dryrun_launches": mesh_training["dryrun"]["int4_matmul_launches"]}
                           if counter is int4.LAUNCHES else
                           {"tp_launches": tp["int4"]["launches"][counter.name], "tp_routes": TP_ROUTES,
                            "tp_shard_shapes": tp["tail_shards"]}),
                        "tp_launches_per_forward": tp["int4"]["forwards"],
                        "max_abs_err": max(r["max_abs_err"] for r in rows + tiny_checks
                                           + (tp["shards"] if counter is int4.LAUNCHES else tp["tail_shards"])),
                        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                        "shapes": rows})

    for entry in entries:
        entry["training_step_launches"] = training["train_launches"][entry["name"]]
        entry["mesh_training_step_launches"] = mesh_training["train_launches"][entry["name"]]
        entry["tiny_recipe_step_launches"] = tiny_recipe["training"]["launches"][entry["name"]]

    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "comorag_tpu"))
    if foreign:
        raise AssertionError(f"the port loaded jax or the JAX package: {foreign[:5]}")

    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
