"""Dataset runner: corpus.jsonl + qas.jsonl -> index -> answer -> results.json.

Port of ``comorag_tpu/cli/run.py``: the same flags plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch path). Usage:

    python -m comorag_torch.cli.run --base_path DIR --llm_name fake --device cuda
    python -m comorag_torch.cli.run --base_path DIR --llm_name jax-tiny --device cuda

Capability parity with the reference's main_openai.py (process_dataset +
per-subset loop) plus an actual CLI (the reference requires editing the
source to change configs, main_openai.py:56-71).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import List, Set

from comorag_torch.comorag import ComoRAG
from comorag_torch.config import ComoConfig
from comorag_torch.parallel.mesh import parse_mesh_shape
from comorag_torch.utils.jsonio import load_jsonl
from comorag_torch.utils.logging import get_logger

logger = get_logger(__name__)


def gold_answers_of(sample: dict) -> List[str]:
    """Reference get_gold_answers semantics (misc_utils.py:207-226)."""
    gold = None
    for key in ("answer", "golden_answers", "reference"):
        if key in sample:
            gold = sample[key]
            break
    if gold is None and "obj" in sample:
        gold = []
        for value in (sample["obj"], sample.get("possible_answers"), sample.get("o_wiki_title"), sample.get("o_aliases")):
            if value is None:
                continue
            # alias fields may be lists — flatten instead of hashing them
            gold.extend(value if isinstance(value, (list, tuple)) else [value])
    assert gold is not None, f"no gold answer in sample: {sample.keys()}"
    if isinstance(gold, str):
        gold = [gold]
    gold_set: Set[str] = set(gold)
    if "answer_aliases" in sample:
        gold_set.update(sample["answer_aliases"])
    return list(gold_set)


def process_dataset(dataset_path: str, config: ComoConfig, device: str = "cuda",
                    retrieval_only: bool = False) -> List[dict]:
    # Per-dataset trace: without a reset, every later subset's trace.json
    # silently accumulates all earlier subsets' timings.
    from comorag_torch.utils import trace

    trace.reset()
    corpus = load_jsonl(os.path.join(dataset_path, "corpus.jsonl"))
    samples = load_jsonl(os.path.join(dataset_path, "qas.jsonl"))
    docs = [doc["contents"] for doc in corpus]
    queries = [s["question"] for s in samples]
    config.corpus_len = len(corpus)

    rag = ComoRAG(config, device=device)
    rag.index(docs)

    if retrieval_only:
        # no LLM loop: dump each query's tri-layer retrieval and a
        # gold-containment recall summary (recall studies, index
        # debugging). EM/F1 from the QA eval CLI are NOT meaningful on
        # these outputs — read retrieval_summary.json instead.
        golds = [gold_answers_of(s) for s in samples]
        results = []
        retrieved = rag.engine.tri_retrieve_batch(queries)
        hits_at = {1: 0, 5: 0, 10: 0}
        for idx, (query, res) in enumerate(zip(queries, retrieved)):
            contains = [any(g.lower() in d.lower() for g in golds[idx]) for d in res.veridical[:10]]
            for k in hits_at:
                hits_at[k] += int(any(contains[:k]))
            results.append(
                {
                    "idx": idx,
                    "question": query,
                    "golden_answers": golds[idx],
                    "gold_in_top": [k for k in (1, 5, 10) if any(contains[:k])],
                    "retrieved": res.as_docs(),
                }
            )
        os.makedirs(config.output_dir, exist_ok=True)
        # NOT named *results*.json: the eval CLI's merge glob would sweep
        # it up, and rows without an answer field score 0.0 — silently
        # halving EM/F1 of a later full-QA run in the same tree
        with open(os.path.join(config.output_dir, "retrieval_output.json"), "w", encoding="utf-8") as f:
            json.dump(results, f, ensure_ascii=False, indent=2)
        summary = {f"gold_containment@{k}": round(v / max(len(queries), 1), 4) for k, v in hits_at.items()}
        with open(os.path.join(config.output_dir, "retrieval_summary.json"), "w", encoding="utf-8") as f:
            json.dump(summary, f, indent=2)
        trace.dump(os.path.join(config.output_dir, "trace.json"))
        logger.info("Retrieval-only summary %s -> %s", summary, config.output_dir)
        return results

    solutions = rag.try_answer(queries)

    golds = [gold_answers_of(s) for s in samples]
    results = []
    for idx, (query, solution) in enumerate(zip(queries, solutions)):
        solution.gold_answers = golds[idx]
        results.append(
            {"idx": idx, "question": query, "golden_answers": golds[idx], "output": solution.answer}
        )

    os.makedirs(config.output_dir, exist_ok=True)
    with open(os.path.join(config.output_dir, "results.json"), "w", encoding="utf-8") as f:
        json.dump(results, f, ensure_ascii=False, indent=2)
    logger.info("Wrote %d results to %s", len(results), config.output_dir)
    return results


def main() -> None:
    parser = argparse.ArgumentParser(description="Run ComoRAG (PyTorch port) over a dataset directory tree")
    parser.add_argument("--base_path", required=True, help="dir with per-subset subdirs (corpus.jsonl + qas.jsonl), or one such dir")
    parser.add_argument("--llm_name", default="gpt-4o-mini")
    parser.add_argument("--llm_base_url", default=None)
    parser.add_argument("--llm_api_key", default=os.environ.get("OPENAI_API_KEY"))
    parser.add_argument("--embedding_model_name", default="hash")
    parser.add_argument("--embedding_batch_size", type=int, default=32)
    parser.add_argument("--need_cluster", action="store_true", default=True)
    parser.add_argument("--no_cluster", dest="need_cluster", action="store_false")
    parser.add_argument("--is_mc", action="store_true")
    parser.add_argument("--output_dir", default="result/run")
    parser.add_argument("--save_dir", default="outputs/run")
    parser.add_argument("--max_meta_loop_iterations", type=int, default=5)
    parser.add_argument("--max_tokens_ver", type=int, default=2000)
    parser.add_argument("--max_tokens_sem", type=int, default=2000)
    parser.add_argument("--max_tokens_epi", type=int, default=2000)
    parser.add_argument("--embedding_dtype", default="float32", choices=["float32", "bfloat16", "int8"],
                        help="retrieval index storage/scoring dtype (int8: per-row quantized rows)")
    parser.add_argument("--topk_method", default="xla", choices=["xla", "pallas"],
                        help="'pallas': the streaming MIPS top-k kernels (csrc/mips_topk.cu) on --device cuda")
    parser.add_argument("--scan_dtype", default=None, choices=["int8", "bfloat16"],
                        help="certified two-pass retrieval scan (default: the config's 'auto')")
    parser.add_argument("--retrieval_only", action="store_true",
                        help="skip the LLM answer loop; dump tri-layer retrieval per question")
    parser.add_argument("--mesh_shape", default=None,
                        help="device mesh for sharded retrieval, e.g. 'corpus=8' or 'data=2,corpus=4', and "
                             "tensor-parallel generation of an in-process LLM, e.g. 'model=2'; over every card "
                             "with --device cuda, over the CPU repeated with --device cpu")
    parser.add_argument("--speculative_decoding", action="store_true",
                        help="in-process engine (jax-offline, jax-tiny, jax:<ckpt>): prompt-lookup speculative decoding")
    parser.add_argument("--device", default="cuda",
                        help="torch device: 'cuda' (default; fails without a card) or 'cpu'")
    args = parser.parse_args()

    mesh_shape = None
    if args.mesh_shape:
        try:
            mesh_shape = parse_mesh_shape(args.mesh_shape)
        except ValueError as e:
            parser.error(f"--mesh_shape must look like 'corpus=8' or 'data=2,corpus=4': {e}")

    config = ComoConfig(
        llm_name=args.llm_name,
        llm_base_url=args.llm_base_url,
        llm_api_key=args.llm_api_key,
        embedding_model_name=args.embedding_model_name,
        embedding_batch_size=args.embedding_batch_size,
        need_cluster=args.need_cluster,
        is_mc=args.is_mc,
        output_dir=args.output_dir,
        save_dir=args.save_dir,
        max_meta_loop_iterations=args.max_meta_loop_iterations,
        max_tokens_ver=args.max_tokens_ver,
        max_tokens_sem=args.max_tokens_sem,
        max_tokens_epi=args.max_tokens_epi,
        embedding_dtype=args.embedding_dtype,
        topk_method=args.topk_method,
        scan_dtype=args.scan_dtype,
        mesh_shape=mesh_shape,
        speculative_decoding=args.speculative_decoding,
    )

    base = args.base_path
    if os.path.exists(os.path.join(base, "corpus.jsonl")):
        subset_paths = [base]
    else:
        subset_paths = sorted(
            os.path.join(base, d) for d in os.listdir(base) if os.path.isdir(os.path.join(base, d))
        )
    for path in subset_paths:
        sub = copy.deepcopy(config)
        sub.output_dir = os.path.join(config.output_dir, os.path.basename(path))
        sub.save_dir = os.path.join(config.save_dir, os.path.basename(path))
        process_dataset(path, sub, device=args.device, retrieval_only=args.retrieval_only)


if __name__ == "__main__":
    main()
