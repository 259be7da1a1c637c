"""QA evaluation: exact match + token-level F1 with max-aggregation over
gold aliases, answer extraction from the '### Final Answer' protocol, and
results merging.

Capability parity with the reference's eval harness (script/eval_qa.py):
same normalization (SQuAD-style), same metrics, same artifact set
(evaluation_summary / detailed results / answer extraction dumps), same
``**/*results*.json`` merge behavior.

Copy of ``comorag_tpu/eval/qa_eval.py`` for the port, which imports nothing of the JAX package.
Run it as ``python -m comorag_torch.eval.qa_eval <results_dir>``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from comorag_torch.utils.text import normalize_answer


def extract_final_answer(output_text: str) -> str:
    if not output_text:
        return ""
    marker = "### Final Answer"
    pos = output_text.rfind(marker)
    if pos == -1:
        return output_text.strip()
    return output_text[pos + len(marker) :].strip()


def exact_match_scores(
    gold_answers: Sequence[Sequence[str]], predicted: Sequence[str]
) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
    assert len(gold_answers) == len(predicted)
    per_example = []
    for golds, pred in zip(gold_answers, predicted):
        scores = [1.0 if normalize_answer(g) == normalize_answer(pred) else 0.0 for g in golds]
        per_example.append({"ExactMatch": max(scores) if scores else 0.0})
    avg = float(np.mean([e["ExactMatch"] for e in per_example])) if per_example else 0.0
    return {"ExactMatch": avg}, per_example


def _token_f1(gold: str, pred: str) -> float:
    gold_tokens = normalize_answer(gold).split()
    pred_tokens = normalize_answer(pred).split()
    common = Counter(pred_tokens) & Counter(gold_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gold_tokens)
    return 2 * precision * recall / (precision + recall)


def f1_scores(
    gold_answers: Sequence[Sequence[str]], predicted: Sequence[str]
) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
    assert len(gold_answers) == len(predicted)
    per_example = []
    for golds, pred in zip(gold_answers, predicted):
        scores = [_token_f1(g, pred) for g in golds]
        per_example.append({"F1": max(scores) if scores else 0.0})
    avg = float(np.mean([e["F1"] for e in per_example])) if per_example else 0.0
    return {"F1": avg}, per_example


# The eval's OWN artifacts match the broad '*results*' merge glob; merging
# them back duplicates every example on rerun (and the answer_extraction
# rows score 0.0), silently dragging EM/F1 down run after run. The
# reference shares the glob AND the corruption; we exclude by filename.
_EVAL_ARTIFACTS = {
    "merged_results.json",
    "detailed_evaluation_results.json",
    "answer_extraction_results.json",
    "evaluation_summary.json",
}


def find_and_merge_results(root_path: str) -> List[dict]:
    merged: List[dict] = []
    for path in glob.glob(os.path.join(root_path, "**/*results*.json"), recursive=True):
        if os.path.basename(path) in _EVAL_ARTIFACTS:
            continue
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
            if isinstance(data, list):
                merged.extend(data)
        except (OSError, json.JSONDecodeError):
            continue
    return merged


def extract_answers(results: Sequence[dict]) -> Tuple[List[List[str]], List[str]]:
    golds, preds = [], []
    import logging

    logger = logging.getLogger(__name__)
    missing_pred = missing_gold = 0
    for item in results:
        gold = item.get("golden_answers", item.get("gold_answers", []))
        if not gold:
            missing_gold += 1
        golds.append(gold)
        if "output" in item:
            preds.append(extract_final_answer(item["output"]))
        elif "prediction" in item:
            preds.append(item["prediction"])
        elif "answer" in item:
            preds.append(item["answer"])
        else:
            # e.g. retrieval-only artifacts swept up by the merge glob —
            # they score 0.0 and silently poison the averages
            missing_pred += 1
            preds.append("")
    if missing_pred or missing_gold:
        logger.warning(
            "eval: %d items missing a prediction field and %d missing gold "
            "answers (scored 0.0) — check for stray *results*.json files "
            "in the merge tree", missing_pred, missing_gold,
        )
    return golds, preds


def evaluate_directory(root_path: str, output_path: str | None = None) -> Dict[str, float]:
    output_path = output_path or os.path.join(root_path, "evaluation_results")
    os.makedirs(output_path, exist_ok=True)
    merged = find_and_merge_results(root_path)
    if not merged:
        raise FileNotFoundError(f"no *results*.json under {root_path}")
    with open(os.path.join(output_path, "merged_results.json"), "w", encoding="utf-8") as f:
        json.dump(merged, f, ensure_ascii=False, indent=2)

    golds, preds = extract_answers(merged)
    em_pooled, em_examples = exact_match_scores(golds, preds)
    f1_pooled, f1_examples = f1_scores(golds, preds)
    pooled = {**em_pooled, **f1_pooled}

    with open(os.path.join(output_path, "evaluation_summary.json"), "w", encoding="utf-8") as f:
        json.dump(pooled, f, ensure_ascii=False, indent=2)
    detailed = []
    for orig, em, f1, pred in zip(merged, em_examples, f1_examples, preds):
        item = dict(orig)
        item["extracted_answer"] = pred
        item.update(em)
        item.update(f1)
        detailed.append(item)
    with open(os.path.join(output_path, "detailed_evaluation_results.json"), "w", encoding="utf-8") as f:
        json.dump(detailed, f, ensure_ascii=False, indent=2)
    extraction = [
        {
            "idx": orig.get("idx", i),
            "question": orig.get("question", ""),
            "original_output": orig.get("output", orig.get("answer", "")),
            "extracted_answer": pred,
            "golden_answers": orig.get("golden_answers", orig.get("gold_answers", [])),
        }
        for i, (orig, pred) in enumerate(zip(merged, preds))
    ]
    with open(os.path.join(output_path, "answer_extraction_results.json"), "w", encoding="utf-8") as f:
        json.dump(extraction, f, ensure_ascii=False, indent=2)
    return pooled


def main() -> None:
    parser = argparse.ArgumentParser(description="QA evaluation: merge results, compute EM + F1")
    parser.add_argument("root_path", help="directory containing *results*.json files")
    parser.add_argument("--output", "-o", default=None)
    args = parser.parse_args()
    pooled = evaluate_directory(args.root_path, args.output)
    print(json.dumps(pooled, indent=2))


if __name__ == "__main__":
    main()
