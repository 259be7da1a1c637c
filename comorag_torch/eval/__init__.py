"""Copy of ``comorag_tpu/eval/__init__.py`` for the port, which imports nothing of the JAX package."""

from comorag_torch.eval.qa_eval import exact_match_scores, extract_final_answer, f1_scores

__all__ = ["exact_match_scores", "f1_scores", "extract_final_answer"]
