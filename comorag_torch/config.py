"""Single configuration object for the whole framework.

Capability parity with the reference's ``BaseConfig``
(``utils/config_utils.py:17-298`` of the reference) — same knobs, same
defaults where the reference's defaults are the ones actually exercised —
plus TPU-specific fields (mesh shape, dtype, kernel tile sizes) that have no
reference counterpart.

Knobs the reference declares but never reads anywhere in its source
(``retrieval_top_k``, ``qa_top_k``, ``record_steps`` — verified by grep over
the reference's source) are intentionally NOT reproduced: dead surface is
documented here instead of carried.

Copy of ``comorag_tpu/config.py`` for the port, which imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, asdict
from typing import Any, Dict, Literal, Optional


@dataclass
class ComoConfig:
    # ------------------------------------------------------------------ LLM
    # (reference: config_utils.py:21-74)
    llm_name: str = "gpt-4o-mini"
    llm_base_url: Optional[str] = None
    llm_api_key: Optional[str] = None
    embedding_base_url: Optional[str] = None
    embedding_api_key: Optional[str] = None
    max_new_tokens: Optional[int] = 2048
    num_gen_choices: int = 1
    seed: Optional[int] = None
    temperature: float = 0.0
    response_format: Optional[dict] = None
    max_retry_attempts: int = 5
    # jax-offline engine only: self-speculative (prompt-lookup) decoding —
    # greedy-exact, commits multiple tokens per device step when the
    # output echoes the prompt (consumed by llm.get_llm)
    speculative_decoding: bool = False

    # ------------------------------------------------------- rerank / graph
    # (reference: config_utils.py:76-124, 151-171)
    rerank_dspy_file_path: Optional[str] = None
    passage_node_weight: float = 0.05
    save_openie: bool = True
    need_cluster: bool = True  # reference default False crashes at init (ComoRAG.py:157); True is the exercised path
    openie_mode: Literal["online", "offline"] = "online"
    skip_graph: bool = False
    synonymy_edge_topk: int = 2047
    synonymy_edge_query_batch_size: int = 1000
    synonymy_edge_key_batch_size: int = 10000
    synonymy_edge_sim_threshold: float = 0.8
    is_directed_graph: bool = False

    # ------------------------------------------------------------ embedding
    # (reference: config_utils.py:127-147)
    embedding_model_name: str = "hash"  # "hash" (hermetic), "bge:<hf-name>", "openai:<model>"
    embedding_batch_size: int = 32
    embedding_return_as_normalized: bool = True
    embedding_max_seq_len: int = 2048
    embedding_dim: int = 512  # used by the hermetic hash encoder
    embedding_dtype: Literal["float32", "bfloat16", "int8"] = "float32"  # index storage/scoring

    # ------------------------------------------------------------ retrieval
    # (reference: config_utils.py:175-187)
    linking_top_k: int = 5
    damping: float = 0.5

    # ------------------------------------------------------------------- QA
    # (reference: config_utils.py:190-257)
    max_meta_loop_iterations: int = 5
    qa_ver_top_k: int = 50
    qa_sem_top_k: int = 50
    qa_epi_top_k: int = 50
    is_mc: bool = False
    use_ver: bool = True
    use_sem: bool = True
    use_epi: bool = True
    max_tokens_ver: int = 3000
    max_tokens_sem: int = 1000
    max_tokens_epi: int = 1000
    # Completion cap for meta-loop QA/probe inferences. Besides bounding
    # the decode, it RAISES the offline engine's prompt limit (prompt
    # limit = window - generation bucket): without it the engine reserves
    # its full default max_new_tokens and left-truncates long QA prompts.
    qa_max_completion_tokens: int = 512

    # ------------------------------------------------------------ IO / dirs
    # (reference: config_utils.py:258-298)
    save_dir: Optional[str] = None
    output_dir: str = "./outputs/qa_results"
    dataset: Optional[str] = None
    corpus_len: Optional[int] = None

    # ------------------------------------------------------------ TPU-native
    # (no reference counterpart — these shape the device-side execution)
    mesh_shape: Optional[Dict[str, int]] = None  # e.g. {"data": 2, "corpus": 4}; None = all devices on "corpus"
    topk_method: Literal["xla", "pallas"] = "xla"  # "pallas" = fused streaming MIPS kernel (ops/pallas_topk.py)
    # two-pass serving: compressed scan + exact fp32 rescore. "auto" (the
    # default) resolves to "int8" on fp32 XLA indexes >=1024 rows
    # — exact results at ~2.3x single-pass fp32 throughput on a TPU v5e —
    # and to single-pass otherwise; None disables the scan copy entirely.
    scan_dtype: Optional[Literal["auto", "int8", "bfloat16"]] = "auto"
    topk_block_rows: int = 512        # corpus rows per Pallas tile in the MIPS kernel (benched default)
    # quantized KV cache for the in-process engine (vLLM kv_cache_dtype
    # counterpart): int8 per-(token, head) symmetric — halves/quarters the
    # decode loop's cache stream, which dominates past ~2.5k context
    kv_cache_dtype: Optional[Literal["int8"]] = None
    compute_dtype: Literal["float32", "bfloat16"] = "float32"
    ppr_max_iterations: int = 128     # power-iteration cap; damping 0.5 converges ~2^-128
    ppr_tolerance: float = 1e-10
    gmm_max_clusters: int = 50        # BIC sweep upper bound (cluster_utils.py:54 semantics)
    gmm_em_iterations: int = 60
    cluster_threshold: float = 0.01   # soft-membership threshold (ComoRAG.py:140)
    reduction_dimension: int = 10     # random-projection target dim (ComoRAG.py:139)
    cluster_seed: int = 224           # reference RANDOM_SEED (cluster_utils.py:17)
    # Token budget for a cluster-summary PROMPT context (highest-membership
    # texts first). The reference concatenates the whole cluster unbounded
    # (cluster_utils.py:563-568) — at 200k chunks a cluster context reaches
    # ~2 MB / ~500k tokens, beyond any model's window (documented quirk,
    # not reproduced). The default guards the pathological tail while
    # leaving moderate clusters whole; set it near the serving model's
    # window for small-context engines (jax-offline: 4096).
    summary_context_max_tokens: int = 60_000
    max_concurrent_llm: int = 16      # async LLM request pool width

    def __post_init__(self) -> None:
        if self.save_dir is None:
            self.save_dir = "outputs" if self.dataset is None else os.path.join("outputs", self.dataset)

    # -- convenience -------------------------------------------------------
    @property
    def working_dir(self) -> str:
        llm_label = self.llm_name.replace("/", "_")
        emb_label = self.embedding_model_name.replace("/", "_").replace(":", "_")
        return os.path.join(self.save_dir, f"{llm_label}_{emb_label}")

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ComoConfig":
        fields = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in fields})
