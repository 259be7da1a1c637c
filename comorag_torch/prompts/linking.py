"""Instruction strings prepended to queries per linking mode.

Same retrieval-instruction contract as the reference (prompts/linking.py):
the encoder embeds queries under a task instruction so query and target
spaces align.

Copy of ``comorag_tpu/prompts/linking.py`` for the port, which imports nothing of the JAX package.
"""

_INSTRUCTIONS = {
    "ner_to_node": "Given a phrase, retrieve synonymous or relevant phrases that best match this phrase.",
    "query_to_node": "Given a question, retrieve relevant phrases that are mentioned in this question.",
    "query_to_fact": "Given a question, retrieve relevant triplet facts that matches this question.",
    "query_to_sentence": "Given a question, retrieve relevant sentences that best answer the question.",
    "query_to_passage": "Given a question, retrieve relevant documents that best answer the question.",
}

_DEFAULT = _INSTRUCTIONS["query_to_passage"]


def get_query_instruction(linking_method: str) -> str:
    return _INSTRUCTIONS.get(linking_method, _DEFAULT)
