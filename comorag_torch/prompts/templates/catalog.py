"""All prompt templates, registered explicitly.

Protocol parity with the reference's templates/ directory (each template
keeps the same placeholders, output markers, and parsing contract —
``{"named_entities": ...}``, ``{"triples": ...}``, ``{"probe_N": ...}``,
``### Final Answer`` with the ``*`` impasse sentinel, "Key Finding" lists) —
the wording is this framework's own.

Copy of ``comorag_tpu/prompts/templates/catalog.py`` for the port, which imports nothing of the JAX package.
"""

# --------------------------------------------------------------------- NER
_NER_SYSTEM = (
    "You extract named entities from a paragraph of text.\n"
    'Reply with a JSON object: {"named_entities": [<entity>, ...]}.\n'
    "Include people, places, organizations, dates, titles, and concrete objects."
)

_NER_EXAMPLE_PASSAGE = (
    "Orion Books\n"
    "Orion Books is a publishing house founded in London on 14 March 1991.\n"
    "It publishes fiction and non-fiction, and in June 2010 it launched an\n"
    "e-book storefront called OrionDigital.com offering novels, audiobooks,\n"
    "and reading-club guides."
)

_NER_EXAMPLE_OUTPUT = (
    '{"named_entities":\n'
    '    ["Orion Books", "London", "14 March 1991", "June 2010", "OrionDigital.com"]\n'
    "}"
)

ner = [
    {"role": "system", "content": _NER_SYSTEM},
    {"role": "user", "content": _NER_EXAMPLE_PASSAGE.replace("$", "$$")},
    {"role": "assistant", "content": _NER_EXAMPLE_OUTPUT.replace("$", "$$")},
    {"role": "user", "content": "${passage}"},
]

# --------------------------------------------------------------- NER (query)
ner_query = [
    {"role": "system", "content": "You are a precise entity extraction system."},
    {
        "role": "user",
        "content": (
            "Extract every named entity that matters for answering the question below.\n"
            "Reply with a JSON object.\n\n"
            "Question: Which lake is larger, Lake Mead or Lake Powell?\n"
        ),
    },
    {"role": "assistant", "content": '{"named_entities": ["Lake Mead", "Lake Powell"]}'},
    {"role": "user", "content": "Question: ${query}"},
]

# ------------------------------------------------------------------ triples
_TRIPLE_SYSTEM = (
    "You build a knowledge graph from a passage and its named-entity list.\n"
    'Reply with a JSON object: {"triples": [[subject, predicate, object], ...]}.\n'
    "Rules:\n"
    "- Every triple should mention at least one (ideally two) listed entities.\n"
    "- Resolve pronouns to the names they refer to.\n"
)

_TRIPLE_FRAME = (
    "Convert the paragraph into a JSON dict holding a named entity list and a triple list.\n"
    "Paragraph:\n"
    "```\n"
    "{passage}\n"
    "```\n\n"
    "{named_entity_json}\n"
)

_TRIPLE_EXAMPLE_OUTPUT = (
    '{"triples": [\n'
    '    ["Orion Books", "is a", "publishing house"],\n'
    '    ["Orion Books", "founded in", "London"],\n'
    '    ["Orion Books", "founded on", "14 March 1991"],\n'
    '    ["Orion Books", "launched", "OrionDigital.com"],\n'
    '    ["OrionDigital.com", "launched in", "June 2010"],\n'
    '    ["OrionDigital.com", "offers", "novels"],\n'
    '    ["OrionDigital.com", "offers", "audiobooks"]\n'
    "]}"
)

triple_extraction = [
    {"role": "system", "content": _TRIPLE_SYSTEM},
    {
        "role": "user",
        "content": _TRIPLE_FRAME.format(
            passage=_NER_EXAMPLE_PASSAGE, named_entity_json=_NER_EXAMPLE_OUTPUT
        ).replace("$", "$$"),
    },
    {"role": "assistant", "content": _TRIPLE_EXAMPLE_OUTPUT.replace("$", "$$")},
    {
        "role": "user",
        "content": _TRIPLE_FRAME.replace("{passage}", "${passage}").replace(
            "{named_entity_json}", "${named_entity_json}"
        ),
    },
]

# ------------------------------------------------------------- QA (narrative)
_QA_SYSTEM = (
    "You read long narrative texts carefully, extract details, and reason about them.\n\n"
    "Given retrieved article content and a question, answer from the given\n"
    "information only, using the shortest answer the text supports.\n\n"
    "Response format:\n"
    '1. Begin with "### Content Understanding": at most two sentences on what the content covers.\n'
    '2. Then "### Relevant Information Analysis": a short markdown list of plausibly relevant\n'
    "   information from the content. Do not invent anything.\n"
    '3. Then "### Key Facts": a concise markdown list of only the facts that directly answer\n'
    "   the question.\n"
    '4. End with "### Final Answer" followed by the shortest possible answer taken from the\n'
    '   text. Write numbers as English words. If the content does not contain enough\n'
    '   information for a confident answer, write exactly "*".'
)

_QA_ONESHOT_DOCS = (
    "Title: Harbor Light Museum\n"
    "The Harbor Light Museum opened in 1902 inside a decommissioned lighthouse. "
    "Its founding curator, Edith Marsh, assembled the first maritime collection.\n"
    "Title: Edith Marsh\n"
    "Edith Marsh was a naturalist and archivist. She directed the Harbor Light "
    "Museum until 1931, when she retired to write field guides.\n"
)

_QA_ONESHOT_INPUT = _QA_ONESHOT_DOCS + "\n\nQuestion: When did the museum Edith Marsh directed open?"

_QA_ONESHOT_OUTPUT = (
    "### Content Understanding\n"
    "The content describes the Harbor Light Museum and its founding curator Edith Marsh.\n\n"
    "### Relevant Information Analysis\n"
    "- Edith Marsh directed the Harbor Light Museum until 1931\n"
    "- The Harbor Light Museum opened in 1902\n\n"
    "### Key Facts\n"
    "- Museum directed by Edith Marsh: Harbor Light Museum\n"
    "- Harbor Light Museum opening year: 1902\n\n"
    "### Final Answer\n"
    "nineteen hundred and two."
)

rag_qa_narrativeqa = [
    {"role": "system", "content": _QA_SYSTEM},
    {"role": "user", "content": _QA_ONESHOT_INPUT},
    {"role": "assistant", "content": _QA_ONESHOT_OUTPUT},
    {"role": "user", "content": "${prompt_user}"},
]

# ---------------------------------------------------------- QA (multi-choice)
# Protocol parity (rag_qa_mc.py:54 / rag_qa_mc_memory.py:53): the answer
# is the BRACKETED OPTION ONLY — '[A]'..'[D]', no option text (eval EM
# compares against letter golds) — and the '*' impasse exists only in the
# MEMORY variant; the reference's iteration-0 MC template has no impasse.
_QA_MC_SYSTEM = (
    "You answer multiple-choice questions about long narrative texts using the\n"
    "retrieved content provided.\n\n"
    "Response format:\n"
    '1. "### Content Understanding": at most two sentences.\n'
    '2. "### Relevant Information Analysis": short markdown list from the content only.\n'
    '3. "### Key Facts": the facts that decide between the options.\n'
    '4. "### Final Answer": the single best option in the format of [A] or\n'
    "   [B] or [C] or [D], without explaining why."
)

rag_qa_mc = [
    {"role": "system", "content": _QA_MC_SYSTEM},
    {"role": "user", "content": "${prompt_user}"},
]

_QA_MC_MEMORY_SYSTEM = (
    _QA_MC_SYSTEM
    + '\n   If the content cannot decide, only output "*".'
    + "\n\nA \"### Historical Information\" section may appear: it holds findings\n"
    "accumulated from earlier reasoning rounds (probe -> finding pairs). Treat it\n"
    "as trusted working memory and combine it with the retrieved content."
)

rag_qa_mc_memory = [
    {"role": "system", "content": _QA_MC_MEMORY_SYSTEM},
    {"role": "user", "content": "${prompt_user}"},
]

# ------------------------------------------------------------- memory fusion
_MEMORY_FUSION_SYSTEM = (
    "You are a narrative analyst. Given a question and retrieved narrative\n"
    "content, distill the content into the findings that matter for the question.\n\n"
    "Consider explicit statements, implications, chronology, and cause-effect.\n\n"
    "Response format — up to 5 lines, each:\n"
    "- Key Finding: <information relevant to answering the question>"
)

memory_fusion = [
    {"role": "system", "content": _MEMORY_FUSION_SYSTEM},
    {"role": "user", "content": "Questions:\n${query}\n\nContent:\n${content}\n\nYour Response: "},
]

# --------------------------------------------------------------- node fusion
_NODE_FUSION_SYSTEM = (
    "You are a narrative synthesis specialist. You receive notes produced by\n"
    "earlier analysis rounds (\"Previous Analysis\") and a current query.\n"
    "Integrate the previous findings into one coherent, flowing response that\n"
    "addresses the current query, keeping continuity with what was already\n"
    "established and surfacing any new insight the combination reveals."
)

node_fusion = [
    {"role": "system", "content": _NODE_FUSION_SYSTEM},
    {"role": "user", "content": "Previous Analysis:\n${content}\n\nCurrent Query:\n${query}\n\nYour Response: "},
]

# -------------------------------------------------------------------- probes
_PROBE_SYSTEM = (
    "You generate retrieval probes: short, entity-focused search queries that\n"
    "broaden evidence coverage for a question over a narrative corpus.\n\n"
    "Inputs: the original query, available context, and probes from earlier\n"
    "rounds (possibly empty).\n\n"
    "Generate UP TO 3 new probes that:\n"
    "- target concrete entities (characters, objects, locations, events) NOT\n"
    "  covered by previous probes — entity coverage first;\n"
    "- are semantically distinct from every previous probe;\n"
    "- each explore a different information dimension;\n"
    "- stay directly relevant to answering the original query.\n\n"
    "If no previous probes exist: probe_1 targets the query's primary entities,\n"
    "probe_2 secondary/related entities, probe_3 contextual or background\n"
    "entities that might contain the answer. Avoid abstract or overly broad\n"
    "probes; prefer names and specific scenes.\n\n"
    "Output format (JSON only):\n"
    "{\n"
    ' "probe_1": "...",\n'
    ' "probe_2": "...",\n'
    ' "probe_3": "..."\n'
    "}"
)

agent_probe = [
    {"role": "system", "content": _PROBE_SYSTEM},
    {
        "role": "user",
        "content": (
            "Original Query:\n${query}\n\nContext:\n${context}\n\n"
            "Previous probes:\n${previous_probes}\n\nYour Response: "
        ),
    },
]

TEMPLATE_CATALOG = {
    "ner": ner,
    "ner_query": ner_query,
    "triple_extraction": triple_extraction,
    "rag_qa_narrativeqa": rag_qa_narrativeqa,
    "rag_qa_mc": rag_qa_mc,
    "rag_qa_mc_memory": rag_qa_mc_memory,
    "memory_fusion": memory_fusion,
    "node_fusion": node_fusion,
    "agent_probe": agent_probe,
}
