"""Synthetic training curriculum for the hermetic tiny decoder.

The reference ships frozen pretrained weights through vLLM
(llm/vllm_offline.py:26-97) — its answer quality comes from models this
repo cannot download (zero egress). The hermetic stack's quality floor was
therefore pinned to random weights, whose guided sampling can't even close
a JSON string. This module generates a deterministic
curriculum over in-repo synthetic narrative text that teaches a tiny
byte-vocab decoder the exact behaviors the pipeline's LLM call sites need:

  - ``ner`` / ``triples``: guided-JSON extraction in the DFA's canonical
    compact form (llm/guided.py) — entities copied from the passage;
  - ``qa``: the 4-section answer protocol ending ``### Final Answer`` with
    the shortest supported span (catalog.rag_qa_narrativeqa), including
    the ``*`` impasse sentinel when the context lacks the answer;
  - ``fusion`` / ``probe`` / ``summary``: the memory-consolidation,
    probe-generation, and summarization formats of the meta loop.

Every sample is rendered through the REAL prompt catalog + chat template
and tokenized/truncated exactly as the offline engine's ``_generate_batch`` does,
so the train and serve distributions match by construction. Loss applies
to completion tokens only (``loss_mask``).

Trained checkpoint recipe: scripts/train_tiny_lm.py (deterministic seed).

Port of ``comorag_tpu/models/curriculum.py``: the same generators (the
golden floors score with them), and the checkpoint reader and writer
without jax.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from comorag_torch.llm.offline import ByteTokenizer, render_chat
from comorag_torch.prompts.manager import PromptManager

_TOK = ByteTokenizer()
_PROMPTS = PromptManager()

FIRST = [
    "Alba", "Bryn", "Cedric", "Dalia", "Evander", "Freya", "Gideon", "Hesper",
    "Ilsa", "Jarek", "Katrin", "Leoric", "Mirela", "Nolan", "Ophira", "Pavel",
    "Quincy", "Rosalind", "Soren", "Tamsin",
]
SURNAME = [
    "Ashcombe", "Birchall", "Corwen", "Dunmore", "Ellery", "Fairweather",
    "Grimsby", "Hollis", "Ironwood", "Jessop", "Kirkwall", "Lockridge",
    "Marrow", "Nightingale", "Ormond", "Pellham", "Quarry", "Redfern",
    "Stavely", "Thorne",
]
PLACES = [
    "mill", "harbor", "orchard", "quarry", "archive", "forge", "lighthouse",
    "granary", "tannery", "brewery", "chapel", "market", "shipyard", "bakery",
]
ITEMS = [
    "ledger", "compass", "seedchest", "ironkey", "starchart", "bronzebell",
    "anvil", "lantern", "spyglass", "hourglass", "tinderbox", "mapcase",
]
TREASURES = [
    "lost scepter", "jade idol", "bronze tablet", "opal diadem",
    "silver astrolabe", "amber chalice", "gilded orrery", "onyx signet",
]
VAULTS = [
    "Szorvane", "Quellmire", "Ashentide", "Velgrath", "Umberfall",
    "Drossinger", "Northgale", "Wrenhollow", "Maravesse", "Oldenbrook",
]
LANDMARKS = [
    "Glasswing Tower", "Emberlight Obelisk", "Saltmarsh Beacon",
    "Hollowbrook Arch", "Thornfield Spire", "Winterglass Dome",
    "Cindervale Gate", "Mistral Column",
]
FILLER = [
    "The road was muddy after the long rain and the carts moved slowly past the fences.",
    "Traders argued about grain prices while children chased geese along the ditch.",
    "By evening the lamps were lit and the clerk recorded the day's totals.",
    "Nothing unusual was reported to the council and the watch changed at the ninth bell.",
    "A cold wind came off the water and the fishermen mended their nets in silence.",
    "Two oxen pulled the last wagon up the hill before the gates were barred.",
    "Smoke rose from the bakery chimneys while the miller weighed sacks at the scale.",
    "An old dog slept under the porch as rain dripped from the thatched eaves.",
]


def _name(rng) -> str:
    return f"{FIRST[rng.integers(len(FIRST))]} {SURNAME[rng.integers(len(SURNAME))]}"


def make_passage(rng) -> Tuple[str, List[str], List[List[str]]]:
    """One synthetic record: (text, entities-in-order, gold triples).

    Entity strings are RANDOM pool combinations plus per-sample random
    tokens (day numbers, relic ids), so the only winning policy is to
    copy them out of the passage — pool memorization can't solve it.
    """
    form = int(rng.integers(6))
    i = int(rng.integers(100_000))
    fillers = " ".join(
        FILLER[int(f)] for f in rng.choice(len(FILLER), size=int(rng.integers(3)), replace=False)
    )
    if form == 0:
        a, b = _name(rng), _name(rng)
        place, item, d = PLACES[rng.integers(len(PLACES))], ITEMS[rng.integers(len(ITEMS))], int(rng.integers(1, 365))
        text = (
            f"Record {i}: {a} visited the {place} on day {d} with {b} and "
            f"catalogued the {item} before returning along the river road at dusk."
        )
        ents = [a, str(d), b, item]
        triples = [[a, "visited", f"the {place}"], [a, "catalogued", item],
                   [a, "travelled with", b]]
    elif form == 1:
        tok = f"relic{int(rng.integers(1000)):03d}"
        place = PLACES[rng.integers(len(PLACES))]
        n = _name(rng)
        text = (
            f"Record {i}: the hidden {tok} was sealed inside the {place} vault "
            f"by the wandering cartographer {n}."
        )
        ents = [tok, n]
        triples = [[tok, "sealed inside", f"the {place} vault"],
                   [n, "sealed", tok]]
    elif form == 2:
        a, b = _name(rng), _name(rng)
        port, item = PLACES[rng.integers(len(PLACES))], ITEMS[rng.integers(len(ITEMS))]
        text = f"Record {i}: {a} sailed to the {port} carrying the {item} and met {b} at the {port}."
        ents = [a, item, b]
        triples = [[a, "sailed to", f"the {port}"], [a, "carried", item], [a, "met", b]]
    elif form == 3:
        t = TREASURES[rng.integers(len(TREASURES))] + f"{int(rng.integers(100)):02d}"
        vault = VAULTS[rng.integers(len(VAULTS))]
        text = f"Record {i}: the {t} rests within the forgotten {vault} cellar according to the oldest charts."
        ents = [t, vault]
        triples = [[t, "rests within", f"the {vault} cellar"]]
    elif form == 4:
        vault = VAULTS[rng.integers(len(VAULTS))]
        lm = LANDMARKS[rng.integers(len(LANDMARKS))]
        text = f"Record {i}: what towers over the {vault} catacomb is the {lm}, a sight every scribe praises."
        ents = [vault, lm]
        triples = [[lm, "towers over", f"the {vault} catacomb"]]
    else:
        a = _name(rng)
        place, d = PLACES[rng.integers(len(PLACES))], int(rng.integers(1, 365))
        text = f"Record {i}: {a} visited the {place} on day {d} and settled the accounts."
        ents = [a, str(d)]
        triples = [[a, "visited", f"the {place}"], [a, "settled", "the accounts"]]
    if fillers:
        text = text + " " + fillers
    return text, ents, triples


# ------------------------------------------------------------------ samples
def _ner_sample(rng) -> Tuple[str, str, Optional[str]]:
    text, ents, _ = make_passage(rng)
    messages = _PROMPTS.render("ner", passage=text)
    target = json.dumps({"named_entities": ents}, separators=(",", ":"))
    return render_chat(messages), target, "ner"


def _triples_sample(rng) -> Tuple[str, str, Optional[str]]:
    text, ents, triples = make_passage(rng)
    messages = _PROMPTS.render(
        "triple_extraction",
        passage=text,
        named_entity_json=json.dumps({"named_entities": ents}),
    )
    target = json.dumps({"triples": triples}, separators=(",", ":"))
    return render_chat(messages), target, "triples"


def _qa_context(rng, gold_text: str, n_distract: int) -> str:
    parts = [make_passage(rng)[0] for _ in range(n_distract)]
    parts.insert(int(rng.integers(len(parts) + 1)), gold_text)
    return "\n".join(parts)


def _qa_sample(rng) -> Tuple[str, str, Optional[str]]:
    """QA over a multi-record context; ~8% of samples are impasses (the
    gold record is withheld) so the '*' sentinel stays learnable.

    The target is built so EVERY generated span is a copy operation a
    small byte model can learn (after the first trained checkpoint
    hallucinated pool values in well-formed sections): the evidence line
    opens with the question's key entity (copyable from the question,
    which sits nearest the generation point) and then continues with the
    VERBATIM context continuation of that entity — textbook induction-
    head behavior — and the final answer is a substring of the line the
    model just wrote (short-range copy)."""
    form = int(rng.integers(3))
    if form == 0:
        tok = f"relic{int(rng.integers(1000)):03d}"
        place = PLACES[rng.integers(len(PLACES))]
        n = _name(rng)
        body = f"the hidden {tok} was sealed inside the {place} vault by the wandering cartographer {n}."
        question = f"Where was the hidden {tok} sealed by {n.split()[0]}?"
        # the line OPENS with the question's unique key: the first trained
        # checkpoint opened with boilerplate ("- the hidden relic…"), and
        # the induction match locked onto a DISTRACTOR record before the
        # discriminating id was emitted (wrong relic id/place copied, QA
        # 0.58); id-first makes the suffix match unambiguous at the point
        # the model starts copying
        line = f"- {tok} was sealed inside the {place} vault by the wandering cartographer {n}"
        answer = f"inside the {place} vault"
    elif form == 1:
        a = _name(rng)
        place, d = PLACES[rng.integers(len(PLACES))], int(rng.integers(1, 365))
        body = f"{a} visited the {place} on day {d} and settled the accounts."
        question = f"Which place did {a} visit on day {d}?"
        # day-first for the same reason: "on day 364, Cedric Pellham
        # visited the" carries the full question key before the copy point
        line = f"- on day {d}, {a} visited the {place}"
        answer = f"the {place}"
    else:
        vault = VAULTS[rng.integers(len(VAULTS))]
        lm = LANDMARKS[rng.integers(len(LANDMARKS))]
        body = f"what towers over the {vault} catacomb is the {lm}, a sight every scribe praises."
        question = f"Which monument marks the {vault} catacomb?"
        line = f"- the {vault} catacomb is the {lm}, a sight every scribe praises"
        answer = lm
    gold = f"Record {int(rng.integers(100_000))}: {body}"
    if rng.random() < 0.5:  # serve-time chunks often carry filler tails
        gold += " " + FILLER[int(rng.integers(len(FILLER)))]

    impasse = rng.random() < 0.12  # the '*' decision (absence detection) is
    # the hardest trained behavior — weight it above serve-time frequency
    ctx_gold = make_passage(rng)[0] if impasse else gold
    ver = _qa_context(rng, ctx_gold, n_distract=int(rng.integers(2, 5)))
    prompt_user = (
        f"### Detail Chunks\n{ver}\n\n### Semantic Summary\n\n\n"
        f"### Timeline Summary\n\n\nQuestion: {question}\nThought: "
    )
    messages = _PROMPTS.render("rag_qa_narrativeqa", prompt_user=prompt_user)
    if impasse:
        target = (
            "### Content Understanding\nThe content describes daily records.\n\n"
            "### Relevant Information Analysis\n- no record answers the question\n\n"
            "### Key Facts\n- none\n\n### Final Answer\n*"
        )
    else:
        target = (
            "### Content Understanding\nThe content describes daily records.\n\n"
            f"### Relevant Information Analysis\n{line}\n\n"
            f"### Key Facts\n{line}\n\n### Final Answer\n{answer}"
        )
    return render_chat(messages), target, None


def _fusion_sample(rng) -> Tuple[str, str, Optional[str]]:
    text, ents, triples = make_passage(rng)
    extra = make_passage(rng)[0]
    q = f"What do the records say about {ents[0]}?"
    messages = _PROMPTS.render("memory_fusion", query=q, content=text + "\n" + extra)
    findings = "\n".join(
        f"- Key Finding: {s} {p} {o}" for s, p, o in triples[:3]
    )
    return render_chat(messages), findings, None


def _probe_sample(rng) -> Tuple[str, str, Optional[str]]:
    text, ents, _ = make_passage(rng)
    q = f"Where was the {ents[-1]} last seen?"
    messages = _PROMPTS.render(
        "agent_probe", query=q, context=text, previous_probes=""
    )
    probes = {
        "probe_1": f"{ents[0]} location",
        "probe_2": f"{ents[-1]} records",
        "probe_3": f"events involving {ents[0]}",
    }
    return render_chat(messages), json.dumps(probes), None


def _summary_sample(rng) -> Tuple[str, str, Optional[str]]:
    texts = [make_passage(rng) for _ in range(int(rng.integers(2, 4)))]
    context = "\n".join(t for t, _, _ in texts)
    messages = [
        {"role": "system", "content": "You are a helpful assistant."},
        {
            "role": "user",
            "content": "Write a summary of the following, including as many key details as possible: "
            + context,
        },
    ]
    lines = [f"{tr[0][0]} {tr[0][1]} {tr[0][2]}." for _, _, tr in texts if tr]
    return render_chat(messages), "Summary: " + " ".join(lines), None


_TASKS = (
    ("ner", _ner_sample, 0.22),
    ("triples", _triples_sample, 0.22),
    ("qa", _qa_sample, 0.34),
    ("fusion", _fusion_sample, 0.08),
    ("probe", _probe_sample, 0.06),
    ("summary", _summary_sample, 0.08),
)


def make_sample(rng, task: Optional[str] = None) -> Dict[str, object]:
    """One (prompt, completion) pair: {prompt, completion, task, template}.
    ``template`` names the guided-JSON schema the completion must satisfy
    (train targets are asserted in-grammar at generation time)."""
    if task is None:
        r = rng.random()
        acc = 0.0
        for name, fn, w in _TASKS:
            acc += w
            if r < acc:
                task = name
                break
        else:
            task = _TASKS[-1][0]
    fn = dict((n, f) for n, f, _ in _TASKS)[task]
    prompt, completion, template = fn(rng)
    return {"prompt": prompt, "completion": completion, "task": task, "template": template}


# ----------------------------------------------------------------- encoding
def encode_sample(
    sample: Dict[str, object], seq_len: int, max_new: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ids, mask, loss_mask), each [seq_len] — tokenized and LEFT-truncated
    exactly as TorchOfflineLLM._generate_batch does (prompt keeps its tail,
    and the prompt limit uses the same seq_len − max_new_bucket rule the
    engine applies, so train and serve see identical truncated views),
    with the completion + EOS appended and loss restricted to it."""
    prompt_ids = [_TOK.bos_token_id] + _TOK.encode(str(sample["prompt"]))
    comp_ids = _TOK.encode(str(sample["completion"]))[: max_new - 1] + [_TOK.eos_token_id]
    # serve-time prompt limit: the engine rounds max_new up to a
    # _NEW_TOKEN_BUCKETS entry (384 -> 512) before sizing the prompt room
    bucket = 64
    while bucket < max_new:
        bucket *= 2
    # same floor as the engine: limit = max(window - max_new_bucket, 64)
    limit = max(min(seq_len - bucket, seq_len - len(comp_ids)), 64)
    comp_ids = comp_ids[: seq_len - limit]  # tiny windows: clamp completion
    prompt_ids = prompt_ids[-limit:]
    ids = prompt_ids + comp_ids
    n = len(ids)
    out = np.full(seq_len, _TOK.pad_token_id, np.int32)
    mask = np.zeros(seq_len, np.int32)
    loss = np.zeros(seq_len, np.float32)
    # LEFT padding (decoder.py contract): content occupies the tail
    out[seq_len - n :] = ids
    mask[seq_len - n :] = 1
    loss[seq_len - len(comp_ids) :] = 1.0
    return out, mask, loss


def sample_batch(
    rng, batch: int, seq_len: int, max_new: int = 384
) -> Dict[str, np.ndarray]:
    ids = np.zeros((batch, seq_len), np.int32)
    mask = np.zeros((batch, seq_len), np.int32)
    loss = np.zeros((batch, seq_len), np.float32)
    for i in range(batch):
        ids[i], mask[i], loss[i] = encode_sample(make_sample(rng), seq_len, max_new)
    return {"ids": ids, "mask": mask, "loss_mask": loss}


# -------------------------------------------------------------- eval helpers
def eval_sample(rng, task: str) -> Dict[str, object]:
    """A held-out sample plus the fields needed to score a generation."""
    return make_sample(rng, task)


# ------------------------------------------------------------- checkpointing
def save_tiny_checkpoint(path: str, params, arch) -> None:
    """One-file npz checkpoint (float16 storage) of a nested dict of torch
    tensors or numpy arrays, keys joined with "/" as the JAX package's
    writer joins its tree paths."""
    import dataclasses

    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        else:
            arr = node.detach().cpu().float().numpy() if hasattr(node, "detach") else np.asarray(node)
            flat[prefix] = arr.astype(np.float16)

    walk(params, "")
    flat["__arch__"] = np.frombuffer(json.dumps(dataclasses.asdict(arch)).encode(), dtype=np.uint8)
    np.savez_compressed(path, **flat)


def load_tiny_checkpoint(path: str):
    """(params as a numpy tree, arch) from ``save_tiny_checkpoint`` output."""
    from comorag_torch.models.decoder import DecoderArch

    with np.load(path) as z:
        meta = json.loads(bytes(z["__arch__"]).decode())
        if isinstance(meta.get("rope_scaling"), list):
            meta["rope_scaling"] = tuple(meta["rope_scaling"])
        arch = DecoderArch(**meta)
        params: Dict[str, object] = {}
        for key in z.files:
            if key == "__arch__":
                continue
            node = params
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(z[key], np.float32)
    return params, arch


TINY_CHECKPOINT = "assets/tiny_lm.npz"  # repo-relative committed artifact


def default_checkpoint_path() -> str:
    import os

    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), TINY_CHECKPOINT)
