"""The golden floors of tests/test_tiny_trained.py, held by the port.

The trained tiny checkpoint (assets/tiny_lm.npz) served by TorchOfflineLLM
on the CPU must reach the floors random weights never reach: guided NER
JSON that parses and copies the passage's entities, triple yield, the
``### Final Answer`` protocol with the right span, and an end-to-end
``jax-tiny`` pipeline run whose F1 beats the fake LLM's on the same corpus.
The floors are the JAX package's; the sample counts are smaller (4 per
task, 2 planted questions among 8 records) so that the file stays quick.
"""

import json

import numpy as np
import pytest
import torch

from comorag_torch.llm.offline import TorchOfflineLLM
from comorag_torch.models import curriculum as cur

N = 4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Decoding runs thousands of small ops: two intra-op threads keep this
    file from contending with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    params, arch = cur.load_tiny_checkpoint(cur.default_checkpoint_path())
    return TorchOfflineLLM(params=params, arch=arch, temperature=0.0, max_new_tokens=384, device="cpu")


@pytest.fixture()
def rng():
    return np.random.default_rng(20260819)


def test_guided_ner_parses_and_copies_entities(engine, rng):
    samples = [cur.make_sample(rng, "ner") for _ in range(N)]
    outs = engine._generate_batch([s["prompt"] for s in samples], 256, "ner", 0.0)
    parsed, recalls = 0, []
    for s, r in zip(samples, outs):
        try:
            got = json.loads(r.text)["named_entities"]
        except (json.JSONDecodeError, KeyError):
            continue
        parsed += 1
        gold = json.loads(s["completion"])["named_entities"]
        recalls.append(len(set(got) & set(gold)) / max(1, len(gold)))
    assert parsed >= N - 1, f"only {parsed}/{N} guided NER outputs parsed"
    assert np.mean(recalls) >= 0.6, f"entity recall {np.mean(recalls):.2f}"


def test_guided_triples_yield(engine, rng):
    samples = [cur.make_sample(rng, "triples") for _ in range(N)]
    outs = engine._generate_batch([s["prompt"] for s in samples], 256, "triples", 0.0)
    parsed, nonempty = 0, 0
    for r in outs:
        try:
            got = json.loads(r.text)["triples"]
        except (json.JSONDecodeError, KeyError):
            continue
        parsed += 1
        nonempty += bool([t for t in got if len(t) == 3 and all(t)])
    assert parsed >= N - 1
    assert nonempty >= N * 0.6, f"triple yield {nonempty}/{N}"


def test_qa_final_answer_protocol(engine, rng):
    samples = [cur.make_sample(rng, "qa") for _ in range(N)]
    outs = engine._generate_batch([s["prompt"] for s in samples], 384, None, 0.0)
    marker, correct = 0, 0
    for s, r in zip(samples, outs):
        gold = str(s["completion"]).rsplit("### Final Answer", 1)[1].strip()
        if "### Final Answer" not in r.text:
            continue
        marker += 1
        pred = r.text.rsplit("### Final Answer", 1)[1].strip()
        correct += int(pred.startswith("*")) if gold == "*" else int(gold.lower() in pred.lower())
    assert marker >= N - 1, f"marker rate {marker}/{N}"
    assert correct >= N * 0.5, f"answer rate {correct}/{N}"


def test_end_to_end_beats_fake_llm_floor(tmp_path, rng):
    from comorag_torch.comorag import ComoRAG
    from comorag_torch.config import ComoConfig
    from comorag_tpu.eval.qa_eval import evaluate_directory

    chunks, qas = [], []
    for g in range(2):
        place, name, tok = cur.PLACES[g], cur._name(rng), f"relic{g:03d}"
        chunks.append(f"Record {g}: the hidden {tok} was sealed inside the {place} vault "
                      f"by the wandering cartographer {name}.")
        qas.append({"question": f"Where was the hidden {tok} sealed by {name.split()[0]}?",
                    "answer": [f"inside the {place} vault", f"the {place} vault"]})
    chunks += [cur.make_passage(rng)[0] for _ in range(6)]

    def run(llm_name):
        config = ComoConfig(llm_name=llm_name, embedding_model_name="hash", embedding_dim=1024, need_cluster=True,
                            save_dir=str(tmp_path / llm_name / "outputs"),
                            output_dir=str(tmp_path / llm_name / "results"), gmm_max_clusters=4,
                            gmm_em_iterations=10, max_meta_loop_iterations=1)
        rag = ComoRAG(config, device="cpu")
        rag.index(chunks)
        solutions = rag.try_answer([q["question"] for q in qas])
        if llm_name == "jax-tiny":
            assert len(rag.entity_store) > 0, "no entities extracted"
            assert len(rag.fact_store) > 0, "no triples extracted"
            rag.llm.close()
        out_dir = tmp_path / llm_name / "results"
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "results.json").write_text(json.dumps([
            {"idx": i, "question": q["question"], "golden_answers": q["answer"], "output": s.answer}
            for i, (q, s) in enumerate(zip(qas, solutions))]))
        return evaluate_directory(str(out_dir))["F1"]

    f1_tiny, f1_fake = run("jax-tiny"), run("fake")
    assert f1_tiny > f1_fake + 0.05, (f1_tiny, f1_fake)
    assert f1_tiny >= 0.5, f1_tiny
