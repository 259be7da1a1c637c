"""The port's copies of the chunk and eval CLIs give what the JAX
package's give: the same chunk files from one corpus jsonl, and the same
ExactMatch and F1 over one results tree (built as tests/test_eval_cli.py
builds it). The port's run as ``python -m``, as a user runs them."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from comorag_torch.eval import qa_eval as tqa
from comorag_tpu.cli import chunk as jchunk
from comorag_tpu.cli.run import process_dataset
from comorag_tpu.config import ComoConfig
from comorag_tpu.eval import qa_eval as jqa
from comorag_tpu.utils.jsonio import save_jsonl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DOCS = [
    "The Lantern, Captain Elara sailed the Windrose to the island of Karst. She searched for pearls! "
    "Did she find them? The hermit Dovan drew her a map of the northern caves.",
    "No title here just words that run on and on about the granary and the mill and the quiet river",
    "Wren's Letter, " + " ".join(f"Sentence number {i} tells of the harbor." for i in range(40)),
]


def run_port(module: str, *args: str, cwd) -> str:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


@pytest.mark.parametrize("chunk_by,size,overlap", [("word", 8, 0), ("word", 8, 3), ("sentence", 12, 0),
                                                   ("recursive", 10, 0), ("token", 16, 0)])
def test_chunk_cli_matches_jax(tmp_path, monkeypatch, chunk_by, size, overlap):
    corpus = tmp_path / "corpus.jsonl"
    save_jsonl([{"id": i, "contents": text} for i, text in enumerate(DOCS)], str(corpus))
    args = ["--chunk_by", chunk_by, "--chunk_size", str(size), "--overlap", str(overlap)]
    monkeypatch.setattr(sys, "argv", ["chunk", "--input_path", str(corpus),
                                      "--output_path", str(tmp_path / "jax.jsonl"), *args])
    jchunk.main()
    out = run_port("comorag_torch.cli.chunk", "--input_path", str(corpus),
                   "--output_path", str(tmp_path / "torch.jsonl"), *args, cwd=tmp_path)
    assert "chunks" in out
    ours, theirs = (tmp_path / "torch.jsonl").read_bytes(), (tmp_path / "jax.jsonl").read_bytes()
    assert ours == theirs and len(theirs.splitlines()) > len(DOCS)


def test_eval_cli_matches_jax(tmp_path):
    ds = tmp_path / "ds1"
    ds.mkdir()
    corpus = [
        "Captain Elara sailed the Windrose to the island of Karst in search of pearls.",
        "On Karst, Elara traded her compass for a map drawn by the hermit Dovan.",
        "Dovan's map led Elara to a cave where the black pearls grew on stone vines.",
        "Elara returned home and gave the largest pearl to her sister Wren.",
    ]
    qas = [
        {"id": "1", "question": "What did Elara trade for the map?", "golden_answers": ["her compass", "compass"]},
        {"id": "2", "question": "Who received the largest pearl?", "golden_answers": ["Wren", "her sister"]},
    ]
    save_jsonl([{"id": i, "contents": t} for i, t in enumerate(corpus)], str(ds / "corpus.jsonl"))
    save_jsonl(qas, str(ds / "qas.jsonl"))
    config = ComoConfig(llm_name="fake", embedding_model_name="hash", embedding_dim=64, need_cluster=True,
                        save_dir=str(tmp_path / "outputs"), output_dir=str(tmp_path / "results"),
                        max_meta_loop_iterations=1, gmm_max_clusters=3, gmm_em_iterations=15)
    assert len(process_dataset(str(ds), config)) == 2
    trees = {name: str(tmp_path / name) for name in ("jax", "torch", "torch_cli")}
    for tree in trees.values():
        shutil.copytree(config.output_dir, tree)

    theirs = jqa.evaluate_directory(trees["jax"])
    ours = tqa.evaluate_directory(trees["torch"])
    assert ours == theirs and theirs["F1"] > 0
    for name in ("evaluation_summary.json", "detailed_evaluation_results.json", "answer_extraction_results.json"):
        with open(os.path.join(trees["jax"], "evaluation_results", name)) as a, \
                open(os.path.join(trees["torch"], "evaluation_results", name)) as b:
            assert json.load(a) == json.load(b), name
    printed = run_port("comorag_torch.eval.qa_eval", trees["torch_cli"], cwd=tmp_path)
    assert json.loads(printed) == theirs
