"""comorag_torch must run without jax (nor optax), without the JAX package
comorag_tpu (the port keeps its own copies of the host modules) and without
transformers (needed only for local HuggingFace checkpoints).

A subprocess installs a meta-path finder that raises ImportError for all
of them, imports every comorag_torch module (the generation engine, its
server and the decoder among them), runs the CLI's ``--help``, indexes and
answers the moonlantern set on the CPU with the hash encoder, runs one
short ``jax-tiny`` generation on one device and one over a ``model`` mesh
axis, and two steps of the training CLI on the CPU without a mesh and
over a data x model mesh, runs the root harness's dry run
(``comorag_torch.graft_entry.dryrun_multichip``, the port of
``__graft_entry__``, which is blocked too) over four CPU positions, imports
the tiny decoder's training recipe (scripts/torch_train_tiny_lm.py), and
checks that none of them was loaded.
httpx and pyarrow are not blocked: the host modules need them (the
OpenAI client, the parquet store), and the H100 machine has them installed.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import importlib, importlib.abc, os, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "optax", "transformers", "comorag_tpu", "__graft_entry__")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked in this test")
            return None

    sys.meta_path.insert(0, Block())

    import comorag_torch
    modules = [m.name for m in pkgutil.walk_packages(comorag_torch.__path__, "comorag_torch.")]
    for name in modules:
        importlib.import_module(name)
    new = {"comorag_torch.models.train", "comorag_torch.models.train_lm", "comorag_torch.cli.train",
           "comorag_torch.cli.chunk", "comorag_torch.eval", "comorag_torch.eval.qa_eval",
           "comorag_torch.parallel", "comorag_torch.parallel.mesh", "comorag_torch.parallel.distributed",
           "comorag_torch.graft_entry"}
    assert new <= set(modules), sorted(new - set(modules))

    from comorag_torch.cli import run
    sys.argv = ["run", "--help"]
    try:
        run.main()
    except SystemExit as e:
        assert e.code == 0, e.code

    from comorag_torch.config import ComoConfig
    tmp = os.environ["PORT_TMP"]
    cfg = ComoConfig(llm_name="fake", embedding_model_name="hash", embedding_dim=64,
                     save_dir=os.path.join(tmp, "save"), output_dir=os.path.join(tmp, "out"),
                     max_meta_loop_iterations=1, gmm_max_clusters=4, gmm_em_iterations=10)
    results = run.process_dataset(os.environ["PORT_DATA"], cfg, device="cpu")
    assert len(results) == 4 and all(r["output"] for r in results), results

    import comorag_torch.llm.offline, comorag_torch.llm.serving, comorag_torch.models.decoder
    from comorag_torch.llm import get_llm
    import torch
    from comorag_torch.parallel.mesh import build_mesh
    for mesh in (None, build_mesh({"model": 2}, [torch.device("cpu")] * 2)):
        llm = get_llm(ComoConfig(llm_name="jax-tiny", save_dir=tmp), device="cpu", mesh=mesh)
        reply = llm.infer([{"role": "user", "content": "Name the record."}], max_tokens=12)
        assert reply.metadata["finish_reason"] in ("stop", "length") and reply.metadata["completion_tokens"] > 0
        llm.close()

    import json
    from comorag_torch.cli import train
    pairs = os.path.join(tmp, "pairs.jsonl")
    with open(pairs, "w") as f:
        f.writelines(json.dumps({"query": f"q {i}", "passage": f"p {i}"}) + "\\n" for i in range(8))
    for mesh_args in ([], ["--mesh_shape", "data=2,model=2"]):
        summary = train.main(["--pairs", pairs, "--output_dir", os.path.join(tmp, "ckpt"), "--init", "tiny",
                              "--steps", "2", "--batch", "4", "--max_seq_len", "8", "--device", "cpu", *mesh_args])
        assert os.path.exists(summary["checkpoint"]), summary

    from comorag_torch import graft_entry
    assert graft_entry.dryrun_multichip(4, [torch.device("cpu")] * 4)["mesh"] == {"data": 2, "model": 2}

    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_train_tiny_lm", os.path.join(os.environ["PORT_REPO"], "scripts", "torch_train_tiny_lm.py"))
    recipe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(recipe)
    assert recipe.build_arch(2048).hidden_size == 256 and recipe.make_schedule(6e-4, 3000)(100) == 6e-4
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("OK", len(modules), "modules")
    """
)


def test_port_runs_without_jax_or_transformers(tmp_path):
    env = dict(os.environ, PORT_TMP=str(tmp_path), PORT_REPO=REPO,
               PORT_DATA=os.path.join(REPO, "dataset", "moonlantern", "moonlantern_1"),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK" in proc.stdout
