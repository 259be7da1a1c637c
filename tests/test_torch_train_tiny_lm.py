"""The tiny decoder's training recipe on the port
(scripts/torch_train_tiny_lm.py) against the JAX package's
(scripts/train_tiny_lm.py).

The two packages draw different random numbers, so their checkpoints
cannot be bit-equal; instead, from the same weights and batches:
  - the host schedule equals optax's ``warmup_cosine_decay_schedule``;
  - the scheduled LM steps give JAX's loss at every step and JAX's weights,
    over the first steps and over a whole 300-step schedule;
  - a checkpoint resumes the schedule at its step;
  - the CLI writes a file the JAX package loads, with JAX's arch and the
    committed checkpoint's keys and shapes;
  - ``evaluate`` scores canned generations as JAX's does.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from comorag_torch.llm.offline import TorchOfflineLLM
from comorag_torch.models import curriculum as tcur
from comorag_torch.models import decoder as tdec
from comorag_torch.models import train as ttrain
from comorag_torch.models.train_lm import make_lm_train_step
from comorag_tpu.llm.jax_offline import JaxOfflineLLM
from comorag_tpu.models import curriculum as jcur
from comorag_tpu.models import decoder as jdec
from comorag_tpu.models import train as jtrain
from comorag_tpu.models import train_lm as jtrain_lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_train_tiny_lm.py")


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


recipe = load_script("torch_train_tiny_lm")
jax_recipe = load_script("train_tiny_lm")

# a narrow decoder on the recipe's vocabulary; the schedule over 20 steps
# warms up over 3, and K = 6 steps run past the warmup
ARCH = dict(vocab_size=259, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2, intermediate_size=128,
            max_seq_len=128)
SEQ, BATCH, LR, STEPS, SEED, K = 128, 2, 6e-4, 20, 0, 6
WARMUP = min(100, STEPS // 10 + 1)
CPU = torch.device("cpu")


def leaves(tree) -> dict:
    return {name: np.asarray(leaf.detach() if isinstance(leaf, torch.Tensor) else leaf)
            for name, leaf in ttrain.whole_leaves(tree)}


# ----------------------------------------------------------------- schedule
@pytest.mark.parametrize("steps", [20, 3000])
def test_schedule_equals_optax(steps):
    """At every count from 0 to steps + 10, warmup, decay and the constant
    tail; optax runs in float64, the host's precision (in fp32 its own
    rounding reaches 2e-6 in the warmup)."""
    warmup = min(100, steps // 10 + 1)
    ours = ttrain.warmup_cosine_decay_schedule(0.0, LR, warmup, steps, LR * 0.05)
    with jax.enable_x64(True):
        ref = np.asarray(optax.warmup_cosine_decay_schedule(0.0, LR, warmup, steps, LR * 0.05)(
            jnp.arange(steps + 11)))
    counts = range(steps + 11)
    np.testing.assert_allclose([ours(c) for c in counts], ref, rtol=1e-6, atol=0)
    assert [recipe.make_schedule(LR, steps)(c) for c in counts] == [ours(c) for c in counts]
    assert ours(0) == 0.0 and isinstance(ours(steps // 2), float)


# ------------------------------------------------------- K steps against JAX
@pytest.fixture(scope="module")
def jax_run():
    """JAX's recipe step (``make_lm_train_step`` with optax's AdamW under
    the schedule, JAX's decay mask) for WARMUP + K steps from
    ``init_params(PRNGKey(0))`` on the curriculum's batches."""
    arch = jdec.DecoderArch(**ARCH)
    schedule = optax.warmup_cosine_decay_schedule(0.0, LR, warmup_steps=WARMUP, decay_steps=STEPS,
                                                  end_value=LR * 0.05)
    optimizer = jtrain.make_optimizer(learning_rate=schedule)
    state = jtrain_lm.create_lm_train_state(jax.random.PRNGKey(SEED), arch, optimizer)
    step = jtrain_lm.make_lm_train_step(arch, optimizer)
    init = jax.tree.map(np.asarray, state.params)
    rng = np.random.default_rng(SEED + 1)
    batches, losses, after = [], [], []
    for _ in range(WARMUP + K):
        batch = jcur.sample_batch(rng, BATCH, SEQ)
        batches.append(batch)
        state, loss = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(loss))
        after.append(jax.tree.map(np.asarray, state.params))
    return {"init": init, "batches": batches, "losses": losses, "first": after[0], "last": after[-1]}


def port_state(init) -> ttrain.TrainState:
    params = tdec.params_from_jax(init, "cpu")
    return ttrain.TrainState(params, ttrain.make_optimizer(learning_rate=recipe.make_schedule(LR, STEPS))(params), 0)


def test_batches_equal_jax(jax_run):
    rng = np.random.default_rng(SEED + 1)
    for ref in jax_run["batches"]:
        got = tcur.sample_batch(rng, BATCH, SEQ)
        assert got.keys() == ref.keys()
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_scheduled_steps_match_jax(jax_run):
    """The recipe's loop (``train``) over the same weights and batches:
    every step's loss within rtol 1e-5 of JAX's; the first update (lr 0)
    moves no weight in either package; after WARMUP + K steps every weight
    within 1e-5 of JAX's (observed 6.3e-7; a decayed norm scale, 0.01 *
    sum(lr_t) = 3.9e-5 away, is caught)."""
    arch = tdec.DecoderArch(**ARCH)
    step_fn = make_lm_train_step(arch)
    init = leaves(jax_run["init"])
    first, _ = recipe.train(port_state(jax_run["init"]), step_fn, 1, BATCH, SEQ, SEED, CPU, log=lambda line: None)
    for name, value in leaves(first.params).items():
        np.testing.assert_array_equal(value, init[name], err_msg=name)
        np.testing.assert_array_equal(leaves(jax_run["first"])[name], init[name], err_msg=name)

    n = WARMUP + K
    lines = []
    state, run = recipe.train(port_state(jax_run["init"]), step_fn, n, BATCH, SEQ, SEED, CPU, log=lines.append)
    assert state.step == n and len(lines) == 2 and lines[0].startswith("step     0  loss ")
    np.testing.assert_allclose(run["losses"], jax_run["losses"], rtol=1e-5)
    schedule = recipe.make_schedule(LR, STEPS)
    assert state.opt_state.param_groups[0]["lr"] == schedule(n - 1)
    ref = leaves(jax_run["last"])
    for name, value in leaves(state.params).items():
        np.testing.assert_allclose(value, ref[name], rtol=0, atol=1e-5, err_msg=name)
    assert not np.array_equal(leaves(state.params)["lm_head"], init["lm_head"])


def port_run(init, arch_kwargs: dict, steps: int, seq: int, batch: int) -> tuple:
    """The port's recipe loop from the numpy tree ``init``: every step's
    loss and the final weights by name."""
    params = tdec.params_from_jax(init, "cpu")
    state = ttrain.TrainState(params, ttrain.make_optimizer(learning_rate=recipe.make_schedule(LR, steps))(params), 0)
    state, run = recipe.train(state, make_lm_train_step(tdec.DecoderArch(**arch_kwargs)), steps, batch, seq, SEED,
                              CPU, log=lambda line: None)
    return np.asarray(run["losses"]), leaves(state.params)


def long_runs(arch_kwargs: dict, steps: int, seq: int, batch: int) -> dict:
    """JAX's recipe step and the port's recipe loop for ``steps`` steps under
    the recipe's schedule over ``steps`` (warmup, the whole cosine decay),
    from JAX's ``init_params(PRNGKey(0))`` on the curriculum's batches: both
    packages' losses at every step, the largest weight gap at the end, and
    the initial weights."""
    schedule = optax.warmup_cosine_decay_schedule(0.0, LR, warmup_steps=min(100, steps // 10 + 1),
                                                  decay_steps=steps, end_value=LR * 0.05)
    arch = jdec.DecoderArch(**arch_kwargs)
    optimizer = jtrain.make_optimizer(learning_rate=schedule)
    state = jtrain_lm.create_lm_train_state(jax.random.PRNGKey(SEED), arch, optimizer)
    step = jtrain_lm.make_lm_train_step(arch, optimizer)
    init = jax.tree.map(np.asarray, state.params)
    rng = np.random.default_rng(SEED + 1)
    jax_losses = []
    for _ in range(steps):
        batch_np = jcur.sample_batch(rng, batch, seq)
        state, loss = step(state, {k: jnp.asarray(v) for k, v in batch_np.items()})
        jax_losses.append(float(loss))
    losses, ours = port_run(init, arch_kwargs, steps, seq, batch)
    ref = leaves(jax.tree.map(np.asarray, state.params))
    gap = max(float(np.abs(value - ref[name]).max()) for name, value in ours.items())
    return {"jax_losses": np.asarray(jax_losses), "losses": losses, "weight_gap": gap, "init": init,
            "weights": ours}


def test_whole_schedule_tracks_jax():
    """300 steps, the recipe's whole schedule over 300 (31 of warmup, then
    the decay to lr * 0.05), from the same weights on the same batches: the
    loss falls from 5.56 to ~2 in both packages, every step's within rtol
    5e-5 of JAX's (observed 1.1e-5), and every weight at the end within
    3e-5 (observed 7.6e-6; dropping the matrices' decay moves them ~8e-5)."""
    runs = long_runs(ARCH, 300, SEQ, BATCH)
    np.testing.assert_allclose(runs["losses"], runs["jax_losses"], rtol=5e-5)
    assert runs["weight_gap"] < 3e-5, runs["weight_gap"]
    assert runs["losses"][-20:].mean() < 0.5 * runs["losses"][0]


@pytest.fixture()
def one_thread():
    """The CPU embedding backward sums repeated ids in a thread-dependent
    order (1 ulp apart between runs): one thread makes two runs
    bit-comparable."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resume_continues_the_schedule(tmp_path, one_thread):
    """A state saved after 3 steps and loaded into a fresh one takes its
    4th update at schedule(3), bit-equal to the uninterrupted run's."""
    arch = recipe.build_arch(SEQ)
    step_fn = make_lm_train_step(arch)
    rng = np.random.default_rng(SEED + 1)
    batches = [{k: torch.from_numpy(v) for k, v in tcur.sample_batch(rng, 1, SEQ).items()} for _ in range(4)]
    state = recipe.create_state(arch, LR, STEPS, SEED, CPU)
    for batch in batches[:3]:
        state, _ = step_fn(state, batch)
    path = str(tmp_path / "state")
    ttrain.save_checkpoint(path, state)
    resumed = ttrain.load_checkpoint(path, recipe.create_state(arch, LR, STEPS, SEED + 7, CPU))
    assert resumed.step == 3
    state, _ = step_fn(state, batches[3])
    resumed, _ = step_fn(resumed, batches[3])
    rate = recipe.make_schedule(LR, STEPS)(3)
    assert rate > 0
    for s in (state, resumed):
        assert s.step == 4 and [g["lr"] for g in s.opt_state.param_groups] == [rate, rate]
    ours, theirs = leaves(state.params), leaves(resumed.params)
    for name in ours:
        np.testing.assert_array_equal(theirs[name], ours[name], err_msg=name)


# ---------------------------------------------------------------------- CLI
def test_cli_writes_a_checkpoint_jax_loads(tmp_path):
    """Four CPU steps through the script's own ``__main__``: the step lines,
    the saved file, the evaluation table with JAX's keys, no module of jax,
    optax or the JAX package loaded; the file loads in JAX with
    ``build_arch(256)`` and has the committed checkpoint's keys and
    shapes."""
    out = str(tmp_path / "tiny.npz")
    code = ("import runpy, sys; sys.argv = sys.argv[1:]; runpy.run_path(sys.argv[0], run_name='__main__'); "
            "loaded = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'comorag_tpu')); "
            "assert not loaded, loaded")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code, SCRIPT, "--device", "cpu", "--steps", "4", "--batch", "2",
                           "--seq", "256", "--out", out], cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("params: 6.03M  seq=256 batch=2"), lines[0]
    assert [line.split()[1] for line in lines if line.startswith("step ")] == ["0", "3"]
    assert any(line.startswith(f"saved {out}") for line in lines)
    table = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert set(table) == {"ner_parse_rate", "ner_entity_recall", "triples_parse_rate", "triples_nonempty_rate",
                          "triples_subject_recall", "qa_marker_rate", "qa_answer_rate"}

    params, arch = jcur.load_tiny_checkpoint(out)
    assert arch == jax_recipe.build_arch(256)
    with np.load(out) as ours, np.load(jcur.default_checkpoint_path()) as committed:
        assert set(ours.files) == set(committed.files)
        for key in committed.files:
            if key != "__arch__":
                assert ours[key].shape == committed[key].shape and ours[key].dtype == np.float16, key
    assert np.isfinite(params["lm_head"]).all()


def test_warm_start_takes_the_checkpoint_of_the_same_arch():
    """``--init``: the committed checkpoint's weights (the recipe's arch at
    S = 2048) replace the random ones; another arch is refused."""
    path = jcur.default_checkpoint_path()
    state = recipe.create_state(recipe.build_arch(2048), LR, STEPS, SEED, CPU, init=path)
    saved = leaves(tcur.load_tiny_checkpoint(path)[0])
    for name, value in leaves(state.params).items():
        np.testing.assert_array_equal(value, saved[name], err_msg=name)
    with pytest.raises(ValueError, match="arch mismatch"):
        recipe.create_state(recipe.build_arch(256), LR, STEPS, SEED, CPU, init=path)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a machine without a card")
def test_cli_on_cuda_without_a_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="cuda"):
        recipe.main(["--steps", "1", "--out", str(tmp_path / "never.npz")])
    assert not os.path.exists(tmp_path / "never.npz")


# ------------------------------------------------------------------ scoring
def canned_texts(seed: int, n: int) -> dict:
    """Each evaluation prompt's canned generation, by its draw's index i:
    the gold completion, a cut one (malformed JSON, no marker), a valid
    JSON that misses (a wrong entity, no triples, a wrong answer), neither
    JSON nor marker, and the ``*`` answer."""
    rng = np.random.default_rng(seed)
    wrong = {"ner": json.dumps({"named_entities": ["Nobody Atall"]}), "triples": json.dumps({"triples": []}),
             "qa": "### Final Answer Nobody Atall"}
    texts = {}
    for task, *_ in recipe.EVAL_TASKS:
        for i in range(n):
            sample = jcur.make_sample(rng, task)
            gold = str(sample["completion"])
            texts[sample["prompt"]] = (gold, gold[: len(gold) // 2], wrong[task], "no answer here",
                                       "### Final Answer *")[i % 5]
    return texts


def test_evaluate_scores_as_jax(monkeypatch):
    seed, n = 4242, 12
    texts = canned_texts(seed, n)

    def generate(self, prompts, max_tokens, json_template, temperature, id_rows=None):
        return [types.SimpleNamespace(text=texts[p]) for p in prompts]

    monkeypatch.setattr(JaxOfflineLLM, "_generate_batch", generate)
    monkeypatch.setattr(TorchOfflineLLM, "_generate_batch", generate)
    params = jax.tree.map(np.asarray, jdec.init_params(jax.random.PRNGKey(0), jdec.DecoderArch(**ARCH)))
    ref = jax_recipe.evaluate(params, jdec.DecoderArch(**ARCH), n_per_task=n, seed=seed)
    got = recipe.evaluate(params, tdec.DecoderArch(**ARCH), n_per_task=n, seed=seed, device="cpu")
    assert got == ref
    assert all(0.0 < got[k] < 1.0 for k in ("ner_parse_rate", "triples_parse_rate", "triples_nonempty_rate",
                                             "qa_marker_rate", "qa_answer_rate")), got


if __name__ == "__main__":
    # The long run at another size, e.g. the recipe's arch:
    #   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_train_tiny_lm.py --arch recipe --steps 1000 --seq 256 --batch 2
    # or JAX's initial weights of the recipe (PRNGKey(0), S = 2048) as a
    # checkpoint in fp32 for the port's ``--init``, so that a run on the card
    # starts where JAX's does:
    #   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_train_tiny_lm.py --write_jax_init build/jax_init.npz
    import argparse

    ap = argparse.ArgumentParser(description="JAX's recipe step against the port's over a whole schedule (CPU)")
    ap.add_argument("--arch", choices=("small", "recipe"), default="small")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--write_jax_init", default=None, metavar="PATH")
    args = ap.parse_args()
    if args.write_jax_init:
        arch = jax_recipe.build_arch(2048)
        init = jax.tree.map(np.asarray, jdec.init_params(jax.random.PRNGKey(SEED), arch))
        flat = {name.replace(".", "/"): value for name, value in leaves(init).items()}
        flat["__arch__"] = np.frombuffer(json.dumps(dataclasses.asdict(arch)).encode(), dtype=np.uint8)
        np.savez_compressed(args.write_jax_init, **flat)
        params, _ = tcur.load_tiny_checkpoint(args.write_jax_init)
        assert all(np.array_equal(leaves(params)[k], v) for k, v in leaves(init).items())
        print(f"wrote {args.write_jax_init}: JAX's init_params(PRNGKey({SEED})) of {arch}, fp32")
        sys.exit(0)
    arch_kwargs = ARCH if args.arch == "small" else dataclasses.asdict(jax_recipe.build_arch(args.seq))
    arch_kwargs = {**arch_kwargs, "max_seq_len": args.seq}
    runs = long_runs(arch_kwargs, args.steps, args.seq, args.batch)
    # the control: the port against itself from weights 1 ulp apart, so a
    # gap that rounding alone grows is told from one the two steps make
    nudged = jax.tree.map(lambda a: np.nextafter(a, np.inf, dtype=np.float32), runs["init"])
    control, control_weights = port_run(nudged, arch_kwargs, args.steps, args.seq, args.batch)
    marks = sorted({0, *range(99, args.steps, 100), args.steps - 1})

    def gaps(a, b):
        rel = np.abs(a - b) / np.abs(b)
        return {"max": float(rel.max()), "median": float(np.median(rel)),
                "by_step": {m: float(rel[m]) for m in marks}}

    print(json.dumps({"arch": args.arch, "steps": args.steps, "seq": args.seq, "batch": args.batch,
                      "first_loss": [float(runs["jax_losses"][0]), float(runs["losses"][0])],
                      "last20_mean_loss": {"jax": float(runs["jax_losses"][-20:].mean()),
                                           "port": float(runs["losses"][-20:].mean()),
                                           "port_1ulp": float(control[-20:].mean())},
                      "rel_loss_gap_port_vs_jax": gaps(runs["losses"], runs["jax_losses"]),
                      "rel_loss_gap_port_vs_port_1ulp": gaps(control, runs["losses"]),
                      "max_weight_gap": {"port_vs_jax": runs["weight_gap"],
                                         "port_vs_port_1ulp": max(float(np.abs(v - runs["weights"][k]).max())
                                                                  for k, v in control_weights.items())}}))
