"""comorag_torch's two training steps against the JAX package's, on the CPU.

The same parameters (JAX's ``init_params`` converted with
``params_from_jax``) and the same numpy batches go through both packages at
``EncoderArch.tiny()`` and ``DecoderArch.tiny(vocab_size=64)``. Tolerances:
  - losses: rtol 1e-5 (fp32 in both);
  - gradients, leaf by leaf: rtol 1e-4 with atol 1e-6 * max|g| over all
    leaves (the key biases' gradients are 0 in exact arithmetic, and both
    packages give ~1e-11 of rounding there);
  - one AdamW step fed JAX's gradients in both packages: parameters within
    2e-7 absolute (the update is lr * ~1 = 1e-3; torch and optax apply the
    decay in another order, which is one fp32 rounding of the LayerNorm
    scales near 1.0: ulp(1.0) = 1.19e-7);
  - remat against no remat: exact (the same operations recomputed).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from comorag_torch.models import bge as tbge
from comorag_torch.models import decoder as tdec
from comorag_torch.models import train as ttrain
from comorag_torch.models import train_lm as ttrain_lm
from comorag_tpu.models import bge as jbge
from comorag_tpu.models import decoder as jdec
from comorag_tpu.models import train as jtrain
from comorag_tpu.models import train_lm as jtrain_lm

LR, WD = 1e-3, 0.1


# ------------------------------------------------------------------ helpers
def jax_leaf(tree, name):
    """The JAX tree's leaf for a port parameter name (``named_leaves``):
    an encoder layer tensor is row i of the stacked [L, ...] leaf."""
    parts = name.split(".")
    if "embed" in tree and isinstance(tree["embed"], dict):  # the encoder's tree
        if parts[0] == "layers":
            return np.asarray(tree["layers"][parts[2]])[int(parts[1])]
        return np.asarray(tree["embed"][parts[0]])
    for part in parts:
        tree = tree[part]
    return np.asarray(tree)


def assert_grads_match(params, jgrads):
    scale = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(jgrads))
    for name, p, _ in ttrain.named_leaves(params):
        np.testing.assert_allclose(p.grad.numpy(), jax_leaf(jgrads, name), rtol=1e-4, atol=1e-6 * scale,
                                   err_msg=name)


def assert_params_match(params, jparams, atol):
    for name, p, _ in ttrain.named_leaves(params):
        np.testing.assert_allclose(p.detach().numpy(), jax_leaf(jparams, name), rtol=0, atol=atol, err_msg=name)


def feed_jax_grads(params, jgrads):
    for name, p, _ in ttrain.named_leaves(params):
        p.grad = torch.from_numpy(np.array(jax_leaf(jgrads, name)))


def optax_step(params, grads, lr=LR, wd=WD):
    opt = jtrain.make_optimizer(lr, wd)
    updates, _ = opt.update(grads, opt.init(params), params)
    return optax.apply_updates(params, updates)


# ------------------------------------------------------------------ encoder
@pytest.fixture(scope="module")
def enc():
    arch = jbge.EncoderArch.tiny()
    params = jax.tree_util.tree_map(np.asarray, jbge.init_params(jax.random.PRNGKey(0), arch))
    rng = np.random.default_rng(5)  # non-trivial LN affine and biases
    for group in params.values():
        for name, arr in group.items():
            if name.endswith(("_b", "ln_scale", "ln_bias")):
                group[name] = (arr + rng.normal(scale=0.05, size=arr.shape)).astype(np.float32)
    b, s = 6, 16
    batch = {}
    for side in ("q", "p"):
        ids = rng.integers(2, arch.vocab_size, (b, s)).astype(np.int32)
        lengths = rng.integers(3, s + 1, size=b)
        mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
        batch[f"{side}_ids"], batch[f"{side}_mask"] = ids * mask, mask
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(jtrain.contrastive_loss)(jparams, jbatch, arch)
    return {"arch": arch, "params": params, "batch": batch, "loss": float(loss),
            "grads": jax.tree_util.tree_map(np.asarray, grads)}


def torch_encoder(enc):
    return tbge.params_from_jax(enc["params"], tbge.EncoderArch.tiny(), device="cpu")


def torch_batch(batch):
    return {k: torch.as_tensor(v, dtype=torch.int64) for k, v in batch.items()}


def test_contrastive_loss_and_grads_match_jax(enc):
    model = torch_encoder(enc)
    opt = ttrain.make_optimizer()(model)  # turns the gradients on
    loss = ttrain.contrastive_loss(model, torch_batch(enc["batch"]), model.arch)
    np.testing.assert_allclose(loss.item(), enc["loss"], rtol=1e-5)
    opt.zero_grad()
    loss.backward()
    assert_grads_match(model, enc["grads"])


def test_encoder_adamw_step_matches_optax(enc):
    """JAX's gradients fed to both optimizers: the AdamW arithmetic and the
    decay mask alone, without gradient noise."""
    model = torch_encoder(enc)
    opt = ttrain.make_optimizer(LR, WD)(model)
    feed_jax_grads(model, enc["grads"])
    opt.step()
    assert_params_match(model, optax_step(enc["params"], enc["grads"]), atol=2e-7)


def test_decay_mask_reproduces_jax(enc):
    """With zero gradients a step only decays: a layer attn_ln_scale ([L, H]
    in JAX's tree) decays in both packages, the embedding ln_scale ([H])
    in neither, and every leaf agrees."""
    zeros = jax.tree_util.tree_map(np.zeros_like, enc["params"])
    stepped = optax_step(enc["params"], zeros)
    model = torch_encoder(enc)
    opt = ttrain.make_optimizer(LR, WD)(model)
    feed_jax_grads(model, zeros)
    opt.step()
    shrink = 1 - LR * WD
    for got in (np.asarray(stepped["layers"]["attn_ln_scale"])[1], model.layers[1].attn_ln_scale.detach().numpy()):
        np.testing.assert_allclose(got, enc["params"]["layers"]["attn_ln_scale"][1] * shrink, rtol=1e-6)
    for got in (np.asarray(stepped["embed"]["ln_scale"]), model.ln_scale.detach().numpy()):
        np.testing.assert_array_equal(got, enc["params"]["embed"]["ln_scale"])
    decayed = {name for name, _, ndim in ttrain.named_leaves(model) if ndim >= 2}
    assert decayed == {n for n, _ in model.named_parameters()} - {"ln_scale", "ln_bias"}
    assert_params_match(model, stepped, atol=2e-7)


def test_encoder_loss_falls(enc):
    """As tests/test_encoder.py requires of JAX: five steps on one batch
    lower the loss, and the step counter counts them."""
    state = ttrain.create_train_state(tbge.EncoderArch.tiny(), torch.Generator().manual_seed(1), device="cpu")
    step = ttrain.make_train_step(state.params.arch)
    batch = torch_batch(enc["batch"])
    loss0 = ttrain.contrastive_loss(state.params, batch, state.params.arch).item()
    for _ in range(5):
        state, loss = step(state, batch)
    assert float(loss) < loss0
    assert state.step == 5


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_checkpoint_save_load_resume(kind, tmp_path):
    """A saved state reloads into a fresh one with its step, parameters and
    Adam moments: the next step from either gives the same parameters."""
    if kind == "encoder":
        arch = tbge.EncoderArch.tiny()
        make = lambda seed: ttrain.create_train_state(arch, torch.Generator().manual_seed(seed), device="cpu")  # noqa: E731
        step = ttrain.make_train_step(arch)
        rng = np.random.default_rng(0)
        batch = {k: torch.as_tensor(rng.integers(2, 512, (4, 8))) for k in ("q_ids", "p_ids")}
        batch.update(q_mask=torch.ones(4, 8, dtype=torch.int64), p_mask=torch.ones(4, 8, dtype=torch.int64))
    else:
        arch = tdec.DecoderArch.tiny(vocab_size=64)
        make = lambda seed: ttrain_lm.create_lm_train_state(arch, torch.Generator().manual_seed(seed), device="cpu")  # noqa: E731
        step = ttrain_lm.make_lm_train_step(arch)
        batch = {"ids": torch.as_tensor(np.random.default_rng(0).integers(1, 64, (2, 12))),
                 "mask": torch.ones(2, 12, dtype=torch.int64)}
    state = make(0)
    for _ in range(3):
        state, _ = step(state, batch)
    path = str(tmp_path / "train_state")
    ttrain.save_checkpoint(path, state)
    restored = ttrain.load_checkpoint(path, make(7))
    assert restored.step == 3
    for (name, a, _), (_, b, _) in zip(ttrain.named_leaves(state.params), ttrain.named_leaves(restored.params)):
        assert torch.equal(a, b), name
    state, _ = step(state, batch)
    restored, _ = step(restored, batch)
    assert restored.step == state.step == 4
    for (name, a, _), (_, b, _) in zip(ttrain.named_leaves(state.params), ttrain.named_leaves(restored.params)):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------- LM
LM_ARCH = dict(vocab_size=64)


@pytest.fixture(scope="module")
def lm():
    arch = jdec.DecoderArch.tiny(**LM_ARCH)
    params = jax.tree_util.tree_map(np.asarray, jdec.init_params(jax.random.PRNGKey(0), arch))
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 64, (4, 24)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[:, 20:] = 0  # a pad tail
    mask[1, 15:] = 0
    loss_mask = (rng.random(ids.shape) < 0.6).astype(np.float32)
    batches = {"pad_tail": {"ids": ids, "mask": mask},
               "loss_mask": {"ids": ids, "mask": mask, "loss_mask": loss_mask}}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    out = {}
    for key, batch in batches.items():
        loss, grads = jax.value_and_grad(jtrain_lm.lm_loss)(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                                                            arch)
        out[key] = (float(loss), jax.tree_util.tree_map(np.asarray, grads))
    return {"arch": arch, "params": params, "batches": batches, "results": out}


def torch_lm(lm):
    params = tdec.params_from_jax(lm["params"], device="cpu")
    return params, ttrain.make_optimizer(LR, WD)(params)


def lm_batch(batch):
    return {k: torch.as_tensor(v if k == "loss_mask" else v.astype(np.int64)) for k, v in batch.items()}


@pytest.mark.parametrize("case", ["pad_tail", "loss_mask"])
def test_lm_loss_and_grads_match_jax(lm, case):
    params, opt = torch_lm(lm)
    ref_loss, ref_grads = lm["results"][case]
    loss = ttrain_lm.lm_loss(params, lm_batch(lm["batches"][case]), tdec.DecoderArch.tiny(**LM_ARCH))
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    opt.zero_grad()
    loss.backward()
    assert_grads_match(params, ref_grads)


def test_lm_adamw_step_matches_optax(lm):
    params, opt = torch_lm(lm)
    grads = lm["results"]["pad_tail"][1]
    feed_jax_grads(params, grads)
    opt.step()
    assert_params_match(params, optax_step(lm["params"], grads), atol=2e-7)
    decayed = {name for name, _, ndim in ttrain.named_leaves(params) if ndim >= 2}
    assert "final_norm" not in decayed and {"embed", "lm_head", "layers.attn_norm"} <= decayed


def test_remat_gives_the_same_lm_gradients(lm):
    arch = tdec.DecoderArch.tiny(**LM_ARCH)
    grads = []
    for remat in (True, False):
        params, opt = torch_lm(lm)
        opt.zero_grad()
        ttrain_lm.lm_loss(params, lm_batch(lm["batches"]["loss_mask"]), arch, remat=remat).backward()
        grads.append({name: p.grad for name, p, _ in ttrain.named_leaves(params)})
    for name in grads[0]:
        torch.testing.assert_close(grads[0][name], grads[1][name], rtol=0, atol=0, msg=name)


def test_lm_loss_falls():
    """As tests/test_offline_llm.py requires of JAX: 30 Adam steps at 1e-2
    halve the loss on one padded batch."""
    arch = tdec.DecoderArch.tiny(**LM_ARCH)
    adam = lambda params: torch.optim.Adam([p.requires_grad_(True) for _, p, _ in ttrain.named_leaves(params)],  # noqa: E731
                                           lr=1e-2)
    state = ttrain_lm.create_lm_train_state(arch, torch.Generator().manual_seed(0), optimizer=adam, device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 64, (8, 32))
    mask = np.ones_like(ids)
    mask[:, 28:] = 0
    batch = {"ids": torch.as_tensor(ids), "mask": torch.as_tensor(mask)}
    step = ttrain_lm.make_lm_train_step(arch)
    first = ttrain_lm.lm_loss(state.params, batch, arch).item()
    for _ in range(30):
        state, loss = step(state, batch)
    assert float(loss) < first * 0.5, (first, float(loss))
    assert state.step == 30


def test_training_route_leaves_generation_cache_path_alone(lm):
    """decoder_forward without a cache (training) gives the logits of the
    cache path over a fresh cache of S slots written at 0, as JAX's lm_loss
    runs it."""
    arch = tdec.DecoderArch.tiny(**LM_ARCH)
    params = tdec.params_from_jax(lm["params"], device="cpu")
    batch = lm_batch(lm["batches"]["pad_tail"])
    b, s = batch["ids"].shape
    pos = torch.arange(s)[None].expand(b, s)
    attn = torch.tril(torch.ones(s, s, dtype=torch.bool))[None] & batch["mask"].bool()[:, None, :]
    cache = tdec.KVCache.zeros(arch, b, s, device="cpu")
    with torch.no_grad():
        ref, _ = tdec.decoder_forward(params, batch["ids"], pos, attn, cache, 0, arch)
        got, _ = tdec.decoder_forward(params, batch["ids"], pos, attn, None, 0, arch)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="remat"):
        tdec.decoder_forward(params, batch["ids"], pos, attn, cache, 0, arch, remat=True)


# --------------------------------------------------------------------- CLI
def test_train_cli_end_to_end(tmp_path):
    """As test_train_cli_end_to_end (tests/test_offline_llm.py) drives the
    JAX CLI: the loss falls on a learnable toy task, the summary has the JAX
    CLI's keys, and the checkpoint reloads into a serving encoder."""
    from comorag_torch.cli.train import main as train_main

    ppath = tmp_path / "pairs.jsonl"
    ppath.write_text("".join(json.dumps({"query": f"topic {i} question", "passage": f"topic {i} passage text"})
                             + "\n" for i in range(32)))
    out = tmp_path / "ckpt"
    summary = train_main(["--pairs", str(ppath), "--output_dir", str(out), "--init", "tiny", "--steps", "60",
                          "--batch", "16", "--lr", "3e-3", "--max_seq_len", "16", "--log_every", "10",
                          "--device", "cpu"])
    assert summary["final_loss"] < summary["first_loss"]
    assert set(summary) == {"steps", "pairs", "first_loss", "final_loss", "pairs_per_s", "arch", "checkpoint"}
    assert json.loads((out / "train_summary.json").read_text()) == summary

    arch = tbge.EncoderArch.tiny()
    fresh = ttrain.create_train_state(arch, torch.Generator().manual_seed(0), ttrain.make_optimizer(3e-3),
                                      device="cpu")
    restored = ttrain.load_checkpoint(summary["checkpoint"], fresh)
    assert restored.step == 60
    enc = tbge.BGETorchEncoder(params=restored.params, max_seq_len=16, device="cpu", attention="kernel")
    vecs = enc.encode(["topic 3 question", "topic 3 passage text"])
    assert vecs.shape == (2, arch.hidden_size) and np.isfinite(vecs).all()


# ------------------------------------------------------------------ errors
@pytest.mark.parametrize("what", ["make_train_step", "make_lm_train_step", "--mesh_shape", "ComoRAG", "get_llm"])
def test_mesh_is_taken(what, tmp_path):
    """Every entry point that takes a mesh runs over one: the two training
    steps take a [cpu] * 2 mesh and step (their JAX parity over data x
    model meshes: tests/test_torch_train_mesh.py), the train CLI's
    ``--mesh_shape data=2 --device cpu`` trains and writes a checkpoint
    that loads into an unsharded state, ``ComoRAG`` builds
    ``config.mesh_shape`` and its indexes shard, and ``get_llm`` splits an
    in-process LLM's weights over a ``model`` axis."""
    from comorag_torch.config import ComoConfig
    from comorag_torch.parallel.mesh import build_mesh

    if what == "ComoRAG":
        from comorag_torch.comorag import ComoRAG

        rag = ComoRAG(ComoConfig(mesh_shape={"corpus": 4}, embedding_model_name="hash", embedding_dim=16,
                                 save_dir=str(tmp_path)), device="cpu")
        assert rag.mesh.shape == {"corpus": 4} and rag.device == torch.device("cpu")
        rag.ver_store.insert_strings([f"chunk number {i}" for i in range(1024)])
        rag.engine.prepare()
        assert rag.engine.ver_index.n_shards == 4
        return
    if what == "get_llm":
        from comorag_torch.llm import get_llm

        mesh = build_mesh({"model": 2}, [torch.device("cpu")] * 2)
        llm = get_llm(ComoConfig(llm_name="jax-tiny", save_dir=str(tmp_path)), device="cpu", mesh=mesh)
        assert llm.engine.mesh is mesh  # its split weights: test_torch_tp.py
        llm.close()
        return
    if what == "--mesh_shape":
        from comorag_torch.cli.train import main as train_main

        ppath = tmp_path / "pairs.jsonl"
        ppath.write_text("".join(json.dumps({"query": f"q {i}", "passage": f"p {i}"}) + "\n" for i in range(8)))
        summary = train_main(["--pairs", str(ppath), "--output_dir", str(tmp_path / "ckpt"), "--init", "tiny",
                              "--steps", "2", "--batch", "4", "--max_seq_len", "8", "--mesh_shape", "data=2",
                              "--device", "cpu"])
        fresh = ttrain.create_train_state(tbge.EncoderArch.tiny(), torch.Generator().manual_seed(1), device="cpu")
        restored = ttrain.load_checkpoint(summary["checkpoint"], fresh)
        assert restored.step == 2 and np.isfinite(summary["final_loss"])
        return
    mesh = build_mesh({"data": 2}, [torch.device("cpu")] * 2)
    if what == "make_train_step":
        arch = tbge.EncoderArch.tiny()
        state = ttrain.create_train_state(arch, torch.Generator().manual_seed(0), device="cpu", mesh=mesh)
        step = ttrain.make_train_step(arch, mesh=mesh)
        batch = {k: torch.ones(4, 8, dtype=torch.int64) for k in ("q_ids", "q_mask", "p_ids", "p_mask")}
    else:
        arch = tdec.DecoderArch.tiny(vocab_size=64)
        state = ttrain_lm.create_lm_train_state(arch, torch.Generator().manual_seed(0), device="cpu", mesh=mesh)
        step = ttrain_lm.make_lm_train_step(arch, mesh=mesh)
        batch = {"ids": torch.ones(4, 8, dtype=torch.int64), "mask": torch.ones(4, 8, dtype=torch.int64)}
    state, loss = step(state, batch)
    assert state.step == 1 and np.isfinite(float(loss))


def test_kernel_route_refuses_autograd():
    """The kernels' wrappers return no grad_fn: under grad with trainable
    parameters the kernel route raises instead of dropping gradients; under
    no_grad, or with frozen parameters, it runs."""
    model = tbge.init_params(tbge.EncoderArch.tiny(), torch.Generator().manual_seed(0), device="cpu")
    ids, mask = torch.ones(2, 8, dtype=torch.int64), torch.ones(2, 8, dtype=torch.int64)
    tbge.encode_pooled(model, ids, mask, attention="kernel")  # frozen: serving
    ttrain.make_optimizer()(model)
    with pytest.raises(RuntimeError, match="no backward"):
        tbge.encode_pooled(model, ids, mask, attention="kernel")
    with torch.no_grad():
        tbge.encode_pooled(model, ids, mask, attention="kernel")
    assert tbge.encode_pooled(model, ids, mask).requires_grad
