"""comorag_torch's training steps over a data x model mesh against the JAX
package's, on the CPU.

The JAX side runs ``make_train_step(mesh=)`` / ``make_lm_train_step(mesh=)``
on meshes over the conftest's virtual CPU devices; the port runs its steps
over one CPU device repeated (``build_mesh(shape, [cpu] * n)``), the weights
split by ``bge.shard_params`` / ``decoder.shard_params``. The same numpy
parameters (JAX's ``init_params``, with noise on the biases and norms) and
batches go to both, at ``__graft_entry__.dryrun_multichip``'s arches.
Tolerances:
  - losses: rtol 1e-5 (fp32 in both);
  - gradients (the port's, summed from every data replica into the split
    masters) against JAX's: tests/test_torch_train.py's rule, rtol 1e-4
    with atol 1e-6 * max|g|;
  - parameters after one AdamW step, each package on its own gradients:
    2e-7 absolute (tests/test_torch_train.py's rule for the update) where
    JAX's |g| >= 1e-6, and 2 * lr elsewhere. The first Adam step moves an
    element by lr * g / (|g| + 1e-8): where g is at rounding level (the key
    biases' gradients are 0 in exact arithmetic; summation order leaves
    ~1e-11 of either sign) that ratio is rounding, and a sign flip moves the
    element by up to 2 * lr. Measured over the eight steps below: at most
    1.31e-5 (lr 1e-3) at those elements, 1.19e-7 at every other;
  - ``shard_params``: JAX's blocks on JAX's devices, exactly; checkpoints
    across layouts: exactly.
The CUDA-marked test holds the mesh step over four distinct cards against
one card and skips here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comorag_torch.models import bge as tbge
from comorag_torch.models import decoder as tdec
from comorag_torch.models import train as ttrain
from comorag_torch.models import train_lm as ttrain_lm
from comorag_torch.parallel.mesh import Sharded, build_mesh, merge_blocks, parse_mesh_shape
from comorag_tpu.models import bge as jbge
from comorag_tpu.models import decoder as jdec
from comorag_tpu.models import train as jtrain
from comorag_tpu.models import train_lm as jtrain_lm
from comorag_tpu.parallel.mesh import build_mesh as jax_build_mesh

CPU = torch.device("cpu")
LR, WD = 1e-3, 0.1
ADAM_EPS_BAND = 1e-6  # |g| below which the first Adam step's direction is rounding
# __graft_entry__.py:151-157, :178-181
ENC = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=8, intermediate_size=128, max_position=64)
DEC = dict(vocab_size=259, hidden_size=64, num_layers=2, num_heads=8, num_kv_heads=4, intermediate_size=128,
           max_seq_len=128, qkv_bias=True)
MESHES = [{"data": 2, "model": 4}, {"data": 4, "model": 2}, {"model": 2}, {"data": 2}]
B, S = 8, 16


def _id(shape):
    return ",".join(f"{k}={v}" for k, v in shape.items())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(shape):
    n = int(np.prod(list(shape.values())))
    return build_mesh(shape, [CPU] * n), jax_build_mesh(shape, devices=jax.devices()[:n])


def _noisy(tree, rng, names):
    """Noise on the biases and norms: zeros and ones would hide a misplaced block."""
    for group in (tree.values() if isinstance(tree, dict) else ()):
        if isinstance(group, dict):
            for name, arr in group.items():
                if name.endswith(names):
                    group[name] = (arr + rng.normal(scale=0.05, size=arr.shape)).astype(np.float32)


def _whole(leaf, attr=None):
    """A port leaf (or its ``.grad``) as one CPU tensor."""
    if isinstance(leaf, Sharded):
        if attr is not None:
            leaf = dataclasses.replace(leaf, shards=tuple(getattr(s, attr) for s in leaf.shards))
        return merge_blocks(leaf, CPU).detach()
    return (leaf if attr is None else getattr(leaf, attr)).detach()


def _jax_leaf(tree, name):
    parts = name.split(".")
    if "embed" in tree and isinstance(tree["embed"], dict):  # the encoder's tree
        if parts[0] == "layers":
            return np.asarray(tree["layers"][parts[2]])[int(parts[1])]
        return np.asarray(tree["embed"][parts[0]])
    for part in parts:
        tree = tree[part]
    return np.asarray(tree)


def _check_step(params, loss, ref_loss, ref_grads, ref_params):
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    scale = max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(ref_grads))
    for name, leaf in ttrain.whole_leaves(params):
        g = _jax_leaf(ref_grads, name)
        np.testing.assert_allclose(_whole(leaf, "grad").numpy(), g, rtol=1e-4, atol=1e-6 * scale, err_msg=name)
        diff = np.abs(_whole(leaf).numpy() - _jax_leaf(ref_params, name))
        band = np.abs(g) < ADAM_EPS_BAND
        assert diff[~band].max(initial=0.0) <= 2e-7, (name, diff[~band].max())
        assert diff[band].max(initial=0.0) <= 2 * LR, (name, diff[band].max())


# ------------------------------------------------------------------ encoder
@pytest.fixture(scope="module")
def enc():
    arch = jbge.EncoderArch(**ENC)
    params = jax.tree_util.tree_map(np.asarray, jbge.init_params(jax.random.PRNGKey(0), arch))
    rng = np.random.default_rng(5)
    _noisy(params, rng, ("_b", "ln_scale", "ln_bias"))
    batch = {}
    for side in ("q", "p"):
        ids = rng.integers(2, arch.vocab_size, (B, S)).astype(np.int32)
        lengths = rng.integers(3, S + 1, size=B)
        mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
        batch[f"{side}_ids"], batch[f"{side}_mask"] = ids * mask, mask
    grads = jax.jit(jax.grad(jtrain.contrastive_loss), static_argnums=2)(params, batch, arch)
    return {"arch": arch, "params": params, "batch": batch, "grads": jax.tree_util.tree_map(np.asarray, grads)}


def _port_encoder(enc, mesh):
    model = tbge.params_from_jax(enc["params"], tbge.EncoderArch(**ENC), device="cpu")
    if mesh is not None:
        model = tbge.shard_params(model, mesh)
    return ttrain.TrainState(model, ttrain.make_optimizer(LR, WD)(model), 0)


def _torch_batch(batch):
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.int64) for k, v in batch.items()}


@pytest.mark.parametrize("shape", MESHES, ids=_id)
def test_encoder_shard_params_matches_param_shardings(enc, shape):
    """Each layer leaf holds, at each position of the model axis, the block
    JAX's ``param_shardings`` puts on that device (a whole leaf: every JAX
    index is the whole array); the blocks are registered parameters that
    ``named_parameters()`` lists; a mesh without the axis splits nothing."""
    tmesh, jmesh = _meshes(shape)
    specs = jbge.param_shardings(jmesh)
    model = _port_encoder(enc, tmesh).params
    tp = shape.get("model", 1)
    jdevices = [jmesh.devices[tuple(m if a == "model" else 0 for a in jmesh.axis_names)] for m in range(tp)]
    tree = model.leaves()
    n_split = 0
    for group, spec_group in (("embed", "embed"), ("layers", "layers")):
        for name, sharding in specs[spec_group].items():
            full = enc["params"][group][name]
            index = sharding.devices_indices_map(full.shape)
            split = "model" in sharding.spec
            for li in range(len(tree.layers) if group == "layers" else 1):
                leaf = tree.layers[li][name] if group == "layers" else tree.embed[name]
                assert isinstance(leaf, Sharded) == split, (group, name)
                n_split += split
                blocks = leaf.shards if split else [leaf] * tp
                for dev, block in zip(jdevices, blocks):
                    want = full[index[dev]][li] if group == "layers" else full[index[dev]]
                    np.testing.assert_array_equal(block.detach().numpy(), want, err_msg=name)
                if split:
                    assert leaf.dim == ("col" if sharding.spec[-1] == "model" else "row"), name
    assert n_split == (10 * ENC["num_layers"] if tp > 1 else 0)
    names = {n for n, _ in model.named_parameters()}
    assert names == {n for n, _, _ in ttrain.named_leaves(model)}
    assert ("layers.0.q_w.1" in names) == (tp > 1)


@pytest.mark.parametrize("shape", MESHES, ids=_id)
def test_encoder_step_over_a_mesh_matches_jax(enc, shape):
    """One step of the port's sharded step against JAX's sharded step on
    the same parameters and batch (and the gradients against JAX's)."""
    tmesh, jmesh = _meshes(shape)
    arch = enc["arch"]
    opt = jtrain.make_optimizer(LR, WD)
    jstate = jtrain.TrainState(enc["params"], opt.init(enc["params"]), jnp.zeros((), jnp.int32))
    jstate, jloss = jtrain.make_train_step(arch, optimizer=opt, mesh=jmesh)(jstate, enc["batch"])
    state = _port_encoder(enc, tmesh)
    state, loss = ttrain.make_train_step(state.params.arch, mesh=tmesh)(state, _torch_batch(enc["batch"]))
    assert state.step == 1
    _check_step(state.params, loss, float(jloss), enc["grads"], jax.tree_util.tree_map(np.asarray, jstate.params))


def test_decay_mask_over_shards(enc):
    """With zero gradients a step only decays: over {"data": 2, "model": 4}
    the blocks decay exactly as the unsharded leaves do (JAX's ndim >= 2
    over its stacked tree: every layer block, not the embedding LayerNorm)."""
    tmesh, _ = _meshes({"data": 2, "model": 4})
    states = [_port_encoder(enc, mesh) for mesh in (tmesh, None)]
    for state in states:
        for _, p, _ in ttrain.named_leaves(state.params):
            p.grad = torch.zeros_like(p)
        state.opt_state.step()
    sharded, whole = (dict(ttrain.whole_leaves(s.params)) for s in states)
    for name in whole:
        torch.testing.assert_close(_whole(sharded[name]), _whole(whole[name]), rtol=0, atol=0, msg=name)
    decayed = {n for n, _, ndim in ttrain.named_leaves(states[0].params) if ndim >= 2}
    blocks = {n for n, _, _ in ttrain.named_leaves(states[0].params)}
    assert decayed == blocks - {"ln_scale", "ln_bias"}
    assert {"layers.1.q_b.3", "layers.1.o_w.0", "layers.1.attn_ln_scale"} <= decayed


# ---------------------------------------------------------------------- LM
@pytest.fixture(scope="module")
def lm():
    arch = jdec.DecoderArch(**DEC)
    params = jax.tree_util.tree_map(np.asarray, jdec.init_params(jax.random.PRNGKey(1), arch))
    rng = np.random.default_rng(0)
    _noisy(params, rng, ("attn_norm", "ffn_norm"))
    params["final_norm"] = (params["final_norm"] + rng.normal(scale=0.05, size=64)).astype(np.float32)
    ids = rng.integers(1, DEC["vocab_size"], (B, S)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[:, 13:] = 0  # a pad tail
    mask[1, 9:] = 0
    loss_mask = (rng.random(ids.shape) < 0.6).astype(np.float32)
    # JAX's pad_tail batch carries an all-ones loss_mask (the same loss): one
    # compiled program serves both cases
    batches = {"pad_tail": {"ids": ids, "mask": mask, "loss_mask": np.ones_like(loss_mask)},
               "loss_mask": {"ids": ids, "mask": mask, "loss_mask": loss_mask}}
    grad_fn = jax.jit(jax.grad(jtrain_lm.lm_loss), static_argnums=2)
    grads = {k: jax.tree_util.tree_map(np.asarray, grad_fn(params, b, arch)) for k, b in batches.items()}
    return {"arch": arch, "params": params, "batches": batches, "grads": grads}


def _port_lm(lm, mesh):
    params = tdec.params_from_jax(lm["params"], device="cpu")
    if mesh is not None:
        params = tdec.shard_params(params, mesh)
    return ttrain.TrainState(params, ttrain.make_optimizer(LR, WD)(params), 0)


def _lm_batch(batch, case):
    out = {"ids": torch.as_tensor(batch["ids"], dtype=torch.int64), "mask": torch.as_tensor(batch["mask"])}
    if case == "loss_mask":
        out["loss_mask"] = torch.as_tensor(batch["loss_mask"])
    return out


@pytest.mark.parametrize("shape", MESHES, ids=_id)
def test_lm_step_over_a_mesh_matches_jax(lm, shape):
    """One step of the port's sharded LM step against JAX's, for a padded
    batch and for a completion-only ``loss_mask`` (the global batch's mean
    over its counted targets in both)."""
    tmesh, jmesh = _meshes(shape)
    arch = lm["arch"]
    opt = jtrain.make_optimizer(LR, WD)
    jstep = jtrain_lm.make_lm_train_step(arch, optimizer=opt, mesh=jmesh, batch_keys=("ids", "mask", "loss_mask"))
    tarch = tdec.DecoderArch(**DEC)
    for case, batch in lm["batches"].items():
        jstate = jtrain.TrainState(lm["params"], opt.init(lm["params"]), jnp.zeros((), jnp.int32))
        jstate, jloss = jstep(jstate, batch)
        state = _port_lm(lm, tmesh)
        state, loss = ttrain_lm.make_lm_train_step(tarch, mesh=tmesh)(state, _lm_batch(batch, case))
        assert state.step == 1
        _check_step(state.params, loss, float(jloss), lm["grads"][case],
                    jax.tree_util.tree_map(np.asarray, jstate.params))


def test_remat_under_a_mesh_gives_the_same_gradients(lm):
    """``mesh_lm_loss`` (the sharded step's loss) recomputes each layer by
    default: its gradients equal those without recomputation, exactly."""
    tmesh, _ = _meshes({"data": 2, "model": 4})
    tarch = tdec.DecoderArch(**DEC)
    batch = _lm_batch(lm["batches"]["loss_mask"], "loss_mask")
    grads = []
    for remat in (True, False):
        state = _port_lm(lm, tmesh)
        ttrain_lm.mesh_lm_loss(state.params, batch, tarch, tmesh, remat=remat).backward()
        grads.append({n: p.grad for n, p, _ in ttrain.named_leaves(state.params)})
    for name in grads[0]:
        torch.testing.assert_close(grads[0][name], grads[1][name], rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_a_data_axis_that_does_not_divide_the_batch_raises(enc, lm, kind):
    """As JAX's P("data", None) refuses a batch of 6 rows on 4 devices."""
    tmesh, _ = _meshes({"data": 4, "model": 2})
    if kind == "encoder":
        state = _port_encoder(enc, tmesh)
        step = ttrain.make_train_step(state.params.arch, mesh=tmesh)
        batch = {k: v[:6] for k, v in _torch_batch(enc["batch"]).items()}
    else:
        state = _port_lm(lm, tmesh)
        step = ttrain_lm.make_lm_train_step(tdec.DecoderArch(**DEC), mesh=tmesh)
        batch = {k: v[:6] for k, v in _lm_batch(lm["batches"]["pad_tail"], "pad_tail").items()}
    with pytest.raises(ValueError, match="6 rows is not divisible by the data axis size 4"):
        step(state, batch)


# -------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("direction", ["sharded_to_whole", "whole_to_sharded"])
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_checkpoint_across_layouts(enc, lm, kind, direction, tmp_path):
    """A state trained two steps in one layout is saved (whole tensors) and
    loaded into a fresh state of the other: parameters and Adam moments
    equal, bit for bit, and the next step from each agrees within the
    parameter rule above."""
    tmesh, _ = _meshes({"data": 2, "model": 4})
    src_mesh, dst_mesh = (tmesh, None) if direction == "sharded_to_whole" else (None, tmesh)
    if kind == "encoder":
        make = lambda mesh: _port_encoder(enc, mesh)  # noqa: E731
        step = lambda mesh: ttrain.make_train_step(tbge.EncoderArch(**ENC), mesh=mesh)  # noqa: E731
        batch = _torch_batch(enc["batch"])
    else:
        make = lambda mesh: _port_lm(lm, mesh)  # noqa: E731
        step = lambda mesh: ttrain_lm.make_lm_train_step(tdec.DecoderArch(**DEC), mesh=mesh)  # noqa: E731
        batch = _lm_batch(lm["batches"]["loss_mask"], "loss_mask")
    state = make(src_mesh)
    for _ in range(2):
        state, _ = step(src_mesh)(state, batch)
    path = str(tmp_path / "train_state")
    ttrain.save_checkpoint(path, state)
    restored = ttrain.load_checkpoint(path, make(dst_mesh))
    assert restored.step == 2
    src, dst = dict(ttrain.whole_leaves(state.params)), dict(ttrain.whole_leaves(restored.params))
    assert set(src) == set(dst)
    for name in src:
        assert torch.equal(_whole(src[name]), _whole(dst[name])), name
        for key in ("exp_avg", "exp_avg_sq"):
            moments = [dataclasses.replace(leaf, shards=tuple(s.opt_state.state[b][key] for b in leaf.shards))
                       if isinstance(leaf, Sharded) else s.opt_state.state[leaf][key]
                       for leaf, s in ((src[name], state), (dst[name], restored))]
            assert torch.equal(_whole(moments[0]), _whole(moments[1])), (name, key)
    state, _ = step(src_mesh)(state, batch)
    restored, _ = step(dst_mesh)(restored, batch)
    assert state.step == restored.step == 3
    for name, leaf in ttrain.whole_leaves(state.params):
        torch.testing.assert_close(_whole(dict(ttrain.whole_leaves(restored.params))[name]), _whole(leaf),
                                   rtol=0, atol=2 * LR, msg=name)


def test_a_checkpoint_of_the_older_layout_is_refused(enc, tmp_path):
    """A file that keeps the optimizer's own state_dict (keyed by position,
    the layout before whole tensors by name) has the same parameter names:
    it raises instead of loading without its Adam moments."""
    state = _port_encoder(enc, None)
    state, _ = ttrain.make_train_step(state.params.arch)(state, _torch_batch(enc["batch"]))
    path = str(tmp_path / "train_state")
    torch.save({"params": {n: _whole(leaf) for n, leaf in ttrain.whole_leaves(state.params)},
                "opt_state": state.opt_state.state_dict(), "step": 1}, path)
    with pytest.raises(ValueError, match="not a 'whole-by-name' checkpoint"):
        ttrain.load_checkpoint(path, _port_encoder(enc, None))


def test_a_moved_sharded_encoder_names_the_devices_its_blocks_hold(enc):
    """``Module.to`` moves a split weight's blocks; the ``Sharded`` leaf the
    forward reads names the devices they hold afterwards."""
    tmesh, _ = _meshes({"model": 2})
    model = _port_encoder(enc, tmesh).params
    assert model.leaves().layers[0]["q_w"].devices == (CPU, CPU)
    meta = torch.device("meta")
    leaf = model.to(meta).leaves().layers[0]["q_w"]
    assert leaf.devices == (meta, meta) and all(b.device == meta for b in leaf.shards)


@pytest.mark.parametrize("spec, shape", [("data=2,model=2", {"data": 2, "model": 2}), ("corpus=8,", {"corpus": 8}),
                                         (" data = 4 , model=2", {"data": 4, "model": 2})])
def test_parse_mesh_shape(spec, shape):
    """Both CLIs' ``--mesh_shape``, as the JAX train CLI's ``parse_mesh``
    reads it; a malformed spec raises ValueError."""
    assert parse_mesh_shape(spec) == shape
    with pytest.raises(ValueError):
        parse_mesh_shape(spec.replace("=", ":"))


# ------------------------------------------------------- the dry run's twin
def test_dryrun_multichip_twin_over_eight_cpu_positions():
    """``__graft_entry__.dryrun_multichip(8)``'s port,
    ``comorag_torch.graft_entry.dryrun_multichip``, over {"data": 2,
    "model": 4} of [cpu] * 8: an encoder step and an LM step (qkv_bias, 4
    kv heads) with finite losses, the trained decoder served with int8
    weights split over the model axis (guided JSON, sampled, then
    speculative at temperature 0), then int4, the qwen3- and gemma-class
    families over the same axis, the corpus-sharded index and PPR. The
    function itself raises where a weight is not split over the axis (int8
    ``q`` / int4 ``packed`` shards, four of them), where the index does not
    shard or take the two-pass, or where a row minimum or PPR score is not
    finite."""
    from comorag_torch import graft_entry

    out = graft_entry.dryrun_multichip(8, devices=[CPU] * 8)
    assert out["mesh"] == {"data": 2, "model": 4}
    assert np.isfinite(out["loss"]) and np.isfinite(out["lm_loss"])
    assert all(isinstance(out["texts"][k], str) for k in ("int8", "int8_speculative", "int4", "qwen3", "gemma"))
    assert out["speculative_decode_steps"] >= 1
    assert out["topk_shape"] == [4, 8] and np.isfinite(out["ppr_sum"])


# --------------------------------------------------------------- the card
@pytest.mark.cuda
def test_mesh_step_over_distinct_cards_matches_one_card():
    """The encoder and LM steps over {"data": 2, "model": 2} of four
    distinct cards (the LM's layers recompute in the backward) against the
    same mesh on one card and the unsharded step: losses within rtol 1e-5,
    the gradients each step applied (summed from both data replicas into
    the split masters) under the gradient rule above, and parameters
    finite and within 2 * lr (the first Adam step moves an element by at
    most lr, so the gradients carry the check)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four cards (a data x model mesh over distinct devices)")
    dev = torch.device("cuda", 0)
    cards = build_mesh({"data": 2, "model": 2}, [torch.device("cuda", i) for i in range(4)])
    one_card = build_mesh({"data": 2, "model": 2}, [dev] * 4)
    rng = np.random.default_rng(0)
    enc_arch = tbge.EncoderArch(**ENC)
    ids = torch.as_tensor(rng.integers(2, 512, (B, S)), device=dev)
    enc_batch = {"q_ids": ids, "p_ids": ids.flip(0), "q_mask": torch.ones_like(ids), "p_mask": torch.ones_like(ids)}
    dec_arch = tdec.DecoderArch(**DEC)
    lm_ids = torch.as_tensor(rng.integers(1, 259, (B, S)), device=dev)
    lm_batch = {"ids": lm_ids, "mask": torch.ones_like(lm_ids)}
    for make, step, batch in (
            (lambda m: ttrain.create_train_state(enc_arch, torch.Generator().manual_seed(0), ttrain.make_optimizer(LR),
                                                 device=dev, mesh=m),
             lambda m: ttrain.make_train_step(enc_arch, mesh=m), enc_batch),
            (lambda m: ttrain_lm.create_lm_train_state(dec_arch, torch.Generator(device=dev).manual_seed(1),
                                                       ttrain.make_optimizer(LR), device=dev, mesh=m),
             lambda m: ttrain_lm.make_lm_train_step(dec_arch, mesh=m), lm_batch)):
        runs = {}
        for tag, mesh in (("cards", cards), ("one_card", one_card), ("whole", None)):
            state = make(mesh)
            if tag == "cards":
                leaf = dict(ttrain.whole_leaves(state.params))["layers.0.q_w" if batch is enc_batch
                                                               else "layers.qkv_w"]
                assert [s.device.index for s in leaf.shards] == [0, 1]
            state, loss = step(mesh)(state, batch)
            leaves = list(ttrain.whole_leaves(state.params))
            runs[tag] = (float(loss), {n: _whole(leaf).cpu() for n, leaf in leaves},
                         {n: _whole(leaf, "grad").cpu() for n, leaf in leaves})
        for tag in ("one_card", "whole"):
            loss, params, grads = runs[tag]
            np.testing.assert_allclose(runs["cards"][0], loss, rtol=1e-5)
            scale = max(float(g.abs().max()) for g in grads.values())
            for name, p in runs["cards"][1].items():
                g = runs["cards"][2][name]
                assert torch.isfinite(g).all() and torch.isfinite(p).all(), (tag, name)
                torch.testing.assert_close(g, grads[name], rtol=1e-4, atol=1e-6 * scale, msg=(tag, name))
                torch.testing.assert_close(p, params[name], rtol=0, atol=2 * LR, msg=(tag, name))
