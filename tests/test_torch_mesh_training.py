"""Training over a ``(dp, tp)`` mesh (``parallel/train.py``) against the JAX
package's sharded training, on the CPU.

The JAX side runs on the root conftest's 8 virtual CPU devices, its
parameters placed by ``param_specs`` and its batch rows by ``P("dp",
None)`` under ``jax.jit`` (GSPMD); the port's side on a mesh that lists the
CPU ``dp * tp`` times (``train_mesh([cpu] * n, tp=...)``), its stand-in for
virtual devices. Both start from the JAX ``init(0)`` weights (carried by
``from_jax_params``) and the same seeded numpy batch.

Tolerances, stated per check: loss within 1e-5 relative and weights within
1e-5 absolute after one step (lr 0.05; measured within 2.4e-7 and 6.6e-7:
the shards sum their partial products in another order than one matmul
does); trainer losses within 1e-5 relative over their few steps under SGD.
AdamW's f32 bias correction in optax differs from torch's by up to 6.4e-6 of
lr a step (``tests/test_torch_trainers.py``), so the AdamW trainer is held
to JAX's losses within 1e-4 relative and weights within 1e-4
(``ADAMW_JAX_*``). The port's sharded step and trainer against its own
unsharded ones: 1e-5.
"""

import io
import json
import os
import socket
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from autorag_research_tpu.embeddings.jax_encoder import _flatten_params
from autorag_research_tpu.models import decoder as jdec
from autorag_research_tpu.models import encoder as jenc
from autorag_research_tpu.models import lm_trainer as jlt
from autorag_research_tpu.models import trainer as jtr
from autorag_research_tpu_torch.models import decoder as tdec
from autorag_research_tpu_torch.models import encoder as tenc
from autorag_research_tpu_torch.models import lm_trainer as tlt
from autorag_research_tpu_torch.models import trainer as ttr
from autorag_research_tpu_torch.parallel import train as pt
from autorag_research_tpu_torch.parallel.mesh import train_mesh

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
GRIDS = [(4, 2), (2, 2), (1, 2), (2, 1), (8, 1)]
LOSS_RTOL = 1e-5
W_ATOL = 1e-5
ENC = dict(vocab_size=512, hidden=32, layers=2, heads=2, max_len=8, out_dim=16)
DEC = dict(hidden=32, layers=2, heads=2, max_len=64)
LR = 0.05
ADAMW_JAX_RTOL = 1e-4  # tests/test_torch_trainers.py's LOSS_TOL, for the same reason
ADAMW_JAX_ATOL = 1e-4  # 4 AdamW steps of lr 1e-3, each within 6.4e-6 of lr of optax's


def tmesh(dp, tp):
    return train_mesh([CPU] * (dp * tp), tp=tp)


def jmesh(dp, tp):
    return Mesh(np.array(jax.devices()[: dp * tp]).reshape(dp, tp), ("dp", "tp"))


def as_tuples(tree):
    """A JAX spec tree with each ``PartitionSpec`` as a tuple."""
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_tuples(v) for v in tree]
    return tuple(tree)


def jax_place(params, specs, mesh):
    return jax.tree.map(lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), params, specs)


def torch_batch(arrays: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)).long() if np.asarray(v).dtype == np.int32
            else torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}


def assert_tree_close(got: dict, ref: dict, atol=W_ATOL):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]), rtol=0, atol=atol,
                                   err_msg=k)


# ------------------------------------------------------------------- specs
@pytest.mark.parametrize("model", ["encoder", "decoder"])
def test_param_specs_equal_jax(model):
    jm, tm = (jenc, tenc) if model == "encoder" else (jdec, tdec)
    for layers in (1, 3):
        jcfg = (jm.EncoderConfig if model == "encoder" else jm.DecoderConfig)(layers=layers)
        tcfg = (tm.EncoderConfig if model == "encoder" else tm.DecoderConfig)(layers=layers)
        assert tm.param_specs(tcfg) == as_tuples(jm.param_specs(jcfg))


@pytest.mark.parametrize("model", ["encoder", "decoder"])
def test_spec_order_is_the_state_dict_order(model):
    """The specs name every parameter; a checkpoint keys the AdamW state by
    the module's parameter order, which is its ``state_dict`` order (a
    block's own tensors before its layer norms', unlike the specs)."""
    if model == "encoder":
        cfg = tenc.EncoderConfig(**ENC)
        module, specs = tenc.RetrievalEncoder(cfg, device="cpu"), tenc.param_specs(cfg)
    else:
        cfg = tdec.DecoderConfig(**DEC)
        module, specs = tdec.CausalDecoder(cfg, device="cpu"), tdec.param_specs(cfg)
    names = [n for n, _ in module.named_parameters()]
    assert names == list(module.state_dict())
    assert sorted(pt.flatten_specs(specs)) == sorted(names) and len(names) == len(set(names))


@pytest.mark.parametrize("model", ["encoder", "decoder"])
@pytest.mark.parametrize("grid", [(4, 2), (2, 4), (1, 8)], ids=lambda g: f"{g[0]}x{g[1]}")
def test_shards_equal_jax_shards(model, grid):
    """Each grid entry holds what the JAX device at its mesh position holds:
    the same shape and, from the same weights, the same values."""
    dp, tp = grid
    if model == "encoder":
        jm, tm, cfg_kw = jenc, tenc, {**ENC, "hidden": 64, "heads": 4}
        jcfg, tcfg = jm.EncoderConfig(**cfg_kw), tm.EncoderConfig(**cfg_kw)
        params = jm.RetrievalEncoder(jcfg).init(0)
    else:
        jm, tm, cfg_kw = jdec, tdec, {**DEC, "hidden": 64, "heads": 4}
        jcfg, tcfg = jm.DecoderConfig(**cfg_kw), tm.DecoderConfig(**cfg_kw)
        params = jm.CausalDecoder(jcfg).init(0)
    mesh = jmesh(dp, tp)
    placed = _flatten_params_sharded(jax_place(params, jm.param_specs(jcfg), mesh))
    sp = tm.shard_params(tm.from_jax_params(_flatten_params(params))
                         if model == "encoder" else tm.decoder_params_from_jax(_flatten_params(params)),
                         tcfg, tmesh(dp, tp))
    for i in range(dp):
        for j in range(tp):
            dev = mesh.devices[i, j]
            for name, arr in placed.items():
                shard = next(s for s in arr.addressable_shards if s.device == dev)
                got = sp.shards[i][j][name]
                assert tuple(got.shape) == tuple(shard.data.shape), name
                np.testing.assert_array_equal(got.detach().numpy(), np.asarray(shard.data))
    assert sp.entry_bytes(0, 0) == sum(
        np.asarray(next(s for s in a.addressable_shards if s.device == mesh.devices[0, 0]).data).nbytes
        for a in placed.values())
    back = tm.gather_params(sp)
    for name, arr in _flatten_params(params).items():
        np.testing.assert_array_equal(back[name].numpy(), arr)


def _flatten_params_sharded(tree, prefix=""):
    """``_flatten_params`` that keeps the placed arrays."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flatten_params_sharded(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flatten_params_sharded(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def test_non_divisible_dimension_refused():
    cfg = tenc.EncoderConfig(**{**ENC, "hidden": 30, "heads": 3})
    with pytest.raises(ValueError, match="not divisible by tp=4"):
        tenc.shard_params(tenc.RetrievalEncoder(cfg, device="cpu"), cfg, tmesh(1, 4))


def test_retrieval_and_training_meshes_are_not_interchangeable():
    from autorag_research_tpu_torch.parallel.mesh import check_mesh, corpus_mesh

    with pytest.raises(ValueError, match="corpus"):
        check_mesh(tmesh(2, 2))
    cfg = tenc.EncoderConfig(**ENC)
    with pytest.raises(ValueError, match=r"\(dp, tp\)"):
        tenc.shard_params(tenc.RetrievalEncoder(cfg, device="cpu"), cfg,
                          corpus_mesh(n_corpus=2, devices=[CPU] * 2))


def test_train_mesh_rule():
    """The JAX CLI's rule: tp = 2 for an even count above 1, dp = n // tp."""
    for n, shape in ((1, (1, 1)), (2, (1, 2)), (3, (3, 1)), (4, (2, 2)), (8, (4, 2))):
        m = train_mesh([CPU] * n)
        assert (m.shape["dp"], m.shape["tp"]) == shape and m.axis_names == ("dp", "tp")


# ------------------------------------------------------------ contrastive step
def contrastive_batch(multi: bool, b: int = 8, t: int = 8):
    rng = np.random.default_rng(1)
    out = {"q_ids": rng.integers(1, 512, size=(b, t), dtype=np.int32),
           "d_ids": rng.integers(1, 512, size=(b, t), dtype=np.int32)}
    if multi:  # the JAX multi-vector step gives NaN on a pad token
        out["q_mask"] = np.ones((b, t), bool)
        out["d_mask"] = np.ones((b, t), bool)
    else:
        out["q_mask"] = rng.random((b, t)) > 0.3
        out["d_mask"] = rng.random((b, t)) > 0.2
        out["q_mask"][:, 0] = out["d_mask"][:, 0] = True
    return out


_JAX_STEPS: dict = {}


def jax_sharded_contrastive(multi: bool, grid):
    """The JAX sharded step of ``tests/test_models.py::test_sharded_train_step``
    at ``grid``: (loss, new flat params), once a key."""
    key = ("contrastive", multi, grid)
    if key not in _JAX_STEPS:
        cfg = jenc.EncoderConfig(**ENC, multi_vector=multi)
        enc = jenc.RetrievalEncoder(cfg)
        mesh = jmesh(*grid)
        params = jax_place(enc.init(0), jenc.param_specs(cfg), mesh)
        bspec = NamedSharding(mesh, P("dp", None))
        batch = {k: jax.device_put(jnp.asarray(v), bspec)
                 for k, v in contrastive_batch(multi).items()}
        step = jax.jit(lambda p, b: jenc.contrastive_train_step(enc, p, b, lr=LR))
        new, loss = step(params, batch)
        _JAX_STEPS[key] = (float(loss), _flatten_params(jax.device_get(new)))
    return _JAX_STEPS[key]


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_sharded_contrastive_step_matches_jax_and_unsharded(multi, grid):
    cfg = tenc.EncoderConfig(**ENC, multi_vector=multi)
    init = _flatten_params(jenc.RetrievalEncoder(jenc.EncoderConfig(**ENC)).init(0))
    sp = tenc.shard_params(tenc.from_jax_params(init), cfg, tmesh(*grid))
    batch = torch_batch(contrastive_batch(multi))
    loss = float(pt.sharded_contrastive_train_step(sp, batch, lr=LR))
    got = tenc.gather_params(sp)

    j_loss, j_new = jax_sharded_contrastive(multi, grid)
    assert loss == pytest.approx(j_loss, rel=LOSS_RTOL)
    assert_tree_close(got, j_new)

    ref = tenc.RetrievalEncoder(cfg, device="cpu")
    ref.load_state_dict(tenc.from_jax_params(init))
    u_loss = float(tenc.contrastive_train_step(ref, batch, lr=LR))
    assert loss == pytest.approx(u_loss, rel=LOSS_RTOL)
    assert_tree_close(got, ref.state_dict())


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_padded_batches_and_uneven_heads_match_unsharded(multi):
    """Pad tokens in both modes (the port's multi-vector step stays finite
    on them) and a tp that splits heads (3 heads over tp = 2): the sharded
    step is still the unsharded step."""
    cfg = tenc.EncoderConfig(**{**ENC, "hidden": 48, "heads": 3}, multi_vector=multi)
    ref = tenc.RetrievalEncoder(cfg, device="cpu", seed=3)
    sp = tenc.shard_params(ref, cfg, tmesh(2, 2))
    arrays = contrastive_batch(False)
    batch = torch_batch(arrays)
    loss = float(pt.sharded_contrastive_train_step(sp, batch, lr=LR))
    u_loss = float(tenc.contrastive_train_step(ref, batch, lr=LR))
    assert np.isfinite(loss) and loss == pytest.approx(u_loss, rel=LOSS_RTOL)
    assert_tree_close(tenc.gather_params(sp), ref.state_dict())


def test_batch_not_divisible_by_dp_refused():
    cfg = tenc.EncoderConfig(**ENC)
    sp = tenc.shard_params(tenc.RetrievalEncoder(cfg, device="cpu"), cfg, tmesh(4, 1))
    batch = torch_batch(contrastive_batch(False, b=6))
    with pytest.raises(ValueError, match="does not split over dp=4"):
        pt.sharded_contrastive_train_step(sp, batch)


# --------------------------------------------------------------- LM steps
def lm_data(sft: bool):
    examples = [("q: a?", "b"), ("what is the capital?", "paris"), ("hi", "hello there"),
                ("café ☃?", "unicode")] * 2
    data = jlt.encode_sft(examples, seq_len=32)
    if not sft:
        data = {"ids": data["ids"], "mask": data["mask"]}
    return data


def jax_sharded_lm(sft: bool, grid):
    key = ("lm", sft, grid)
    if key not in _JAX_STEPS:
        cfg = jdec.DecoderConfig(**DEC)
        dec = jdec.CausalDecoder(cfg)
        mesh = jmesh(*grid)
        params = jax_place(dec.init(0), jdec.param_specs(cfg), mesh)
        bspec = NamedSharding(mesh, P("dp", None))
        batch = {k: jax.device_put(jnp.asarray(v), bspec) for k, v in lm_data(sft).items()}
        if sft:
            def step(p, b):
                loss, grads = jax.value_and_grad(lambda q: jlt._sft_loss(dec, q, b))(p)
                return jax.tree.map(lambda x, g: x - LR * g, p, grads), loss
        else:
            def step(p, b):
                return jdec.lm_train_step(dec, p, b, lr=LR)
        new, loss = jax.jit(step)(params, batch)
        _JAX_STEPS[key] = (float(loss), _flatten_params(jax.device_get(new)))
    return _JAX_STEPS[key]


@pytest.mark.parametrize("sft", [True, False], ids=["sft", "lm"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_sharded_lm_step_matches_jax_and_unsharded(sft, grid):
    cfg = tdec.DecoderConfig(**DEC)
    init = _flatten_params(jdec.CausalDecoder(jdec.DecoderConfig(**DEC)).init(0))
    sp = tdec.shard_params(tdec.decoder_params_from_jax(init), cfg, tmesh(*grid))
    batch = torch_batch(lm_data(sft))
    loss = float(pt.sharded_lm_train_step(sp, batch, lr=LR))
    got = tdec.gather_params(sp)

    j_loss, j_new = jax_sharded_lm(sft, grid)
    assert loss == pytest.approx(j_loss, rel=LOSS_RTOL)
    assert_tree_close(got, j_new)

    ref = tdec.CausalDecoder(cfg, device="cpu")
    ref.load_state_dict(tdec.decoder_params_from_jax(init))
    if sft:
        u_loss = float(tenc.sgd_step(ref, lambda: tlt._sft_loss(ref, batch), LR))
    else:
        u_loss = float(tdec.lm_train_step(ref, batch, lr=LR))
    assert loss == pytest.approx(u_loss, rel=LOSS_RTOL)
    assert_tree_close(got, ref.state_dict())


def test_sharded_adamw_state_is_the_unsharded_state():
    """Three AdamW SFT steps over a (2, 2) grid against ``LMTrainer``'s
    optimizer on one device: the weights and both moments, gathered."""
    cfg = tdec.DecoderConfig(**DEC)
    ref = tdec.CausalDecoder(cfg, device="cpu", seed=2).requires_grad_(True)
    sp = tdec.shard_params(ref, cfg, tmesh(2, 2))
    opt = pt.adamw(sp, 3e-3)
    ref_opt = torch.optim.AdamW(ref.parameters(), lr=3e-3, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.01)
    batch = torch_batch(lm_data(True))
    for _ in range(3):
        loss = float(pt.sharded_lm_train_step(sp, batch, optimizer=opt))
        ref_opt.zero_grad()
        u_loss = tlt._sft_loss(ref, batch)
        u_loss.backward()
        ref_opt.step()
        assert loss == pytest.approx(float(u_loss.detach()), rel=LOSS_RTOL)
    assert_tree_close(tdec.gather_params(sp), ref.state_dict())
    names = dict(ref.named_parameters())
    for key in ("exp_avg", "exp_avg_sq"):
        got = pt.gather_tree(sp, pick=lambda t, key=key: opt.state[t][key])
        assert_tree_close(got, {n: ref_opt.state[p][key] for n, p in names.items()})


# --------------------------------------------------------------- trainers
def mesh_catalogs(tmp_path, n=8):
    """``tests/test_models.py::test_trainer_sharded_mesh``'s catalog, once
    for each package."""
    from autorag_research_tpu.store.catalog import Catalog as JaxCatalog
    from autorag_research_tpu_torch.store.catalog import Catalog

    cats = []
    for cls, name in ((JaxCatalog, "jax"), (Catalog, "port")):
        cat = cls(tmp_path / f"{name}.db")
        cat.add_chunks([{"id": i, "contents": f"doc {i}"} for i in range(n)])
        cat.add_queries([{"id": i, "contents": f"query {i}"} for i in range(n)])
        for i in range(n):
            cat.add_retrieval_gt(i, i)
        cats.append(cat)
    return cats


MESH_CFG = dict(vocab_size=256, hidden=32, layers=1, heads=2, max_len=8, out_dim=16)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_bi_encoder_trainer_mesh_matches_jax(tmp_path, optimizer):
    """``tests/test_models.py::test_trainer_sharded_mesh``'s config on a (4, 2)
    mesh, loss by loss against the JAX trainer's report (and the port's
    unsharded trainer, whose weights the mesh trainer's equal)."""
    jcat, tcat = mesh_catalogs(tmp_path)
    kw = dict(batch_size=8, optimizer=optimizer)  # the JAX test's default lr, 1e-3
    jt = jtr.BiEncoderTrainer(jenc.EncoderConfig(**MESH_CFG), mesh=jmesh(4, 2), **kw)
    init = tenc.from_jax_params(_flatten_params(jt.params))
    tt = ttr.BiEncoderTrainer(tenc.EncoderConfig(**MESH_CFG), mesh=tmesh(4, 2), device="cpu", **kw)
    tt.load_params(init)
    ut = ttr.BiEncoderTrainer(tenc.EncoderConfig(**MESH_CFG), device="cpu", **kw)
    ut.load_params(init)
    ref = jt.train(jcat, epochs=4)
    got = tt.train(tcat, epochs=4)
    unsharded = ut.train(tcat, epochs=4)
    assert got.steps == ref.steps == unsharded.steps == 4
    # against JAX under AdamW: optax's f32 bias correction, as in
    # tests/test_torch_trainers.py (measured 1.3e-5 by the third step, where
    # the loss has fallen to 0.01)
    np.testing.assert_allclose(got.losses, ref.losses, atol=0,
                               rtol=LOSS_RTOL if optimizer == "sgd" else ADAMW_JAX_RTOL)
    np.testing.assert_allclose(got.losses, unsharded.losses, rtol=LOSS_RTOL, atol=0)
    assert_tree_close(tt.state_dict(), _flatten_params(jax.device_get(jt.params)),
                      atol=W_ATOL if optimizer == "sgd" else ADAMW_JAX_ATOL)
    assert_tree_close(tt.state_dict(), ut.state_dict())
    assert tt.encoder is None and tt.device == CPU


def test_trainer_dp_alignment_and_too_few_pairs(tmp_path):
    """``bsz = max(dp, bsz - bsz % dp)``: 6 pairs a batch on dp = 4 train
    4 a batch; fewer pairs than dp raise as in the JAX trainer."""
    _, tcat = mesh_catalogs(tmp_path)
    tt = ttr.BiEncoderTrainer(tenc.EncoderConfig(**MESH_CFG), batch_size=6, mesh=tmesh(4, 2),
                              device="cpu")
    sizes = []
    make = tt._make_batch
    tt._make_batch = lambda pairs: (sizes.append(len(pairs)), make(pairs))[1]
    report = tt.train(tcat, epochs=1)
    assert sizes == [4, 4] and report.steps == 2
    (tmp_path / "small").mkdir()
    j_small, t_small = mesh_catalogs(tmp_path / "small", n=3)
    jt = jtr.BiEncoderTrainer(jenc.EncoderConfig(**MESH_CFG), mesh=jmesh(4, 2))
    with pytest.raises(ValueError, match="need at least dp=4 training pairs") as ref:
        jt.train(j_small, epochs=1)
    with pytest.raises(ValueError, match="need at least dp=4 training pairs") as got:
        ttr.BiEncoderTrainer(tenc.EncoderConfig(**MESH_CFG), mesh=tmesh(4, 2),
                             device="cpu").train(t_small, epochs=1)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("resume_on", ["mesh", "unsharded"])
def test_checkpoint_round_trip_under_a_mesh(tmp_path, resume_on):
    """AdamW on a (2, 2) mesh: 2 steps and a checkpoint, then resumed to 5
    steps (on the mesh, or without one: the checkpoint is in the unsharded
    form) gives the losses and weights of the same interrupted run without
    a mesh; the files hold the gathered weights and every moment."""
    _, tcat = mesh_catalogs(tmp_path, n=16)
    cfg = tenc.EncoderConfig(**MESH_CFG)

    def trainer(mesh):
        return ttr.BiEncoderTrainer(cfg, lr=0.01, batch_size=4, optimizer="adamw",
                                    mesh=mesh, device="cpu")

    r1 = trainer(tmesh(2, 2)).train(tcat, epochs=5, max_steps=2, checkpoint_dir=tmp_path / "m")
    resumed = trainer(tmesh(2, 2) if resume_on == "mesh" else None)
    r2 = resumed.train(tcat, epochs=5, max_steps=5, checkpoint_dir=tmp_path / "m")
    assert (r1.steps, r2.steps) == (2, 3)
    u1 = trainer(None).train(tcat, epochs=5, max_steps=2, checkpoint_dir=tmp_path / "u")
    ref = trainer(None)
    u2 = ref.train(tcat, epochs=5, max_steps=5, checkpoint_dir=tmp_path / "u")
    np.testing.assert_allclose(r1.losses + r2.losses, u1.losses + u2.losses, rtol=LOSS_RTOL)
    assert_tree_close(resumed.state_dict(), ref.state_dict())
    with np.load(tmp_path / "m" / "step_5" / "params.npz") as data:
        assert_tree_close({k: data[k] for k in data.files}, resumed.state_dict(), atol=0)
    mesh_state = torch.load(tmp_path / "m" / "step_2" / "state.pt", weights_only=True)
    ref_state = torch.load(tmp_path / "u" / "step_2" / "state.pt", weights_only=True)
    assert mesh_state["step"] == 2
    assert set(mesh_state["optimizer"]["state"]) == set(ref_state["optimizer"]["state"])
    for idx, entry in ref_state["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(mesh_state["optimizer"]["state"][idx][key].numpy(),
                                       entry[key].numpy(), rtol=0, atol=W_ATOL)


def test_mesh_trained_weights_serve(tmp_path):
    """``save`` and ``as_embedding`` under a mesh give the gathered weights:
    the ``.npz`` loads into ``TorchEncoderEmbedding`` and the JAX loader."""
    from autorag_research_tpu.embeddings.jax_encoder import JaxEncoderEmbedding
    from autorag_research_tpu_torch.embeddings.torch_encoder import TorchEncoderEmbedding

    _, tcat = mesh_catalogs(tmp_path)
    cfg = tenc.EncoderConfig(**MESH_CFG)
    tt = ttr.BiEncoderTrainer(cfg, batch_size=8, mesh=tmesh(2, 2), device="cpu")
    tt.train(tcat, epochs=2)
    tt.save(tmp_path / "m.npz")
    texts = ["query 1", "doc 3", ""]
    ref = tt.as_embedding().embed_texts(texts)
    loaded = TorchEncoderEmbedding(cfg, params_path=tmp_path / "m.npz", device="cpu").embed_texts(texts)
    np.testing.assert_array_equal(np.asarray(loaded), np.asarray(ref))
    jax_emb = JaxEncoderEmbedding(jenc.EncoderConfig(**MESH_CFG), params_path=tmp_path / "m.npz")
    np.testing.assert_allclose(np.asarray(jax_emb.embed_texts(texts)), np.asarray(ref), atol=1e-5)


# ------------------------------------------------------------ two processes
_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    sys.path.insert(0, {repo!r})
    from autorag_research_tpu_torch.models import encoder as tenc, decoder as tdec
    from autorag_research_tpu_torch.parallel import train as pt
    from autorag_research_tpu_torch.parallel.distributed import global_train_mesh, initialize_distributed
    rank = int(sys.argv[1])
    assert initialize_distributed("tcp://127.0.0.1:{port}", 2, rank, backend="gloo") is True
    data = np.load({data!r})
    out = {{}}
    try:
        global_train_mesh(tp=4, local_devices=[torch.device("cpu")] * 2)
        cfg = tenc.EncoderConfig(**{enc!r})
        tenc.shard_params(tenc.RetrievalEncoder(cfg, device="cpu"), cfg,
                          global_train_mesh(tp=4, local_devices=[torch.device("cpu")] * 2))
    except ValueError as exc:
        out["refused"] = str(exc)
    mesh = global_train_mesh(tp=2, local_devices=[torch.device("cpu")] * 4)
    out["ranks"] = mesh.ranks
    batch = {{k: torch.from_numpy(data[k]) for k in ("q_ids", "q_mask", "d_ids", "d_mask")}}
    for multi in (False, True):
        cfg = tenc.EncoderConfig(**{enc!r}, multi_vector=multi)
        sp = tenc.shard_params(tenc.RetrievalEncoder(cfg, device="cpu", seed=5), cfg, mesh)
        opt = pt.adamw(sp, 0.01)
        losses = [float(pt.sharded_contrastive_train_step(sp, batch, optimizer=opt)) for _ in range(2)]
        out[f"enc{{int(multi)}}"] = [losses, {{k: v.tolist() for k, v in tenc.gather_params(sp).items()}}]
    lm = {{k: torch.from_numpy(data[k]) for k in ("ids", "mask", "loss_mask")}}
    cfg = tdec.DecoderConfig(**{dec!r})
    sp = tdec.shard_params(tdec.CausalDecoder(cfg, device="cpu", seed=5), cfg, mesh)
    loss = float(pt.sharded_lm_train_step(sp, lm, lr=0.05))
    out["lm"] = [[loss], {{k: v.tolist() for k, v in tdec.gather_params(sp).items()}}]
    print(json.dumps(out))
""")


def test_two_gloo_processes_match_one_process_grid(tmp_path):
    """Two gloo processes, each holding two dp rows of a (4, 2) grid (dp
    across processes: the embeddings all-gathered with autograd, the
    gradients all-reduced), give the one-process (4, 2) grid's losses and
    weights (contrastive single and multi-vector under AdamW, the SFT step);
    a tp group across the processes is refused. Each process has 90 s."""
    arrays = contrastive_batch(False)
    arrays["q_ids"] = arrays["q_ids"].astype(np.int64)
    arrays["d_ids"] = arrays["d_ids"].astype(np.int64)
    lm = lm_data(True)
    np.savez(tmp_path / "data.npz", **arrays, ids=lm["ids"].astype(np.int64), mask=lm["mask"],
             loss_mask=lm["loss_mask"])
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=str(REPO), port=port, data=str(tmp_path / "data.npz"),
                                     enc=ENC, dec=DEC))
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, str(script), str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env) for r in (0, 1)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=90)
            assert proc.returncode == 0, err
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            proc.kill()
    assert outs[0] == outs[1]
    assert outs[0]["ranks"] == [[0, 0], [0, 0], [1, 1], [1, 1]]
    assert "spans processes" in outs[0]["refused"]
    batch = torch_batch(arrays)
    for multi in (False, True):
        cfg = tenc.EncoderConfig(**ENC, multi_vector=multi)
        sp = tenc.shard_params(tenc.RetrievalEncoder(cfg, device="cpu", seed=5), cfg, tmesh(4, 2))
        opt = pt.adamw(sp, 0.01)
        losses = [float(pt.sharded_contrastive_train_step(sp, batch, optimizer=opt)) for _ in range(2)]
        got_losses, got = outs[0][f"enc{int(multi)}"]
        np.testing.assert_allclose(got_losses, losses, rtol=LOSS_RTOL)
        assert_tree_close(got, tenc.gather_params(sp))
    cfg = tdec.DecoderConfig(**DEC)
    sp = tdec.shard_params(tdec.CausalDecoder(cfg, device="cpu", seed=5), cfg, tmesh(4, 2))
    loss = float(pt.sharded_lm_train_step(sp, torch_batch(lm), lr=0.05))
    np.testing.assert_allclose(outs[0]["lm"][0], [loss], rtol=LOSS_RTOL)
    assert_tree_close(outs[0]["lm"][1], tdec.gather_params(sp))


def test_tp_group_across_processes_refused_in_one_process():
    """A mesh whose rows list two ranks is refused before any step."""
    from autorag_research_tpu_torch.parallel.mesh import DeviceMesh

    mesh = DeviceMesh([[CPU, CPU], [CPU, CPU]], [[0, 1], [0, 1]], axis_names=("dp", "tp"))
    cfg = tenc.EncoderConfig(**ENC)
    with pytest.raises(ValueError, match="spans processes"):
        tenc.shard_params(tenc.RetrievalEncoder(cfg, device="cpu"), cfg, mesh)


# ---------------------------------------------------------------------- CLI
@pytest.mark.parametrize("grid", [(1, 1), (4, 2)], ids=["device-cpu", "4x2"])
def test_cli_train_mesh(tmp_path, capsys, monkeypatch, grid):
    """``train --model bi --mesh``: over ``--device cpu`` (a 1 x 1 mesh) or,
    with the visible devices stood in by 8 CPU entries, a (4, 2) mesh; the
    losses and the ``.npz`` equal the unsharded ``train``'s (the weights
    within 1e-5), and the JAX loader reads the file."""
    from autorag_research_tpu.embeddings.jax_encoder import load_params
    from autorag_research_tpu_torch.cli.app import main
    from autorag_research_tpu_torch.parallel import mesh as tmesh_mod
    from autorag_research_tpu_torch.store.catalog import Catalog
    from autorag_research_tpu_torch.store.gt import or_all

    ws = tmp_path / "trainws"
    ws.mkdir()
    cat = Catalog(ws / "catalog.db")
    docs = [f"topic {chr(97 + i)} text" for i in range(8)]
    cat.add_chunks([{"id": i, "contents": d} for i, d in enumerate(docs)])
    cat.add_queries([{"id": i, "contents": f"find {chr(97 + i)}"} for i in range(8)])
    for i in range(8):
        cat.add_retrieval_gt(i, or_all([i]))
    cat.close()
    if grid != (1, 1):
        monkeypatch.setattr(tmesh_mod, "device_train_mesh", lambda device: tmesh(*grid))
    argv = ["--device", "cpu", "train", "--db", str(ws), "--model", "bi", "--epochs", "3",
            "--batch-size", "8", "--hidden", "32", "--layers", "1"]
    capsys.readouterr()
    assert main([*argv, "--out", str(tmp_path / "mesh.npz"), "--mesh"]) == 0
    mesh_out = capsys.readouterr().out
    assert main([*argv, "--out", str(tmp_path / "one.npz")]) == 0
    one_out = capsys.readouterr().out
    assert "trained 3 steps" in mesh_out and "saved params" in mesh_out

    def losses(text):
        line = next(x for x in text.splitlines() if x.startswith("trained"))
        return [float(v) for v in line.split("(loss ")[1].rstrip(")").split(" -> ")]

    np.testing.assert_allclose(losses(mesh_out), losses(one_out), rtol=1e-4)
    with np.load(tmp_path / "mesh.npz") as a, np.load(tmp_path / "one.npz") as b:
        assert_tree_close({k: a[k] for k in a.files}, {k: b[k] for k in b.files})
    template = jenc.RetrievalEncoder(jenc.EncoderConfig(hidden=32, layers=1, out_dim=16)).init(0)
    loaded = _flatten_params(load_params(template, tmp_path / "mesh.npz"))
    with np.load(tmp_path / "mesh.npz") as a:
        assert_tree_close(loaded, {k: a[k] for k in a.files}, atol=0)


# ------------------------------------------------------------------ dry run
@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_ids_equal_jax(n):
    """``entry.dryrun_multichip(n, "cpu")`` runs every sharded path and prints
    the JAX dry run's ids (dense, int8, BM25, MaxSim, IVF); the losses are
    the port's seeded weights', so only their finiteness is compared."""
    import __graft_entry__ as graft

    from autorag_research_tpu_torch.entry import dryrun_multichip

    got = dryrun_multichip(n, "cpu")
    buf = io.StringIO()
    with redirect_stdout(buf):
        graft.dryrun_multichip(n)
    ref = buf.getvalue().strip().splitlines()[-1]
    assert got.startswith(f"dryrun_multichip ok: {n} devices, train loss ")
    assert got.split(", sharded dense ids ")[1] == ref.split(", sharded dense ids ")[1]


def test_entry_step_runs_on_the_cpu():
    from autorag_research_tpu_torch.entry import entry

    fn, args = entry("cpu")
    scores, ids = fn(*args)
    assert tuple(scores.shape) == tuple(ids.shape) == (16, 10)
    assert torch.isfinite(scores).all() and int(ids.max()) < 4096


def test_entry_module_refuses_cuda_without_a_card(monkeypatch, capsys):
    from autorag_research_tpu_torch.entry import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--dryrun", "2"]) == 2
    assert "no CUDA GPU" in capsys.readouterr().err
