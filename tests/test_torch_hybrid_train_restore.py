"""The port's hybrid training (Griffin/RecurrentGemma) through C/R on the
CPU: the trainer through kill -> ``restore("latest")``; its training
chains restored by the JAX package and the JAX package's by the port;
and the card's plan (the port's own byte count) on a fake 80 GB card.
The configurations are ``test_torch_hybrid_train.py``'s."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.parallel.planner import make_plan as jmake_plan
from repro_torch import convert
from repro_torch.api import CheckpointSession, Policy
from repro_torch.configs import registry as treg
from repro_torch.models import model as M
from repro_torch.parallel import planner
from repro_torch.train.loop import Trainer, TrainJob
from test_torch_cross_restore import _jax_training_chain, _port_training_chain
from test_torch_hybrid_train import MATRIX, MESH

SMALL = dict(sparse_chunk_bytes=1024, sparse_min_bytes=2048)


def test_trainer_kill_restore_continues_bit_identically(tmp_path):
    policy = Policy(interval=2, chain=2, **SMALL)
    sess = CheckpointSession(f"localfs:{tmp_path}", policy)
    t = Trainer(TrainJob(MATRIX, "train_s24_b2"), manager=sess.manager,
                device="cpu")
    t.init_state()
    sess.attach(t)
    losses = []
    for _ in range(5):
        losses.append(t.train_steps(1)["loss"])
        sess.maybe_snapshot()
    sess.wait()
    want = t.state_digest()
    assert sess.restorable_steps() == [2, 4]
    sess.close()
    del t                                        # the kill
    sess2 = CheckpointSession(f"localfs:{tmp_path}", policy)
    t2 = sess2.restore("latest", expect_kind="train", device="cpu")
    assert t2.checkpoint_step() == 4
    assert t2.train_steps(1)["loss"] == losses[4]
    assert t2.state_digest() == want
    sess2.close()


def test_port_hybrid_training_chain_restores_under_jax(tmp_path):
    _port_training_chain(tmp_path, MATRIX, "train_s24_b2",
                         ["['groups']['b0_rglru']['rg_lambda']",
                          "['groups']['b2_attn']['attn']['wq']"])


def test_jax_hybrid_training_chain_restores_under_the_port(tmp_path):
    """The JAX step starts from the port's seeded init (bf16, as the
    trainer's), handed over as arrays."""
    tparams = M.init_params(treg.resolve_config(MATRIX), seed=0,
                            device="cpu")
    jparams = jax.tree.map(
        lambda a: jnp.asarray(a.view(ml_dtypes.bfloat16)
                              if a.dtype == np.uint16 else a),
        convert.tree_to_numpy(tparams))
    _jax_training_chain(tmp_path, MATRIX, "train_s24_b2", jparams)


# --- the card's plan ----------------------------------------------------------

CARD = 80e9


def test_card_plan_counts_what_the_port_stores():
    """On a card (a fake 80 GB one here) the plan counts the template's
    params (8,524,206,080 for recurrentgemma-9b, where ``n_params()``
    says 6,611,185,664), f32 moments (8 bytes a param) and the bf16
    gradients; the cut that chip_smoke.py trains fits, full depth is
    refused before anything is allocated, naming the bytes and A9."""
    full = treg.resolve_config("recurrentgemma-9b")
    cut = treg.resolve_config("recurrentgemma-9b-layers3")
    shape = treg.get_shape("train_s4096_b2")
    assert M.param_count(full) == 8_524_206_080
    assert full.n_params() == 6_611_185_664
    est = planner.estimate_card_train_memory(cut, shape, 1)
    n = M.param_count(cut)
    assert n == 1_637_986_304
    assert est.params == 2 * n
    assert est.opt_state == 8 * n + 2 * n
    plan = planner.card_plan(cut, shape, CARD)
    assert (plan.remat, plan.grad_accum) == ("full", 1)
    with pytest.raises(MemoryError, match="A9") as err:
        planner.card_plan(full, shape, CARD)
    assert "8524206080 params" in str(err.value)
    assert "85.2 GB" in str(err.value) and "102.3 GB" in str(err.value)
    # the CPU's plan stays the reference's, term for term
    want = jmake_plan(jreg.resolve_config("recurrentgemma-9b"),
                      jreg.get_shape("train_s4096_b2"), MESH)
    got = planner.make_plan(full, shape)
    assert (got.grad_accum, got.remat) == (want.grad_accum, want.remat)


def test_a_card_trainer_refuses_full_depth_before_allocating(monkeypatch):
    """The Trainer builds its step (and so its plan) before any state:
    on a card too small for the params and moments it raises there."""
    class Props:
        total_memory = CARD

    monkeypatch.setattr(planner, "_on_card", lambda device: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props())
    with pytest.raises(MemoryError, match="ROADMAP A9"):
        Trainer(TrainJob("recurrentgemma-9b", "train_s4096_b2"),
                device="cpu")
    t = Trainer(TrainJob("recurrentgemma-9b-layers3", "train_s4096_b2"),
                device="cpu")
    assert t.plan.grad_accum == 1 and "(card)" in t.plan.notes
