"""The port's DAMSM pretraining step against attngan_tpu's DamsmTrainer.

Both trainers run the tiny image encoder in fp32 with dropout 0 (JAX's
dropout stream cannot be reproduced by a torch.Generator). The JAX state is
flattened to numpy and loaded into the port through
attngan_torch.convert.load_damsm_flat: weights, Adam moments and count,
step. Then both take the same steps on the same batch, and the loss parts,
the BiLSTM's gradient norm and the updated parameters are compared after 1
and after 3 steps, from a fresh state and from a converted mid-run state.

Tolerance 1e-4 (relative on the metrics, absolute on parameters and
moments): the same fp32 step with other summation orders; Adam divides by
sqrt(nu), so rounding in a small gradient moves its update by more than it
moves the gradient (observed ~1e-6).
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from attngan_tpu.core.config import DamsmConfig as JaxDamsmConfig
from attngan_tpu.train.damsm_trainer import DamsmTrainer as JaxDamsmTrainer

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.convert import convert_damsm_flat, load_damsm_flat
from attngan_torch.core.config import DamsmConfig
from attngan_torch.train.damsm_trainer import DamsmTrainer

B, L, VOCAB, RES = 4, 5, 30, 64
SHAPE = dict(emb_dim=32, text_emb_dim=16, batch_size=B, image_encoder="tiny",
             compute_dtype="", dropout=0.0)
METRICS = ("loss", "rnn_grad_norm", "words_loss", "sentence_loss")
ATOL = 1e-4


def _batch():
    rng = np.random.default_rng(3)
    return {"tokens": rng.integers(0, VOCAB, (B, L)).astype(np.int32),
            "lengths": np.array([5, 3, 4, 2], np.int32),
            "class_ids": np.array([0, 1, 0, 3], np.int32),
            "img256": (rng.standard_normal((B, RES, RES, 3)) * 0.5).astype(
                np.float32)}


def _key(entry) -> str:
    for attr in ("idx", "name", "key"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(entry)


def flatten_damsm_state(state) -> dict:
    """A JAX DamsmState -> the {path: np.ndarray} dict convert.py reads
    (everything but the PRNG key)."""
    out = {}
    for field in ("rnn_params", "cnn_head_params", "cnn_trunk_params",
                  "cnn_stats"):
        for k, v in traverse_util.flatten_dict(getattr(state, field),
                                               sep="/").items():
            out[f"{field}/{k}"] = np.array(v)
    for path, leaf in jax.tree_util.tree_flatten_with_path(state.opt_state)[0]:
        out["opt_state/" + "/".join(_key(p) for p in path)] = np.array(leaf)
    out["step"] = np.array(state.step)
    return out


def _jax_run(steps, rnn_grad_clip=0.25, warmup=0):
    """(flat state before, [metrics per step], [flat state after each])."""
    cfg = JaxDamsmConfig(rnn_grad_clip=rnn_grad_clip, **SHAPE)
    trainer = JaxDamsmTrainer(cfg, vocab_size=VOCAB, seq_len=L,
                              image_res=RES)
    state = trainer.init_state(seed=0)
    batch = {k: jax.numpy.asarray(v) for k, v in _batch().items()}
    for _ in range(warmup):
        state, _ = trainer.train_step(state, batch)
    start = flatten_damsm_state(state)
    metrics, states = [], []
    for _ in range(steps):
        state, m = trainer.train_step(state, batch)
        metrics.append({k: float(m[k]) for k in METRICS})
        states.append(flatten_damsm_state(state))
    return start, metrics, states


@pytest.fixture(scope="module")
def fresh():
    return _jax_run(steps=3)


@pytest.fixture(scope="module")
def mid_run():
    return _jax_run(steps=1, warmup=2)


def _port(flat, fused, **cfg):
    trainer = DamsmTrainer(DamsmConfig(fused_similarity=fused, **SHAPE, **cfg),
                           VOCAB, L, device="cpu")
    state = trainer.init_state(seed=1)
    load_damsm_flat(flat, state)
    return trainer, state


def _assert_state_matches(state, flat):
    want = convert_damsm_flat(flat)
    got_rnn = state.rnn.state_dict()
    for k, v in want["rnn"].items():
        np.testing.assert_allclose(got_rnn[k].numpy(), v.numpy(), atol=ATOL,
                                   err_msg=k)
    got_cnn = state.cnn.state_dict()
    for k in ("emb_features.weight", "emb_cnn_code.weight",
              "emb_cnn_code.bias", "trunk.Conv_0.weight"):
        np.testing.assert_allclose(got_cnn[k].numpy(), want["cnn"][k].numpy(),
                                   atol=ATOL, err_msg=k)
    params = dict(state.trainable())
    for name, slot in want["adam"].items():
        opt = state.optimizer.state[params[name]]
        assert int(opt["step"]) == want["count"]
        for k, v in slot.items():
            np.testing.assert_allclose(opt[k].numpy(), v.numpy(), atol=ATOL,
                                       err_msg=f"{name} {k}")
    assert state.step == want["step"]


def _assert_metrics(got, want):
    for k in METRICS:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_steps_match_jax(fresh, fused):
    start, metrics, states = fresh
    trainer, state = _port(start, fused)
    batch = _batch()
    for i in range(3):
        state, m = trainer.train_step(state, batch)
        _assert_metrics(m, metrics[i])
        if i in (0, 2):
            _assert_state_matches(state, states[i])
    # the clip bit: the first step's BiLSTM gradient norm is above 0.25
    assert metrics[0]["rnn_grad_norm"] > 0.25
    assert metrics[-1]["loss"] < metrics[0]["loss"]


def test_step_from_converted_mid_run_state(mid_run):
    start, metrics, states = mid_run
    assert int(start["opt_state/0/count"]) == 2
    assert np.abs(start["opt_state/0/nu/rnn/w_ih_fwd"]).max() > 0
    trainer, state = _port(start, fused=True)
    state, m = trainer.train_step(state, _batch())
    _assert_metrics(m, metrics[0])
    _assert_state_matches(state, states[0])


def test_step_without_clipping_matches_jax():
    start, metrics, states = _jax_run(steps=1, rnn_grad_clip=100.0)
    assert metrics[0]["rnn_grad_norm"] < 100.0      # scale 1
    trainer, state = _port(start, fused=True, rnn_grad_clip=100.0)
    state, m = trainer.train_step(state, _batch())
    _assert_metrics(m, metrics[0])
    _assert_state_matches(state, states[0])


def test_encoders_match_jax(fresh):
    start, _, _ = fresh
    cfg = JaxDamsmConfig(**SHAPE)
    jax_trainer = JaxDamsmTrainer(cfg, vocab_size=VOCAB, seq_len=L,
                                  image_res=RES)
    jax_state = jax_trainer.init_state(seed=0)
    trainer, state = _port(flatten_damsm_state(jax_state), fused=True)
    batch = _batch()
    for got, want in zip(
            trainer.encode_text(state, batch["tokens"], batch["lengths"])
            + trainer.encode_image(state, batch["img256"]),
            jax_trainer.encode_text(jax_state, batch["tokens"],
                                    batch["lengths"])
            + jax_trainer.encode_image(jax_state, batch["img256"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_converter_is_strict(fresh):
    start, _, _ = fresh
    counts = {t: sum(k.startswith(t + "/") for k in start)
              for t in ("rnn_params", "cnn_head_params", "cnn_trunk_params",
                        "opt_state")}
    assert counts == {"rnn_params": 7, "cnn_head_params": 3,
                      "cnn_trunk_params": 6, "opt_state": 21}
    _, state = _port(start, fused=True)
    with pytest.raises(KeyError, match="unexpected"):
        load_damsm_flat({**start, "gen_params/x/kernel": np.zeros(1)}, state)
    with pytest.raises(KeyError, match="unexpected trunk"):
        load_damsm_flat({**start, "cnn_trunk_params/x/kernel": np.zeros(1)},
                        state)
    with pytest.raises(KeyError, match="unexpected optimizer"):
        load_damsm_flat({**start, "opt_state/0/mu/gen/x": np.zeros(1)}, state)
    missing = dict(start)
    del missing["cnn_trunk_params/trunk/Conv_1/bias"]
    with pytest.raises(RuntimeError, match="Conv_1.bias"):
        load_damsm_flat(missing, state)
    missing = dict(start)
    del missing["opt_state/0/nu/cnn_heads/emb_cnn_code/bias"]
    with pytest.raises(KeyError, match="lacks"):
        load_damsm_flat(missing, state)
    missing = dict(start)
    del missing["opt_state/0/count"]
    with pytest.raises(KeyError, match="count"):
        load_damsm_flat(missing, state)


def test_trainer_runs_on_the_gpu_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DamsmTrainer(DamsmConfig(**SHAPE), VOCAB, L)
    assert DamsmTrainer(DamsmConfig(**SHAPE), VOCAB, L,
                        device="cpu").device == torch.device("cpu")


def test_dropout_draws_from_the_state_generator():
    cfg = DamsmConfig(**{**SHAPE, "dropout": 0.5})
    trainer = DamsmTrainer(cfg, VOCAB, L, device="cpu")
    losses = []
    for _ in range(2):
        state = trainer.init_state(seed=5)
        torch.manual_seed(len(losses))           # the global RNG is not read
        losses.append(float(trainer.train_step(state, _batch())[1]["loss"]))
    assert losses[0] == losses[1]
    state = trainer.init_state(seed=5)
    state.generator.manual_seed(6)
    assert float(trainer.train_step(state, _batch())[1]["loss"]) != losses[0]
