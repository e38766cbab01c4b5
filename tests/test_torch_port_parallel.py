"""The port's data parallelism against one process and against the JAX
package's sharded run.

The ranks are CPU processes joined by gloo (tests/torch_parallel_ranks.py):
one spawn of 2 ranks and one of 4 (the 2-D (2, 2) mesh) run every job, and
each rank's result comes back to this process, which compares it with
(a) the same job of the port in this process on the whole batch, and
(b) the JAX package on its 8-device CPU mesh (tests/conftest.py) with a
mesh of the same size: the sharded DAMSM loss (``make_sharded_damsm_loss``),
the sharded ``DamsmTrainer`` and ``GanTrainer`` steps from the same
converted weights, and the sharded ``Sampler``.

Cases: the sharded loss and its gradients (the plain and the kernels' CPU
route); the pretrain step in each form (plain with dropout, cached,
superbatch, the Inception trunk's train-mode BN); a GAN step with the
coupling (3 stages) and one at 2 stages (the synced BN statistics and
every parameter after the update); sharded sampling; the ranks' states
equal bit for bit; ``mesh_size_for_batch`` against JAX's
``make_mesh_for_batch``, its errors and the (2, 2) shape. The gradient-scale
proof: the pretrain step with the gradients' mean left out, or with the
BiLSTM's clip taken before it, must fail the comparison that the correct
step passes.

Tolerances are the port's fp32 parity tests' (tests/test_torch_port_
damsm_trainer.py, tests/test_torch_port_gan_trainer.py): 1e-4 relative on
metrics, 1e-4 absolute on parameters, statistics and moments. Two things
of a step are ill-posed in fp32 whatever computes it, and are held so:
- Adam moves a weight by lr * m / (sqrt(v) + eps), about +-lr whatever the
  size of its gradient, so an element whose gradient lies within rounding
  of 0 moves by an amount that rounding decides: a parameter may differ by
  a further lr times the difference of the two runs' m / (sqrt(v) + eps)
  (at most 2 * lr a step: a GAN step's, where the first moments lie on two
  sides of 0), while the moments themselves are held at 1e-4.
- A GAN step's gradients pass through train-mode BatchNorm over 4 images
  at every stage. Where the fakes saturate (tanh near +-1), a channel is
  nearly constant over the batch, and BN's 1 / sqrt(var + eps) turns the
  ranks' other summation order (fakes within ~1e-5) into gradients ~1%
  apart, though the same discriminator step on the same inputs agrees to
  ~2e-6. So the four Adams' moments of a GAN step, which are its
  gradients (m, and sqrt(v) for the second), are held in norm at
  GAN_GRAD_RTOL = 0.1, the rule chip_smoke.py holds the fp32 GAN step's
  gradients to across devices; its metrics, parameters and BN statistics
  stay elementwise.
The loss's gradients: each rank's are n times its rows' share (the
gathers' backward sums the replicated loss of every rank; the trainers'
mean divides it back), held after the division at 1e-4 relative and 1e-5
absolute, as tests/test_torch_port_damsm_losses.py holds the loss's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch threads under xdist)
from torch_parallel_ranks import JOBS, run_ranks

from attngan_tpu.core.config import DamsmConfig as JaxDamsmConfig
from attngan_tpu.core.config import GanConfig as JaxGanConfig
from attngan_tpu.infer.sampler import Sampler as JaxSampler
from attngan_tpu.losses.damsm_sharded import (
    make_sharded_damsm_loss as jax_sharded_loss,
)
from attngan_tpu.parallel import make_mesh, make_mesh_for_batch, replicate
from attngan_tpu.parallel import shard_batch
from attngan_tpu.train.damsm_trainer import DamsmTrainer as JaxDamsmTrainer
from attngan_tpu.train.gan_trainer import GanTrainer as JaxGanTrainer

from attngan_torch.core.config import DamsmConfig
from attngan_torch.parallel.mesh import mesh_size_for_batch
from attngan_torch.train.damsm_trainer import DamsmTrainer
from test_torch_port_damsm_trainer import (
    _assert_state_matches as assert_damsm_state_matches,
)
from test_torch_port_damsm_trainer import flatten_damsm_state
from test_torch_port_gan_trainer import flatten_gan_state

B, L, VOCAB = 4, 5, 30
RTOL = ATOL = 1e-4
GAN_GRAD_RTOL = 0.1
DAMSM = dict(emb_dim=32, text_emb_dim=16, batch_size=B, image_encoder="tiny",
             compute_dtype="")
GAN = dict(gf_dim=8, df_dim=4, emb_dim=32, cond_dim=4, z_dim=4, seq_len=L,
           batch_size=B, image_encoder="tiny", compute_dtype="")
GAN2 = dict(GAN, num_stages=2)
GAN3 = dict(GAN, num_stages=3)


def _batch(seed, resolutions=(64,), img256=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, VOCAB, (B, L)).astype(np.int32),
             "lengths": np.array([5, 3, 4, 2], np.int32),
             "class_ids": np.array([0, 1, 0, 3], np.int32)}
    for res in resolutions:
        key = "img256" if img256 else f"img{res}"
        batch[key] = np.tanh(rng.standard_normal(
            (B, res, res, 3))).astype(np.float32)
    return batch


def _loss_inputs():
    rng = np.random.default_rng(0)
    r, d = 9, 8
    mask = (rng.random((B, L)) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    return {"img": rng.standard_normal((B, r, d)).astype(np.float32),
            "code": rng.standard_normal((B, d)).astype(np.float32),
            "words": rng.standard_normal((B, L, d)).astype(np.float32),
            "sent": rng.standard_normal((B, d)).astype(np.float32),
            "mask": mask, "class_ids": np.array([0, 1, 0, 1], np.int64)}


# ------------------------------------------------- the JAX side, once

@pytest.fixture(scope="module")
def jax_damsm():
    """A JAX DamsmState (dropout 0) and its sharded step on 2 and on (2, 2)
    devices: {"flat": state before, n: (metrics, flat state after)}."""
    cfg = JaxDamsmConfig(dropout=0.0, **DAMSM)
    trainer = JaxDamsmTrainer(cfg, vocab_size=VOCAB, seq_len=L, image_res=64)
    state = trainer.init_state(seed=0)
    out = {"flat": flatten_damsm_state(state)}
    batch = {k: jnp.asarray(v) for k, v in _batch(1, img256=True).items()}
    for shape in ((2,), (2, 2)):
        mesh = make_mesh(shape=shape)
        sharded = JaxDamsmTrainer(cfg, vocab_size=VOCAB, seq_len=L,
                                  image_res=64, mesh=mesh)
        st, m = sharded.train_step(
            replicate(jax.tree_util.tree_map(jnp.copy, state), mesh),
            shard_batch(dict(batch), mesh))
        out[shape] = ({k: float(v) for k, v in m.items()},
                      flatten_damsm_state(st))
    return out


@pytest.fixture(scope="module")
def jax_gan():
    """A 2-stage JAX GanState, its draws at the global batch, and its
    sharded step on 2 devices."""
    cfg = JaxGanConfig(**GAN2)
    trainer = JaxGanTrainer(cfg, vocab_size=VOCAB)
    state = jax.jit(trainer.init_state, static_argnums=0)(0)
    flat = flatten_gan_state(state)
    _, k_noise, k_reparam, k_label = jax.random.split(state.key, 4)
    draws = {"noise": np.array(jax.random.normal(k_noise, (B, cfg.z_dim))),
             "eps": np.array(jax.random.normal(k_reparam, (B, cfg.cond_dim))),
             "real_labels": None}
    mesh = make_mesh(shape=(2,))
    sharded = JaxGanTrainer(cfg, vocab_size=VOCAB, mesh=mesh)
    batch = {k: jnp.asarray(v) for k, v in _batch(3, (64, 128)).items()}
    st, m = sharded.train_step(
        replicate(jax.tree_util.tree_map(jnp.copy, state), mesh),
        shard_batch(dict(batch), mesh))
    return {"flat": flat, "draws": draws, "cfg": cfg,
            "metrics": {k: float(v) for k, v in m.items()},
            "after": flatten_gan_state(st), "state": state,
            "trainer": trainer}


@pytest.fixture(scope="module")
def jax_samples(jax_gan):
    """JAX's sharded Sampler on 2 and on (2, 2) devices over the 2-stage
    state, and the noise and eps it drew: {shape: stages}."""
    from attngan_torch.convert import convert_flat

    trainer, state = jax_gan["trainer"], jax_gan["state"]
    batch = _batch(5, ())
    key = jax.random.key(7)
    k_noise, k_reparam = jax.random.split(key)
    cfg = jax_gan["cfg"]
    out = {"noise": np.array(jax.random.normal(k_noise, (B, cfg.z_dim))),
           "eps": np.array(jax.random.normal(k_reparam, (B, cfg.cond_dim))),
           "tokens": batch["tokens"], "lengths": batch["lengths"]}
    sub = {k: v for k, v in jax_gan["flat"].items()
           if k.split("/")[0] in ("rnn_params", "gen_params", "gen_stats")}
    sd = convert_flat(sub)
    out["weights"] = {**{f"rnn.{k}": v.numpy() for k, v in sd["rnn"].items()},
                      **{f"generator.{k}": v.numpy()
                         for k, v in sd["generator"].items()}}
    for shape in ((2,), (2, 2)):
        mesh = make_mesh(shape=shape)
        sampler = JaxSampler(trainer, replicate(state, mesh), mesh=mesh)
        tokens, lengths = shard_batch(
            (jnp.asarray(batch["tokens"]), jnp.asarray(batch["lengths"])),
            mesh)
        stages, attns = sampler.generate_stages(tokens, lengths, key)
        out[shape] = ([np.asarray(x) for x in stages],
                      [np.asarray(a) for a in attns])
    return out


# ------------------------------------------------- the ranks, twice

def _jobs(jax_damsm, jax_gan, jax_samples, shape):
    """(name, mesh shape, kwargs) of every job a spawn runs."""
    inputs = _loss_inputs()
    damsm_batches = [_batch(1, img256=True), _batch(2, img256=True)]
    plain = dict(cfg=dict(DAMSM, dropout=0.0), vocab=VOCAB, seq_len=L,
                 batches=damsm_batches[:1], flat=jax_damsm["flat"])
    gan2 = dict(cfg=GAN2, vocab=VOCAB, batch=_batch(3, (64, 128)),
                draws=[jax_gan["draws"]], flat=jax_gan["flat"])
    sample = dict(cfg=GAN2, vocab=VOCAB, tokens=jax_samples["tokens"],
                  lengths=jax_samples["lengths"],
                  weights=jax_samples["weights"], noise=jax_samples["noise"],
                  eps=jax_samples["eps"])
    jobs = {"loss": ("loss", shape, dict(inputs=inputs)),
            "damsm_jax": ("damsm", shape, plain),
            "gan_jax": ("gan", shape, gan2),
            "sample": ("sample", shape, sample)}
    if shape == (2,):
        with_dropout = dict(cfg=dict(DAMSM, dropout=0.5), vocab=VOCAB,
                            seq_len=L, batches=damsm_batches)
        jobs.update({
            "loss_plain": ("loss", shape, dict(inputs=inputs, fused=False)),
            "damsm_plain": ("damsm", shape, with_dropout),
            "damsm_cached": ("damsm", shape, dict(with_dropout,
                                                  form="cached")),
            "damsm_super": ("damsm", shape, dict(
                with_dropout, cfg=dict(with_dropout["cfg"], superbatch=2),
                form="super")),
            "damsm_train_bn": ("damsm", shape, dict(
                with_dropout, batches=damsm_batches[:1],
                cfg=dict(with_dropout["cfg"], image_encoder="inception_v3",
                         trunk_train_mode_bn=True))),
            "fault_no_mean": ("damsm", shape, dict(plain, fault="no_mean")),
            "fault_clip_first": ("damsm", shape, dict(plain,
                                                      fault="clip_first")),
            "gan_coupling": ("gan", shape, dict(
                cfg=GAN3, vocab=VOCAB, batch=_batch(4, (64, 128, 256)),
                draws=[{}])),
        })
    return jobs


@pytest.fixture(scope="module")
def ranks(jax_damsm, jax_gan, jax_samples):
    """{shape: {job: [each rank's result]}} from one spawn per world."""
    out = {}
    for world, shape in ((2, (2,)), (4, (2, 2))):
        jobs = _jobs(jax_damsm, jax_gan, jax_samples, shape)
        results = run_ranks(world, list(jobs.values()))
        out[shape] = {name: [r[i] for r in results]
                      for i, name in enumerate(jobs)}
        out[shape]["_jobs"] = jobs
    return out


def _one_process(ranks, shape, name):
    job, _, kwargs = ranks[shape]["_jobs"][name]
    kwargs = {k: v for k, v in kwargs.items() if k != "fault"}
    return JOBS[job](None, **kwargs)


# ------------------------------------------------- comparisons

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _assert_bit_equal(a, b):
    for (path, x), (_, y) in zip(_leaves(a), _leaves(b)):
        assert np.array_equal(np.asarray(x), np.asarray(y)), path


def _far(got, want, allow=0.0) -> float:
    """Largest elementwise error beyond ``allow`` (and ATOL)."""
    err = np.abs(np.asarray(got, np.float64) - want) - allow
    return float(err.max()) if err.size else 0.0


def _assert_metrics(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=RTOL,
                                   err_msg=k)


def _adam_ratio(slot: dict, betas) -> np.ndarray:
    """m / (sqrt(v) + eps) of an Adam slot, bias-corrected."""
    t = float(slot["step"])
    m = slot["exp_avg"] / (1 - betas[0] ** t)
    v = slot["exp_avg_sq"] / (1 - betas[1] ** t)
    return m / (np.sqrt(v) + 1e-8)


def _damsm_state_error(got: dict, want: dict, names=None) -> float:
    """Largest error over the BiLSTM, the heads and the Adam moments; with
    ``names`` (the trainable parameters in optimizer order) a parameter
    may differ by a further lr times the two runs' difference of
    m / (sqrt(v) + eps)."""
    cfg = DamsmConfig()
    allow = {}
    for pid, slot in want["optimizer"]["state"].items():
        other = got["optimizer"]["state"][pid]
        for k in ("exp_avg", "exp_avg_sq"):
            worst = _far(other[k], slot[k])
            if worst > ATOL:
                return worst
        if names is not None:
            allow[names[int(pid)]] = cfg.lr * np.abs(
                _adam_ratio(other, cfg.betas) - _adam_ratio(slot, cfg.betas))
    worst = 0.0
    for part in ("rnn", "cnn"):
        for k, v in want[part].items():
            worst = max(worst, _far(got[part][k], v,
                                    allow.get(f"{part}.{k}", 0.0)))
    return worst


def _damsm_names(cfg: dict) -> list:
    """The DAMSM trainer's trainable parameters, in optimizer order."""
    trainer = DamsmTrainer(DamsmConfig(**cfg), VOCAB, L, device="cpu")
    return [n for n, _ in trainer.init_state(seed=1).trainable()]


def _gan_state_error(got: dict, want: dict, lr: float, names: dict) -> float:
    """Largest error over the generator, the discriminators (parameters
    beyond the sign-flip allowance, BN statistics) and the four Adams (in
    norm, relative, scaled so that GAN_GRAD_RTOL reads as ATOL)."""
    worst = 0.0
    optims = {"gen": (got["gen_optimizer"], want["gen_optimizer"],
                      got["gen"], want["gen"])}
    for res in want["disc_optimizers"]:
        optims[res] = (got["disc_optimizers"][res],
                       want["disc_optimizers"][res],
                       _disc(got["discs"], res), _disc(want["discs"], res))
    for who, (og, ow, mg, mw) in optims.items():
        allow = {}
        for pid, slot in ow["state"].items():
            name = names[who][int(pid)]
            side = np.sign(og["state"][pid]["exp_avg"]) != np.sign(
                slot["exp_avg"])
            allow[name] = 2 * lr * side
            for k in ("exp_avg", "exp_avg_sq"):
                a, b = og["state"][pid][k], slot[k]
                if k == "exp_avg_sq":      # its gradient's scale
                    a, b = np.sqrt(a), np.sqrt(b)
                rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
                worst = max(worst, rel / GAN_GRAD_RTOL * ATOL)
        for k, v in mw.items():
            if k.endswith("num_batches_tracked"):
                continue
            worst = max(worst, _far(mg[k], v, allow.get(k, 0.0)))
    return worst


def _disc(discs: dict, res: str) -> dict:
    """Discriminator ``res``'s entries of the discs' state_dict."""
    return {k[len(res) + 1:]: v for k, v in discs.items()
            if k.startswith(res + ".")}


def _gan_names(cfg: dict) -> dict:
    """{"gen" or res: [parameter names in optimizer order]}."""
    from attngan_torch.core.config import GanConfig
    from attngan_torch.train.gan_trainer import GanTrainer

    state = GanTrainer(GanConfig(**cfg), VOCAB, device="cpu").init_state(1)
    return {"gen": [n for n, _ in state.gen.named_parameters()],
            **{res: [n for n, _ in d.named_parameters()]
               for res, d in state.discs.items()}}


# ------------------------------------------------- the tests

@pytest.mark.parametrize("batch,world,shape", [
    (16, 8, ()), (6, 8, ()), (7, 8, ()), (16, 4, (4,)), (16, 8, (2, 4)),
    (8, 4, (2, 2)), (6, 8, (2, 4)), (16, 8, (4, 4)), (8, 4, (8,)),
    (8, 8, (2, 2, 2))])
def test_mesh_size_for_batch_matches_jax(batch, world, shape):
    devices = jax.devices()[:world]
    try:
        want = make_mesh_for_batch(batch, devices=devices, shape=shape).size
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_size_for_batch(batch, world, shape)
        assert str(got.value).split(" (")[0] == str(e).split(" (")[0]
        return
    assert mesh_size_for_batch(batch, world, shape) == want


@pytest.mark.parametrize("shape,name", [((2,), "loss"), ((2,), "loss_plain"),
                                        ((2, 2), "loss")])
def test_sharded_loss_and_gradients(ranks, shape, name):
    got = ranks[shape][name]
    ref = _one_process(ranks, shape, name)
    inputs = _loss_inputs()
    n = len(got)
    jmesh = make_mesh(shape=shape)
    args = (jnp.asarray(inputs["img"]), jnp.asarray(inputs["code"]),
            jnp.asarray(inputs["words"]), jnp.asarray(inputs["sent"]),
            jnp.arange(B), jnp.asarray(inputs["mask"]),
            jnp.asarray(inputs["class_ids"]))
    loss_fn = jax_sharded_loss(jmesh)

    def total(img, words, code, sent):
        return loss_fn(img, code, words, sent, *args[4:])[0]

    sharded = shard_batch(args, jmesh)
    want = jax.jit(total)(sharded[0], sharded[2], sharded[1], sharded[3])
    jgrads = jax.jit(jax.grad(total, argnums=(0, 1, 2, 3)))(
        sharded[0], sharded[2], sharded[1], sharded[3])
    jgrads = dict(zip(("d_img", "d_words", "d_code", "d_sent"), jgrads))
    for rank, out in enumerate(got):
        for k in ("total", "words_loss", "sentence_loss"):
            np.testing.assert_allclose(out[k], ref[k], rtol=RTOL, err_msg=k)
        np.testing.assert_allclose(out["total"], float(want), rtol=RTOL)
        rows = slice(rank * B // n, (rank + 1) * B // n)
        for k in ("d_img", "d_words", "d_code", "d_sent"):
            for other in (ref[k][rows], np.asarray(jgrads[k])[rows]):
                np.testing.assert_allclose(out[k] / n, other, rtol=1e-4,
                                           atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["damsm_plain", "damsm_cached",
                                  "damsm_super", "damsm_train_bn"])
def test_damsm_step_forms_match_one_process(ranks, name):
    got = ranks[(2,)][name]
    ref = _one_process(ranks, (2,), name)
    _assert_bit_equal(got[0]["state"], got[1]["state"])
    assert len(got[0]["metrics"]) == len(ref["metrics"])
    for mg, mw in zip(got[0]["metrics"], ref["metrics"]):
        _assert_metrics(mg, mw)
    cfg = ranks[(2,)]["_jobs"][name][2]["cfg"]
    assert _damsm_state_error(got[0]["state"], ref["state"],
                              _damsm_names(cfg)) <= ATOL
    if name == "damsm_train_bn":   # the trunk's statistics, synced
        trunk = {k: v for k, v in ref["state"]["cnn"].items()
                 if k.startswith("trunk.") and "running" in k}
        assert trunk
        for k, v in trunk.items():
            assert _far(got[0]["state"]["cnn"][k], v) <= ATOL, k


@pytest.mark.parametrize("shape", [(2,), (2, 2)])
def test_damsm_step_matches_one_process_and_jax(ranks, jax_damsm, shape):
    got = ranks[shape]["damsm_jax"]
    ref = _one_process(ranks, shape, "damsm_jax")
    for other in got[1:]:
        _assert_bit_equal(got[0]["state"], other["state"])
    metrics, flat = jax_damsm[shape]
    _assert_metrics(got[0]["metrics"][0], metrics)
    _assert_metrics(got[0]["metrics"][0], ref["metrics"][0])
    assert metrics["rnn_grad_norm"] > 0.25       # the clip is active
    assert _damsm_state_error(got[0]["state"], ref["state"]) <= ATOL
    # the rank's state, rebuilt, against JAX's by the DAMSM parity rule
    trainer = DamsmTrainer(DamsmConfig(dropout=0.0, **DAMSM), VOCAB, L,
                           device="cpu")
    state = trainer.init_state(seed=1)
    parts = got[0]["state"]
    state.rnn.load_state_dict(_torch_tree(parts["rnn"]))
    state.cnn.load_state_dict(_torch_tree(parts["cnn"]))
    state.optimizer.load_state_dict(_torch_tree(parts["optimizer"]))
    state.step = parts["step"]
    assert_damsm_state_matches(state, flat)


def _torch_tree(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return tree


@pytest.mark.parametrize("fault", ["no_mean", "clip_first"])
def test_gradient_scale_faults_fail_the_comparison(ranks, fault):
    """The gradient-scale proof: the correct step matches one process
    (test above); the same step with the gradients' mean left out, or the
    BiLSTM's clip taken before the mean, must not."""
    got = ranks[(2,)][f"fault_{fault}"]
    ref = _one_process(ranks, (2,), "damsm_jax")
    worst = max(_damsm_state_error(g["state"], ref["state"]) for g in got)
    assert worst > 100 * ATOL, worst


def test_gan_step_with_coupling_matches_one_process(ranks):
    got = ranks[(2,)]["gan_coupling"]
    ref = _one_process(ranks, (2,), "gan_coupling")
    _assert_bit_equal(got[0]["state"], got[1]["state"])
    assert "damsm_loss" in ref["metrics"][0]
    _assert_metrics(got[0]["metrics"][0], ref["metrics"][0])
    err = _gan_state_error(got[0]["state"], ref["state"], 2e-4,
                           _gan_names(GAN3))
    assert err <= ATOL, err


@pytest.mark.parametrize("shape", [(2,), (2, 2)])
def test_gan_step_matches_one_process_and_jax(ranks, jax_gan, shape):
    from attngan_torch.convert import convert_gan_flat

    got = ranks[shape]["gan_jax"]
    ref = _one_process(ranks, shape, "gan_jax")
    for other in got[1:]:
        _assert_bit_equal(got[0]["state"], other["state"])
    _assert_metrics(got[0]["metrics"][0], ref["metrics"][0])
    _assert_metrics(got[0]["metrics"][0], jax_gan["metrics"])
    names = _gan_names(GAN2)
    assert _gan_state_error(got[0]["state"], ref["state"], 2e-4,
                            names) <= ATOL
    # JAX's sharded step: the weights (beyond a sign flip's 2 * lr) and the
    # BN statistics, which moved, of every module
    want = convert_gan_flat(jax_gan["after"])
    before = convert_gan_flat(jax_gan["flat"])
    for who in ["generator", *want["discs"]]:
        mg = (got[0]["state"]["gen"] if who == "generator"
              else _disc(got[0]["state"]["discs"], who))
        mw, m0 = ((want[who], before[who]) if who == "generator"
                  else (want["discs"][who], before["discs"][who]))
        for k, v in mw.items():
            allow = 0.0 if "running" in k else 2 * 2e-4
            assert _far(mg[k], v.numpy(), allow) <= ATOL, (who, k)
            if "running" in k:
                assert not np.array_equal(v.numpy(), m0[k].numpy()), k


@pytest.mark.parametrize("shape", [(2,), (2, 2)])
def test_sharded_sampling_matches_one_process_and_jax(ranks, jax_samples,
                                                      shape):
    got = ranks[shape]["sample"]
    ref = _one_process(ranks, shape, "sample")
    for other in got[1:]:
        _assert_bit_equal(got[0], other)
    stages, attns = jax_samples[shape]
    assert len(got[0]["images"]) == len(stages) == 2
    for stage, (g, r, j) in enumerate(zip(got[0]["images"], ref["images"],
                                          stages)):
        assert g.shape == (B, 64 * 2 ** stage, 64 * 2 ** stage, 3)
        np.testing.assert_allclose(g, r, atol=ATOL)
        np.testing.assert_allclose(g, j, atol=ATOL)
    for g, r, j in zip(got[0]["attns"], ref["attns"], attns):
        np.testing.assert_allclose(g, r, atol=ATOL)
        np.testing.assert_allclose(g, j, atol=ATOL)
