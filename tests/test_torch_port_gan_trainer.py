"""The port's GAN training step against attngan_tpu's GanTrainer.

Both trainers run at tiny dims (gf 4, df 4, emb 16, cond 4, z 4, 4 words,
batch 3) with the tiny image encoder in fp32. The JAX state is flattened
to numpy and loaded into the port through attngan_torch.convert.
load_gan_flat: generator and discriminator weights and BN statistics, the
four Adam states, the frozen encoders, the step. The noise, the
conditioning-augmentation eps and the standard loss's real labels are
JAX's own draws on the state's key, passed to the port. Then both take the
same steps on the same batch; every metric, the generator's and the
discriminators' parameters and BN statistics, and the moments and counts
of all four optimizers are compared after the first and the third step:
3 stages under the non-saturating loss (the words loss through the
kernels' CPU path and through the plain form), 2 stages (no DAMSM
coupling) under the standard loss, and one step from a converted mid-run
state.

Tolerance 1e-4 (relative on the metrics, absolute on parameters, statistics
and moments): the same fp32 step in other summation orders. Two things of
the step are ill-posed in fp32 whatever computes it, and are held so:
- Adam moves a weight by lr * m / (sqrt(v) + eps), about +-lr whatever the
  size of its gradient, so an element whose first moment lies within
  rounding of 0 moves either way. Where the port's and JAX's first moments
  of an element lie on two sides of 0, the element's parameter may differ
  by 2 * lr more per such step.
- The DAMSM coupling's gradient is piecewise: the tiny trunk's ReLUs flip
  where a pre-activation lies within rounding of 0, and the fakes carry
  the rounding of three stages of train-mode BatchNorm over 3 images. At
  the third step of the non-saturating run a flip moves the generator's
  gradient by about 1% of its largest entry, between JAX's compiled step
  and JAX's own op-by-op computation of the same gradient as much as
  between JAX and the port. So after a coupling step past the first, the
  generator's moments are held in norm, ||port - JAX|| <= COUPLING_RTOL
  ||JAX||; everything else stays at 1e-4 elementwise.

The JAX state is made by ``jax.jit(init_state)``: the same function as the
eager call, compiled once instead of op by op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attngan_tpu.core.config import GanConfig as JaxGanConfig
from attngan_tpu.data.dataset import word_mask as jax_word_mask
from attngan_tpu.train.gan_trainer import GanTrainer as JaxGanTrainer

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.convert import convert_gan_flat, load_gan_flat
from attngan_torch.core.config import GanConfig
from attngan_torch.train.gan_trainer import GanTrainer

B, L, VOCAB = 3, 4, 30
SHAPE = dict(gf_dim=4, df_dim=4, emb_dim=16, cond_dim=4, z_dim=4, seq_len=L,
             batch_size=B, image_encoder="tiny", compute_dtype="")
ATOL = 1e-4
COUPLING_RTOL = 1e-2
STEPS = 3


def _batch(resolutions):
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, VOCAB, (B, L)).astype(np.int32),
             "lengths": np.array([4, 2, 3], np.int32),
             "class_ids": np.array([0, 1, 0], np.int32)}
    for res in resolutions:
        batch[f"img{res}"] = np.tanh(
            rng.standard_normal((B, res, res, 3))).astype(np.float32)
    return batch


def _key(entry) -> str:
    for attr in ("idx", "name", "key"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(entry)


def flatten_gan_state(state) -> dict:
    """A JAX GanState -> the {path: np.ndarray} dict convert.py reads
    (everything but the PRNG key)."""
    out = {}
    for field in ("gen_params", "gen_stats", "disc_params", "disc_stats",
                  "gen_opt_state", "disc_opt_states", "rnn_params",
                  "cnn_params", "cnn_stats"):
        leaves = jax.tree_util.tree_flatten_with_path(getattr(state, field))
        for path, leaf in leaves[0]:
            out[field + "/" + "/".join(_key(p) for p in path)] = np.array(leaf)
    out["step"] = np.array(state.step)
    return out


def _jax_draws(state, cfg):
    """The noise, eps and real labels _gan_step draws from state.key."""
    _, k_noise, k_reparam, k_label = jax.random.split(state.key, 4)
    b = cfg.batch_size
    return {
        "noise": torch.from_numpy(np.array(
            jax.random.normal(k_noise, (b, cfg.z_dim)))),
        "eps": torch.from_numpy(np.array(
            jax.random.normal(k_reparam, (b, cfg.cond_dim), jnp.float32))),
        "real_labels": {str(res): torch.from_numpy(np.array(
            jax.random.uniform(jax.random.fold_in(k_label, i), (b,),
                               minval=cfg.label_smooth, maxval=1.0)))
            for i, res in enumerate(cfg.resolutions)}}


def _jax_run(**cfg):
    """{"states": flat state before each step and after the last, "metrics",
    "draws": per step; "trainer", "state0"}."""
    cfg = JaxGanConfig(**SHAPE, **cfg)
    trainer = JaxGanTrainer(cfg, vocab_size=VOCAB)
    state = jax.jit(trainer.init_state, static_argnums=0)(0)
    out = {"trainer": trainer, "states": [], "metrics": [], "draws": [],
           # a copy: the step donates its input state
           "state0": jax.tree_util.tree_map(jnp.copy, state)}
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg.resolutions).items()}
    for _ in range(STEPS):
        out["states"].append(flatten_gan_state(state))
        out["draws"].append(_jax_draws(state, cfg))
        state, m = trainer.train_step(state, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["states"].append(flatten_gan_state(state))
    return out


@pytest.fixture(scope="module")
def non_saturating():
    return _jax_run(num_stages=3)


@pytest.fixture(scope="module")
def standard_two_stages():
    # one JAX compile for both: the loss variant does not touch the
    # coupling, which 2 stages leave out
    return _jax_run(num_stages=2, loss_variant="standard")


@pytest.fixture(autouse=True)
def native_cpu_convolutions():
    """The port's steps on PyTorch's native CPU convolutions. oneDNN's,
    PyTorch's default on the CPU, sums a conv's weight gradient over the
    batch and the 256^2 pixels in an order whose rounding grows as the
    threads get fewer: with one thread (an xdist worker's share of 8
    cores) the first step's ``gen3.up.conv.weight`` moments lie 1.2e-4
    from JAX's, against ATOL = 1e-4. The native convolutions sum in an
    order that does not depend on the thread count. The tolerances stay."""
    enabled = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = enabled


def _port(flat, **cfg):
    trainer = GanTrainer(GanConfig(**SHAPE, **cfg), VOCAB, device="cpu")
    state = trainer.init_state(seed=1)
    load_gan_flat(flat, state)
    return trainer, state


def _optimizers(state) -> dict:
    """{"gen" or res: (optimizer, module)}: the four Adam states."""
    return {"gen": (state.gen_optimizer, state.gen),
            **{res: (state.disc_optimizers[res], d)
               for res, d in state.discs.items()}}


def _assert_close(got: torch.Tensor, want: torch.Tensor, what: str,
                  allow: torch.Tensor | float = 0.0):
    err = (got.detach() - want).abs() - allow
    assert float(err.max()) <= ATOL, (
        f"{what}: {int((err > ATOL).sum())} of {err.numel()} elements off "
        f"by up to {float(err.max()):.3g} beyond the allowance")


def _assert_state_matches(state, flat, cfg, flips, check, coupling):
    """The port's state against JAX's after the same step. ``flips``
    accumulates, per parameter, 2 * lr at each step where the port's and
    JAX's first moments of an element lie on two sides of 0 (Adam's update
    of such an element takes either sign); the parameters are held to ATOL
    beyond it. With ``check`` False only ``flips`` is updated."""
    want = convert_gan_flat(flat)
    for who, (optimizer, module) in _optimizers(state).items():
        norm_only = who == "gen" and coupling
        for name, p in module.named_parameters():
            opt, ref = optimizer.state[p], want["adam"][who][name]
            side = torch.sign(opt["exp_avg"]) != torch.sign(ref["exp_avg"])
            lr = cfg.gen_lr if who == "gen" else cfg.disc_lr
            flips[who, name] = flips.get((who, name), 0.0) + 2 * lr * side
            if not check:
                continue
            assert int(opt["step"]) == want["count"][who], (who, name)
            for k, v in ref.items():
                if norm_only:
                    rel = float((opt[k] - v).norm() / v.norm().clamp_min(1e-30))
                    assert rel <= COUPLING_RTOL, (who, name, k, rel)
                else:
                    _assert_close(opt[k], v, f"Adam {who} {name} {k}")
    if not check:
        return
    modules = {"gen": (state.gen, want["generator"]),
               **{res: (d, want["discs"][res])
                  for res, d in state.discs.items()}}
    assert set(state.discs) == set(want["discs"])
    for who, (module, ref) in modules.items():
        got = module.state_dict()
        assert set(got) == set(ref)
        for k, v in ref.items():
            _assert_close(got[k], v, f"{who} {k}", flips.get((who, k), 0.0))
    assert state.step == want["step"]


def _assert_metrics(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=ATOL, err_msg=k)


def _run_port(run, start: int, steps: int, **cfg):
    trainer, state = _port(run["states"][start], **cfg)
    batch = _batch(trainer.cfg.resolutions)
    coupling = trainer.cfg.resolutions[-1] == 256
    flips = {}
    for i in range(start, start + steps):
        state, m = trainer.train_step(state, batch, **run["draws"][i])
        _assert_metrics(m, run["metrics"][i])
        # the generator's moments after a coupling step that is not the
        # first from a fresh state: in norm (module docstring)
        _assert_state_matches(
            state, run["states"][i + 1], trainer.cfg, flips,
            check=i in (start, start + steps - 1), coupling=coupling and i > 0)
    return state


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_steps_match_jax(non_saturating, fused):
    _run_port(non_saturating, 0, STEPS, num_stages=3, fused_similarity=fused)
    metrics = non_saturating["metrics"]
    assert {"damsm_loss", "kl_loss", "g_total", "d_loss_256"} <= set(metrics[0])
    assert metrics[-1]["g_total"] != metrics[0]["g_total"]


def test_standard_loss_two_stage_steps_match_jax(standard_two_stages):
    assert "damsm_loss" not in standard_two_stages["metrics"][0]
    _run_port(standard_two_stages, 0, STEPS, num_stages=2,
              loss_variant="standard")


def test_step_from_converted_mid_run_state(non_saturating):
    start = non_saturating["states"][2]
    assert int(start["gen_opt_state/0/count"]) == 2
    assert int(start["disc_opt_states/256/0/count"]) == 2
    assert np.abs(start["gen_opt_state/0/nu/gen1/Dense_0/kernel"]).max() > 0
    _run_port(non_saturating, 2, 1, num_stages=3)


def test_embed_and_generate_match_jax(non_saturating):
    jax_trainer, jax_state = non_saturating["trainer"], non_saturating["state0"]
    trainer, state = _port(non_saturating["states"][0], num_stages=3)
    batch = _batch((64,))
    words, sent = trainer.embed_text(state, batch["tokens"], batch["lengths"])
    jwords, jsent = jax_trainer.embed_text(jax_state, batch["tokens"],
                                           batch["lengths"])
    for got, want in ((words, jwords), (sent, jsent)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    rng = jax.random.key(7)
    noise = np.random.default_rng(4).standard_normal((B, 4)).astype(np.float32)
    eps = np.array(jax.random.normal(rng, (B, 4), jnp.float32))
    mask = jax_word_mask(jnp.asarray(batch["lengths"]), L)
    want = jax_trainer.generate(jax_state, jnp.asarray(noise), jsent, jwords,
                                mask, rng)
    got = trainer.generate(state, noise, sent, words, np.array(mask),
                           eps=torch.from_numpy(eps))
    assert state.gen.training                  # the step's mode is kept
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_converter_is_strict(standard_two_stages):
    start = standard_two_stages["states"][0]
    trees = {k.split("/")[0] for k in start}
    assert trees == {"gen_params", "gen_stats", "disc_params", "disc_stats",
                     "gen_opt_state", "disc_opt_states", "rnn_params",
                     "cnn_params", "step"}    # the tiny trunk has no stats
    _, state = _port(start, num_stages=2)
    with pytest.raises(KeyError, match="unexpected key"):
        load_gan_flat({**start, "key": np.zeros(2)}, state)
    with pytest.raises(KeyError, match="unknown discriminator path"):
        load_gan_flat({**start, "disc_params/64/DownBlock_0/Conv_1/kernel":
                       np.zeros(1)}, state)
    with pytest.raises(KeyError, match="unexpected optimizer"):
        load_gan_flat({**start, "gen_opt_state/1/mu/x": np.zeros(1)}, state)
    with pytest.raises(KeyError, match="twice"):
        load_gan_flat({**start, "disc_params/128/Conv_0/scale": np.ones(1)},
                      state)
    extra = {k.replace("disc_params/128/", "disc_params/256/"): v
             for k, v in start.items() if k.startswith("disc_params/128/")}
    with pytest.raises(KeyError, match="discriminators"):
        load_gan_flat({**start, **extra}, state)
    for key, error, match in (
            ("disc_params/128/Block3x3LeakyRelu_0/Conv_0/kernel",
             RuntimeError, "squeeze.0.conv.weight"),
            ("gen_stats/gen2/UpBlock_0/TorchBatchNorm_0/var", RuntimeError,
             "gen2.up.bn.running_var"),
            ("cnn_params/trunk/Conv_1/bias", RuntimeError, "Conv_1.bias"),
            ("disc_opt_states/64/0/nu/Conv_0/bias", KeyError, "lacks"),
            ("gen_opt_state/0/count", KeyError, "counts"),
            ("step", KeyError, "step")):
        missing = dict(start)
        del missing[key]
        with pytest.raises(error, match=match):
            load_gan_flat(missing, state)
    wrong = dict(start)
    head = "disc_params/64/Conv_0/kernel"
    wrong[head] = np.zeros(wrong[head].shape[:-2] + (3, 1), np.float32)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_gan_flat(wrong, state)
    wrong = dict(start)
    moment = "gen_opt_state/0/mu/img_out1/Conv_0/kernel"
    wrong[moment] = np.zeros((1,) + wrong[moment].shape, np.float32)
    with pytest.raises(RuntimeError, match="Adam exp_avg"):
        load_gan_flat(wrong, state)


def test_trainer_runs_on_the_gpu_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GanTrainer(GanConfig(**SHAPE), VOCAB)
    assert GanTrainer(GanConfig(**SHAPE), VOCAB,
                      device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="loss_variant"):
        GanTrainer(GanConfig(**SHAPE, loss_variant="hinge"), VOCAB,
                   device="cpu")


def test_draws_come_from_the_state_generator():
    cfg = GanConfig(**SHAPE, num_stages=2, loss_variant="standard")
    trainer = GanTrainer(cfg, VOCAB, device="cpu")
    batch = _batch(cfg.resolutions)
    runs = []
    for global_seed in (0, 1):
        state = trainer.init_state(seed=5)
        torch.manual_seed(global_seed)            # the global RNG is not read
        _, m = trainer.train_step(state, batch)
        runs.append({k: float(v) for k, v in m.items()})
    assert runs[0] == runs[1]
    state = trainer.init_state(seed=5)
    state.generator.manual_seed(6)
    _, m = trainer.train_step(state, batch)
    assert float(m["g_total"]) != runs[0]["g_total"]
    # the discriminators take gradients again after the G-step's passes
    assert all(p.requires_grad for p in state.discs.parameters())
    assert not any(p.requires_grad for p in state.cnn.parameters())


def test_coupling_plan_at_five_words():
    """The G-step's words loss at full width (16 x 16, L = 5, D = 256): the
    tensor-core forward and backward pass take 12 texts (60 word rows) a
    tile, 2 tiles, the second of 4 texts; every (image, text) pair is
    computed once on either grid (the card test in
    test_torch_cuda_kernels.py holds the kernels at this shape)."""
    from attngan_torch.ops.cuda_damsm import plan, takes_tc

    assert takes_tc(5, 256)
    t, k, s_bwd = plan(16, 16, 5, 256)
    s_fwd = plan(16, 16, 5, 256, slack=1.0)[2]
    assert (t, k, s_bwd, s_fwd) == (12, 2, 2, 2)
    assert t * 5 == 60 and 16 - (k - 1) * t == 4
    for s in (s_bwd, s_fwd):
        seen = np.zeros((16, 16), dtype=int)
        for j in range(16):
            for split in range(s):
                for tile in range(split, k, s):
                    seen[j, tile * t:min(16, (tile + 1) * t)] += 1
        assert (seen == 1).all()
