"""The port's text encoder, generator and sampler against the JAX package.

Weights come from the JAX modules' init, randomized with numpy, and reach
the port through attngan_torch.convert; noise and the reparametrization eps
are drawn once and handed to both. Both run in fp32 on the CPU (JAX at
"highest" matmul precision, tests/conftest.py).

Tolerance: 1e-4 absolute on images in [0, 1] (and on the attention maps,
mu and logvar). Both sides compute the same fp32 function with different
summation orders and conv algorithms; observed differences are ~1e-6, and
1e-4 is still two orders below what a wrong tap, transpose or concat order
produces (~1e-1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from attngan_tpu.data.dataset import word_mask as jax_word_mask
from attngan_tpu.infer.sampler import denormalize as jax_denormalize
from attngan_tpu.models.generator import Generator as JaxGenerator
from attngan_tpu.models.rnn_encoder import BiLSTMEncoder as JaxBiLSTM

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.convert import convert_flat, load_flat
from attngan_torch.core.config import GanConfig
from attngan_torch.infer.sampler import (
    InferState,
    Sampler,
    load_infer_state,
    save_infer_state,
)

ATOL = 1e-4
B, L, VOCAB = 2, 5, 40
CFG = GanConfig(gf_dim=8, emb_dim=32, seq_len=L, compute_dtype="float32")


def _draw(tree, rng):
    """numpy weights for a flax shape tree, at init-like scales (kernels
    1/sqrt(fan_in)); BN statistics and biases are not the init's ones and
    zeros, so a transposed or misplaced leaf shows."""
    def draw(path, x):
        name, shape = path[-1], x.shape
        if name in ("var", "scale"):
            a = rng.uniform(0.5, 1.5, shape)
        elif name in ("mean", "bias") or name.startswith("b_"):
            a = rng.standard_normal(shape) * 0.1
        elif name == "embedding":
            a = rng.uniform(-0.1, 0.1, shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        return a.astype(np.float32)
    flat = traverse_util.flatten_dict(tree)
    return traverse_util.unflatten_dict({k: draw(k, v) for k, v in flat.items()})


def _flat(rnn_params, gen_params, gen_stats):
    out = {}
    for tree, name in ((rnn_params, "rnn_params"), (gen_params, "gen_params"),
                       (gen_stats, "gen_stats")):
        for k, v in traverse_util.flatten_dict(tree, sep="/").items():
            out[f"{name}/{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_state():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, VOCAB, (B, L)).astype(np.int32)
    lengths = np.array([L, 3], np.int32)
    rnn = JaxBiLSTM(vocab_size=VOCAB, hidden_dim=CFG.emb_dim)
    rnn_params = jax.eval_shape(lambda: rnn.init(
        jax.random.key(1), tokens, lengths, train=False))["params"]
    gen = JaxGenerator(gf_dim=CFG.gf_dim, emb_dim=CFG.emb_dim,
                       z_dim=CFG.z_dim, cond_dim=CFG.cond_dim, num_stages=3)
    words = jnp.zeros((B, L, CFG.emb_dim))
    gvars = jax.eval_shape(lambda: gen.init(
        jax.random.key(2), jnp.zeros((B, CFG.z_dim)),
        jnp.zeros((B, CFG.emb_dim)), words, jnp.ones((B, L), jnp.int32),
        jax.random.key(3), train=False))
    return dict(
        rnn=rnn, gen=gen, tokens=tokens, lengths=lengths,
        rnn_params=_draw(rnn_params, rng),
        gen_params=_draw(gvars["params"], rng),
        gen_stats=_draw(gvars["batch_stats"], rng),
        noise=rng.standard_normal((B, CFG.z_dim)).astype(np.float32),
        eps=rng.standard_normal((B, CFG.cond_dim)).astype(np.float32))


@pytest.fixture(scope="module")
def port_state(jax_state):
    s = jax_state
    state = InferState(CFG, VOCAB)
    load_flat(_flat(s["rnn_params"], s["gen_params"], s["gen_stats"]),
              state.rnn, state.generator)
    return state.eval()


def _jax_generator(s, words, sent, mask, train=False):
    """The JAX generator with eps injected: CondAugment draws
    jax.random.normal(rng, (B, cond)), so the key is replaced by a draw
    function returning the test's eps."""
    variables = {"params": s["gen_params"], "batch_stats": s["gen_stats"]}
    eps = jnp.asarray(s["eps"])
    real_normal = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=jnp.float32: eps.astype(dtype)
    try:
        apply = jax.jit(s["gen"].apply, static_argnames=("train", "mutable"))
        return apply(variables, jnp.asarray(s["noise"]), sent, words, mask,
                     jax.random.key(0), train=train,
                     mutable=("batch_stats",) if train else False)
    finally:
        jax.random.normal = real_normal


def _jax_text(s):
    return s["rnn"].apply({"params": s["rnn_params"]}, s["tokens"],
                          s["lengths"], train=False)


def test_bilstm_ragged_lengths_match_jax(port_state, jax_state):
    s = jax_state
    tokens = np.array([[3, 7, 1, 9, 2], [4, 4, 0, 0, 0], [5, 0, 0, 0, 0],
                       [6, 1, 2, 0, 0]], np.int32)
    lengths = np.array([5, 2, 1, 0], np.int32)     # 0: an empty caption
    want_w, want_s = s["rnn"].apply({"params": s["rnn_params"]}, tokens,
                                    lengths, train=False)
    got_w, got_s = port_state.rnn(torch.as_tensor(tokens),
                                  torch.as_tensor(lengths))
    assert got_w.shape == (4, L, CFG.emb_dim)
    np.testing.assert_allclose(got_w.detach().numpy(), np.asarray(want_w),
                               atol=1e-5)
    np.testing.assert_allclose(got_s.detach().numpy(), np.asarray(want_s),
                               atol=1e-5)
    assert not got_w[1, 2:].any() and not got_w[3].any()   # zero at padding


@pytest.mark.parametrize("train", [False, True], ids=["eval_bn", "train_bn"])
def test_generator_matches_jax(port_state, jax_state, train):
    s = jax_state
    words, sent = _jax_text(s)
    mask = jax_word_mask(jnp.asarray(s["lengths"]), L)
    out = _jax_generator(s, words, sent, mask, train=train)
    (fakes, attns, mu, logvar), new_vars = out if train else (out, None)

    gen = port_state.generator
    snapshot = {k: v.clone() for k, v in gen.state_dict().items()}
    gen.train(train)
    try:
        with torch.no_grad():
            t_fakes, t_attns, t_mu, t_logvar = gen(
                torch.as_tensor(s["noise"]), torch.as_tensor(np.array(sent)),
                torch.as_tensor(np.array(words)),
                torch.as_tensor(np.array(mask)),
                eps=torch.as_tensor(s["eps"]))
        stats = {k: v.clone() for k, v in gen.state_dict().items()
                 if "running" in k}
    finally:
        gen.load_state_dict(snapshot)
        gen.eval()
    assert [f.shape for f in t_fakes] == [(B, 64, 64, 3), (B, 128, 128, 3),
                                          (B, 256, 256, 3)]
    assert [a.shape for a in t_attns] == [(B, L, 64, 64), (B, L, 128, 128)]
    for got, want in zip(t_fakes + t_attns + [t_mu, t_logvar],
                         list(fakes) + list(attns) + [mu, logvar]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if train:
        want_stats = convert_flat(_flat(
            s["rnn_params"], s["gen_params"], new_vars["batch_stats"]))
        for k, v in stats.items():
            np.testing.assert_allclose(
                v.numpy(), want_stats["generator"][k].numpy(), atol=1e-5,
                err_msg=k)


def test_sampler_matches_jax_generator_and_denormalize(port_state, jax_state,
                                                       tmp_path):
    s = jax_state
    words, sent = _jax_text(s)
    mask = jax_word_mask(jnp.asarray(s["lengths"]), L)
    fakes, attns, _, _ = _jax_generator(s, words, sent, mask)
    want = [np.asarray(jax_denormalize(f)) for f in fakes]

    # through the checkpoint round trip the CLI uses
    path = str(tmp_path / "state.pt")
    save_infer_state(path, port_state)
    sampler = Sampler(load_infer_state(path, CFG, device="cpu"), device="cpu")
    noise, eps = torch.as_tensor(s["noise"]), torch.as_tensor(s["eps"])
    img = sampler.generate_from_tokens(s["tokens"], s["lengths"], noise, eps)
    assert img.shape == (B, 256, 256, 3)
    np.testing.assert_allclose(img.numpy(), want[-1], atol=ATOL)

    stages, t_attns = sampler.generate_stages(s["tokens"], s["lengths"],
                                              noise, eps)
    for got, ref in zip(stages + t_attns, want + [np.asarray(a) for a in attns]):
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)
    assert all(0.0 <= float(x.min()) and float(x.max()) <= 1.0 for x in stages)


def test_sampler_draws_from_an_explicit_generator(port_state):
    sampler = Sampler(port_state, device="cpu")
    tokens = np.ones((B, L), np.int32)
    lengths = np.full((B,), L, np.int32)
    a, b, c = (sampler.generate_from_tokens(
        tokens, lengths, generator=torch.Generator().manual_seed(seed))
        for seed in (7, 7, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_converter_covers_every_leaf_exactly_once(jax_state):
    s = jax_state
    flat = _flat(s["rnn_params"], s["gen_params"], s["gen_stats"])
    counts = {t: sum(k.startswith(t + "/") for k in flat)
              for t in ("gen_params", "gen_stats", "rnn_params")}
    assert counts == {"gen_params": 52, "gen_stats": 30, "rnn_params": 7}
    state = InferState(CFG, VOCAB)
    load_flat(flat, state.rnn, state.generator)

    with pytest.raises(KeyError, match="unknown generator path"):
        convert_flat({**flat, "gen_params/gen9/extra/kernel": np.zeros(1)})
    with pytest.raises(KeyError, match="unexpected"):
        convert_flat({**flat, "opt_state/mu": np.zeros(1)})
    missing = dict(flat)
    del missing["gen_stats/gen3/UpBlock_0/TorchBatchNorm_0/var"]
    with pytest.raises(RuntimeError, match="running_var"):
        load_flat(missing, state.rnn, state.generator)
    missing = dict(flat)
    del missing["rnn_params/b_bwd"]
    with pytest.raises(KeyError, match="b_bwd"):
        convert_flat(missing)


def test_full_width_generator_has_the_jax_parameter_count():
    from attngan_torch.models.generator import Generator

    gen = Generator.from_config(GanConfig())
    params = sum(p.numel() for p in gen.parameters())
    stats = sum(b.numel() for b in gen.buffers())
    # the JAX tree at full width: 7,084,592 gen_params + 36,480 gen_stats
    assert (params, stats) == (7_084_592, 36_480)
