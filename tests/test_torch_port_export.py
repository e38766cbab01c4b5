"""The port's serving artifacts (attngan_torch/infer/export.py) against the
live samplers, after attngan_tpu's tests/test_export.py, and the BiLSTM's
traceable form against its packed one.

An artifact holds the plain path (no K1, no K2, the BiLSTM's
``forward_masked``), so it is held against a live Sampler on the plain
path with the same weights and the same seed's draws; the int8 artifact
against a live Int8Sampler with the artifact's recorded scales.

Tolerances, fp32 on the CPU: the masked-scan BiLSTM against nn.LSTM's
packed form at 1e-5 (the same cell arithmetic in other summation orders;
observed ~1e-8); the float artifact against the live sampler at 1e-5 on
images in [0, 1] (the same ops, exported; observed ~6e-8); the int8
artifact against the live Int8Sampler to the same 1e-5, an int8 rounding
flip being possible only where their float inputs differ (observed 0).
"""

import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.cli import infer
from attngan_torch.core.config import GanConfig
from attngan_torch.data.synthetic import make_synthetic_dataset
from attngan_torch.infer.export import (
    ExportedSampler,
    plain_state,
    save_exported_int8_sampler,
    save_exported_sampler,
)
from attngan_torch.infer.quantize import Int8Sampler
from attngan_torch.infer.sampler import InferState, Sampler
from attngan_torch.models.rnn_encoder import BiLSTMEncoder

VOCAB = 30
CFG = GanConfig(gf_dim=8, emb_dim=32, seq_len=4, num_stages=2,
                compute_dtype="float32")
ATOL = 1e-5


@pytest.fixture(scope="module")
def state():
    torch.manual_seed(0)
    return InferState(CFG, VOCAB)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, VOCAB, (3, CFG.seq_len)).astype(np.int32)
    return tokens, np.array([4, 2, 3], np.int32)


@pytest.fixture(scope="module")
def artifact(state, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "float.zip")
    assert save_exported_sampler(path, state, platforms=("cpu",)) > 0
    return path


@pytest.fixture(scope="module")
def int8_artifact(state, batch, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "int8.zip")
    save_exported_int8_sampler(path, state, *batch, platforms=("cpu",),
                               device="cpu")
    return path


def _live(sampler, tokens, lengths, seed):
    return sampler.generate_from_tokens(
        tokens, lengths, generator=torch.Generator().manual_seed(seed))


def test_masked_bilstm_equals_the_packed_one():
    torch.manual_seed(1)
    rnn = BiLSTMEncoder(VOCAB, emb_dim=16, hidden_dim=24).eval()
    tokens = torch.randint(0, VOCAB, (5, 6))
    lengths = torch.tensor([6, 3, 1, 0, 4])           # 0: an empty caption
    with torch.no_grad():
        want = rnn(tokens, lengths)
        got = rnn.forward_masked(tokens, lengths)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL)
    assert not got[0][3].any() and not got[1][3].any()
    assert not got[0][1, 3:].any()                    # zero at padding


def test_round_trip_equals_the_live_sampler(state, batch, artifact):
    served = ExportedSampler(artifact, device="cpu")
    assert served.platforms == ("cpu",) and served.abi["batch_size"] is None
    live = Sampler(plain_state(state, "cpu"), device="cpu")
    got = served(*batch, seed=5)
    assert got.shape == (3, 128, 128, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _live(live, *batch, 5).numpy(),
                               atol=ATOL)


def test_a_symbolic_batch_serves_any_size(batch, artifact):
    served = ExportedSampler(artifact, device="cpu")
    tokens, lengths = batch
    for n in (1, 2, 7):
        idx = np.arange(n) % 3
        imgs = served(tokens[idx], lengths[idx], seed=1)
        assert imgs.shape == (n, 128, 128, 3)
        assert bool(torch.isfinite(imgs).all())
        assert float(imgs.min()) >= 0.0 and float(imgs.max()) <= 1.0


def test_the_seed_is_deterministic(batch, artifact):
    served = ExportedSampler(artifact, device="cpu")
    a, b, c = (served(*batch, seed=s) for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_int8_artifact_equals_the_live_int8_sampler(state, batch,
                                                    int8_artifact):
    served = ExportedSampler(int8_artifact, device="cpu")
    abi = served.abi
    assert abi["int8"] and len(abi["act_scales"]) == 9
    live = Int8Sampler(plain_state(state, "cpu"), device="cpu")
    live.act_scales = live.quantizer.act_scales = abi["act_scales"]
    got = served(*batch, seed=6)
    np.testing.assert_allclose(got.numpy(), _live(live, *batch, 6).numpy(),
                               atol=ATOL)
    float_imgs = _live(Sampler(plain_state(state, "cpu"), device="cpu"),
                       *batch, 6)
    assert float((got - float_imgs).abs().max()) > 0  # int8 did act


def test_cli_export_with_a_fixed_batch(tmp_path, batch):
    """cli.infer --export at a fixed batch on the CPU: served in a process
    that imports torch and the loader's file only; other batch sizes are
    refused."""
    caps = tmp_path / "caps.json"
    make_synthetic_dataset(4).save_captions_and_class_ids(str(caps))
    path = str(tmp_path / "fixed.zip")
    got = infer.main(["--device", "cpu", "--checkpoint", "", "--gf-dim", "4",
                      "--emb-dim", "16", "--seq-len", "4", "--num-stages",
                      "2", "--captions-path", str(caps), "--export", path,
                      "--export-platforms", "cpu", "--export-batch", "2"])
    assert got == path
    served = ExportedSampler(path, device="cpu")
    tokens, lengths = np.minimum(batch[0], 2), batch[1]   # within its vocab
    with pytest.raises(ValueError, match="batches of 2"):
        served(tokens, lengths)
    with pytest.raises(Exception):              # the program's own guard
        served.program(*(torch.zeros((3,) + s, dtype=d) for s, d in (
            ((4,), torch.int32), ((), torch.int32), ((100,), torch.float32),
            ((100,), torch.float32))))
    want = served(tokens[:2], lengths[:2], seed=9)
    loader = os.path.join(os.path.dirname(infer.__file__), os.pardir,
                          "infer", "export.py")
    script = textwrap.dedent(f"""
        import importlib.util, sys
        import numpy as np
        spec = importlib.util.spec_from_file_location("loader", {loader!r})
        loader = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(loader)
        served = loader.ExportedSampler({path!r}, device="cpu")
        imgs = served(np.array({tokens[:2].tolist()}, np.int32),
                      np.array({lengths[:2].tolist()}, np.int32), seed=9)
        assert not [m for m in sys.modules if m.startswith("attngan")]
        np.save(sys.stdout.buffer, imgs.numpy())
        """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         check=True, cwd=str(tmp_path), timeout=300)
    np.testing.assert_array_equal(np.load(io.BytesIO(out.stdout)),
                                  want.numpy())
