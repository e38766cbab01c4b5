"""The three CLIs under ``torchrun`` on the CPU: 2 gloo ranks with
``--mesh-shape 2`` against the same chain in one process.

``cli.pretrain`` (8 synthetic images, batch 4: 2 steps), ``cli.train`` from
its checkpoint (1 step at 3 stages, the sharded coupling: past the first
step Adam's sign flips compound, which a checkpoint's moments cannot
bound) and
``cli.infer`` from that (``--benchmark``, whose line counts the ranks in
``devices``, and 2 captions' PNGs), chained through their own checkpoints,
which rank 0 alone writes. The checkpoints of the two chains are held to
tests/test_torch_port_parallel.py's rules (the same steps on the same
global batches: the BiLSTM's dropout is drawn at the global batch), the
PNGs to one level of 255.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from attngan_torch.cli import infer, pretrain, train
from attngan_torch.train.checkpoint import latest_checkpoint, load_part
from test_torch_port_parallel import (
    ATOL,
    _damsm_names,
    _damsm_state_error,
    _gan_names,
    _gan_state_error,
)
from torch_parallel_ranks import numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--image-encoder", "tiny", "--emb-dim", "16",
        "--compute-dtype", "float32", "--batch-size", "4", "--epochs", "1"]
GAN = ["--gf-dim", "4", "--df-dim", "4", "--seq-len", "4"]
GAN_CFG = dict(gf_dim=4, df_dim=4, emb_dim=16, seq_len=4, batch_size=4,
               image_encoder="tiny", compute_dtype="float32")


def _dirs(root):
    return ["--checkpoint-dir", os.path.join(root, "ckpt"), "--image-dir",
            os.path.join(root, "img"), "--captions-path",
            os.path.join(root, "caps.json")]


def _torchrun(module, argv):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", module, *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return out.stdout


def _chain(root, ranks):
    """Run the chain in ``root``; returns the benchmark line and PNGs."""
    d = _dirs(root)
    ckpt = os.path.join(root, "ckpt")
    steps = [
        ("attngan_torch.cli.pretrain", pretrain,
         ["--synthetic", "8", *TINY, *d]),
        ("attngan_torch.cli.train", train,
         ["--synthetic", "4", *GAN, "--damsm-checkpoint",
          os.path.join(ckpt, "damsm"), *TINY, *d]),
    ]
    serve = ["--checkpoint", os.path.join(ckpt, "gan"), "--device", "cpu",
             "--captions-path", os.path.join(root, "caps.json"),
             "--compute-dtype", "float32"]
    bench = [*serve, "--benchmark", "--batch-size", "2"]
    images = [*serve, "--image-names", "00000", "00001", "--out",
              os.path.join(root, "out")]
    mesh = ["--mesh-shape", "2"] if ranks else []
    for module, cli, argv in steps:
        if ranks:
            _torchrun(module, argv + mesh)
        else:
            cli.main(argv)
    if ranks:
        lines = _torchrun("attngan_torch.cli.infer", bench + mesh)
        line = json.loads([ln for ln in lines.splitlines()
                           if ln.startswith("{")][-1])
        _torchrun("attngan_torch.cli.infer", images + mesh)
    else:
        line = infer.main(bench)
        infer.main(images)
    from attngan_torch.utils.imaging import read_png

    pngs = [read_png(os.path.join(root, "out", f"{n}.png"))
            for n in ("00000", "00001")]
    return line, pngs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{ranks: (root, benchmark line, PNGs)}: one process and 2 ranks."""
    out = {}
    for ranks in (0, 2):
        root = str(tmp_path_factory.mktemp(f"ranks{ranks}"))
        line, pngs = _chain(root, ranks)
        out[ranks] = (root, line, pngs)
    return out


def _parts(root, phase, names):
    ckpt = latest_checkpoint(os.path.join(root, "ckpt", phase))
    assert ckpt is not None
    return numpy_tree({n: load_part(ckpt, n) for n in names})


def test_pretrain_under_torchrun_matches_one_process(runs):
    names = ("rnn", "cnn", "optimizer", "step")
    got, want = (_parts(runs[r][0], "damsm", names) for r in (2, 0))
    assert got["step"] == want["step"] == 2
    cfg = dict(emb_dim=16, batch_size=4, image_encoder="tiny",
               compute_dtype="float32")
    err = _damsm_state_error(got, want, _damsm_names(cfg))
    assert err <= ATOL, err


def test_train_under_torchrun_matches_one_process(runs):
    names = ("gen", "discs", "gen_optimizer", "disc_optimizers", "step")
    got, want = (_parts(runs[r][0], "gan", names) for r in (2, 0))
    assert got["step"] == want["step"] == 1
    err = _gan_state_error(got, want, 2e-4, _gan_names(GAN_CFG))
    assert err <= ATOL, err


def test_infer_under_torchrun_serves_the_same_images(runs):
    _, line, pngs = runs[2]
    _, ref_line, ref_pngs = runs[0]
    assert line["devices"] == 2 and ref_line["devices"] == 1
    assert line["batch_size"] == 2 and line["value"] > 0
    for got, want in zip(pngs, ref_pngs):
        assert got.shape == (256, 256, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
