"""The port's tools (``python -m attngan_torch.tools.<name>``) on the CPU at
tiny dims: each ``main(argv)`` runs and prints the JSON keys of the root
tools/ script of its name (each key a string in that script, or in the
JAX module it reports through).

The silhouette score they report equals scikit-learn's within 1e-9, and
collision_check's losses equal JAX's DAMSM loss on the same features.
The checkpoint tools (collision_check, fid_curve, int8_fid_run) run on one
module-scoped chain of the port's CLIs: ``cli.pretrain --cluster`` with a
capped vocabulary over 8 scene JPEGs (16 records, so that classes
collide), then ``cli.train`` for 2 epochs (2 step_* saves). The FID tools
run with a small host featurizer in place of the Inception trunk (FID
itself is held against JAX in tests/test_torch_port_fid.py).
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from attngan_torch.eval import fid as fid_module

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_DAMSM = ["--device", "cpu", "--image-encoder", "tiny", "--emb-dim", "16",
              "--compute-dtype", "float32", "--batch-size", "4"]


def jax_tool_keys(*files) -> set:
    """Every string constant used as a dict key in the given files of the
    repository (tools/<name>.py and the like)."""
    keys = set()
    for name in files:
        with open(os.path.join(REPO, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Dict):
                keys |= {k.value for k in node.keys
                         if isinstance(k, ast.Constant)}
            elif isinstance(node, ast.Subscript) and isinstance(
                    node.slice, ast.Constant) and isinstance(
                    node.ctx, ast.Store):
                keys.add(node.slice.value)
    return keys


def json_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


class HostFeaturizer:
    """FIDEvaluator's interface over per-channel means and deviations."""

    def __init__(self, batch_size: int = 32, device=None, **_):
        self.batch_size = batch_size

    def features(self, images) -> np.ndarray:
        x = torch.as_tensor(images).float().cpu()
        return torch.cat([x.mean((1, 2)), x.std((1, 2)),
                          x.square().mean((1, 2))], dim=1).numpy()

    def fid(self, real, fake) -> float:
        mu_r, s_r = fid_module.activation_statistics(self.features(real))
        mu_f, s_f = fid_module.activation_statistics(self.features(fake))
        return fid_module.frechet_distance(mu_r, s_r, mu_f, s_f)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    from PIL import Image

    from attngan_torch.cli import pretrain, train
    from attngan_torch.data.synthetic import make_scene_dataset

    root = tmp_path_factory.mktemp("chain")
    images = root / "imgs"
    images.mkdir()
    dataset, _ = make_scene_dataset(8, seed=0)
    for rec in dataset.records:
        Image.fromarray(rec.pixels).save(images / os.path.basename(rec.fpath),
                                         quality=95)
    common = [*TINY_DAMSM, "--checkpoint-dir", str(root / "ckpt"),
              "--image-dir", str(root / "img"),
              "--captions-path", str(root / "caps.json"),
              "--data-root", str(images)]
    pretrain.main([*common, "--cluster", "--max-vocab-size", "16",
                   "--min-clusters", "1", "--epochs", "1"])
    train.main([*common, "--gf-dim", "4", "--df-dim", "4", "--seq-len", "4",
                "--epochs", "2", "--damsm-checkpoint",
                str(root / "ckpt" / "damsm")])
    assert len([d for d in os.listdir(root / "ckpt" / "gan")
                if d.startswith("step_")]) == 2
    return root


def jax_damsm_losses(args) -> tuple:
    """(total, words, sentence) of JAX's losses/damsm.py::damsm_loss on
    the arguments the port's damsm_loss was called with."""
    import jax.numpy as jnp

    from attngan_tpu.losses import damsm as jax_damsm

    args = list(args)
    args[5] = args[5].astype(np.int32)                  # the word mask
    total, parts, _ = jax_damsm.damsm_loss(*[
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    return (float(total), float(parts["words_loss"]),
            float(parts["sentence_loss"]))


def test_collision_check(chain, capsys, tmp_path, monkeypatch):
    """Its keys and exit codes, and each batch's masked and ablated losses
    equal to JAX's DAMSM loss on the same features, with the batch's class
    ids and without (fp32, 1e-4 relative; the tool rounds to 5
    decimals)."""
    from attngan_torch.losses import damsm
    from attngan_torch.tools import collision_check

    calls, port_loss = [], damsm.damsm_loss

    def recording(*args, **kwargs):
        calls.append([a.detach().numpy() if isinstance(a, torch.Tensor)
                      else a for a in args])
        return port_loss(*args, **kwargs)

    monkeypatch.setattr(damsm, "damsm_loss", recording)
    args = ["--checkpoint", str(chain / "ckpt" / "damsm"), "--data-root",
            str(chain / "imgs"), "--batches", "2", "--batch-size", "8",
            "--device", "cpu"]
    rows = collision_check.main([*args, "--captions-path",
                                 str(chain / "caps.json")])
    lines = json_lines(capsys.readouterr().out)
    assert lines == rows and len(rows) == 3
    keys = jax_tool_keys("tools/collision_check.py")
    assert set(rows[0]) == {"batch", "excluded_offdiag_pairs",
                            "distinct_classes", "loss_masked", "loss_ablated",
                            "delta", "words_delta", "sent_delta"} <= keys
    assert set(rows[-1]) == {"summary", "total_excluded_pairs",
                             "batches"} <= keys
    assert rows[-1]["total_excluded_pairs"] > 0
    assert "ACTIVE" in rows[-1]["summary"]
    assert len(calls) == 4
    close = dict(rtol=1e-4, atol=1e-5)
    for row, masked, ablated in zip(rows, calls[::2], calls[1::2]):
        assert masked[6] is not None and ablated[6] is None
        (m, mw, ms), (a, aw, as_) = map(jax_damsm_losses, (masked, ablated))
        np.testing.assert_allclose(row["loss_masked"], m, **close)
        np.testing.assert_allclose(row["loss_ablated"], a, **close)
        np.testing.assert_allclose(row["delta"], a - m, **close)
        np.testing.assert_allclose(row["words_delta"], aw - mw, **close)
        np.testing.assert_allclose(row["sent_delta"], as_ - ms, **close)
    # every class its own: no collision, a non-zero exit
    with open(chain / "caps.json") as f:
        mapping = json.load(f)
    distinct = {k: [c, i] for i, (k, (c, _)) in enumerate(mapping.items())}
    caps = tmp_path / "distinct.json"
    caps.write_text(json.dumps(distinct))
    with pytest.raises(SystemExit) as exit_:
        collision_check.main([*args, "--captions-path", str(caps)])
    assert exit_.value.code == 1
    assert "NOT exercised" in capsys.readouterr().out


def test_fid_curve(chain, capsys, tmp_path, monkeypatch):
    from attngan_torch.tools import fid_curve

    monkeypatch.setattr(fid_module, "FIDEvaluator", HostFeaturizer)
    summary = fid_curve.main([
        "--checkpoint", str(chain / "ckpt" / "gan"), "--captions-path",
        str(chain / "caps.json"), "--data-root", str(chain / "imgs"),
        "--n", "4", "--max-real", "8", "--seeds", "2", "--out",
        str(tmp_path / "out"), "--device", "cpu"])
    lines = json_lines(capsys.readouterr().out)
    keys = jax_tool_keys("tools/fid_curve.py")
    assert [line["step"] for line in lines[:2]] == [4, 8]
    assert set(lines[0]) == {"step", "fid", "fid_std", "fid_seeds"} <= keys
    assert set(lines[-1]) == {"first", "last", "decreasing"} <= keys
    assert set(summary) == {"checkpoint", "n_fake", "n_seeds", "n_real",
                            "resolution", "units", "curve",
                            "decreasing"} <= keys
    assert summary["n_fake"] == 4 and summary["n_real"] == 8
    assert summary["resolution"] == 256 and len(lines[0]["fid_seeds"]) == 2
    with open(tmp_path / "out" / "fid_curve.json") as f:
        assert json.load(f) == summary


def test_int8_fid_run(chain, capsys, monkeypatch):
    from attngan_torch.tools import int8_fid_run

    monkeypatch.setattr(fid_module, "FIDEvaluator", HostFeaturizer)
    line = int8_fid_run.main([
        "--checkpoint", str(chain / "ckpt" / "gan"), "--captions-path",
        str(chain / "caps.json"), "--real-dir", str(chain / "imgs"),
        "--n", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "restored" in out and json_lines(out) == [line]
    assert set(line) == {"fid_int8_vs_float", "fid_float", "fid_int8"}
    assert all(np.isfinite(v) for v in line.values())


def test_cluster_quality_run(capsys, tmp_path):
    from attngan_torch.tools import cluster_quality_run

    summary = cluster_quality_run.main([
        "--num-images", "12", "--latent-dims", "8", "--max-vocab-size", "16",
        "--min-clusters", "1", "--out", str(tmp_path), "--device", "cpu"])
    assert json_lines(capsys.readouterr().out)[-1] == summary
    keys = jax_tool_keys("tools/cluster_quality_run.py")
    assert set(summary) == {"n_images", "k_ladder", "method", "reducer",
                            "levels", "grid_member_counts",
                            "caption_swap_demo"} <= keys
    assert summary["n_images"] == 12 and summary["k_ladder"] == [2, 4, 8]
    for level in summary["levels"]:
        assert set(level) == {"k", "silhouette", "size_max", "size_min",
                              "ari_vs_factors"} <= keys
        assert -1.0 <= level["silhouette"] <= 1.0
    assert set(summary["caption_swap_demo"]) == {"before", "after"} <= keys
    assert sorted(p.name for p in tmp_path.glob("k-*.png")) == \
        ["k-2.png", "k-4.png", "k-8.png"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_silhouette_score_matches_sklearn(dtype, monkeypatch):
    """data/clusterer.py's silhouette (the tool's metric, so that it runs
    without scikit-learn) within 1e-9 of scikit-learn's, a singleton
    cluster and a distance matrix in row blocks included; its label
    checks."""
    from sklearn.metrics import silhouette_score as sk_silhouette

    from attngan_torch.data import clusterer
    from attngan_torch.data.clusterer import silhouette_score

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(300, 7)) + np.repeat(rng.normal(
        size=(5, 7)) * 3, 60, axis=0)).astype(dtype)
    labels = np.repeat(np.arange(5), 60)
    labels[:40] = rng.integers(0, 5, 40)
    labels[0] = 9                                   # a cluster of its own
    whole = silhouette_score(x, labels)
    with monkeypatch.context() as m:
        m.setattr(clusterer, "SILHOUETTE_ROWS", 64)
        got = silhouette_score(x, labels)
    assert abs(got - float(sk_silhouette(x, labels))) <= 1e-9
    assert got == whole
    for bad in (np.zeros(300), np.arange(300)):
        with pytest.raises(ValueError, match="Number of labels"):
            silhouette_score(x, bad)


def test_attnmaps_bench(capsys):
    from attngan_torch.tools import attnmaps_bench

    lines = attnmaps_bench.main([
        "--n", "8", "--batch-size", "4", "--emb-dim", "16",
        "--image-encoder", "tiny", "--levels", "2", "--compute-dtype",
        "float32", "--png", "--device", "cpu"])
    assert json_lines(capsys.readouterr().out) == lines
    keys = jax_tool_keys("tools/attnmaps_bench.py")
    assert set(lines[0]) == {"metric", "value", "unit", "images",
                             "batch_size", "image_encoder", "seconds",
                             "reference_img_per_sec", "vs_reference"} <= keys
    assert set(lines[1]) == {"metric", "value", "unit", "images", "seconds",
                             "vs_reference"}
    assert lines[0]["images"] == lines[1]["images"] == 8
    assert lines[0]["reference_img_per_sec"] == round(1000 / 44, 1)


def test_mfu_report_tool(capsys):
    from attngan_torch.tools import mfu_report

    lines = mfu_report.main([
        "--device", "cpu", "--sampler-batch", "2", "--damsm-batch", "2",
        "--gan-batch", "2", "--iters", "1", "--gf-dim", "4", "--df-dim", "4",
        "--emb-dim", "16", "--num-stages", "2", "--image-encoder", "tiny",
        "--compute-dtype", "float32"])
    assert json_lines(capsys.readouterr().out) == lines
    keys = jax_tool_keys("tools/mfu_report.py", "attngan_tpu/utils/mfu.py")
    assert [line["path"] for line in lines] == [
        "sampler_b2_fp32", "damsm_step_b2_fp32", "gan_step_b2_fp32"]
    for line in lines:
        assert set(line) == {"path", "sec_per_call", "unit_per_call",
                             "windows_ms", "model_gflops_per_call",
                             "device_kind", "achieved_tflops", "peak_tflops",
                             "mfu"} <= keys
        assert len(line["windows_ms"]) == 3 and line["mfu"] is None
        assert line["model_gflops_per_call"] > 0
        assert line["device_kind"] == "cpu"
    with pytest.raises(SystemExit):
        mfu_report.main(["serving", "--device", "cpu"])


def test_make_photo_corpus(capsys, tmp_path, monkeypatch):
    from PIL import Image

    from attngan_torch.data import synthetic
    from attngan_torch.tools import make_photo_corpus

    if synthetic.find_bundled_photos():
        meta = make_photo_corpus.main(["--num-images", "3", "--out",
                                       str(tmp_path / "c")])
        assert f"wrote 3 patches to {tmp_path / 'c'}" in \
            capsys.readouterr().out
        for name, factors in meta.items():
            assert set(factors) == {"photo", "region"}
            assert Image.open(tmp_path / "c" / name).size == (256, 256)
    monkeypatch.setattr(synthetic, "find_bundled_photos", lambda: {})
    with pytest.raises(SystemExit, match="no bundled photographs"):
        make_photo_corpus.main(["--out", str(tmp_path / "d")])
    assert not (tmp_path / "d").exists()


def test_convert_torch_weights(tmp_path, capsys):
    from tests.torch_oracles import randomize_, t_vgg19_bn_features

    from attngan_torch.models.cnn_encoder import InceptionV3Trunk
    from attngan_torch.models.resnet import ImageEmbedder, init_resnet18
    from attngan_torch.models.vgg import VGG19BNFeatures
    from attngan_torch.tools import convert_torch_weights

    resnet = init_resnet18(3).state_dict()
    trunk = InceptionV3Trunk().state_dict()
    vgg = {f"features.{k}": v for k, v in
           randomize_(t_vgg19_bn_features()).state_dict().items()}
    sources = {
        "resnet18": {**resnet, "fc.weight": torch.zeros(1000, 512),
                     "fc.bias": torch.zeros(1000)},
        "inception": {**trunk, "AuxLogits.fc.weight": torch.zeros(1000, 768),
                      "fc.weight": torch.zeros(1000, 2048),
                      "Conv2d_1a_3x3.bn.num_batches_tracked": torch.tensor(0)},
        "vgg19_bn": {**vgg, "classifier.6.bias": torch.zeros(1000)},
    }
    for kind, sd in sources.items():
        src, dst = tmp_path / f"{kind}.pth", tmp_path / f"{kind}.pt"
        torch.save(sd, src)
        convert_torch_weights.main([kind, str(src), str(dst)])
        assert f"wrote {dst}" in capsys.readouterr().out
        out = torch.load(dst, weights_only=True)
        want = {"resnet18": resnet, "inception": trunk,
                "vgg19_bn": {k: v for k, v in vgg.items()
                             if "num_batches" not in k}}[kind]
        assert set(out) == set(want)
        assert all(torch.equal(out[k], want[k]) for k in want)
    ImageEmbedder(torch.load(tmp_path / "resnet18.pt"), device="cpu")
    VGG19BNFeatures().load_state_dict(torch.load(tmp_path / "vgg19_bn.pt"))
    torch.save({k: v for k, v in resnet.items() if k != "conv1.weight"},
               tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="conv1.weight"):
        convert_torch_weights.main(["resnet18", str(tmp_path / "bad.pth"),
                                    str(tmp_path / "bad.pt")])
    assert not (tmp_path / "bad.pt").exists()
