"""The port stands alone and runs where it is told to.

- Nothing under attngan_torch/, nor chip_smoke.py, imports JAX, flax, optax,
  orbax or the JAX package (the GPU machine has none of them), nor
  scikit-learn outside the two reducers that are its own; the native JPEG
  loader builds from the port's own copy of its source.
- resolve_device() means the GPU, raises without one, and gives the CPU only
  on request.
- The CLI serves at tiny dims on the CPU, and chip_smoke.py refuses to run
  without a GPU or without the repository around it.
"""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import torch

from attngan_torch.core.runtime import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "attngan_tpu"}
TINY = ["--gf-dim", "4", "--emb-dim", "16", "--seq-len", "4"]


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax():
    files = glob.glob(os.path.join(REPO, "attngan_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 15
    bad = {os.path.relpath(f, REPO): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in files}
    assert {"attngan_torch/ops/cuda_damsm.py",
            "attngan_torch/ops/damsm_similarity.py",
            "attngan_torch/losses/damsm.py",
            "attngan_torch/models/cnn_encoder.py",
            "attngan_torch/train/damsm_trainer.py",
            "attngan_torch/models/discriminators.py",
            "attngan_torch/losses/gan.py",
            "attngan_torch/train/gan_trainer.py",
            "attngan_torch/data/dataset.py",
            "attngan_torch/data/synthetic.py",
            "attngan_torch/data/prefetch.py",
            "attngan_torch/data/vocab.py",
            "attngan_torch/data/captions.py",
            "attngan_torch/utils/imaging.py",
            "attngan_torch/utils/timing.py",
            "attngan_torch/train/checkpoint.py",
            "attngan_torch/train/loops.py",
            "attngan_torch/cli/pretrain.py",
            "attngan_torch/cli/train.py",
            "attngan_torch/cli/infer.py",
            "attngan_torch/models/resnet.py",
            "attngan_torch/data/clusterer.py",
            "attngan_torch/data/umap_native.py",
            "attngan_torch/data/native_loader.py",
            "attngan_torch/data/streaming.py",
            "attngan_torch/data/captioned.py",
            "attngan_torch/models/vae.py",
            "attngan_torch/models/vgg.py",
            "attngan_torch/utils/mfu.py",
            "attngan_torch/utils/training.py",
            *(f"attngan_torch/tools/{name}.py" for name in (
                "mfu_report", "attnmaps_bench", "cluster_quality_run",
                "collision_check", "fid_curve", "int8_fid_run",
                "make_photo_corpus", "convert_torch_weights"))} <= set(bad)
    assert not {f: m for f, m in bad.items() if m}


def _sklearn_imports(path):
    """(enclosing function or None, imported name) of each scikit-learn
    import in ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            names = []
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.module:
                names = [child.module]
            found.extend((func, n) for n in names
                         if n.split(".")[0] == "sklearn")
            visit(child, func)

    visit(tree, None)
    return found


def test_port_needs_no_sklearn_and_ships_its_native_source():
    """The GPU machine has no scikit-learn: no port module imports it at
    module level, and the only imports are the lazy ones of the reducers
    that are scikit-learn's own (spectral, tsne). The native JPEG loader's
    source is the port's own copy."""
    files = glob.glob(os.path.join(REPO, "attngan_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    found = {os.path.relpath(f, REPO): _sklearn_imports(f) for f in files}
    assert {f: i for f, i in found.items() if i} == {
        "attngan_torch/data/clusterer.py": [
            ("reduce_dimensionality", "sklearn.manifold"),
            ("reduce_dimensionality", "sklearn.manifold")]}
    native = os.path.join(REPO, "attngan_torch", "native")
    assert sorted(f for f in os.listdir(native) if f != "build") == \
        ["jpeg_loader.cpp"]
    with open(os.path.join(native, "jpeg_loader.cpp")) as f:
        source = f.read()
    assert "attngan_tpu" not in source and 'extern "C"' in source
    from attngan_torch.data import native_loader

    assert native_loader.SOURCE == os.path.join(native, "jpeg_loader.cpp")
    assert native_loader.BUILD_DIR == os.path.join(native, "build")


def test_resolve_device_means_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")


def test_cli_benchmark_on_cpu(capsys):
    from attngan_torch.cli.infer import main

    main(["--benchmark", "--device", "cpu", "--batch-size", "2",
          "--captions-path", "/nonexistent.json", *TINY])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "gen_images_per_sec" and line["device"] == "cpu"
    assert len(line["windows"]) == 5 and line["value"] > 0


def test_cli_writes_images_from_a_checkpoint(tmp_path, capsys):
    from attngan_torch.cli.infer import main
    from attngan_torch.core.config import GanConfig
    from attngan_torch.infer.sampler import InferState, save_infer_state

    caps = {"imgs/a001.jpg": [["c1", "c7", "f3"], 0],
            "imgs/b002.jpg": [["c2", "f9"], 1]}
    caps_path = tmp_path / "caps.json"
    caps_path.write_text(json.dumps(caps))
    cfg = GanConfig(gf_dim=4, emb_dim=16, seq_len=4, num_stages=2)
    ckpt = tmp_path / "state.pt"
    save_infer_state(str(ckpt), InferState(cfg, vocab_size=6))
    out = tmp_path / "out"
    main(["--captions-path", str(caps_path), "--checkpoint", str(ckpt),
          "--image-names", "a001", "b002", "--out", str(out),
          "--device", "cpu"])
    from PIL import Image

    for name in ("a001", "b002"):
        img = np.asarray(Image.open(out / f"{name}.png"))
        assert img.shape == (128, 128, 3)          # 2 stages, from the file
    assert "restored" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="contradicts"):
        main(["--captions-path", str(caps_path), "--checkpoint", str(ckpt),
              "--image-names", "a001", "--gf-dim", "8", "--device", "cpu"])


@pytest.mark.parametrize("alone", [False, True], ids=["no_gpu", "no_repo"])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_pyproject_ships_the_port():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        tool = tomllib.load(f)["tool"]["setuptools"]
    assert "attngan_torch*" in tool["packages"]["find"]["include"]
    assert {"csrc/*.cu", "csrc/*.cuh", "native/*.cpp"} <= set(
        tool["package-data"]["attngan_torch"])
