"""The port's data at scale against attngan_tpu's, on the CPU: the
streaming dataset, the native JPEG loader and the captioned loaders.

- StreamingDataset yields the eager Dataset's batches bit for bit for a
  seed (both through one decoder), and JAX's StreamingDataset's; record
  lists, the captions JSON round trip, zero-filled unreadable files with a
  warning, one decode for a file and its flip duplicate, and the
  open_dataset threshold mirror tests/test_streaming.py.
- The native loader builds here with g++ and libjpeg, decodes as JAX's
  build of the same source does (bit for bit), stays within a mean
  absolute difference of 6 levels of Pillow (tests/test_native_loader.py's
  bar) and tolerates bad and missing files.
- folder_caption_dataset and csv_caption_dataset give JAX's records.
- cli.pretrain --data-root --cluster --stream runs end to end.
"""

import json
import logging
import os

import numpy as np
import pytest
from PIL import Image

from attngan_tpu.data import captioned as jax_captioned
from attngan_tpu.data import native_loader as jax_native_loader
from attngan_tpu.data import streaming as jax_streaming

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.data import captioned, native_loader, streaming
from attngan_torch.data.clusterer import HierarchicalClusterer
from attngan_torch.data.dataset import Dataset, decode_image
from attngan_torch.data.streaming import StreamingDataset, open_dataset

PIL_MAD = 6.0


def _write_corpus(root, n, res=40, seed=0, smooth=False):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n):
        if smooth:       # JPEG round-trip noise stays small
            base = np.linspace(0, 255, res * res * 3) % 256
            arr = (base.reshape(res, res, 3)
                   + rng.normal(0, 8, (res, res, 3))).clip(0, 255)
        else:
            arr = rng.integers(0, 255, (res, res, 3))
        p = os.path.join(root, f"img_{i:05d}.jpg")
        Image.fromarray(arr.astype(np.uint8), "RGB").save(p, quality=92)
        paths.append(p)
    return paths


def _assign_captions(dataset):
    for i, rec in enumerate(dataset.records):
        rec.caption = [f"k8c{i % 3}", f"k4c{i % 2}"]
        rec.class_id = i % 3


def _batches_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for key in x:
            np.testing.assert_array_equal(x[key], y[key], err_msg=key)


@pytest.mark.parametrize("native", [False, True], ids=["pil", "native"])
def test_streaming_batches_identical_to_eager(tmp_path, native):
    _write_corpus(tmp_path / "c", 9)
    root = str(tmp_path / "c")
    eager = Dataset(root, use_native_loader=native)
    stream = StreamingDataset(root, use_native_loader=native)
    assert [(r.fpath, r.flip) for r in eager.records] == \
        [(r.fpath, r.flip) for r in stream.records]
    _assign_captions(eager)
    _assign_captions(stream)
    for seed in (0, 7):
        _batches_equal(list(eager.iter_batches(4, seed=seed)),
                       list(stream.iter_batches(4, seed=seed)))
    assert eager.vocab.word2index == stream.vocab.word2index
    theirs = jax_streaming.StreamingDataset(root, use_native_loader=native)
    _assign_captions(theirs)
    _batches_equal(list(stream.iter_batches(4, seed=3)),
                   list(theirs.iter_batches(4, seed=3)))


@pytest.mark.parametrize("max_images,flip",
                         [(5, True), (6, False), (99, True)])
def test_construction_matches_eager_and_jax(tmp_path, max_images, flip):
    _write_corpus(tmp_path / "c", 4)
    kw = dict(max_images=max_images, flip_augment=flip)
    root = str(tmp_path / "c")
    want = [(r.fpath, r.flip) for r in Dataset(root, **kw).records]
    assert [(r.fpath, r.flip) for r in StreamingDataset(root, **kw).records] \
        == want == [(r.fpath, r.flip) for r in
                    jax_streaming.StreamingDataset(root, **kw).records]


def test_captions_json_roundtrip_between_classes(tmp_path):
    _write_corpus(tmp_path / "c", 4)
    eager = Dataset(str(tmp_path / "c"))
    _assign_captions(eager)
    eager.save_captions_and_class_ids(str(tmp_path / "caps.json"))
    stream = StreamingDataset(str(tmp_path / "c"))
    stream.load_captions_and_class_ids(str(tmp_path / "caps.json"))
    for a, b in zip(eager.records, stream.records):
        assert (a.caption, a.class_id) == (b.caption, b.class_id)


@pytest.mark.parametrize("native", [False, True], ids=["pil", "native"])
def test_unreadable_file_zero_filled_with_warning(tmp_path, caplog, native):
    paths = _write_corpus(tmp_path / "c", 4)
    with open(paths[2], "wb") as f:
        f.write(b"not a jpeg")
    stream = StreamingDataset(str(tmp_path / "c"), flip_augment=False,
                              use_native_loader=native)
    _assign_captions(stream)
    with caplog.at_level(logging.WARNING):
        batches = list(stream.iter_batches(4, shuffle=False))
    assert len(batches) == 1
    assert (batches[0]["pixels"][2] == 0).all()
    assert (batches[0]["pixels"][1] != 0).any()
    assert stream._decode_failures == 1
    assert any("streaming decode failed" in r.message for r in caplog.records)
    # the eager loader drops it up front instead
    assert len(Dataset(str(tmp_path / "c"), flip_augment=False,
                       use_native_loader=native)) == 3


def test_flip_duplicates_share_one_decode(tmp_path, monkeypatch):
    _write_corpus(tmp_path / "c", 2)
    stream = StreamingDataset(str(tmp_path / "c"), use_native_loader=False)
    calls = []
    monkeypatch.setattr(streaming, "decode_image",
                        lambda p, res=256: calls.append(p) or decode_image(p))
    pixels = stream._batch_pixels(stream.records)   # 2 files x (orig, flip)
    assert len(calls) == 2
    assert pixels.shape == (4, 256, 256, 3)
    np.testing.assert_array_equal(pixels[0], pixels[1])   # pre-flip share
    np.testing.assert_array_equal(stream._record_pixels(stream.records[3]),
                                  pixels[3])


def test_open_dataset_auto_threshold(tmp_path, monkeypatch, capsys):
    _write_corpus(tmp_path / "c", 6)
    root = str(tmp_path / "c")
    monkeypatch.setattr(streaming, "STREAM_AUTO_THRESHOLD", 4)
    assert isinstance(open_dataset(root), StreamingDataset)
    assert "exceed the eager-decode threshold" in capsys.readouterr().out
    monkeypatch.setattr(streaming, "STREAM_AUTO_THRESHOLD", 50_000)
    assert type(open_dataset(root)) is Dataset
    ds = open_dataset(root, stream=True)
    assert isinstance(ds, StreamingDataset) and ds.use_native_loader
    assert streaming.STREAM_AUTO_THRESHOLD == \
        jax_streaming.STREAM_AUTO_THRESHOLD


def test_clusterer_embeds_streaming_dataset(tmp_path):
    class MeanEmbedder:
        def embed(self, images, batch_size):
            return images.reshape(images.shape[0], -1)[:, :8].numpy()

    _write_corpus(tmp_path / "c", 6)
    clus = HierarchicalClusterer(MeanEmbedder(), device="cpu")
    np.testing.assert_array_equal(
        clus.embed_dataset(Dataset(str(tmp_path / "c")), batch_size=4),
        clus.embed_dataset(StreamingDataset(str(tmp_path / "c"),
                                            use_native_loader=False), 4))


# ------------------------------------------------------------ native loader

@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    for i, size in enumerate([(640, 480), (256, 256), (100, 377)]):
        base = np.linspace(0, 255, size[0] * size[1] * 3) % 256
        arr = (base.reshape(size[1], size[0], 3)
               + rng.normal(0, 8, (size[1], size[0], 3))).clip(0, 255)
        Image.fromarray(arr.astype(np.uint8)).save(d / f"img{i}.jpg",
                                                   quality=95)
    return str(d)


def test_native_loader_builds_and_matches_jax_and_pil(jpeg_dir):
    assert native_loader.available(), native_loader.build_error()
    assert native_loader.build_error() == ""
    path = native_loader.library_path()
    assert path.startswith(native_loader.BUILD_DIR) and os.path.exists(path)
    paths = sorted(os.path.join(jpeg_dir, f) for f in os.listdir(jpeg_dir))
    for res in (64, 256):
        images, ok = native_loader.decode_batch(paths, res=res)
        assert ok.all() and images.shape == (3, res, res, 3)
        want, want_ok = jax_native_loader.decode_batch(paths, res=res)
        assert want_ok.all()
        np.testing.assert_array_equal(images, want)
        for i, p in enumerate(paths):
            mad = np.abs(decode_image(p, res).astype(np.float32)
                         - images[i].astype(np.float32)).mean()
            assert mad < PIL_MAD, f"{p}: mean abs diff {mad:.2f}"


def test_native_decode_tolerates_bad_files(jpeg_dir, tmp_path):
    bad = tmp_path / "notajpeg.jpg"
    bad.write_bytes(b"definitely not a jpeg")
    png = tmp_path / "a.png"               # not a JPEG: Pillow decodes it
    Image.fromarray(np.full((8, 8, 3), 77, np.uint8)).save(png)
    good = os.path.join(jpeg_dir, "img0.jpg")
    images, ok = native_loader.decode_batch(
        [good, str(bad), str(tmp_path / "missing.jpg"), str(png)], res=32)
    assert ok.tolist() == [True, False, False, True]
    assert images[1].sum() == 0 and images[2].sum() == 0
    assert (images[3] == 77).all()


def test_eager_dataset_uses_native_loader(jpeg_dir):
    native = Dataset(jpeg_dir, flip_augment=False, use_native_loader=True)
    pil = Dataset(jpeg_dir, flip_augment=False)
    assert len(native) == len(pil) == 3
    for a, b in zip(native.records, pil.records):
        assert a.fpath == b.fpath
        mad = np.abs(a.pixels.astype(np.float32)
                     - b.pixels.astype(np.float32)).mean()
        assert mad < PIL_MAD
    want = jax_native_loader.decode_batch([r.fpath for r in native.records])[0]
    np.testing.assert_array_equal(np.stack([r.pixels for r in native.records]),
                                  want)


def test_native_loader_falls_back_to_pil_when_the_build_fails(
        jpeg_dir, monkeypatch):
    state = native_loader._Library()
    monkeypatch.setattr(native_loader, "_LIBRARY", state)
    monkeypatch.setattr(native_loader, "library_path",
                        lambda: "/nonexistent/dir/lib.so")
    monkeypatch.setattr(native_loader, "_build",
                        lambda out: "g++: not found")
    assert not native_loader.available()
    assert native_loader.build_error() == "g++: not found"
    path = os.path.join(jpeg_dir, "img1.jpg")
    images, ok = native_loader.decode_batch([path], res=64)
    assert ok.all()
    np.testing.assert_array_equal(images[0], decode_image(path, 64))


# -------------------------------------------------------- captioned loaders

def _records_equal(ours, theirs):
    assert len(ours.records) == len(theirs.records) > 0
    for a, b in zip(ours.records, theirs.records):
        assert (a.fpath, a.flip, a.caption, a.class_id) == \
            (b.fpath, b.flip, b.caption, b.class_id)
        np.testing.assert_array_equal(a.pixels, b.pixels)


@pytest.mark.parametrize("max_images,flip", [(99, True), (3, True),
                                             (99, False)])
def test_captioned_loaders_match_jax(tmp_path, max_images, flip):
    for i, folder in enumerate(("gothic", "modern", "skipped")):
        _write_corpus(tmp_path / "folders" / folder, 2, res=24, seed=i)
    (tmp_path / "folders" / "stray.txt").write_text("not a folder")
    lookup = {"gothic": "tall, pointed arches", "modern": "glass,steel  box"}
    kw = dict(max_images=max_images, flip_augment=flip)
    _records_equal(
        captioned.folder_caption_dataset(str(tmp_path / "folders"), lookup,
                                         **kw),
        jax_captioned.folder_caption_dataset(str(tmp_path / "folders"),
                                             lookup, **kw))
    _write_corpus(tmp_path / "flat", 3, res=24)
    (tmp_path / "index.csv").write_text(
        "img_00000.jpg,a red room\nshort\nimg_00002.jpg,\"blue, wide bed\"\n"
        "missing.jpg,nothing\nimg_00001.jpg,window\n")
    _records_equal(
        captioned.csv_caption_dataset(str(tmp_path / "index.csv"),
                                      str(tmp_path / "flat"), **kw),
        jax_captioned.csv_caption_dataset(str(tmp_path / "index.csv"),
                                          str(tmp_path / "flat"), **kw))
    assert captioned.tokenize_caption(" a, b  c,,d ") == \
        jax_captioned.tokenize_caption(" a, b  c,,d ") == ["a", "b", "c", "d"]


# ------------------------------------------------------------------ CLIs

def test_cli_pretrain_clusters_a_streamed_folder(tmp_path):
    from attngan_torch.cli import pretrain, train

    _write_corpus(tmp_path / "imgs", 8, res=48, smooth=True)
    caps = tmp_path / "caps.json"
    common = ["--data-root", str(tmp_path / "imgs"), "--stream",
              "--device", "cpu", "--image-encoder", "tiny", "--emb-dim", "16",
              "--compute-dtype", "float32", "--batch-size", "4",
              "--epochs", "1", "--captions-path", str(caps),
              "--checkpoint-dir", str(tmp_path / "ckpt"),
              "--image-dir", str(tmp_path / "img")]
    _, state, _ = pretrain.main([*common, "--cluster", "--max-vocab-size",
                                 "16", "--min-clusters", "1"])
    assert state.step == 4                  # 8 files + flips, batch 4
    mapping = json.loads(caps.read_text())
    assert len(mapping) == 16
    assert sum(k.endswith("_r") for k in mapping) == 8
    assert all([t.split("c")[0] for t in c] == ["k2", "k4", "k8"]
               for c, _ in mapping.values())
    # the JSON captions a second, streamed run; --stream reaches cli.train
    _, state, _ = pretrain.main(common)
    assert state.step == 4
    assert train.parse_args(["--stream"]).stream
