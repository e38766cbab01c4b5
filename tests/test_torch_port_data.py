"""The port's data path against attngan_tpu's, on the CPU.

The same seeds go through both packages: the synthetic datasets' pixels,
captions and class ids, the batches ``iter_batches`` gives (indices,
tokens, lengths, class ids, pixels, flips; ragged batches dropped), the
vocabulary, caption swaps, the scan and decode of an image directory and
the captions JSON are identical. The image pyramid matches JAX's
``preprocess_pyramid`` within 1e-5 absolute in fp32 (the same bilinear
resize, antialiased where it shrinks, in another summation order). The
image writers give JAX's arrays, read back through Pillow; the port's
writers need no Pillow. The prefetch cases mirror tests/test_prefetch.py.
"""

import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from attngan_tpu.data import dataset as jax_dataset
from attngan_tpu.data import synthetic as jax_synthetic
from attngan_tpu.data.captions import CaptionHandler as JaxCaptionHandler
from attngan_tpu.data.vocab import Vocab as JaxVocab
from attngan_tpu.utils import imaging as jax_imaging

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch.data import dataset, synthetic
from attngan_torch.data.captions import CaptionHandler
from attngan_torch.data.prefetch import prefetch
from attngan_torch.data.vocab import Vocab
from attngan_torch.utils import imaging

PYRAMID_ATOL = 1e-5


def _records_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert (a.fpath, a.flip, a.caption, a.class_id) == \
            (b.fpath, b.flip, b.caption, b.class_id)
        assert a.pixels.dtype == b.pixels.dtype == np.uint8
        np.testing.assert_array_equal(a.pixels, b.pixels)


@pytest.mark.parametrize("seed,with_captions", [(0, True), (5, True),
                                                (3, False)])
def test_synthetic_dataset_matches_jax(seed, with_captions):
    kw = dict(num_images=7, num_classes=3, seed=seed, levels=3, res=32,
              with_captions=with_captions)
    _records_equal(synthetic.make_synthetic_dataset(**kw).records,
                   jax_synthetic.make_synthetic_dataset(**kw).records)


def _flipped(ds):
    for i, rec in enumerate(ds.records):
        rec.flip = i % 3 == 1
    return ds


@pytest.mark.parametrize("seed", [0, 11])
def test_iter_batches_match_jax(seed):
    # 10 records in batches of 4: two full batches, the ragged third dropped
    kw = dict(num_images=10, num_classes=4, res=16)
    ours = _flipped(synthetic.make_synthetic_dataset(**kw))
    theirs = _flipped(jax_synthetic.make_synthetic_dataset(**kw))
    got = list(ours.iter_batches(4, max_seqlen=3, seed=seed))
    want = list(theirs.iter_batches(4, max_seqlen=3, seed=seed))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for key in b:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert ours.vocab.word2index == theirs.vocab.word2index


@pytest.mark.parametrize("flip", [[False] * 3, [True, False, True]],
                         ids=["no_flip", "flip"])
def test_preprocess_pyramid_matches_jax(flip):
    rng = np.random.default_rng(1)
    pixels = rng.integers(0, 256, (3, 256, 256, 3), dtype=np.uint8)
    flip = np.asarray(flip)
    got = dataset.preprocess_pyramid(torch.from_numpy(pixels),
                                     torch.from_numpy(flip))
    want = jax_dataset.preprocess_pyramid(jnp.asarray(pixels),
                                          jnp.asarray(flip))
    for res in (256, 128, 64):
        assert got[res].shape == (3, res, res, 3)
        assert got[res].dtype == torch.float32
        np.testing.assert_allclose(got[res].numpy(), np.asarray(want[res]),
                                   rtol=0, atol=PYRAMID_ATOL)


def test_device_batch_matches_jax():
    ours = _flipped(synthetic.make_synthetic_dataset(4, res=64))
    theirs = _flipped(jax_synthetic.make_synthetic_dataset(4, res=64))
    host = next(ours.iter_batches(4, seed=1))
    got = ours.device_batch(dataset.pinned_batch(host, "cpu"), "cpu")
    want = theirs.device_batch(next(theirs.iter_batches(4, seed=1)))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=PYRAMID_ATOL, err_msg=key)
    assert got["lengths"].device.type == "cpu"      # read there by packing


def test_vocab_build_and_encode_match_jax():
    captions = [["k2c0", "k4c1"], ["k2c1"], ["k2c0", "k4c3", "k8c5"], []]
    ours, theirs = Vocab(), JaxVocab()
    ours.build(captions)
    theirs.build(captions)
    for attr in ("word2index", "n_words", "vocab_built"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    ours.add_caption(["new", "k2c0"])
    theirs.add_caption(["new", "k2c0"])
    assert ours.word2index == theirs.word2index
    query = captions + [["unseen", "k2c1"]]
    for a, b in zip(ours.encode_batch(query, 2), theirs.encode_batch(query, 2)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("num", [1, 2])
def test_swap_captions_matches_jax(tmp_path, reverse, num):
    path = tmp_path / "caps.json"
    path.write_text(json.dumps({"a/1.jpg": [["k2c0", "k4c1", "k8c2"], 0],
                                "b/2.jpg": [["k2c1", "k4c3", "k8c7"], 1]}))
    captions = [["k2c0", "k4c1", "k8c2"], ["k2c1", "k4c3", "k8c7"]]
    got = CaptionHandler(str(path)).swap_captions(captions, num, reverse)
    want = JaxCaptionHandler(str(path)).swap_captions(captions, num, reverse)
    assert got == want and got != captions


def test_image_directory_and_captions_json_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    root = tmp_path / "images"
    (root / "sub").mkdir(parents=True)
    for name, size in (("b.png", (40, 30)), ("sub/a.jpg", (64, 64))):
        Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8)
                        ).save(root / name)
    (root / "broken.jpg").write_bytes(b"not an image")
    ours = dataset.Dataset(str(root))
    theirs = jax_dataset.Dataset(str(root))
    assert len(ours) == 4                     # 2 images + flipped copies
    _records_equal(ours.records, theirs.records)
    assert [p for p in dataset.scan_image_paths(str(root), 2)] == \
        jax_dataset.scan_image_paths(str(root), 2)

    for rec, cls in zip(ours.records, (0, 0, 1, 1)):
        rec.caption, rec.class_id = ["k2c%d" % cls, "k4c%d" % (cls + 2)], cls
    caps = tmp_path / "caps.json"
    ours.save_captions_and_class_ids(str(caps))
    theirs.load_captions_and_class_ids(str(caps))
    _records_equal(ours.records, theirs.records)
    again = dataset.Dataset(str(root))
    again.load_captions_and_class_ids(str(caps))
    _records_equal(again.records, ours.records)


def test_save_image_reads_back_through_pil(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.3, 1.3, (19, 33, 3)).astype(np.float32)
    imaging.save_image(x, str(tmp_path / "a" / "x.png"))
    want = (np.clip(x, 0, 1) * 255).astype(np.uint8)
    with Image.open(tmp_path / "a" / "x.png") as img:
        assert img.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(img), want)
    np.testing.assert_array_equal(imaging.read_png(str(tmp_path / "a" /
                                                       "x.png")), want)
    with pytest.raises(ValueError, match="takes"):
        imaging.save_image(x[..., 0], str(tmp_path / "gray.png"))


def _png(path):
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def test_grids_and_attention_maps_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    images = rng.uniform(0, 1, (5, 8, 6, 3)).astype(np.float32)
    for nrow in (0, 2):
        np.testing.assert_array_equal(imaging.image_grid(images, nrow),
                                      jax_imaging.image_grid(images, nrow))
    attn = rng.uniform(0, 0.3, (4, 6, 6)).astype(np.float32)
    imaging.save_attention_maps(attn, str(tmp_path / "ours.png"))
    jax_imaging.save_attention_maps(attn, str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(_png(tmp_path / "ours.png"),
                                  _png(tmp_path / "jax.png"))
    fakes = [images, rng.uniform(0, 1, (5, 12, 12, 3)).astype(np.float32)]
    imaging.save_image_grids(fakes, 3, str(tmp_path / "ours"))
    jax_imaging.save_image_grids(fakes, 3, str(tmp_path / "jax"))
    for name in ("epoch_3-8x8.png", "epoch_3-12x12.png"):
        np.testing.assert_array_equal(_png(tmp_path / "ours" / name),
                                      _png(tmp_path / "jax" / name))
    np.testing.assert_array_equal(imaging.moving_average(np.arange(9.0), 4),
                                  jax_imaging.moving_average(np.arange(9.0), 4))


def test_plot_history_draws_each_curve(tmp_path):
    falling = list(np.linspace(9.0, 1.0, 50))
    imaging.plot_history([falling, [5.0] * 50], str(tmp_path / "p.png"),
                         window=1)
    plot = imaging.read_png(str(tmp_path / "p.png"))
    assert plot.shape == (*imaging.PLOT_SIZE, 3)
    for color in imaging.PLOT_COLORS[:2]:
        rows, cols = np.nonzero((plot == color).all(-1))
        # every column of the plot area carries the curve
        assert len(set(cols)) == imaging.PLOT_SIZE[1] - 2 * int(
            imaging.PLOT_SIZE[1] * imaging.PLOT_MARGIN)
    rows, cols = np.nonzero((plot == imaging.PLOT_COLORS[0]).all(-1))
    assert rows[cols.argmin()] < rows[cols.argmax()]     # it falls
    imaging.plot_history(falling, str(tmp_path / "one.png"))   # one history
    assert imaging.read_png(str(tmp_path / "one.png")).shape == plot.shape


def test_prefetch_preserves_order_and_transform():
    out = list(prefetch(iter(range(10)), lambda x: x * 2, depth=3))
    assert out == [x * 2 for x in range(10)]


def test_prefetch_overlaps_producer_latency():
    def slow_source():
        for i in range(5):
            time.sleep(0.05)
            yield i

    start = time.perf_counter()
    for _ in prefetch(slow_source(), depth=2):
        time.sleep(0.05)  # consumer work overlapping producer work
    elapsed = time.perf_counter() - start
    # serial would be ~0.5 s; overlapped should be well under
    assert elapsed < 0.45, f"no overlap: {elapsed:.3f}s"


def test_prefetch_early_exit_stops_worker():
    produced = []

    def source():
        for i in range(1000):
            produced.append(i)
            yield i

    before = threading.active_count()
    it = prefetch(source(), depth=2)
    assert next(it) == 0
    it.close()  # early exit: consumer walks away after one item
    deadline = time.perf_counter() + 5.0
    while threading.active_count() > before and time.perf_counter() < deadline:
        time.sleep(0.02)
    assert threading.active_count() <= before, "prefetch worker leaked"
    # the worker stopped near where the consumer did, not at exhaustion
    assert len(produced) < 20


def test_prefetch_propagates_worker_errors():
    def bad_source():
        yield 1
        raise ValueError("boom")

    it = prefetch(bad_source(), depth=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)
