"""The port's clustering captioner against attngan_tpu's, on the CPU.

- ResNet18 from converted flax variables (BN statistics and scales drawn
  away from the init's) gives JAX's embeddings within 1e-4 absolute at
  64^2 (same fp32 function, other conv algorithms; ~3e-6 observed on
  features of magnitude ~5).
- The agglomerative labels equal JAX's value for value at every k (the
  same scipy tree, cut and numbered as scikit-learn's ``_hc_cut``), on
  separated blobs with distinct merge heights; the cut also equals
  ``_hc_cut`` itself at every k of random trees. k-means partitions
  equal JAX's up to renaming on separated blobs (JAX's KMeans is
  unseeded).
- PCA equals JAX's within 1e-5 (signs included) where scikit-learn picks
  its ``full`` or ``covariance_eigh`` solver (identical bits observed).
- umap_native: the torch kNN gives sklearn's indices and distances within
  1e-6 (its GEMM-form distances differ by ~1e-12); smooth_knn_dist,
  fuzzy_simplicial_set, find_ab_params and optimize_layout from the same
  inputs within 1e-6; the whole embedding holds JAX's blob ARI bar (the
  graphs' 1e-12 differences reorder the layout's sampling, so the two
  embeddings are not compared value for value).
- HierarchicalClusterer.cluster with a converted embedder writes JAX's
  captions and class ids; the corpora are bit-identical; the CLI writes
  a captions JSON with one token per k.
"""

import builtins
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from PIL import Image
from sklearn.cluster._agglomerative import _hc_cut
from sklearn.metrics import adjusted_rand_score

from attngan_tpu.data import clusterer as jax_clusterer
from attngan_tpu.data import synthetic as jax_synthetic
from attngan_tpu.data import umap_native as jax_umap
from attngan_tpu.models.resnet import ImageEmbedder as JaxImageEmbedder

import torch_threads  # noqa: F401  (torch threads under xdist)
from attngan_torch import convert
from attngan_torch.data import clusterer, synthetic, umap_native
from attngan_torch.models.resnet import ImageEmbedder, ResNet18, init_resnet18

EMBED_ATOL = 1e-4
PCA_ATOL = 1e-5
UMAP_ATOL = 1e-6


def _blobs(n_per=20, dims=8, n_blobs=4, sep=5.0, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_blobs, dims)) * sep
    x = np.concatenate([c + rng.normal(size=(n_per, dims)) for c in centers])
    return x.astype(np.float32), np.repeat(np.arange(n_blobs), n_per)


@pytest.fixture(scope="module")
def resnet_variables():
    """JAX ImageEmbedder variables with BN scales and statistics drawn away
    from the init's (a transposed or misplaced leaf then shows)."""
    rng = np.random.default_rng(0)
    variables = JaxImageEmbedder(rng_seed=3).variables
    flat = {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(variables).items()}
    for key, value in flat.items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("scale", "var"):
            flat[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif leaf in ("mean", "bias"):
            flat[key] = rng.normal(0, 0.1, value.shape).astype(np.float32)
    tree = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    return flat, tree


def test_resnet18_matches_jax(resnet_variables):
    flat, tree = resnet_variables
    images = np.random.default_rng(1).uniform(
        -1, 1, (5, 64, 64, 3)).astype(np.float32)
    want = JaxImageEmbedder(variables=tree).embed(images, batch_size=4)
    ours = ImageEmbedder(convert.convert_resnet_flat(flat), device="cpu")
    got = ours.embed(images, batch_size=4)          # a ragged last batch
    assert got.shape == (5, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=EMBED_ATOL)
    np.testing.assert_array_equal(ours.embed(torch.as_tensor(images), 2), got)


def test_resnet18_keys_are_torchvisions(resnet_variables):
    keys = set(init_resnet18().state_dict())
    assert len(keys) == 120 and sum(k.endswith(".weight") for k in keys) == 40
    assert {"conv1.weight", "bn1.running_var", "bn1.num_batches_tracked",
            "layer1.0.conv1.weight", "layer1.1.bn2.bias",
            "layer2.0.downsample.0.weight",
            "layer4.0.downsample.1.running_mean"} <= keys
    assert not any("downsample" in k for k in keys
                   if k.startswith(("layer1.", "layer2.1", "layer3.1")))
    flat, _ = resnet_variables
    assert set(convert.convert_resnet_flat(flat)) == keys
    with pytest.raises(KeyError, match="unexpected ResNet18 leaf"):
        convert.convert_resnet_flat({**flat, "params/conv1/w": np.zeros(1)})
    with pytest.raises(RuntimeError, match="fc.weight"):
        convert.load_resnet_flat({**flat, "params/fc/kernel": np.zeros(
            (512, 10), np.float32)}, ResNet18())
    missing = {k: v for k, v in flat.items() if k != "batch_stats/bn1/var"}
    with pytest.raises(RuntimeError, match="bn1.running_var"):
        convert.load_resnet_flat(missing, ResNet18())


def test_embedder_init_is_seeded_and_keeps_activations():
    a, b, c = (init_resnet18(s).state_dict() for s in (0, 0, 1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    x = np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 3))
    emb = ImageEmbedder(seed=0, device="cpu").embed(x.astype(np.float32))
    assert np.isfinite(emb).all() and 0.1 < float(np.abs(emb).mean()) < 10


@pytest.mark.parametrize("vocab,min_k", [(1000, 5), (16, 1), (64, 8), (10, 5),
                                         (3, 1)])
def test_determine_k_values_matches_jax(vocab, min_k):
    assert clusterer.determine_k_values(vocab, min_k) == \
        jax_clusterer.determine_k_values(vocab, min_k)


@pytest.mark.parametrize("method", ["agglomerative_complete",
                                    "agglomerative_single_linkage"])
def test_agglomerative_labels_equal_jax_at_every_k(method):
    from scipy.cluster import hierarchy

    x, _ = _blobs(n_per=24, n_blobs=4)
    linkage = "single" if "single" in method else "complete"
    heights = hierarchy.linkage(x, linkage, "cosine")[:, 2]
    assert len(set(heights.tolist())) == len(heights)   # no tied merges
    ks = clusterer.determine_k_values(96, 1)             # 3 .. 48
    assert ks == [3, 6, 12, 24, 48]
    for k, labels in zip(ks, clusterer.cluster_ladder(x, ks, method)):
        assert [f"k{k}c{c}" for c in labels] == \
            jax_clusterer._make_cluster_labels(x, k, method), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cut_numbers_clusters_as_sklearn(seed):
    from scipy.cluster import hierarchy

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(30, 5))
    for linkage in ("complete", "single", "average"):
        children = hierarchy.linkage(x, linkage, "cosine")[:, :2].astype(int)
        for k in range(1, 31):
            np.testing.assert_array_equal(
                clusterer.cut_tree(children, 30, k),
                _hc_cut(k, children, 30), err_msg=f"{linkage} k={k}")
    with pytest.raises(ValueError, match="more clusters than samples"):
        clusterer.cut_tree(children, 30, 31)


def test_cosine_linkage_refuses_zero_vectors():
    x, _ = _blobs()
    x[3] = 0
    with pytest.raises(ValueError, match="zero vectors"):
        clusterer.cluster_ladder(x, [2], "agglomerative_complete")
    with pytest.raises(ValueError, match="unknown clustering method"):
        clusterer.cluster_ladder(x, [2], "ward")


def test_kmeans_partition_equals_jax_up_to_renaming():
    x, truth = _blobs(n_per=20, n_blobs=5, sep=8.0)
    got = clusterer.cluster_ladder(x, [5], "kmeans")[0]
    want = [int(t.split("c")[1]) for t in
            jax_clusterer._make_cluster_labels(x, 5, "kmeans")]
    assert clusterer.adjusted_rand_index(got, want) == 1.0
    assert clusterer.adjusted_rand_index(got, truth) == 1.0
    np.testing.assert_array_equal(got, clusterer.kmeans(x, 5))  # seeded


def test_adjusted_rand_index_matches_sklearn():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a, b = rng.integers(0, 6, 50), rng.integers(0, 4, 50)
        assert abs(clusterer.adjusted_rand_index(a, b)
                   - adjusted_rand_score(a, b)) < 1e-12
    for a, b in (([0, 0, 1], [1, 1, 0]), ([0] * 5, [0] * 5),
                 ([0, 1, 2], [0, 0, 0]), ([0, 1, 2, 3], [0, 1, 2, 3])):
        assert clusterer.adjusted_rand_index(a, b) == adjusted_rand_score(a, b)


@pytest.mark.parametrize("shape", [(96, 16), (60, 120), (400, 24)],
                         ids=["full", "full_wide", "covariance_eigh"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pca_matches_jax(shape, dtype):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape) @ rng.normal(size=(shape[1], shape[1]))
         ).astype(dtype)
    want = jax_clusterer._reduce_dimensionality(x, 8, "pca")
    got = clusterer.reduce_dimensionality(x, 8, "pca")
    assert got.shape == want.shape == (shape[0], 8) and got.dtype == dtype
    np.testing.assert_allclose(got, want, atol=PCA_ATOL)


def test_reducer_auto_is_pca_and_sklearn_reducers_name_it(capsys, monkeypatch):
    x, _ = _blobs()
    np.testing.assert_array_equal(clusterer.reduce_dimensionality(x, 4),
                                  clusterer.pca(x, 4))
    assert "reducer 'auto' -> pca" in capsys.readouterr().out
    real_import = builtins.__import__

    def no_sklearn(name, *args, **kwargs):
        if name == "sklearn" or name.startswith("sklearn."):
            raise ImportError("no sklearn")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    for reducer in ("spectral", "tsne"):
        with pytest.raises(ImportError, match="needs scikit-learn"):
            clusterer.reduce_dimensionality(x, 2, reducer)
    with pytest.raises(ValueError, match="unknown reducer"):
        clusterer.reduce_dimensionality(x, 2, "ica")


# ---------------------------------------------------------------- UMAP

def test_knn_matches_sklearn():
    x, _ = _blobs(n_per=60, dims=64, sep=8.0)
    want_idx, want_d = jax_umap._knn(x.astype(np.float64), 15)
    got_idx, got_d = umap_native._knn(x, 15, device="cpu")
    np.testing.assert_array_equal(got_idx, want_idx)
    np.testing.assert_allclose(got_d, want_d, atol=UMAP_ATOL)
    # equal distances keep index order; self is excluded even when tied
    dup = np.repeat(np.eye(3), 2, axis=0)
    idx, d = umap_native._knn(dup, 2, device="cpu")
    assert idx.tolist() == [[1, 2], [0, 2], [3, 0], [2, 0], [5, 0], [4, 0]]
    assert (d[:, 0] == 0).all()


def test_graph_stages_match_jax():
    # float64, as umap_embed hands x on (sklearn's kNN of float32 rows
    # computes in float32)
    x, _ = _blobs(n_per=40, dims=32, n_blobs=3, sep=8.0)
    x = x.astype(np.float64)
    _, dists = umap_native._knn(x, 10, device="cpu")
    for got, want in zip(umap_native.smooth_knn_dist(dists, 10),
                         jax_umap.smooth_knn_dist(dists, 10)):
        np.testing.assert_allclose(got, want, atol=UMAP_ATOL)
    got = umap_native.fuzzy_simplicial_set(x, 10, device="cpu")
    want = jax_umap.fuzzy_simplicial_set(x, 10)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=UMAP_ATOL)
    np.testing.assert_allclose(umap_native.find_ab_params(1.0, 0.1),
                               jax_umap.find_ab_params(1.0, 0.1),
                               atol=UMAP_ATOL)


def test_layout_matches_jax_from_the_same_graph():
    x, _ = _blobs(n_per=30, dims=16, n_blobs=3, sep=8.0)
    rows, cols, vals = jax_umap.fuzzy_simplicial_set(x, 10)
    a, b = jax_umap.find_ab_params(1.0, 0.1)
    init = jax_umap._initial_embedding(x, rows, cols, vals, 2,
                                       np.random.default_rng(4))
    np.testing.assert_allclose(
        umap_native._initial_embedding(x, rows, cols, vals, 2,
                                       np.random.default_rng(4)),
        init, atol=UMAP_ATOL)
    got = umap_native.optimize_layout(init, rows, cols, vals, 60, a, b,
                                      np.random.default_rng(5))
    want = jax_umap.optimize_layout(init, rows, cols, vals, 60, a, b,
                                    np.random.default_rng(5))
    np.testing.assert_allclose(got, want, atol=UMAP_ATOL)


def test_umap_embedding_recovers_blobs_as_jax_does():
    x, y = _blobs(n_per=60, dims=64, sep=8.0)
    emb = umap_native.umap_embed(x, n_components=2, random_state=0,
                                 device="cpu")
    assert emb.shape == (x.shape[0], 2) and np.isfinite(emb).all()
    labels = clusterer.kmeans(emb, 4)
    assert adjusted_rand_score(y, labels) > 0.95   # JAX's bar
    np.testing.assert_array_equal(
        emb, umap_native.umap_embed(x, 2, random_state=0, device="cpu"))
    out = clusterer.reduce_dimensionality(x, 2, "umap", device="cpu")
    assert adjusted_rand_score(y, clusterer.kmeans(out, 4)) > 0.9
    with pytest.raises(ValueError):
        umap_native.umap_embed(np.zeros((3, 8)), 2, device="cpu")


# ------------------------------------------------- clusterer and corpora

def _scene_pair(n=16, res=64):
    ours, factors = synthetic.make_scene_dataset(n, seed=2, res=res)
    theirs, jfactors = jax_synthetic.make_scene_dataset(n, seed=2, res=res)
    return ours, theirs, factors, jfactors


def test_scene_and_photo_corpora_match_jax():
    ours, theirs, factors, jfactors = _scene_pair(9, 48)
    assert [r.fpath for r in ours.records] == [r.fpath for r in theirs.records]
    for a, b in zip(ours.records, theirs.records):
        assert a.pixels.dtype == np.uint8
        np.testing.assert_array_equal(a.pixels, b.pixels)
    assert factors.keys() == jfactors.keys() == {"wall", "bed", "layout"}
    for k in factors:
        np.testing.assert_array_equal(factors[k], jfactors[k])
    photos = synthetic.find_bundled_photos()
    assert photos == jax_synthetic.find_bundled_photos()
    if photos:
        ours, factors = synthetic.make_photo_patch_dataset(4, seed=1, res=32)
        theirs, jfactors = jax_synthetic.make_photo_patch_dataset(4, seed=1,
                                                                  res=32)
        for a, b in zip(ours.records, theirs.records):
            assert a.fpath == b.fpath
            np.testing.assert_array_equal(a.pixels, b.pixels)
        for k in factors:
            np.testing.assert_array_equal(factors[k], jfactors[k])


def test_photo_corpus_raises_without_bundled_photos(monkeypatch):
    monkeypatch.setattr(synthetic, "find_bundled_photos", lambda: {})
    with pytest.raises(RuntimeError, match="no bundled real photos"):
        synthetic.make_photo_patch_dataset(4)


@pytest.mark.parametrize("method", ["agglomerative_complete",
                                    "agglomerative_single_linkage"])
def test_hierarchical_clusterer_writes_jax_captions(resnet_variables, method):
    flat, tree = resnet_variables
    ours, theirs, _, _ = _scene_pair()
    for i, (a, b) in enumerate(zip(ours.records, theirs.records)):
        a.flip = b.flip = i % 3 == 1
    ours_c = clusterer.HierarchicalClusterer(
        ImageEmbedder(convert.convert_resnet_flat(flat), device="cpu"),
        device="cpu")
    theirs_c = jax_clusterer.HierarchicalClusterer(
        JaxImageEmbedder(variables=tree))
    np.testing.assert_allclose(ours_c.embed_dataset(ours, 8),
                               theirs_c.embed_dataset(theirs, 8),
                               atol=EMBED_ATOL)
    kw = dict(latent_dims=8, max_vocab_size=16, min_clusters=1, batch_size=8,
              method=method)
    ours_c.cluster(ours, **kw)
    theirs_c.cluster(theirs, **kw)
    assert [r.caption for r in ours.records] == \
        [r.caption for r in theirs.records]
    assert [r.class_id for r in ours.records] == \
        [r.class_id for r in theirs.records]
    assert all(len(r.caption) == 3 for r in ours.records)      # k 2, 4, 8
    with pytest.raises(ValueError, match="too small"):
        ours_c.cluster(ours, max_vocab_size=4, min_clusters=5,
                       embeddings=np.ones((16, 4)))


def test_evaluate_clustering_matches_jax(tmp_path):
    from attngan_torch.utils.imaging import read_png

    ours, theirs, _, _ = _scene_pair(12, 32)
    for i, (a, b) in enumerate(zip(ours.records, theirs.records)):
        a.caption = b.caption = [f"k2c{i % 2}", f"k4c{i % 4}"]
    got = ours.evaluate_clustering(1, max_images=4, nrow=2,
                                   folder=str(tmp_path / "ours"))
    want = theirs.evaluate_clustering(1, max_images=4, nrow=2,
                                      folder=str(tmp_path / "jax"))
    assert got == want == {"4": 3, "2": 6}
    for k in ("2", "4"):
        with Image.open(tmp_path / "jax" / f"k-{k}.png") as png:
            want_png = np.asarray(png.convert("RGB"))
        got_png = read_png(str(tmp_path / "ours" / f"k-{k}.png"))
        assert got_png.shape == want_png.shape
        np.testing.assert_array_equal(got_png, want_png)
    assert ours.evaluate_clustering(ours.records[2].fpath, max_images=2,
                                    folder=str(tmp_path / "by_path")) == \
        {"4": 3, "2": 6}


def test_cli_pretrain_cluster_writes_one_token_per_k(tmp_path):
    from attngan_torch.cli import pretrain

    caps = tmp_path / "caps.json"
    _, state, history = pretrain.main([
        "--synthetic", "16", "--cluster", "--max-vocab-size", "16",
        "--min-clusters", "1", "--device", "cpu", "--image-encoder", "tiny",
        "--emb-dim", "16", "--compute-dtype", "float32", "--batch-size", "4",
        "--epochs", "1", "--captions-path", str(caps),
        "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--image-dir", str(tmp_path / "img")])
    assert state.step == 4 and all(np.isfinite(history))
    mapping = json.loads(caps.read_text())
    ks = clusterer.determine_k_values(16, 1)
    assert ks == [2, 4, 8] and len(mapping) == 16
    finest = sorted({caption[-1] for caption, _ in mapping.values()})
    for fpath, (caption, class_id) in mapping.items():
        assert [t.split("c")[0] for t in caption] == [f"k{k}" for k in ks]
        assert class_id == finest.index(caption[-1])
    assert len({c[0] for c, _ in mapping.values()}) == 2
