"""Hierarchical clustering pseudo-caption synthesis: port of
attngan_tpu/data/clusterer.py on numpy, scipy and torch, without
scikit-learn (the GPU machine has none).

Reference: data/bedrooms.py:241-304 (HierarchicalClusterer). Captions are
SYNTHESIZED, not human-written: every image is embedded (a frozen
ResNet-18 on the GPU), optionally reduced to latent_dims, then clustered
at an ascending ladder of k values (coarse -> fine); each level appends a
token ``k{k}c{c}`` to the image's caption, and the finest clustering
assigns the class_id used by the DAMSM mismatch masks.

Clustering (``cluster_ladder``):

* agglomerative (``agglomerative_complete``, ``agglomerative_single_linkage``):
  one tree from ``scipy.cluster.hierarchy.linkage(x, method, "cosine")``,
  the call scikit-learn's ``AgglomerativeClustering(metric="cosine")``
  makes without a connectivity (for single linkage too: "cosine" is not
  among its fast metrics), cut at each k the way its ``_hc_cut`` cuts and
  numbers: a heap of negated node ids from the root, the largest node
  split k-1 times, then label i for the leaves under the heap's i-th entry.
  The labels are the JAX package's, value for value, and so are the
  tokens and class ids built from them. ``fcluster(..., "maxclust")`` is
  no substitute: with tied merge heights it can give fewer than k
  clusters.
* ``kmeans``: seeded k-means++ and Lloyd iterations, best inertia of 10
  starts. The JAX package's ``KMeans(n_init=10)`` has no random_state, so
  it is not deterministic itself; on separated clusters every good run
  gives one partition, up to the label numbering.

Reducers (``reduce_dimensionality``): ``auto`` resolves to ``pca``, the
measured default on real photographs (docs/cluster_quality_photos/).
``pca`` is exact: scikit-learn's ``full`` solver (an SVD of the centred
data), or for tall data (n >= 10 d, d <= 1000) its ``covariance_eigh``
solver, the same operations in the same order, with its sign rule
(``svd_flip(u_based_decision=False)``: the largest-|.| entry of each
component is positive). Caveat: scikit-learn 1.9's ``svd_solver="auto"``
picks ``randomized``, unseeded, for the 161 <= n < 5120 ResNet embeddings
(d = 512) at 128 latent dims, so the JAX package is not deterministic
there, where this port is exact. ``umap`` is the port's native UMAP
(data/umap_native.py). ``spectral`` and ``tsne`` import scikit-learn when
asked for, as the JAX package does, and without it raise an error naming
it; nothing stands in for them.
"""

from __future__ import annotations

import heapq
from typing import List, Optional

import numpy as np
import torch

from attngan_torch.core.runtime import resolve_device
from attngan_torch.data.dataset import Dataset, preprocess_pyramid

METHODS = ("kmeans", "agglomerative_single_linkage", "agglomerative_complete")
SILHOUETTE_ROWS = 1024      # rows of the distance matrix held at once
KMEANS_INIT, KMEANS_ITERS, KMEANS_TOL = 10, 300, 1e-4


def determine_k_values(max_vocab_size: int, min_k: int = 5) -> List[int]:
    """k ladder: max//2, max//4, ... > min_k, ascending (bedrooms.py:291-304)."""
    ks, factor = [], 2
    k = max_vocab_size // factor
    while k > min_k:
        ks.append(k)
        factor *= 2
        k = max_vocab_size // factor
    return list(reversed(ks))


def adjusted_rand_index(a, b) -> float:
    """Adjusted Rand index of two labelings (Hubert & Arabie 1985), as
    scikit-learn's adjusted_rand_score computes it: 1 for one partition,
    about 0 for independent ones."""
    _, ai = np.unique(np.asarray(a), return_inverse=True)
    _, bi = np.unique(np.asarray(b), return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(table, (ai, bi), 1)

    def pairs(n):
        return float((n * (n - 1) // 2).sum())

    index, rows, cols = pairs(table), pairs(table.sum(1)), pairs(table.sum(0))
    expected = rows * cols / pairs(np.asarray(ai.size))
    top = (rows + cols) / 2.0
    if top == expected:          # both a single cluster, or both singletons
        return 1.0
    return (index - expected) / (top - expected)


def silhouette_score(x, labels) -> float:
    """Mean silhouette coefficient of ``labels`` over the Euclidean
    distances of ``x`` (n, d), as scikit-learn's silhouette_score computes
    it: the squared distance as |a|^2 + |b|^2 - 2 a.b in fp64, clipped at
    0 and 0 on the diagonal, and the rest in the data's type (fp32 for
    fp32 data, else fp64); a sample in a cluster of its own scores 0.
    Needs 2 <= clusters <= n - 1."""
    x = np.asarray(x)
    _, lab = np.unique(np.asarray(labels), return_inverse=True)
    n, k = lab.size, int(lab.max()) + 1
    if not 1 < k < n:
        raise ValueError(f"Number of labels is {k}. Valid values are 2 to "
                         f"n_samples - 1 (inclusive)")
    dtype = np.float32 if x.dtype == np.float32 else np.float64
    xf = x.astype(np.float64)
    sq = np.einsum("ij,ij->i", xf, xf)
    onehot = np.eye(k)[lab]
    counts = np.bincount(lab, minlength=k)
    intra, inter = np.empty(n, dtype), np.empty(n, dtype)
    for start in range(0, n, SILHOUETTE_ROWS):
        stop = min(n, start + SILHOUETTE_ROWS)
        rows = np.arange(stop - start)
        d2 = -2.0 * (xf[start:stop] @ xf.T)
        d2 += sq[start:stop, None]
        d2 += sq[None, :]
        d2 = np.maximum(d2.astype(dtype), 0)
        d2[rows, rows + start] = 0
        sums = (np.sqrt(d2).astype(np.float64) @ onehot).astype(dtype)
        own = lab[start:stop]
        intra[start:stop] = sums[rows, own]
        sums[rows, own] = np.inf
        inter[start:stop] = (sums / counts).astype(dtype).min(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        intra = (intra / (counts - 1)[lab]).astype(dtype)
        sil = np.nan_to_num((inter - intra) / np.maximum(intra, inter))
    return float(np.mean(sil))


# ---------------------------------------------------------- agglomerative

def linkage_children(x: np.ndarray, linkage: str) -> np.ndarray:
    """(n - 1, 2) merges of the cosine-distance tree: row i joins two nodes
    into node n + i (leaves are 0 .. n - 1)."""
    from scipy.cluster import hierarchy

    if np.any(~np.any(x, axis=1)):
        raise ValueError("Cosine affinity cannot be used when X contains "
                         "zero vectors")
    out = hierarchy.linkage(x, method=linkage, metric="cosine")
    return out[:, :2].astype(int)


def cut_tree(children: np.ndarray, n_leaves: int, k: int) -> np.ndarray:
    """Labels of the k clusters under the tree's top k - 1 merges, numbered
    as scikit-learn's ``_hc_cut`` numbers them (module docstring)."""
    if k > n_leaves:
        raise ValueError(f"Cannot extract more clusters than samples: {k} "
                         f"clusters were given for a tree with {n_leaves} "
                         f"leaves.")
    nodes = [-(int(max(children[-1])) + 1)]
    for _ in range(k - 1):
        left, right = children[-nodes[0] - n_leaves]
        heapq.heappush(nodes, -int(left))
        heapq.heappushpop(nodes, -int(right))
    labels = np.zeros(n_leaves, np.intp)
    for i, node in enumerate(nodes):
        stack = [-node]
        while stack:
            top = stack.pop()
            if top < n_leaves:
                labels[top] = i
            else:
                stack.extend(children[top - n_leaves])
    return labels


# ---------------------------------------------------------------- k-means

def _sq_dists(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    d2 = ((x * x).sum(1)[:, None] - 2.0 * x @ centers.T
          + (centers * centers).sum(1)[None, :])
    return np.maximum(d2, 0.0)


def _kmeans_pp(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """k-means++ seeding: each next centre drawn with probability
    proportional to the squared distance to the nearest chosen one."""
    centers = [x[rng.integers(x.shape[0])]]
    closest = _sq_dists(x, centers[0][None])[:, 0]
    for _ in range(1, k):
        total = closest.sum()
        pick = (rng.choice(x.shape[0], p=closest / total) if total > 0
                else rng.integers(x.shape[0]))
        centers.append(x[pick])
        closest = np.minimum(closest, _sq_dists(x, x[pick][None])[:, 0])
    return np.stack(centers)


def kmeans(x: np.ndarray, k: int) -> np.ndarray:
    """Labels of the best (least inertia) of KMEANS_INIT k-means++ starts
    seeded with 0, each run by Lloyd's iterations until the centres move less
    than KMEANS_TOL of the data's mean variance (scikit-learn's rule). An
    empty cluster keeps its centre."""
    x = np.asarray(x, np.float64)
    rng = np.random.default_rng(0)
    tol = KMEANS_TOL * float(np.mean(np.var(x, axis=0)))
    best_inertia, best = np.inf, None
    for _ in range(KMEANS_INIT):
        centers = _kmeans_pp(x, k, rng)
        for _ in range(KMEANS_ITERS):
            labels = _sq_dists(x, centers).argmin(1)
            sums = np.zeros_like(centers)
            np.add.at(sums, labels, x)
            counts = np.bincount(labels, minlength=k)[:, None]
            moved = np.where(counts > 0, sums / np.maximum(counts, 1),
                             centers)
            shift = float(((moved - centers) ** 2).sum())
            centers = moved
            if shift <= tol:
                break
        d2 = _sq_dists(x, centers)
        labels = d2.argmin(1)
        inertia = float(d2[np.arange(x.shape[0]), labels].sum())
        if inertia < best_inertia:
            best_inertia, best = inertia, labels
    return best


def cluster_ladder(x: np.ndarray, ks: List[int], method: str
                   ) -> List[np.ndarray]:
    """Integer labels of ``x``'s rows at each k of ``ks``; agglomerative
    methods build one tree and cut it at every k."""
    if method == "kmeans":
        return [kmeans(x, k) for k in ks]
    if method not in METHODS:
        raise ValueError(f"unknown clustering method {method!r}")
    linkage = "single" if "single" in method else "complete"
    children = linkage_children(x, linkage)
    return [cut_tree(children, x.shape[0], k) for k in ks]


# --------------------------------------------------------------- reducers

def pca(x: np.ndarray, outdims: int) -> np.ndarray:
    """The first ``outdims`` principal components of ``x``'s rows, in
    ``x``'s dtype, exactly as scikit-learn's ``full`` solver (or, for tall
    data, its ``covariance_eigh`` solver) gives them, signs included."""
    from scipy import linalg

    n, d = x.shape
    outdims = min(outdims, n, d)
    mean = np.mean(x, axis=0)
    if d <= 1_000 and n >= 10 * d:           # covariance_eigh
        cov = x.T @ x
        cov -= n * mean.reshape(-1, 1) * mean.reshape(1, -1)
        cov /= n - 1
        _, vecs = np.linalg.eigh(cov)
        vt = np.flip(vecs, axis=1).T
        u = None
    else:                                     # full
        centred = x - mean
        u, s, vt = linalg.svd(centred, full_matrices=False)
    rows = np.arange(vt.shape[0])
    signs = np.sign(vt[rows, np.argmax(np.abs(vt), axis=1)])
    if u is None:
        components = (vt * signs[:, None])[:outdims]
        return x @ components.T - mean.reshape(1, -1) @ components.T
    u = u * signs[None, :]
    return u[:, :outdims] * s[:outdims]


def _needs_sklearn(reducer: str):
    return ImportError(f"reducer {reducer!r} needs scikit-learn, which is "
                       f"not installed; use 'pca' or 'umap'")


def reduce_dimensionality(x: np.ndarray, outdims: int, reducer: str = "auto",
                          device: str | torch.device | None = None
                          ) -> np.ndarray:
    """reducer: 'pca', 'umap' (the port's native UMAP, its kNN on
    ``device``), 'spectral' or 'tsne' (scikit-learn's, when installed), or
    'auto' = pca (module docstring)."""
    if reducer == "auto":
        # Visible at run time, not only in --help: 'auto' diverges from the
        # reference's UMAP default (bedrooms.py:274-276) by measurement.
        print("reducer 'auto' -> pca (measured best ARI on real photos, "
              "docs/cluster_quality_photos/; pass --reducer umap for "
              "reference parity)")
        reducer = "pca"
    if reducer == "pca":
        return pca(x, outdims)
    if reducer == "umap":
        from attngan_torch.data.umap_native import umap_embed

        return umap_embed(x, n_components=outdims, device=device)
    if reducer == "tsne":
        try:
            from sklearn.manifold import TSNE
        except ImportError as e:
            raise _needs_sklearn(reducer) from e
        n = x.shape[0]
        if outdims > 3:  # barnes-hut supports <= 3 components
            print(f"tsne: clamping latent dims {outdims} -> 3 (sklearn "
                  "barnes-hut limit); downstream k-ladder clustering runs "
                  "on the 3-dim embedding")
        outdims = min(outdims, 3)
        return TSNE(n_components=outdims, init="pca",
                    perplexity=min(30.0, max(2.0, (n - 1) / 3.0)),
                    random_state=0).fit_transform(x)
    if reducer == "spectral":
        try:
            from sklearn.manifold import SpectralEmbedding
        except ImportError as e:
            raise _needs_sklearn(reducer) from e
        outdims = min(outdims, x.shape[0] - 2)
        return SpectralEmbedding(
            n_components=outdims,
            n_neighbors=min(15, x.shape[0] - 1)).fit_transform(x)
    raise ValueError(f"unknown reducer {reducer!r}")


class HierarchicalClusterer:
    """Embeds a dataset's images (``embedder``, default a seeded
    ``ImageEmbedder`` on ``device``: the GPU unless told otherwise) and
    writes the caption ladder into its records."""

    def __init__(self, embedder=None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        if embedder is None:
            from attngan_torch.models.resnet import ImageEmbedder

            embedder = ImageEmbedder(device=self.device)
        self.embedder = embedder

    def embed_dataset(self, dataset: Dataset, batch_size: int = 32
                      ) -> np.ndarray:
        """(M, F) embeddings of the normalised, flipped img256 of every
        record, the pyramid built on the clusterer's device. Pixels come
        through ``dataset._batch_pixels``, so a StreamingDataset is
        embedded in bounded host memory."""
        embs = []
        recs = dataset.records
        for start in range(0, len(recs), batch_size):
            chunk = recs[start:start + batch_size]
            pixels = torch.as_tensor(dataset._batch_pixels(chunk),
                                     device=self.device)
            flip = torch.as_tensor([r.flip for r in chunk], device=self.device)
            img256 = preprocess_pyramid(pixels, flip)[256]
            embs.append(self.embedder.embed(img256, batch_size))
        return np.concatenate(embs, axis=0)

    def cluster(
        self,
        dataset: Dataset,
        latent_dims: int = 128,
        max_vocab_size: int = 1000,
        min_clusters: int = 5,
        batch_size: int = 32,
        method: str = "agglomerative_complete",
        embeddings: Optional[np.ndarray] = None,
        reducer: str = "auto",
    ) -> None:
        """In place: appends caption tokens and assigns class_ids
        (reference bedrooms.py:248-271)."""
        ks = determine_k_values(max_vocab_size, min_clusters)
        if not ks:
            raise ValueError(f"max_vocab_size {max_vocab_size} is too small "
                             f"for any k level above {min_clusters}")
        if embeddings is None:
            embeddings = self.embed_dataset(dataset, batch_size)
        x = embeddings
        if latent_dims < x.shape[1]:
            x = reduce_dimensionality(x, latent_dims, reducer, self.device)
        for k, labels in zip(ks, cluster_ladder(x, ks, method)):
            for rec, c in zip(dataset.records, labels):
                rec.caption.append(f"k{k}c{c}")
        finest = [rec.caption[-1] for rec in dataset.records]
        id_map = {lab: i for i, lab in enumerate(sorted(set(finest)))}
        for rec, label in zip(dataset.records, finest):
            rec.class_id = id_map[label]
