"""Native UMAP dimensionality reduction: port of
attngan_tpu/data/umap_native.py (no umap-learn, no scikit-learn).

The reference's clustering captioner reduces image embeddings with UMAP
before building the caption k-ladder (reference data/bedrooms.py:274-276:
``umap.UMAP(n_components=latent_dims).fit_transform(embeddings)``). This
module implements the UMAP algorithm (McInnes, Healy & Melville 2018,
arXiv:1802.03426) from its published math:

  1. exact kNN graph, in torch on the caller's device (``_knn``: float64
     distances, self excluded, equal distances ordered by index);
  2. per-point smooth kNN calibration — binary-search ``sigma_i`` so that
     ``sum_j exp(-max(0, d_ij - rho_i) / sigma_i) = log2(k)`` with ``rho_i``
     the distance to the nearest neighbor (paper section 3.1);
  3. fuzzy simplicial set symmetrization ``P + P^T - P o P^T``
     (probabilistic t-conorm);
  4. curve parameters ``(a, b)`` fit so ``1/(1 + a d^{2b})`` matches the
     ``min_dist``/``spread`` offset-exponential target curve;
  5. spectral initialization from the symmetric normalized graph
     Laplacian (fallback: the clusterer's exact PCA), scaled to the usual
     [-10, 10] box;
  6. stochastic layout optimization with per-edge sampling schedules
     (``epochs_per_sample = max(w)/w``) and ``negative_sample_rate``
     uniform negative samples per positive, gradients clipped to +-4,
     learning rate annealed linearly to 0.

Steps 2-6 are the JAX package's numpy and scipy code with the same
``default_rng(random_state)`` stream, so from the same kNN graph both give
the same embedding. One deliberate divergence from umap-learn: each
epoch's edge updates are applied as a vectorized batch (``np.add.at``
scatter-add) instead of umap-learn's sequential asynchronous
(Hogwild-style) per-edge updates. Both are stochastic-gradient schemes for
the same cross-entropy objective; the batch form is deterministic given
the seed and orders of magnitude faster in pure numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from attngan_torch.core.runtime import resolve_device

SMOOTH_K_TOLERANCE = 1e-5
MIN_K_DIST_SCALE = 1e-3
KNN_ROWS = 1024      # query rows a cdist block


def _knn(x: np.ndarray, n_neighbors: int,
         device: str | torch.device | None = None
         ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN (excluding self): (indices, distances), each (N, k).
    Euclidean distances in float64 on ``device`` (default: the GPU),
    KNN_ROWS rows at a time; a stable sort orders equal distances by
    index."""
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float64), device=dev)
    n = xt.shape[0]
    idx, dists = [], []
    for start in range(0, n, KNN_ROWS):
        rows = torch.arange(start, min(start + KNN_ROWS, n), device=dev)
        d = torch.cdist(xt[rows], xt,
                        compute_mode="donot_use_mm_for_euclid_dist")
        d[rows - start, rows] = float("inf")
        d, order = torch.sort(d, dim=1, stable=True)
        idx.append(order[:, :n_neighbors].cpu())
        dists.append(d[:, :n_neighbors].cpu())
    return torch.cat(idx).numpy(), torch.cat(dists).numpy()


def smooth_knn_dist(
    dists: np.ndarray, n_neighbors: int, n_iter: int = 64
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-point (sigma, rho) calibration (paper section 3.1).

    Binary-search sigma_i > 0 so the effective number of neighbors
    ``sum_j exp(-max(0, d_ij - rho_i)/sigma_i)`` equals ``log2(k)``.
    Vectorized over points.
    """
    n = dists.shape[0]
    target = np.log2(n_neighbors)
    rho = np.where(dists[:, 0] > 0, dists[:, 0], 0.0)
    # For points whose first neighbors are duplicates (d=0), umap uses the
    # smallest nonzero distance as rho; replicate that.
    has_zero_first = dists[:, 0] <= 0
    if np.any(has_zero_first):
        masked = np.where(dists > 0, dists, np.inf)
        smallest_nonzero = np.min(masked, axis=1)
        rho = np.where(
            has_zero_first,
            np.where(np.isfinite(smallest_nonzero), smallest_nonzero, 0.0),
            rho,
        )
    lo = np.zeros(n)
    hi = np.full(n, np.inf)
    mid = np.ones(n)
    adjusted = np.maximum(dists - rho[:, None], 0.0)
    for _ in range(n_iter):
        psum = np.exp(-adjusted / mid[:, None]).sum(axis=1)
        err = psum - target
        done = np.abs(err) < SMOOTH_K_TOLERANCE
        if np.all(done):
            break
        too_high = err > 0
        hi = np.where(~done & too_high, mid, hi)
        lo = np.where(~done & ~too_high, mid, lo)
        mid = np.where(
            ~done,
            np.where(
                np.isinf(hi), np.where(too_high, mid, mid * 2.0), (lo + hi) / 2.0
            ),
            mid,
        )
    # Floor sigma the way umap-learn does (vs mean distances) to avoid
    # degenerate zero-bandwidth points.
    mean_d = dists.mean()
    mean_row = dists.mean(axis=1)
    floor = np.where(
        rho > 0, MIN_K_DIST_SCALE * mean_row, MIN_K_DIST_SCALE * mean_d
    )
    return np.maximum(mid, floor), rho


def fuzzy_simplicial_set(
    x: np.ndarray, n_neighbors: int, device: str | torch.device | None = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetrized fuzzy graph as COO arrays (rows, cols, weights); the
    kNN on ``device``."""
    from scipy.sparse import coo_matrix

    n = x.shape[0]
    idx, dists = _knn(x, n_neighbors, device)
    sigma, rho = smooth_knn_dist(dists, n_neighbors)
    w = np.exp(-np.maximum(dists - rho[:, None], 0.0) / sigma[:, None])
    rows = np.repeat(np.arange(n), idx.shape[1])
    cols = idx.ravel()
    p = coo_matrix((w.ravel(), (rows, cols)), shape=(n, n)).tocsr()
    pt = p.T.tocsr()
    sym = (p + pt - p.multiply(pt)).tocoo()
    keep = sym.data > 0
    return sym.row[keep], sym.col[keep], sym.data[keep]


def find_ab_params(spread: float, min_dist: float) -> Tuple[float, float]:
    """Fit (a, b) of 1/(1 + a d^{2b}) to the min_dist/spread target curve."""
    from scipy.optimize import curve_fit

    def curve(d, a, b):
        return 1.0 / (1.0 + a * d ** (2.0 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))
    (a, b), _ = curve_fit(curve, xv, yv, p0=(1.0, 1.0), maxfev=5000)
    return float(a), float(b)


def _spectral_init(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n: int,
    n_components: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Eigenvectors 1..n_components of the sym-normalized Laplacian."""
    from scipy.sparse import coo_matrix, identity
    from scipy.sparse.linalg import eigsh

    g = coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    deg = np.asarray(g.sum(axis=1)).ravel()
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    lap = identity(n) - g.multiply(dinv[:, None]).multiply(dinv[None, :])
    k = n_components + 1
    # deterministic Lanczos start (eigsh's default v0 is random)
    v0 = np.full(n, 1.0 / np.sqrt(n))
    _, vecs = eigsh(lap.tocsc(), k=k, sigma=0.0, which="LM", v0=v0)
    emb = vecs[:, 1:k]
    return emb + rng.normal(scale=1e-4, size=emb.shape)


def _initial_embedding(
    x: np.ndarray,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_components: int,
    rng: np.random.Generator,
) -> np.ndarray:
    n = x.shape[0]
    try:
        emb = _spectral_init(rows, cols, vals, n, n_components, rng)
    except Exception:
        from attngan_torch.data.clusterer import pca

        k = min(n_components, min(x.shape))
        emb = np.zeros((n, n_components))
        emb[:, :k] = pca(x, k)
        emb += rng.normal(scale=1e-4, size=emb.shape)
    # umap scales the init so the max extent is 10 per axis.
    extent = np.abs(emb).max()
    if extent > 0:
        emb = emb * (10.0 / extent)
    return emb.astype(np.float64)


def optimize_layout(
    emb: np.ndarray,
    rows: np.ndarray,
    cols: np.ndarray,
    weights: np.ndarray,
    n_epochs: int,
    a: float,
    b: float,
    rng: np.random.Generator,
    learning_rate: float = 1.0,
    negative_sample_rate: int = 5,
    repulsion_strength: float = 1.0,
    move_other: bool = True,
) -> np.ndarray:
    """Negative-sampling SGD on the UMAP cross-entropy (paper section 3.2).

    Per-edge sampling schedule matches umap-learn: an edge with weight w is
    updated every ``max(w)/w`` epochs; each update draws
    ``negative_sample_rate`` uniform negatives for its head. Updates within
    an epoch are applied as one vectorized scatter-add batch (see module
    docstring for the divergence note).
    """
    n = emb.shape[0]
    emb = emb.copy()
    eps = weights.max() / weights  # epochs per sample
    next_sample = eps.copy()
    clip = 4.0
    for epoch in range(n_epochs):
        alpha = learning_rate * (1.0 - epoch / float(n_epochs))
        active = next_sample <= epoch + 1
        if not np.any(active):
            continue
        h = rows[active]
        t = cols[active]
        yh, yt = emb[h], emb[t]
        diff = yh - yt
        d2 = np.einsum("ij,ij->i", diff, diff)
        # attractive: dCE/dy_h = (-2ab d^{2b-2}) / (1 + a d^{2b}) * diff
        pd = np.power(np.maximum(d2, 1e-12), b)
        att = (-2.0 * a * b * pd) / (np.maximum(d2, 1e-12) * (1.0 + a * pd))
        att = np.where(d2 > 0, att, 0.0)
        grad = np.clip(att[:, None] * diff, -clip, clip)
        np.add.at(emb, h, alpha * grad)
        if move_other:
            np.add.at(emb, t, -alpha * grad)
        # repulsive: negative_sample_rate uniform negatives per active edge
        m = h.shape[0]
        for _ in range(negative_sample_rate):
            neg = rng.integers(0, n, size=m)
            yh = emb[h]
            diffn = yh - emb[neg]
            d2n = np.einsum("ij,ij->i", diffn, diffn)
            pdn = np.power(np.maximum(d2n, 1e-12), b)
            rep = (2.0 * repulsion_strength * b) / (
                (0.001 + d2n) * (1.0 + a * pdn)
            )
            gradn = np.where(
                d2n[:, None] > 0,
                np.clip(rep[:, None] * diffn, -clip, clip),
                clip,  # coincident points repel at full clip (umap-learn)
            )
            gradn = np.where(neg[:, None] == h[:, None], 0.0, gradn)
            np.add.at(emb, h, alpha * gradn)
        next_sample[active] += eps[active]
    return emb


def umap_embed(
    x: np.ndarray,
    n_components: int = 2,
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    spread: float = 1.0,
    n_epochs: Optional[int] = None,
    learning_rate: float = 1.0,
    negative_sample_rate: int = 5,
    random_state: int = 0,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """UMAP-embed rows of ``x`` to ``n_components`` dimensions, the kNN
    graph on ``device`` (default: the GPU).

    Drop-in for the reference's ``UMAP(n_components=...).fit_transform``
    (bedrooms.py:274-276) with umap-learn's defaults.
    """
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if n <= n_components + 2:
        raise ValueError(
            f"need more than {n_components + 2} samples to embed to "
            f"{n_components} dims, got {n}"
        )
    if n > 20_000:
        # This implementation uses EXACT kNN (O(N^2 D)) and a numpy-level
        # epoch loop — correct at any size but built for the captioner's
        # corpus scale (hundreds to tens of thousands of images). Point
        # very large corpora at reducer='pca'.
        print(f"umap_native: N={n} is large for the exact-kNN native "
              "implementation; expect minutes-scale runtime "
              "(reducer='pca' is the fast path)")
    n_neighbors = min(n_neighbors, n - 1)
    rng = np.random.default_rng(random_state)
    rows, cols, vals = fuzzy_simplicial_set(x, n_neighbors, device)
    if n_epochs is None:
        n_epochs = 200 if n > 10_000 else 500
    # umap-learn prunes edges too weak to ever be sampled
    keep = vals >= vals.max() / float(n_epochs)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    a, b = find_ab_params(spread, min_dist)
    emb = _initial_embedding(x, rows, cols, vals, n_components, rng)
    emb = optimize_layout(
        emb,
        rows,
        cols,
        vals,
        n_epochs,
        a,
        b,
        rng,
        learning_rate=learning_rate,
        negative_sample_rate=negative_sample_rate,
    )
    return emb.astype(np.float32)
