"""Hierarchical binary-descriptor vocabulary — the DBoW2 replacement.

Covers the vendored `TemplatedVocabulary<FORB::TDescriptor, FORB>`
(`ThirdParty/DBoW2/DBoW2/TemplatedVocabulary.h:42-140`): a k^L tree built by
hierarchical k-means on ORB descriptors (k-means++ seeding, bitwise-majority
means — `FORB::meanValue`, `FORB.cpp:40-77`), tf-idf weighted bag-of-words
vectors, and L1/L2/chi2/dot similarity scoring (`ScoringObject.h:73-89`).

Matmul-shaped design decisions:
  - the tree is stored as dense arrays: level l holds k^(l+1) node descriptors
    as +-1 int8 (256,) rows; `transform` descends all descriptors of a frame
    through all levels with ONE Hamming matmul per level (descriptor x node
    children), no per-descriptor recursion;
  - a frame's BoW vector is a dense (V,) tf-idf histogram (V = k^L words);
    batched frame-vs-database scoring is then a single (Q, V) x (V, D)
    matmul — the "inverted-index matmul" of BASELINE.json;
  - training (k-means) is offline/CPU-friendly numpy but uses the same
    Hamming-via-matmul primitive.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Vocabulary(NamedTuple):
    """Dense k^L vocabulary tree.

    nodes[l]: (+-1 int8) array of shape (k^(l+1), 256) — level-l node
    descriptors in breadth-first order: node j's children are
    [j*k, (j+1)*k) at the next level.
    """

    nodes: tuple  # tuple of (k^(l+1), 256) int8 arrays
    weights: jnp.ndarray  # (V,) float32 idf word weights
    k: int
    L: int

    @property
    def n_words(self) -> int:
        return self.k**self.L


def _hamming_np(a_pm1: np.ndarray, b_pm1: np.ndarray) -> np.ndarray:
    """(N, 256) x (M, 256) -> (N, M) int32 Hamming distances (numpy)."""
    return (256 - a_pm1.astype(np.int32) @ b_pm1.astype(np.int32).T) // 2


def _majority_mean(desc_pm1: np.ndarray) -> np.ndarray:
    """Bitwise-majority mean of +-1 descriptors (FORB::meanValue semantics,
    `FORB.cpp:40-77`): sign of the per-bit sum (ties -> +1)."""
    s = desc_pm1.astype(np.int32).sum(axis=0)
    return np.where(s >= 0, 1, -1).astype(np.int8)


def _kmeans_binary(rng, desc: np.ndarray, k: int, iters: int = 8):
    """k-means on +-1 binary descriptors with k-means++ seeding and majority
    means. Returns (centers (k, 256) int8, assign (N,))."""
    n = len(desc)
    if n <= k:
        centers = np.ones((k, 256), np.int8)
        centers[:n] = desc
        return centers, np.arange(n) % k
    # k-means++ seeding (DBoW2 uses the same scheme via DUtils::Random)
    first = rng.randint(n)
    centers = [desc[first]]
    d2 = _hamming_np(desc, desc[first : first + 1])[:, 0].astype(np.float64)
    for _ in range(k - 1):
        s = d2.sum()
        if s <= 0:
            # every remaining descriptor coincides with a chosen center
            # (deep-level groups of near-duplicates) — uniform pick
            nxt = rng.randint(n)
        else:
            probs = d2 / s
            probs = probs / probs.sum()  # exact renormalization for choice()
            nxt = rng.choice(n, p=probs)
        centers.append(desc[nxt])
        d2 = np.minimum(d2, _hamming_np(desc, desc[nxt : nxt + 1])[:, 0])
    centers = np.stack(centers)
    assign = None
    for _ in range(iters):
        D = _hamming_np(desc, centers)
        new_assign = D.argmin(axis=1)
        if assign is not None and (new_assign == assign).all():
            break
        assign = new_assign
        for c in range(k):
            m = assign == c
            if m.any():
                centers[c] = _majority_mean(desc[m])
    return centers, assign


def train(
    descriptors_pm1: np.ndarray,
    k: int = 10,
    L: int = 3,
    seed: int = 0,
    weighting: str = "tf_idf",
) -> Vocabulary:
    """Build a k^L vocabulary from training descriptors (N, 256) +-1 int8.

    Default DBoW2 shape is k=10, L=5 (1e5 words, `TemplatedVocabulary.h:55-57`);
    k=10, L=3 (1000 words) is plenty for trajectory-scale loop closure and
    keeps the dense BoW matmul small.
    """
    rng = np.random.RandomState(seed)
    desc = np.asarray(descriptors_pm1, np.int8)
    levels = []
    groups = [desc]  # descriptors assigned to each node of current level
    for lvl in range(L):
        centers_lvl = []
        next_groups = []
        for g in groups:
            centers, assign = _kmeans_binary(rng, g, k)
            centers_lvl.append(centers)
            for c in range(k):
                next_groups.append(g[assign == c] if len(g) else g)
        levels.append(np.concatenate(centers_lvl, axis=0))  # (k^(lvl+1), 256)
        groups = next_groups

    V = k**L
    # idf from the training corpus treated as one document per descriptor
    # (DBoW2 initializes idf from training word frequencies,
    # TemplatedVocabulary::setNodeWeights).
    word_of = _transform_words_np(levels, k, L, desc)
    counts = np.bincount(word_of, minlength=V).astype(np.float64)
    n = max(len(desc), 1)
    if weighting == "tf_idf":
        w = np.log(n / np.maximum(counts, 1.0))
    else:
        w = np.ones(V)
    return Vocabulary(
        nodes=tuple(jnp.asarray(lv) for lv in levels),
        weights=jnp.asarray(w, jnp.float32),
        k=k,
        L=L,
    )


def _transform_words_np(levels, k, L, desc_pm1: np.ndarray) -> np.ndarray:
    """numpy reference word assignment (training-time)."""
    node = np.zeros(len(desc_pm1), np.int64)
    for lvl in range(L):
        cand = levels[lvl]  # (k^(lvl+1), 256)
        base = node * k
        idx = base[:, None] + np.arange(k)[None, :]
        child_desc = cand[idx]  # (N, k, 256)
        d = (256 - np.einsum("nb,nkb->nk", desc_pm1.astype(np.int32), child_desc.astype(np.int32))) // 2
        node = base + d.argmin(axis=1)
    return node


def transform_words(voc: Vocabulary, desc_pm1: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Assign each descriptor to its leaf word: L rounds of batched Hamming
    argmin over the k children (`TemplatedVocabulary::transform`'s tree
    descent, vectorized over all descriptors). Returns (N,) int32 word ids
    (invalid descriptors get word 0 but are masked by callers via tf).

    Matmul-shaped: each level scores ALL descriptors against ALL level nodes
    with ONE +-1 matmul, then slices each descriptor's k children out of
    the distance matrix (a tiny (N, k) take_along_axis). The per-descriptor
    child gather it replaces — (N, k, 256) rows from the node table — is
    the direct form."""
    N = desc_pm1.shape[0]
    node = jnp.zeros(N, jnp.int32)
    d8 = desc_pm1.astype(jnp.int8)
    for lvl in range(voc.L):
        cand = voc.nodes[lvl]  # (k^(lvl+1), 256) int8
        dots = jnp.matmul(
            d8, cand.T, preferred_element_type=jnp.int32
        )  # (N, k^(lvl+1)) — larger dot = smaller Hamming
        base = node * voc.k
        idx = base[:, None] + jnp.arange(voc.k, dtype=jnp.int32)[None, :]
        child_dots = jnp.take_along_axis(dots, idx, axis=1)  # (N, k)
        node = base + jnp.argmax(child_dots, axis=1).astype(jnp.int32)
    return node


def node_words(
    voc: Vocabulary, desc_pm1: jnp.ndarray, valid: jnp.ndarray,
    levels_up: int = 2,
) -> jnp.ndarray:
    """Per-descriptor node id at `levels_up` levels above the leaves — the
    DBoW2 FeatureVector key (`TemplatedVocabulary::transform`'s nodeid
    output with its `levelsup` parameter; `FeatureVector.h:1-56`). In
    breadth-first child indexing, a leaf's ancestor is an integer divide:
    node = word // k^levels_up."""
    words = transform_words(voc, desc_pm1, valid)
    return words // jnp.int32(voc.k**levels_up)


def bow_vector(voc: Vocabulary, desc_pm1: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Dense tf-idf BoW vector (V,), L1-normalized (DBoW2's default
    normalization for L1 scoring, `BowVector.h:36-53`)."""
    words = transform_words(voc, desc_pm1, valid)
    V = voc.n_words
    tf = jax.ops.segment_sum(valid.astype(jnp.float32), words, num_segments=V)
    v = tf * voc.weights
    return v / jnp.maximum(jnp.sum(jnp.abs(v)), 1e-12)


bow_vectors_batched = jax.vmap(bow_vector, in_axes=(None, 0, 0))


# --- scoring schemes (`DBoW2/ScoringObject.h:73-89`) -------------------------

def score_l1(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 score: 1 - 0.5 |a - b|_1 for L1-normalized vectors. Batched:
    a (..., V), b (..., V)."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(a - b), axis=-1)


def score_l2(a, b):
    """1 - 0.5 |a/|a| - b/|b||_2 (DBoW2 L2Scoring)."""
    an = a / jnp.maximum(jnp.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
    bn = b / jnp.maximum(jnp.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
    return 1.0 - 0.5 * jnp.linalg.norm(an - bn, axis=-1)


def score_dot(a, b):
    return jnp.sum(a * b, axis=-1)


def score_chi2(a, b):
    return jnp.sum((a * b) / jnp.maximum(a + b, 1e-12), axis=-1) * 2.0


def score_bhattacharyya(a, b):
    return jnp.sum(jnp.sqrt(jnp.maximum(a * b, 0.0)), axis=-1)


def score_kl(a, b):
    """KL divergence (lower = more similar; DBoW2 returns divergence)."""
    eps = 1e-12
    return jnp.sum(jnp.where(a > eps, a * jnp.log(jnp.maximum(a, eps) / jnp.maximum(b, eps)), 0.0), axis=-1)


SCORING = {
    "l1": score_l1,
    "l2": score_l2,
    "dot": score_dot,
    "chi2": score_chi2,
    "bhattacharyya": score_bhattacharyya,
    "kl": score_kl,
}


def score_against_database(query: jnp.ndarray, database: jnp.ndarray, kind: str = "l1"):
    """Score one query BoW (V,) against a database (D, V): the candidate
    search of loop detection as one matmul-shaped op."""
    return SCORING[kind](query[None, :], database)


# --- persistence -------------------------------------------------------------

def save(path: str, voc: Vocabulary) -> None:
    np.savez_compressed(
        path,
        k=voc.k,
        L=voc.L,
        weights=np.asarray(voc.weights),
        **{f"level_{i}": np.asarray(n) for i, n in enumerate(voc.nodes)},
    )


def load(path: str) -> Vocabulary:
    data = np.load(path)
    k, L = int(data["k"]), int(data["L"])
    return Vocabulary(
        nodes=tuple(jnp.asarray(data[f"level_{i}"]) for i in range(L)),
        weights=jnp.asarray(data["weights"]),
        k=k,
        L=L,
    )


def load_default() -> Vocabulary:
    """Bundled 10^4-word (k=10, L=4) vocabulary trained on this extractor's
    ORB descriptors over a 6-scene rendered corpus (~118k descriptors,
    deterministic seed; `benchmarks/train_vocab.py`) — the out-of-the-box
    analog of DBoW2's shipped ORB vocabulary (its default is k=10, L=5,
    `TemplatedVocabulary.h:55-57`). Evaluated on disjoint scenes in
    `benchmarks/vocab_eval_cpu.json`."""
    import os

    return load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "default_vocab.npz"))
