"""DBoW2 direct-index (FeatureVector) guided matching semantics.

The reference vendors the direct index for CPU-cheap guided matching
(`ThirdParty/DBoW2/DBoW2/FeatureVector.h:1-56`); here it is a node-equality
mask over the same single-matmul Hamming table (`ops/matching.guided_match`).
These tests pin the semantics; `benchmarks/loop_match_scale.py` carries the
speed comparison on real hardware."""

import jax
import jax.numpy as jnp
import numpy as np

from monocular_slam_tpu.ops import matching
from monocular_slam_tpu.retrieval import vocabulary as vocab


def _rand_desc(key, n):
    bits = jax.random.bernoulli(key, 0.5, (n, 256))
    return (bits.astype(jnp.int8) << 1) - jnp.int8(1)


class TestGuidedMatch:
    def test_matches_share_nodes(self):
        key = jax.random.PRNGKey(0)
        a = _rand_desc(key, 128)
        b = _rand_desc(jax.random.fold_in(key, 1), 160)
        na = jnp.asarray(np.random.RandomState(0).randint(0, 8, 128))
        nb = jnp.asarray(np.random.RandomState(1).randint(0, 8, 160))
        m = matching.guided_match(
            a, b, jnp.ones(128, bool), jnp.ones(160, bool), na, nb,
            ratio=0.95, cross_check=False,
        )
        ok = np.asarray(m.ok)
        idx = np.asarray(m.idx)
        assert ok.any()
        # every accepted pair shares a vocabulary node — the direct-index
        # contract (DBoW2 only compares same-node features)
        assert (np.asarray(na)[ok] == np.asarray(nb)[idx[ok]]).all()

    def test_identical_sets_fully_matched(self):
        """With b a permutation of a (identical descriptors quantize to
        identical nodes), guided matching recovers the exact permutation,
        like the full table does."""
        key = jax.random.PRNGKey(2)
        a = _rand_desc(key, 100)
        perm = np.random.RandomState(3).permutation(100)
        b = a[jnp.asarray(perm)]
        desc_np = np.asarray(a)
        voc = vocab.train(desc_np, k=4, L=2, seed=0)
        na = vocab.node_words(voc, a, jnp.ones(100, bool), levels_up=1)
        nb = vocab.node_words(voc, b, jnp.ones(100, bool), levels_up=1)
        m = matching.guided_match(
            a, b, jnp.ones(100, bool), jnp.ones(100, bool), na, nb,
            ratio=0.95,
        )
        ok = np.asarray(m.ok)
        idx = np.asarray(m.idx)
        # random 256-bit descriptors are far apart: every feature matches
        # its own copy at distance 0
        assert ok.mean() > 0.95
        inv = np.empty(100, np.int64)
        inv[perm] = np.arange(100)
        assert (idx[ok] == inv[ok]).all()
        assert (np.asarray(m.dist)[ok] == 0).all()

    def test_node_words_ancestor_relation(self):
        """node_words at levels_up L must be the integer-divide ancestor of
        the leaf word (breadth-first child layout)."""
        key = jax.random.PRNGKey(4)
        desc = _rand_desc(key, 300)
        voc = vocab.train(np.asarray(desc), k=3, L=3, seed=1)
        valid = jnp.ones(300, bool)
        leaf = np.asarray(vocab.transform_words(voc, desc, valid))
        for lu in (1, 2):
            nodes = np.asarray(vocab.node_words(voc, desc, valid, levels_up=lu))
            assert (nodes == leaf // (3**lu)).all()
            assert nodes.max() < 3 ** (3 - lu)

    def test_mask_restricts_but_full_recovers(self):
        """On descriptors with small bit noise, guided matching loses the
        pairs whose noisy copy quantizes across a node boundary — the
        documented DBoW2 recall cost the full table avoids."""
        key = jax.random.PRNGKey(5)
        a = _rand_desc(key, 200)
        # flip ~8 of 256 bits
        flips = jax.random.bernoulli(jax.random.fold_in(key, 9), 8 / 256, (200, 256))
        b = jnp.where(flips, -a, a).astype(jnp.int8)
        voc = vocab.train(np.asarray(a), k=4, L=2, seed=2)
        valid = jnp.ones(200, bool)
        na = vocab.node_words(voc, a, valid, levels_up=0)
        nb = vocab.node_words(voc, b, valid, levels_up=0)
        full = matching.match(a, b, valid, valid, ratio=0.9)
        guided = matching.guided_match(a, b, valid, valid, na, nb, ratio=0.9)
        n_full = int(full.n_matches)
        n_guided = int(guided.n_matches)
        assert n_full >= n_guided  # the mask can only drop candidates here
        assert n_full > 0.9 * 200  # the full table matches nearly all
