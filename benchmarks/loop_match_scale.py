"""Loop-closure verification matching at map scale — the DBoW2 direct-index
justification, measured.

DBoW2's FeatureVector ("direct index", `ThirdParty/DBoW2/DBoW2/FeatureVector.h`)
exists to make loop *verification* cheap on a CPU: instead of brute-force
matching the query frame's descriptors against every candidate descriptor, it
buckets features by vocabulary node so only same-bucket pairs are compared.
Here the brute-force table is one int8 (N, 256) x (256, M) matmul
(`ops/matching.py:hamming_matrix`), so this framework skips the direct index.
This benchmark times that choice at the scales the index was built for:

  1. retrieval:     BoW-score one query against a 10,000-frame database
                    (`retrieval/vocabulary.score_against_database`).
  2. verification:  full ratio-test matching between two 2,000-feature frames
                    (`ops/matching.match`, the `compute_sim3` path of
                    `slam/loop_closer.py`).
  3. map-scale:     one query frame (2,000 descriptors) against 20,000+ map
                    point descriptors in a single Hamming matmul — strictly
                    MORE work than any direct-index guided match would do.

Writes JSON to --out. Times are device times only when run on the GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _timeit(f, *a, n=20):
    import jax

    out = f(*a)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = f(*a)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--db-frames", type=int, default=10000)
    p.add_argument("--n-feat", type=int, default=2000)
    p.add_argument("--map-points", type=int, default=20000)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from monocular_slam_tpu.ops import matching
    from monocular_slam_tpu.retrieval import vocabulary as vocab

    key = jax.random.PRNGKey(0)
    out = {"device": str(jax.devices()[0])}

    # --- 1. retrieval: query BoW vs 10k-frame database ----------------------
    voc = vocab.load_default()
    V = voc.n_words
    kd, kq = jax.random.split(key)
    db = jax.random.dirichlet(kd, jnp.ones(V), (args.db_frames,)).astype(jnp.float32)
    q = jax.random.dirichlet(kq, jnp.ones(V)).astype(jnp.float32)
    f_score = jax.jit(lambda q_, db_: vocab.score_against_database(q_, db_, "l1"))
    dt = _timeit(f_score, q, db)
    out["retrieval_10k_frames"] = {
        "db_frames": args.db_frames,
        "n_words": int(V),
        "ms": round(dt * 1e3, 3),
    }

    # --- 2. verification: frame-vs-frame ratio-test match -------------------
    ka, kb = jax.random.split(key, 2)
    da = jnp.sign(jax.random.normal(ka, (args.n_feat, 256))).astype(jnp.int8)
    db2 = jnp.sign(jax.random.normal(kb, (args.n_feat, 256))).astype(jnp.int8)
    ok = jnp.ones(args.n_feat, bool)
    f_match = jax.jit(
        lambda a, b: matching.match(a, b, ok, ok, ratio=0.9, max_dist=80)
    )
    dt = _timeit(f_match, da, db2)
    out["verification_frame_pair"] = {"n_feat": args.n_feat, "ms": round(dt * 1e3, 3)}

    # --- 3. map-scale: query frame vs ALL map point descriptors -------------
    km = jax.random.split(key, 3)[2]
    dmap = jnp.sign(jax.random.normal(km, (args.map_points, 256))).astype(jnp.int8)
    f_big = jax.jit(lambda a, b: matching.hamming_matrix(a, b).min(axis=1))
    dt = _timeit(f_big, da, dmap)
    out["map_scale_match"] = {
        "n_query": args.n_feat,
        "n_map_points": args.map_points,
        "ms": round(dt * 1e3, 3),
    }

    # --- 4. direct-index head-to-head at the LARGEST supported map ----------
    # Full ratio-test matching vs node-masked (FeatureVector-guided)
    # matching of one query frame against the whole map descriptor set, at
    # the framework's max_points capacities. The guided variant is the
    # DBoW2 semantics (`FeatureVector.h:1-56`); the mask is applied on top
    # of the SAME single matmul, so it can only add work — this is the
    # measurement COVERAGE.md's claim rests on.
    okq = jnp.ones(args.n_feat, bool)
    for M in (20000, 30000, 65536):
        dmapM = jnp.sign(
            jax.random.normal(jax.random.fold_in(key, M), (M, 256))
        ).astype(jnp.int8)
        okm = jnp.ones(M, bool)
        nq = vocab.node_words(voc, da, okq, levels_up=2)
        nm = vocab.node_words(voc, dmapM, okm, levels_up=2)
        f_full = jax.jit(
            lambda a, b: matching.match(a, b, okq, okm, ratio=0.9, max_dist=80)
        )
        f_guided = jax.jit(
            lambda a, b, na, nb: matching.guided_match(
                a, b, okq, okm, na, nb, ratio=0.9, max_dist=80
            )
        )
        t_full = _timeit(f_full, da, dmapM)
        # guided pays its quantization too (the node ids of the query are
        # not free — DBoW2 computes them during transform())
        f_guided_with_quant = jax.jit(
            lambda a, b: matching.guided_match(
                a, b, okq, okm,
                vocab.node_words(voc, a, okq, levels_up=2),
                vocab.node_words(voc, b, okm, levels_up=2),
                ratio=0.9, max_dist=80,
            )
        )
        t_guided = _timeit(f_guided, da, dmapM, nq, nm)
        t_guided_q = _timeit(f_guided_with_quant, da, dmapM)
        out[f"direct_index_vs_full_{M}"] = {
            "n_query": args.n_feat,
            "n_map_points": M,
            "full_xla_ms": round(t_full * 1e3, 3),
            "guided_precomputed_nodes_ms": round(t_guided * 1e3, 3),
            "guided_with_quantization_ms": round(t_guided_q * 1e3, 3),
        }

    s = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(s + "\n")
    print(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
