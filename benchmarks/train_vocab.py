"""Train and evaluate the bundled vocabulary.

DBoW2's shipped ORB vocabulary is k=10, L=5 (1e5 words,
`TemplatedVocabulary.h:55-57`). This trains the 1e4 (k=10, L=4) and 1e5
(k=10, L=5) shapes on a diverse multi-scene rendered corpus with photometric
augmentation, and evaluates place recognition on DISJOINT scenes under
DOMAIN SHIFT (queries photometrically transformed + viewpoint-perturbed
relative to the database imagery) — the r04 eval's closed-world top-1
recall of 1.0 said little; the shifted margins here are what the detector's
consistency gate actually survives on.

    python benchmarks/train_vocab.py [--train-scenes 12] [--eval-scenes 4]
                                     [--big] [--save]

Writes benchmarks/vocab_eval_<platform>.json and (with --save) the winning
tree to `retrieval/default_vocab.npz`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".data")


def _augment(img, rng):
    """Photometric domain shift: gamma + gain/bias + sensor noise."""
    import numpy as np

    gamma = rng.uniform(0.55, 1.7)
    gain = rng.uniform(0.6, 1.3)
    bias = rng.uniform(-20, 25)
    out = 255.0 * (np.clip(img, 0, 255) / 255.0) ** gamma
    out = np.clip(out * gain + bias + rng.normal(0, 4.0, img.shape), 0, 255)
    return out.astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-scenes", type=int, default=12)
    ap.add_argument("--frames-per-scene", type=int, default=24)
    ap.add_argument("--augs", type=int, default=2,
                    help="photometric augmentations per training frame")
    ap.add_argument("--eval-scenes", type=int, default=4)
    ap.add_argument("--big", action="store_true",
                    help="also train the 1e5-word (k=10, L=5) DBoW2 default shape")
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--save-shape", default=None,
                    help="which result to bundle (default: best shifted recall, tie -> margin)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from monocular_slam_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    from functools import partial

    from monocular_slam_tpu.datasets import render
    from monocular_slam_tpu.ops import features as features_mod
    from monocular_slam_tpu.retrieval import vocabulary as vocab_mod

    dev = jax.devices()[0]
    print("device:", dev, file=sys.stderr)
    wh = (640, 480)
    extract = jax.jit(partial(features_mod.extract, n_features=1000))
    rng = np.random.RandomState(7)

    def frame_descs(img):
        f = extract(jnp.asarray(img, jnp.float32))
        return np.asarray(f.desc_pm1)[np.asarray(f.valid)]

    # --- training corpus: diverse scenes x photometric augs -----------------
    t0 = time.perf_counter()
    train_descs = []
    for s in range(args.train_scenes):
        imgs, _, _ = render.render_sequence(
            jax.random.PRNGKey(100 + s), n_frames=args.frames_per_scene,
            wh=wh, ang_step=0.12,
        )
        cnt = 0
        for im in imgs:
            d = frame_descs(im)
            train_descs.append(d)
            cnt += len(d)
            for _ in range(args.augs):
                d = frame_descs(_augment(im, rng))
                train_descs.append(d)
                cnt += len(d)
        print(f"  scene {s}: {cnt} descriptors", file=sys.stderr)
    corpus = np.concatenate(train_descs)
    print(f"corpus: {len(corpus)} descriptors "
          f"({time.perf_counter() - t0:.0f}s)", file=sys.stderr)

    shapes = {"10k": (10, 4)}
    if args.big:
        shapes["100k (DBoW2 default)"] = (10, 5)
    results = {}
    vocs = {}
    for name, (k, L) in shapes.items():
        t0 = time.perf_counter()
        voc = vocab_mod.train(corpus, k=k, L=L, seed=0)
        vocs[name] = voc
        print(f"trained {name}: {voc.n_words} words in "
              f"{time.perf_counter() - t0:.0f}s", file=sys.stderr)
        # scratch dump for in-pipeline A/B runs (not committed)
        os.makedirs(DATA, exist_ok=True)
        vocab_mod.save(os.path.join(DATA, f"vocab_{voc.n_words}.npz"), voc)

    # --- evaluation: disjoint scenes, revisit retrieval under shift ---------
    # DB = first revolution of each eval scene (clean renders); queries =
    # second revolution, PHOTOMETRICALLY SHIFTED and at a perturbed orbit
    # radius (small viewpoint offset on top of the revisit). Ground truth:
    # query q revisits db frame q - half.
    n_eval = 52  # 2 revolutions at 26 frames/rev
    ang = 2 * np.pi / 26
    half = n_eval // 2
    eval_feats = []
    for s in range(args.eval_scenes):
        imgs, _, _ = render.render_sequence(
            jax.random.PRNGKey(900 + s), n_frames=n_eval, wh=wh, ang_step=ang,
        )
        # perturbed-viewpoint pass for the query revolution
        imgs_q, _, _ = render.render_sequence(
            jax.random.PRNGKey(900 + s), n_frames=n_eval, wh=wh, ang_step=ang,
            radius=1.72,
        )
        fr = []
        for i in range(half):
            f = extract(jnp.asarray(imgs[i], jnp.float32))
            fr.append((np.asarray(f.desc_pm1), np.asarray(f.valid)))
        for i in range(half, n_eval):
            f = extract(jnp.asarray(_augment(imgs_q[i], rng), jnp.float32))
            fr.append((np.asarray(f.desc_pm1), np.asarray(f.valid)))
        eval_feats.append(fr)
        print(f"  eval scene {s} rendered (+shifted queries)", file=sys.stderr)

    for name, voc in vocs.items():
        bow = jax.jit(lambda d, v, _voc=voc: vocab_mod.bow_vector(_voc, d, v))
        db, db_ids = [], []
        for s, fr in enumerate(eval_feats):
            for i in range(half):
                db.append(np.asarray(bow(jnp.asarray(fr[i][0]), jnp.asarray(fr[i][1]))))
                db_ids.append((s, i))
        db = np.stack(db)
        hits = total = 0
        margins = []
        for s, fr in enumerate(eval_feats):
            for q in range(half, n_eval):
                qv = np.asarray(bow(jnp.asarray(fr[q][0]), jnp.asarray(fr[q][1])))
                scores = 1.0 - 0.5 * np.abs(db - qv[None]).sum(axis=1)  # L1
                best = int(scores.argmax())
                bs, bi = db_ids[best]
                want = q - half
                ok = (bs == s) and (abs(bi - want) <= 2 or abs(bi - want) >= 24)
                hits += ok
                total += 1
                floor = float(np.median(scores))
                margins.append(float(scores[best]) - floor)
        m = np.asarray(margins)
        results[name] = {
            "words": int(voc.n_words),
            "top1_recall_shifted": round(hits / total, 4),
            "margin_p10": round(float(np.percentile(m, 10)), 4),
            "median_margin": round(float(np.median(m)), 4),
            "n_queries": total,
        }
        print(name, results[name], file=sys.stderr)

    out = {
        "device": str(dev),
        "train_descriptors": int(len(corpus)),
        "train_scenes": args.train_scenes,
        "train_augs_per_frame": args.augs,
        "eval_scenes": args.eval_scenes,
        "protocol": (
            "DB = first revolution of each DISJOINT eval scene (clean); "
            "query = second revolution rendered at a perturbed orbit radius "
            "and photometrically shifted (gamma 0.55-1.7, gain/bias, sensor "
            "noise). top-1 correct iff same scene within 2 frames of the "
            "revisited view. margin = best minus median score (what the "
            "detector's consistency gate sees)."
        ),
        "results": results,
    }
    print(json.dumps(out))
    path = f"benchmarks/vocab_eval_{dev.platform}.json"
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", path, file=sys.stderr)

    if args.save:
        pick = args.save_shape
        if pick is None:
            pick = max(
                results,
                key=lambda n: (
                    results[n]["top1_recall_shifted"],
                    results[n]["median_margin"],
                ),
            )
        dst = os.path.join(
            os.path.dirname(os.path.abspath(vocab_mod.__file__)),
            "default_vocab.npz",
        )
        vocab_mod.save(dst, vocs[pick])
        print(f"saved bundle ({pick}):", dst, file=sys.stderr)


if __name__ == "__main__":
    main()
