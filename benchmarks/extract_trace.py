"""Device-time breakdown of ORB extraction from a profiler trace.

Traces the jitted `ops.features.extract` at the TUM shape (640x480, 1000
features) and the KITTI shape (1241x376, 2000 features) and reports, per
call: the device time of the whole extraction (sum of its kernels' device
durations), the part spent in the FAST score + 3x3 NMS fusions (the ops
under the `fast_score_nms` named scope), the host wall time, and the ten
longest kernels. Needs a GPU.

    python benchmarks/extract_trace.py [--out .data/extract_trace.json]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import sys
import time
from collections import defaultdict
from functools import partial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SCOPE = "fast_score_nms"
SHAPES = {"tum_640x480": ((480, 640), 1000), "kitti_1241x376": ((376, 1241), 2000)}


def _stats(ev) -> dict:
    try:
        return {str(k): v for k, v in ev.stats}
    except (TypeError, ValueError):
        return {}


def scoped_kernels(hlo_text: str, scope: str) -> set[str]:
    """Names (dots as underscores) of the HLO instructions whose own or
    fused-computation metadata carries `scope` in its op_name."""
    comp_has, inst_calls, hit = {}, {}, set()
    comp = None
    for line in hlo_text.splitlines():
        m = re.match(r"\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
        if m and "=" not in line.split("{")[0]:
            comp = m.group(1)
            continue
        m = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=", line)
        if not m:
            continue
        name = m.group(1)
        if f"{scope}" in line and "op_name" in line:
            hit.add(name)
            if comp:
                comp_has[comp] = True
        c = re.search(r"calls=%?([\w.\-]+)", line)
        if c:
            inst_calls[name] = c.group(1)
    for name, callee in inst_calls.items():
        if comp_has.get(callee):
            hit.add(name)
    return {h.replace(".", "_") for h in hit} | hit


def trace_program(fn, arg, n_calls: int, scoped: set[str], logdir: str) -> dict:
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(arg))
    t0 = time.perf_counter()
    for _ in range(n_calls):
        out = fn(arg)
    jax.block_until_ready(out)
    wall = (time.perf_counter() - t0) / n_calls

    shutil.rmtree(logdir, ignore_errors=True)
    with jax.profiler.trace(logdir):
        for _ in range(n_calls):
            out = fn(arg)
        jax.block_until_ready(out)
    path = sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    planes = [
        pl for pl in ProfileData.from_file(path).planes
        if pl.name.startswith("/device:GPU")
    ]
    line_names = sorted({ln.name for pl in planes for ln in pl.lines})
    # one op per event on the "XLA Ops" line where the tracer writes it;
    # otherwise the raw kernels on the stream lines (the module lines
    # summarize the same time again)
    use = "XLA Ops" if "XLA Ops" in line_names else "Stream"
    per_kernel = defaultdict(lambda: [0, 0, ""])
    total = fast = 0
    for plane in planes:
        for line in plane.lines:
            if not line.name.startswith(use):
                continue
            for ev in line.events:
                st = _stats(ev)
                # inside a command buffer the hlo_op stat names the buffer;
                # the kernel's own name is then its fusion's name
                hlo = str(st.get("hlo_op", ev.name))
                is_fast = (
                    ev.name in scoped or hlo in scoped
                    or hlo.replace(".", "_") in scoped
                    or any(SCOPE in str(v) for v in st.values())
                )
                d = ev.duration_ns
                total += d
                fast += d if is_fast else 0
                k = per_kernel[ev.name]
                k[0] += d
                k[1] += 1
                k[2] = hlo + (" [fast]" if is_fast else "")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "trace_lines": line_names,
        "events_from": use,
        "wall_ms_per_call": wall * 1e3,
        "device_ms_per_call": total / n_calls / 1e6,
        "fast_score_nms_ms_per_call": fast / n_calls / 1e6,
        "fast_share": fast / total if total else None,
        "top_kernels": [
            {"kernel": n, "hlo_op": v[2], "ms_per_call": v[0] / n_calls / 1e6,
             "launches_per_call": v[1] / n_calls}
            for n, v in top
        ],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from monocular_slam_tpu.ops import features

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"extract_trace: needs a GPU; JAX found {dev.platform!r}")
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind}}
    for name, ((h, w), n_feat) in SHAPES.items():
        img = jax.random.uniform(jax.random.PRNGKey(3), (h, w), jnp.float32) * 255.0
        fn = jax.jit(partial(features.extract, n_features=n_feat))
        scoped = scoped_kernels(fn.lower(img).compile().as_text(), SCOPE)
        logdir = os.path.join(ROOT, ".data", "extract_trace", name)
        out[name] = trace_program(fn, img, args.calls, scoped, logdir)
        print(name, json.dumps(out[name]), flush=True)
    s = json.dumps(out, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(s + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
