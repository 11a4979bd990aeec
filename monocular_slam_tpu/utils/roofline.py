"""Per-program roofline / MFU accounting (BASELINE.json's "speed-of-light"
clause): XLA's own cost model (`Compiled.cost_analysis()` — flops and
device-memory bytes) against the card's peak FLOP rate and memory bandwidth.

The reference has no analog (it never measures anything, SURVEY.md §6); g2o's
`G2OBatchStatistics` records wall times only. Here every perf claim can carry
  - mfu:        achieved FLOP/s over peak FLOP/s,
  - hbm_frac:   achieved bytes/s over peak memory bytes/s,
  - bound:      which wall the program is nearer to ("compute" when its
                arithmetic intensity exceeds the machine balance, else
                "memory"),
  - sol_frac:   distance to that wall — achieved/attainable throughput, where
                attainable = min(peak_flops, intensity * peak_bw). This is
                the honest "percent of speed of light" number: a tiny-FLOP
                memory-bound program can have 1% MFU while sitting at 80% of
                its actual roof.
"""

from __future__ import annotations

from typing import NamedTuple


class DevicePeaks(NamedTuple):
    name: str
    peak_flops: float  # FLOP/s, dense bf16 tensor-core peak (MFU convention)
    peak_int8: float  # OP/s, dense int8 tensor-core peak
    peak_tf32: float  # FLOP/s, dense TF32 tensor-core peak
    peak_f32: float  # FLOP/s, float32 outside the tensor cores
    peak_bw: float  # device-memory bytes/s
    source: str


# Published peaks, keyed by `jax.Device.device_kind`. MFU convention: the
# dense bf16 peak, for every kernel, so numbers stay comparable across
# kernels whatever their dtype. The rates assume the card's full power
# limit; report the limit (nvidia-smi power.limit) beside any share of them.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        "NVIDIA H100 SXM", 989.0e12, 1979.0e12, 495.0e12, 67.0e12, 3.35e12,
        "NVIDIA H100 Tensor Core GPU data sheet, SXM, dense (no sparsity)",
    ),
}


def device_peaks(device=None) -> DevicePeaks:
    """Peaks of `device` (default: the first JAX device). A device kind that
    is not in the table is an error, never a default."""
    import jax

    dev = device or jax.devices()[0]
    kind = getattr(dev, "device_kind", "")
    try:
        return _PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {kind!r} ({dev.platform}); "
            f"known: {sorted(_PEAKS)}"
        ) from None


def name_power_limit() -> list[str]:
    """Each card's name and power limit, one line per card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (a child process that stays off JAX). The published peaks assume
    the full limit; a card set below it cannot hold its top clock."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()


class Roofline(NamedTuple):
    flops: float
    bytes: float
    wall_s: float
    intensity: float  # flops per device-memory byte
    mfu: float  # achieved / peak FLOP rate
    hbm_frac: float  # achieved / peak memory rate
    bound: str  # "compute" | "memory"
    sol_frac: float  # achieved / attainable under the roofline

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "wall_ms": round(self.wall_s * 1e3, 3),
            "intensity_flop_per_byte": round(self.intensity, 2),
            "mfu": round(self.mfu, 4),
            "hbm_frac": round(self.hbm_frac, 4),
            "bound": self.bound,
            "sol_frac": round(self.sol_frac, 4),
        }


def analyze(compiled, wall_s: float, peaks: DevicePeaks | None = None) -> Roofline:
    """Roofline numbers for one compiled program measured at `wall_s` per
    call. `compiled` is a `jax.stages.Compiled` (use jit(f).lower(...).compile())."""
    peaks = peaks or device_peaks()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    flops = float(ca.get("flops", 0.0))
    byts = float(ca.get("bytes accessed", 0.0))
    intensity = flops / max(byts, 1.0)
    mfu = flops / max(wall_s, 1e-12) / peaks.peak_flops
    hbm = byts / max(wall_s, 1e-12) / peaks.peak_bw
    balance = peaks.peak_flops / peaks.peak_bw  # flop/byte machine balance
    bound = "compute" if intensity >= balance else "memory"
    attainable = min(peaks.peak_flops, intensity * peaks.peak_bw)  # flop/s
    sol = (flops / max(wall_s, 1e-12)) / attainable if flops > 0 else hbm
    return Roofline(flops, byts, wall_s, intensity, mfu, hbm, bound, min(sol, 1.0))
