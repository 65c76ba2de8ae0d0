"""Env-var-driven configuration, read once and cached.

Analog of ``core/config.rs``: every knob is an environment variable
read lazily on first use and cached for the process lifetime (the
reference caches in `OnceLock`s; we cache in a singleton dataclass).
Variables keep the reference's ``MIDNIGHT_*`` names where the semantics
carry over (core/config.rs:52-363):

  MIDNIGHT_DEVICE          auto | gpu | cpu, default auto (as the reference)
  MIDNIGHT_GPU_MIN_K       MSM accel threshold log2, default 15
  MIDNIGHT_NTT_MIN_K       NTT accel threshold log2, default 12
  MIDNIGHT_VECOPS_MIN_SIZE vecops accel threshold, default 4096
  MIDNIGHT_GPU_PRECOMPUTE  base precompute factor 1..8, default 1
  MIDNIGHT_MSM_WINDOW      fixed MSM window bits (else auto table)
  MIDNIGHT_NTT_ORDERING    NN | NR | RN | RR, default NN
  MIDNIGHT_NTT_ALGORITHM   auto | radix2, default auto (both the radix-2
                           ladder; the reference's MixedRadix,
                           core/config.rs:168-212, is not implemented
                           and is rejected)
  MIDNIGHT_NTT_FAST_TWIDDLES  accepted for drop-in compatibility
                           (core/config.rs:225-244); the ladder always
                           uses the full twiddle table, so the knob is a
                           logged no-op here
  MIDNIGHT_NTT_MAX_LOG_N   default domain size the Accelerator pre-builds
                           (default 16; the reference's GpuNttContext::new
                           max(log_n, 20) analog, core/ntt.rs:342-364)
  MIDNIGHT_SHARDING        auto | none | <int #devices>, default auto
  MIDNIGHT_TRACE           comma list: msm,ntt,vecops,all (timing spans)
"""

from __future__ import annotations

import enum
import logging
import os
from dataclasses import dataclass, field

logger = logging.getLogger("bls12_381_jax")


class DeviceType(enum.Enum):
    AUTO = "auto"
    GPU = "gpu"
    CPU = "cpu"


NTT_ALGORITHMS = ("auto", "radix2")


def _int_env(name: str, default: int, lo: int, hi: int) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        v = int(raw)
    except ValueError:
        logger.warning("%s=%r is not an int; using %d", name, raw, default)
        return default
    if not (lo <= v <= hi):
        logger.warning("%s=%d out of [%d, %d]; clamping", name, v, lo, hi)
        return min(max(v, lo), hi)
    return v


@dataclass(frozen=True)
class Config:
    device: DeviceType
    msm_min_k: int
    ntt_min_k: int
    vecops_min_size: int
    precompute_factor: int
    msm_window: int | None
    # "auto" (default): GLV when the doubled point set still fits the MSM
    # memory budget in one shot; "on"/"off" force.  pippenger.msm
    # resolves "auto" per call.
    msm_glv: str
    ntt_max_log_n: int
    ntt_ordering: str
    ntt_algorithm: str
    sharding: str
    trace: frozenset = field(default_factory=frozenset)

    @classmethod
    def from_env(cls) -> "Config":
        raw_dev = os.environ.get("MIDNIGHT_DEVICE", "auto").lower()
        try:
            device = DeviceType(raw_dev)
        except ValueError:
            logger.warning("MIDNIGHT_DEVICE=%r unknown; using auto", raw_dev)
            device = DeviceType.AUTO
        window = _int_env("MIDNIGHT_MSM_WINDOW", 0, 0, 24)
        trace_raw = os.environ.get("MIDNIGHT_TRACE", "")
        trace = frozenset(t.strip() for t in trace_raw.split(",") if t.strip())
        ft = os.environ.get("MIDNIGHT_NTT_FAST_TWIDDLES")
        if ft is not None:
            logger.info(
                "MIDNIGHT_NTT_FAST_TWIDDLES=%s accepted (no-op: per-stage "
                "twiddle table is always used here)", ft)
        algo = os.environ.get("MIDNIGHT_NTT_ALGORITHM", "auto").lower()
        if algo not in NTT_ALGORITHMS:
            raise ValueError(
                f"MIDNIGHT_NTT_ALGORITHM={algo!r} is not supported; "
                f"expected one of {', '.join(NTT_ALGORITHMS)}")
        return cls(
            device=device,
            msm_min_k=_int_env("MIDNIGHT_GPU_MIN_K", 15, 0, 30),
            ntt_min_k=_int_env("MIDNIGHT_NTT_MIN_K", 12, 0, 32),
            vecops_min_size=_int_env("MIDNIGHT_VECOPS_MIN_SIZE", 4096, 0, 1 << 30),
            precompute_factor=_int_env("MIDNIGHT_GPU_PRECOMPUTE", 1, 1, 8),
            msm_window=window or None,
            msm_glv={"1": "on", "true": "on", "on": "on", "yes": "on",
                     "0": "off", "false": "off", "off": "off", "no": "off",
                     }.get(os.environ.get("MIDNIGHT_MSM_GLV", "auto")
                           .lower(), "auto"),
            ntt_max_log_n=_int_env("MIDNIGHT_NTT_MAX_LOG_N", 16, 0, 32),
            ntt_ordering=os.environ.get("MIDNIGHT_NTT_ORDERING", "NN").upper(),
            ntt_algorithm=algo,
            sharding=os.environ.get("MIDNIGHT_SHARDING", "auto").lower(),
            trace=trace,
        )

    # --- decision helpers (core/config.rs:449-513 analogs) -----------------

    def use_accel_msm(self, n: int) -> bool:
        if self.device is DeviceType.CPU:
            return False
        if self.device is DeviceType.GPU:
            return True
        return n >= (1 << self.msm_min_k)

    def use_accel_ntt(self, n: int) -> bool:
        if self.device is DeviceType.CPU:
            return False
        if self.device is DeviceType.GPU:
            return True
        return n >= (1 << self.ntt_min_k)

    def use_accel_vecops(self, n: int) -> bool:
        if self.device is DeviceType.CPU:
            return False
        if self.device is DeviceType.GPU:
            return True
        return n >= self.vecops_min_size

    def traces(self, tag: str) -> bool:
        return "all" in self.trace or tag in self.trace


_CONFIG: Config | None = None


def config() -> Config:
    """Process-wide cached config (read env once, like OnceLock)."""
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = Config.from_env()
        logger.info("bls12_381_jax config: %s", _CONFIG)
    return _CONFIG


def reset_config_cache() -> None:
    """Drop the cache (tests / after os.environ mutation)."""
    global _CONFIG
    _CONFIG = None
