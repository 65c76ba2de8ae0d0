"""Runtime layer: config, dispatch, contexts, async handles, accelerator facade.

The re-imagining of the reference's Rust API layer (``core/``):
env-var config registry (core/config.rs), auto CPU/accelerator dispatch
(core/dispatch.rs), MSM/NTT contexts with cached device bases and async
handles (core/msm.rs, core/ntt.rs), and the consumer-facing backend trait
facade with a global singleton (core/traits/).
"""

from .config import (
    Config,
    DeviceType,
    config,
    reset_config_cache,
)
from .handles import AsyncHandle
from .msm_context import MsmContext, PrecomputedBases
from .ntt_context import NttContext
from .accelerator import (
    Accelerator,
    AcceleratorError,
    global_accelerator,
    backend_info,
    warmup,
)
from .dispatch import DispatchResult, dispatch_msm, dispatch_ntt, dispatch_vecop
from .memory import live_arrays_report, total_live_bytes

__all__ = [
    "Config",
    "DeviceType",
    "config",
    "reset_config_cache",
    "AsyncHandle",
    "MsmContext",
    "PrecomputedBases",
    "NttContext",
    "Accelerator",
    "AcceleratorError",
    "global_accelerator",
    "backend_info",
    "warmup",
    "DispatchResult",
    "dispatch_msm",
    "dispatch_ntt",
    "dispatch_vecop",
    "live_arrays_report",
    "total_live_bytes",
]
