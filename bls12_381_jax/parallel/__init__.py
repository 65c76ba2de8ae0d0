"""Multi-device scale-out: sharded MSM and NTT over a `jax.sharding.Mesh`.

The reference is single-process/single-GPU (device 0 hardcoded,
core/config.rs:529-531); this package adds the missing axis —
points/coefficients partitioned across devices, local kernels per shard,
and collectives (`all_gather` / `all_to_all`, which XLA hands to NCCL on
GPUs) for the combine steps.
"""

from .mesh import default_mesh, init_distributed, shard_axis
from .msm import msm_sharded, msm_g1_sharded, msm_g2_sharded
from .ntt import (
    ntt_sharded,
    intt_sharded,
    ntt_batch_sharded,
    coset_ntt_sharded,
    coset_intt_sharded,
    build_step_twiddles,
)

__all__ = [
    "default_mesh",
    "init_distributed",
    "shard_axis",
    "coset_ntt_sharded",
    "coset_intt_sharded",
    "msm_sharded",
    "msm_g1_sharded",
    "msm_g2_sharded",
    "ntt_sharded",
    "intt_sharded",
    "ntt_batch_sharded",
    "build_step_twiddles",
]
