"""Worker for the 2-process DCN-path test (spawned by test_parallel.py).

Exercises the multi-host recipe end to end on CPU: `init_distributed()`
joins the cluster from JAX_COORDINATOR_ADDRESS/JAX_NUM_PROCESSES/
JAX_PROCESS_ID, `default_mesh()` spans both processes' devices, and a
sharded NTT roundtrip runs with its all_to_alls crossing the process
boundary (gloo playing DCN's role).  Exit code 0 = pass.
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bls12_381_jax.parallel import init_distributed  # noqa: E402

assert init_distributed() is True, "init_distributed did not activate"
assert jax.process_count() == 2

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from bls12_381_jax import constants  # noqa: E402
from bls12_381_jax.fields import FR  # noqa: E402
from bls12_381_jax.fields.limbs import ints_to_limbs  # noqa: E402
from bls12_381_jax.parallel import default_mesh, intt_sharded, ntt_sharded  # noqa: E402
from bls12_381_jax.parallel.mesh import SHARD_AXIS  # noqa: E402

mesh = default_mesh()
p = mesh.devices.size
assert p == 2, f"expected 2 global devices, got {p}"

n = 256
rng = np.random.default_rng(7)
vals = [int(v) % constants.FR_MODULUS
        for v in rng.integers(0, 2**63, size=n)]
host = np.asarray(ints_to_limbs([FR.to_mont(v) for v in vals], FR.num_limbs))

sharding = NamedSharding(mesh, P(None, SHARD_AXIS))
cols = n // p
lo = jax.process_index() * cols
x = jax.make_array_from_process_local_data(
    sharding, host[:, lo:lo + cols], global_shape=host.shape)

ev = ntt_sharded(x, mesh, transposed_out=True)
back = intt_sharded(ev, mesh, transposed_in=True)

for s in back.addressable_shards:
    want = host[:, s.index[1]]
    np.testing.assert_array_equal(np.asarray(s.data), want)

print(f"proc {jax.process_index()}: DCN-path sharded NTT roundtrip OK")
