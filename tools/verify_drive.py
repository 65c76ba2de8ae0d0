"""Verify drive: end-to-end consumer flow on CPU (per .claude/skills/verify)."""
import os, sys, random
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from bls12_381_jax.compile_cache import enable_compile_cache
enable_compile_cache()

from bls12_381_jax import constants, oracle, runtime
from bls12_381_jax.curves import g1
from bls12_381_jax.fields import FR
from bls12_381_jax.fields.limbs import ints_to_limbs
from bls12_381_jax.runtime import dispatch

rng = random.Random(0xBEEF)
N = 64

def fr_mont(vals):
    return jnp.asarray(ints_to_limbs([FR.to_mont(v % constants.FR_MODULUS) for v in vals], FR.num_limbs))

ks = [rng.randrange(1, 1 << 48) for _ in range(N)]
G = oracle.g1_generator()
pts = [oracle.jac_to_affine(oracle.scalar_mul(k, G, oracle.FQ_OPS), oracle.FQ_OPS) for k in ks]
A = g1.affine_from_ints(pts)
vals = [rng.randrange(constants.FR_MODULUS) for _ in range(N)]
sc = fr_mont(vals)
want = oracle.jac_to_affine(oracle.msm(vals, pts, oracle.FQ_OPS), oracle.FQ_OPS)

# 1. accelerator facade: cached bases + async MSM
acc = runtime.global_accelerator()
bases = acc.g1.upload_bases(A, precompute_factor=2)
got = acc.g1.msm_with_bases_async(sc, bases).wait()
got = g1.jacobian_to_ints(jax.tree_util.tree_map(lambda c: c[..., None], got))[0]
assert got == want, f"accelerator MSM mismatch"
print("OK accelerator cached-bases async MSM == oracle", flush=True)

# 2. dispatch routing (host-int consumer surface): small -> CPU
res = dispatch.dispatch_msm(vals, pts)
assert res.route == dispatch.Route.CPU, f"expected CPU route, got {res.route}"
assert res.value == want, "dispatch MSM mismatch"
print(f"OK dispatch_msm route={res.route.value} == oracle", flush=True)

nt_vals = [rng.randrange(constants.FR_MODULUS) for _ in range(64)]
res = dispatch.dispatch_ntt(nt_vals)
back = dispatch.dispatch_ntt(res.value, inverse=True)
assert back.value == nt_vals, "dispatch NTT roundtrip failed"
print(f"OK dispatch_ntt roundtrip route={res.route.value}", flush=True)

# 3. NTT roundtrip via accelerator
n = 1 << 10
x_np = np.random.default_rng(1).integers(0, 1 << 16, size=(FR.num_limbs, n), dtype=np.uint64)
x_np[-1] &= 0x0FFF  # keep values < 2^252 < r (canonical field elements)
x = jnp.asarray(x_np).astype(jnp.uint32)
y = acc.ntt.forward(x)
xr = acc.ntt.inverse(y)
assert np.array_equal(np.asarray(x), np.asarray(xr)), "NTT roundtrip failed"
print("OK NTT forward/inverse roundtrip", flush=True)

# 4. graft entry hooks
import __graft_entry__ as ge
fn, args = ge.entry()
out = jax.jit(fn)(*args)
jax.block_until_ready(out)
print("OK entry() jit-compiles and runs", flush=True)
ge.dryrun_multichip(8)
print("OK dryrun_multichip(8)", flush=True)

# 5. clean-error probes
try:
    from bls12_381_jax.ntt import ntt
    ntt(x[:, :1000])
    print("FAIL: non-pow2 NTT did not raise")
except Exception as e:
    print(f"OK non-pow2 NTT raises: {type(e).__name__}", flush=True)

res = dispatch.dispatch_msm([0] * N, pts)
assert res.value is None, f"all-zero MSM should be identity, got {res.value}"
print("OK all-zero-scalar MSM returns identity", flush=True)

print("VERIFY DRIVE PASSED", flush=True)
