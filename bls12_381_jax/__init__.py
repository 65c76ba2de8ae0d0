"""bls12_381_jax: BLS12-381 cryptographic primitives in JAX.

A brand-new JAX/XLA/Pallas implementation of the capabilities of the CUDA
reference backend riusricardo/midnight-bls12-381-cuda: Montgomery-form
Fr/Fq/Fq2 field arithmetic, G1/G2 group law, Pippenger MSM, Cooley-Tukey
NTT/iNTT (coset + batch), and element-wise vecops — designed around
whole-array XLA ops (limb-vectorized arithmetic, sort/scan bucket
accumulation, mesh sharding) rather than translated from CUDA.
"""

from . import constants
from .fields import FQ, FR

__version__ = "0.1.0"

__all__ = ["constants", "FQ", "FR", "__version__"]
