"""ntt_bfv: NTT + RNS BFV primitive library in JAX.

A from-scratch re-design of the capabilities of ozgunozerk/NTT-Cuda:
60-bit modular arithmetic on u64 arrays (Montgomery form), negacyclic
NTTs (a CUDA kernel for NVIDIA Hopper, an XLA stage loop elsewhere),
Salsa20 samplers, full BFV keygen/encrypt/decrypt plus an evaluator, and
sharding over device meshes.

The library requires 64-bit integer support; importing enables
``jax_enable_x64`` process-wide.
"""

import sys as _sys

import jax as _jax

_jax.config.update("jax_enable_x64", True)

# The largest BFV pipelines (unrolled stage loops over many transforms)
# trace to jaxprs deep enough to approach CPython's default 1000-frame
# recursion limit inside jax's tracing recursion.  Raise it once,
# process-wide, to a depth that covers the largest parameter set.
if _sys.getrecursionlimit() < 20000:
    _sys.setrecursionlimit(20000)

from . import params  # noqa: E402,F401
from .params import BFVParams, get_bfv_params, get_params  # noqa: E402,F401

__version__ = "0.1.0"
