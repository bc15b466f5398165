"""Benchmark / tracing harness.

The reference instruments each BFV phase with cudaEvent elapsed-time pairs
(demo.cu:18-20,275-296) and relied on nvprof externally.  The
equivalents here:

* `time_chained*` — per-application latency of a jitted function with
  host dispatch overhead removed: chain `inner` iterations inside one jit
  via lax.fori_loop and take the SLOPE between two inner counts (bench.py
  methodology).
* `trace` — a jax.profiler context writing an XPlane trace for offline
  roofline inspection (the nvprof analog).
"""

from __future__ import annotations

import contextlib
import time

import jax
import jax.numpy as jnp


def time_chained(make_step, x, inner_lo: int = 4, inner_hi: int = 16,
                 reps: int = 3) -> float:
    """Seconds per application of `fn`, dispatch overhead removed.

    `make_step(inner)` must return a jitted function chaining `inner`
    applications of the target onto its argument; latency is the slope
    ((t_hi - t_lo) / (inner_hi - inner_lo)) averaged over `reps`.
    """
    def timed(step):
        out = step(x)
        jax.block_until_ready(out)                       # compile + warm
        t0 = time.perf_counter()
        for _ in range(reps):
            out = step(x)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps

    t_lo = timed(make_step(inner_lo))
    t_hi = timed(make_step(inner_hi))
    return max((t_hi - t_lo) / (inner_hi - inner_lo), 0.0)


def time_chained_dynamic(step, x, *extra, inner_lo: int = 4,
                         inner_hi: int = 16, reps: int = 3,
                         epochs: int = 3) -> float:
    """Like time_chained, but `step(x, inner, *extra)` takes the chain
    length as a TRACED scalar (lax.fori_loop with a dynamic trip count),
    so ONE compilation covers both inner counts (the dynamic bound costs
    nothing: fori_loop lowers to a while either way).  `extra` pytrees
    are threaded as runtime buffer arguments (loop-invariant bundles:
    keeps big tables OUT of the compiled module's constants).

    Returns the min-over-epochs slope (host noise is additive and
    positive, so min is the estimator)."""
    def timed(k):
        out = step(x, k, *extra)
        jax.block_until_ready(out)                       # compile (first epoch) + warm
        t0 = time.perf_counter()
        for _ in range(reps):
            out = step(x, k, *extra)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps

    k_lo = jnp.asarray(inner_lo, jnp.int32)
    k_hi = jnp.asarray(inner_hi, jnp.int32)
    # min PER POINT over epochs (noise is additive-positive on each
    # timing; a per-epoch slope can go negative and poison a min-of-
    # slopes), then one slope from the two minima.
    t_lo = min(timed(k_lo) for _ in range(epochs))
    t_hi = min(timed(k_hi) for _ in range(epochs))
    return max((t_hi - t_lo) / (inner_hi - inner_lo), 0.0)


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (view with tensorboard / xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
