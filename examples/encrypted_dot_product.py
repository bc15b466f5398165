"""Encrypted dot product — the classic batching + rotation workload.

Packs two integer vectors into ciphertext slots, multiplies slotwise
(one EvalMult), then folds the row sum with log2(n/2) rotate-and-adds
plus one column swap, so EVERY slot of the result holds the dot product.
Run it:

    python examples/encrypted_dot_product.py

This exercises the whole evaluator stack beyond the reference: the
batching encoder (prime t), EvalMult + relinearization, Galois
rotations, and the noise budget inspector.
"""

import numpy as np


def encrypted_dot_product(n: int = 2048, length: int = 256, seed: int = 0,
                          verbose: bool = True):
    import jax.numpy as jnp  # noqa: F401  (jax initialized lazily)
    from ntt_bfv.models import bfv, encoder
    from ntt_bfv.utils import primegen

    t = primegen.find_plain_modulus(n, 17)
    params = primegen.make_bfv_params(n, 45, 3, t=t)
    enc = encoder.BatchEncoder(params)
    ctx = bfv.BFVContext.build(params)

    rng = np.random.default_rng(seed)
    bound = int((t / length) ** 0.5)         # sum of products stays < t
    x = rng.integers(0, bound, length, dtype=np.uint64)
    y = rng.integers(0, bound, length, dtype=np.uint64)
    expected = int(np.dot(x.astype(object), y.astype(object))) % t

    vx = np.zeros(n, dtype=np.uint64)
    vy = np.zeros(n, dtype=np.uint64)
    vx[:length] = x
    vy[:length] = y

    sk, pk = ctx.keygen()
    rlk = ctx.relin_keygen(sk)
    steps = [1 << i for i in range((n // 2).bit_length() - 1)]
    elts = [encoder.rotation_element(n, s) for s in steps]
    elts.append(encoder.column_element(n))
    gks = ctx.galois_keygen(sk, elts)

    ct = ctx.mul(ctx.encrypt(pk, enc.encode(vx), nonce=1),
                 ctx.encrypt(pk, enc.encode(vy), nonce=2), rlk=rlk)
    for s in steps:                           # fold each row onto itself
        ct = ctx.add(ct, ctx.rotate_rows(ct, s, gks))
    ct = ctx.add(ct, ctx.rotate_columns(ct, gks))

    result = int(np.asarray(enc.decode(ctx.decrypt(sk, ct)))[0])
    budget = ctx.noise_budget(sk, ct)
    if verbose:
        print(f"[dot] n={n} t={t} length={length} "
              f"rotations={len(steps) + 1}")
        print(f"[dot] encrypted result: {result}  expected: {expected}  "
              f"match: {result == expected}")
        print(f"[dot] remaining noise budget: {budget} bits")
    return result, expected, budget


if __name__ == "__main__":
    result, expected, budget = encrypted_dot_product()
    raise SystemExit(0 if result == expected and budget > 0 else 1)
