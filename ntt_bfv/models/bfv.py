"""BFV keygen / encryption / decryption pipelines (RNS form, SEAL 3.5
semantics).

Counterpart of the reference's scheme layer (bfv_keygen.cuh:95,
bfv_encryption.cuh:223, bfv_decryption.cuh:76).  Each operation is one
jitted XLA computation over (r, n) / (2, r, n) residue tensors; the
reference's stream/launch orchestration disappears into the XLA schedule.
Every transform goes through the one NTT entry (ops/ntt.py), which runs
the CUDA kernel on a GPU and the XLA stage loop elsewhere.

Domain-state conventions preserved from the reference (SURVEY.md §3.5):
the uniform pk1 ("a") is sampled directly in the NTT domain, the secret
key lives in the NTT domain forever, pk0 is returned in the NTT domain,
and ciphertexts are coefficient-domain with the last RNS modulus dropped
(we return clean (2, r-1, n) tensors instead of the reference's in-place
padding layout, bfv_encryption.cuh:216-222).

Randomness: the Salsa20 keystream with the reference's fixed key/nonce and
byte-consumption layout (ops/salsa20.py, ops/sampling.py), so keygen and
encryption are deterministic functions of the parameter set, as in the
reference's `generate_random_default`.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import params as params_mod
from ..ops import behz, modmath, ntt, poly, sampling
from ..utils import hostmath as hm

U64 = jnp.uint64


def _as_array(name: str, x):
    """jnp.asarray with the same actionable TypeError as check_residues
    (for call sites that must inspect the shape before knowing the full
    expected one, e.g. decrypt's variable component count)."""
    try:
        return jnp.asarray(x)
    except (TypeError, ValueError) as e:
        raise TypeError(f"{name}: expected an array, got "
                        f"{type(x).__name__} ({e})") from None


def check_residues(name: str, x, shape: tuple, hint: str = ""):
    """Validate a residue-tensor argument at the public API boundary:
    exact shape and an integer dtype, cast to the canonical u64.  Raises
    immediately with an actionable message instead of failing deep inside
    kernel reshapes (the reference has no such layer; its raw device
    pointers simply corrupt)."""
    try:
        x = jnp.asarray(x)
    except (TypeError, ValueError) as e:
        raise TypeError(f"{name}: expected an array, got "
                        f"{type(x).__name__} ({e})") from None
    if not jnp.issubdtype(x.dtype, jnp.integer):
        raise TypeError(f"{name}: expected an integer array (canonically "
                        f"uint64), got dtype {x.dtype}")
    if x.shape != shape:
        msg = f"{name}: expected shape {shape}, got {x.shape}"
        if hint:
            msg += f" — {hint}"
        raise ValueError(msg)
    return x.astype(U64)


def _inv_mul(x, y, tables, ms):
    """INTT(x (.) y): every dyadic product in the pipelines feeds an
    inverse transform (SURVEY.md §3)."""
    return ntt.ntt_inverse(ntt.dyadic_mul(x, y, ms), tables, ms)


@dataclasses.dataclass(frozen=True)
class BFVContext:
    """Device-resident constants for one parameter set, plus jitted ops.

    Build once per (n, r) — the analog of demo.cu's host precompute +
    cudaMemcpyToSymbol setup (demo.cu:62-272).
    """

    params: params_mod.BFVParams
    ms_full: modmath.ModulusSet       # all r moduli
    ms_drop: modmath.ModulusSet       # first r-1 moduli
    ms_last: modmath.ModulusSet       # the dropped modulus only
    tables_full: ntt.NTTTables        # (r, n)
    tables_drop: ntt.NTTTables        # (r-1, n)
    dr_consts: poly.DivideRoundConsts
    msg_consts: poly.MessageConsts
    dec_consts: poly.DecryptConsts
    uniform_spec: str = "int"          # "int" | "fp64" (reference-exact)
    # lazily-built EvalMult state (aux-base consts + Bsk NTT tables);
    # a mutable cache on a frozen context, excluded from eq/hash
    _mult_cache: dict = dataclasses.field(default_factory=dict,
                                          compare=False, repr=False)

    @staticmethod
    def build(params: params_mod.BFVParams,
              uniform_spec: str = "int") -> "BFVContext":
        """uniform_spec="fp64" makes keygen's uniform draw follow the
        reference's exact double-precision semantics (bfv_keygen.cuh:33-45,
        emulated bit-for-bit in integer arithmetic — ops/sampling.py
        uniform_ref).  The default "int" spec is the documented
        integer-exact deviation.

        The NTT implementation follows the platform the tables are placed
        on (ntt.NTTTables.build): the CUDA kernel on a GPU, the XLA stage
        loop elsewhere; results are bit-identical either way."""
        if params.t % 2 == 0 and params.t & (params.t - 1):
            raise ValueError(
                f"t={params.t} is neither a power of two (reference "
                f"semantics) nor odd (batching-prime semantics); no "
                f"decrypt path supports it")
        if uniform_spec not in ("int", "fp64"):
            raise ValueError(f"unknown uniform_spec {uniform_spec!r}")
        return BFVContext(
            uniform_spec=uniform_spec,
            params=params,
            ms_full=modmath.modulus_set(params),
            ms_drop=modmath.modulus_set(params, params.r - 1),
            ms_last=modmath.ModulusSet.from_moduli([params.q[-1]]),
            tables_full=ntt.tables_for(params),
            tables_drop=ntt.tables_for(params, params.r - 1),
            dr_consts=poly.DivideRoundConsts.build(params),
            msg_consts=poly.MessageConsts.build(params),
            dec_consts=poly.DecryptConsts.build(params),
        )

    @property
    def ntt_kernel(self) -> bool:
        """Whether this context's transforms run the CUDA kernel."""
        return self.tables_full.kernel

    def with_ntt(self, kernel: bool) -> "BFVContext":
        """This context with the NTT implementation pinned: kernel=False
        runs the XLA stage loop even on a GPU (GSPMD meshes, whose
        partitioner cannot split a custom call, and kernel-vs-XLA
        measurements).  Same results either way."""
        if kernel == self.ntt_kernel:
            return self
        return dataclasses.replace(
            self,
            tables_full=dataclasses.replace(self.tables_full, kernel=kernel),
            tables_drop=dataclasses.replace(self.tables_drop, kernel=kernel),
            _mult_cache={})

    # -- public API ---------------------------------------------------------

    def keygen(self, nonce=0):
        """-> (sk (r, n), pk (2, r, n)), both NTT-domain.

        `nonce` (int or traced u64) selects the Salsa20 nonce; 0 is the
        reference's deterministic default.  Keygen nonces live in the
        bit-63-clear half of the nonce space (sampling.keygen_nonce) —
        structurally disjoint from every nonzero encryption nonce.
        Nonces must be < 2**63 (bit 63 is the domain-separation bit)."""
        sampling.check_user_nonce(nonce)
        return _keygen_jit(jnp.asarray(nonce, U64), self.ms_full,
                           self.tables_full, self.params.n, self.params.r,
                           self.uniform_spec)

    def encrypt(self, pk, m_poly, nonce=0):
        """pk (2, r, n) NTT-domain, m_poly (n,) in [0, t) ->
        ciphertext (2, r-1, n), coefficient domain.

        Pass a distinct `nonce` per message for fresh (u, e0, e1) draws;
        nonce 0 reproduces the reference's fixed-randomness pipeline.
        Nonzero encryption nonces are mapped into the bit-63-set half of
        the nonce space (sampling.encrypt_nonce), so they can never
        collide with a keygen stream; nonce 0 passes through for
        reference byte-compatibility (its keygen and encryption share
        the nonce-0 stream BY DESIGN — never use a nonce-0 pair for real
        data; see ops/sampling.py).  Nonces must be < 2**63 (bit 63 is
        the domain-separation bit)."""
        sampling.check_user_nonce(nonce)
        p = self.params
        pk = check_residues("pk", pk, (2, p.r, p.n),
                            "keygen returns the NTT-domain (2, r, n) pk")
        m_poly = check_residues("m_poly", m_poly, (p.n,),
                                f"one plaintext value in [0, t) per "
                                f"coefficient, n={p.n}")
        return _encrypt_jit(jnp.asarray(nonce, U64), pk, m_poly,
                            self.ms_full, self.ms_drop, self.ms_last,
                            self.tables_full, self.dr_consts, self.msg_consts,
                            self.params.n, self.params.r)

    def encrypt_batch(self, pk, m_batch, nonces):
        """Throughput-mode encryption: J messages per transform batch.

        pk (2, r, n) NTT-domain, m_batch (J, n) in [0, t), nonces (J,)
        distinct per-message nonces -> (J, 2, r-1, n) ciphertexts.  The
        draws and every transform run over all J messages at once (the
        V100's Table 7 numbers are internally 18-36-transform batches).
        Bit-identical to encrypt() per message."""
        p = self.params
        pk = check_residues("pk", pk, (2, p.r, p.n),
                            "keygen returns the NTT-domain (2, r, n) pk")
        m_batch = jnp.asarray(m_batch)
        if m_batch.ndim != 2:
            raise ValueError(f"m_batch: expected (J, n), got {m_batch.shape}")
        J = m_batch.shape[0]
        m_batch = check_residues("m_batch", m_batch, (J, p.n))
        sampling.check_user_nonce(nonces)
        nonces = jnp.asarray(nonces, U64)
        if nonces.shape != (J,):
            raise ValueError(f"nonces: expected shape ({J},), got "
                             f"{nonces.shape}")
        return _encrypt_batch_jit(nonces, pk, m_batch, self.ms_full,
                                  self.ms_drop, self.ms_last,
                                  self.tables_full, self.dr_consts,
                                  self.msg_consts, p.n, p.r)

    def decrypt(self, sk, ct):
        """sk (r, n) NTT-domain (first r-1 residues used; (r-1, n) also
        accepted), ct (L, r-1, n) -> plaintext (n,) in [0, t).

        L = 2 for fresh/relinearized ciphertexts; L >= 3 decrypts
        un-relinearized EvalMult outputs directly (c0 + c1*s + ... +
        c_{L-1}*s^{L-1}, the standard BFV extended-ciphertext form)."""
        p = self.params
        sk = self._sk_drop(sk)
        ct = _as_array("ct", ct)
        if ct.ndim != 3 or ct.shape[0] < 2:
            raise ValueError(f"ct: expected shape (L>=2, r-1, n), got "
                             f"{ct.shape}")
        L = ct.shape[0]
        ct = check_residues("ct", ct, (L, p.r - 1, p.n),
                            "encrypt returns (2, r-1, n), mul() (3, r-1, n)"
                            " — the last RNS modulus is dropped")
        return _decrypt_jit(sk, ct, self.ms_drop, self.tables_drop,
                            self.dec_consts)

    def decrypt_batch(self, sk, cts):
        """Throughput-mode decryption: cts (J, 2, r-1, n) -> (J, n), one
        transform batch over all J messages; bit-identical to decrypt()
        per message."""
        p = self.params
        sk = self._sk_drop(sk)
        cts = jnp.asarray(cts)
        if cts.ndim != 4:
            raise ValueError(f"cts: expected (J, 2, r-1, n), got {cts.shape}")
        J = cts.shape[0]
        cts = check_residues("cts", cts, (J, 2, p.r - 1, p.n))
        return _decrypt_jit(sk, cts, self.ms_drop, self.tables_drop,
                            self.dec_consts)

    def add(self, ct_a, ct_b):
        """Homomorphic addition: decrypt(add(E(m1), E(m2))) == (m1 + m2) mod t.

        BFV ciphertexts are linear in the message — component-wise
        residue addition is the scheme's EvalAdd (beyond the reference,
        which stops at encrypt/decrypt; the noise of the sum is the sum
        of the operands' noises, so fresh encryptions are far inside the
        decryption budget).  Accepts (2, r-1, n) ciphertexts or
        (J, 2, r-1, n) batches (shapes must match)."""
        a, b = self._ct_pair("add", ct_a, ct_b)
        return _ct_add_jit(a, b, self.ms_drop)

    def sub(self, ct_a, ct_b):
        """Homomorphic subtraction: decrypts to (m1 - m2) mod t.
        Same shape/noise contract as add()."""
        a, b = self._ct_pair("sub", ct_a, ct_b)
        return _ct_sub_jit(a, b, self.ms_drop)

    def add_plain(self, ct, m_poly):
        """Ciphertext + plaintext: decrypts to (m_ct + m) mod t.

        Reuses encryption's Delta-scaling (poly.add_message — the
        reference's weird_m_stuff, bfv_encryption.cuh:193-213) on c0;
        c1 is unchanged, so no noise is added at all."""
        p = self.params
        ct = check_residues("ct", ct, (2, p.r - 1, p.n),
                            "encrypt returns (2, r-1, n)")
        m_poly = check_residues("m_poly", m_poly, (p.n,),
                                f"one plaintext value in [0, t) per "
                                f"coefficient, n={p.n}")
        return _add_plain_jit(ct, m_poly, self.msg_consts)

    def negate(self, ct):
        """Homomorphic negation: decrypts to (-m) mod t.  Component-wise
        modular negate (the reference's poly_negate semantics,
        poly_arithmetic.cuh:332-343, with canonical 0 -> 0).  Accepts
        (2, r-1, n) or (J, 2, r-1, n)."""
        p = self.params
        ct = _as_array("ct", ct)
        base = (2, p.r - 1, p.n)
        if ct.shape[-3:] != base or ct.ndim not in (3, 4):
            raise ValueError(f"ct: expected (2, r-1, n) or (J, 2, r-1, n),"
                             f" got {ct.shape}")
        ct = check_residues("ct", ct, ct.shape)
        return _ct_negate_jit(ct, self.ms_drop)

    def sub_plain(self, ct, m_poly):
        """Ciphertext - plaintext: decrypts to (m_ct - m) mod t.  The
        exact inverse of add_plain (same Delta-scaled embedding,
        subtracted from c0; no noise added)."""
        p = self.params
        ct = check_residues("ct", ct, (2, p.r - 1, p.n),
                            "encrypt returns (2, r-1, n)")
        m_poly = check_residues("m_poly", m_poly, (p.n,),
                                f"one plaintext value in [0, t) per "
                                f"coefficient, n={p.n}")
        return _sub_plain_jit(ct, m_poly, self.msg_consts)

    def mul_plain(self, ct, m_poly):
        """Ciphertext * plaintext in R_t = Z_t[x]/(x^n + 1): decrypts to
        the negacyclic product (m_ct * m) mod t.

        Both components are multiplied by m in the NTT domain
        (INTT(NTT(c_i) . NTT(m)) per kept residue).  Noise scales with
        the plaintext's size; monomials and small constants are
        noise-free multipliers, dense random plaintexts can exhaust a
        fresh ciphertext's budget."""
        p = self.params
        ct = check_residues("ct", ct, (2, p.r - 1, p.n),
                            "encrypt returns (2, r-1, n)")
        m_poly = check_residues("m_poly", m_poly, (p.n,),
                                f"one plaintext value in [0, t) per "
                                f"coefficient, n={p.n}")
        return _mul_plain_jit(ct, m_poly, self.ms_drop, self.tables_drop)

    def mul(self, ct_a, ct_b, rlk=None):
        """Homomorphic ciphertext multiplication (BEHZ RNS EvalMult):
        decrypts to the negacyclic product (m1 * m2) mod t.

        The reference stops at encrypt/decrypt; this is the full RNS
        multiplication pipeline (Bajard-Eynard-Hasan-Zucca 2016, the
        SEAL 3.5 BFV evaluator semantics) built on the same fast
        base-conversion primitive as decryption
        (poly_arithmetic.cuh:217-251): extend both ciphertexts to the
        auxiliary base Bsk (ops/behz.py), tensor-product in NTT form
        over q AND Bsk, scale by t/q (fast_floor), and convert back
        (Shenoy-Kumaresan).

        Accepts (2, r-1, n) ciphertexts or (J, 2, r-1, n) batches.
        Returns the 3-component (..., 3, r-1, n) ciphertext, or a
        relinearized (..., 2, r-1, n) one when `rlk` (relin_keygen) is
        given.  decrypt() accepts both forms."""
        a, b = self._ct_pair("mul", ct_a, ct_b)
        st = self._mult_setup()
        ct3 = _mult_jit(a, b, st.mc, self.tables_drop, st.tables_bsk,
                        self.ms_drop)
        if rlk is None:
            return ct3
        return self.relinearize(ct3, rlk)

    def square(self, ct, rlk=None):
        """Homomorphic squaring: mul(ct, ct) at ~half the transform cost
        (one operand's forwards over q and Bsk serve both sides, and the
        cross term is 2*a0*a1).  Bit-identical to mul(ct, ct)."""
        a, _ = self._ct_pair("square", ct, ct)
        st = self._mult_setup()
        ct3 = _square_jit(a, st.mc, self.tables_drop, st.tables_bsk,
                          self.ms_drop)
        if rlk is None:
            return ct3
        return self.relinearize(ct3, rlk)

    def op_programs(self):
        """(kg_fn, enc_fn, dec_fn, enc_batch_fn, dec_batch_fn, bundles):
        the scheme ops as pure functions of their array arguments, for
        embedding inside an OUTER jit (e.g. a benchmark's chained
        fori_loop).  The constant bundles travel as runtime buffers
        instead of being frozen into the compiled module: a 32k module
        with its twiddle tables inlined carries tens of MB of literals,
        which costs compile time and host memory on every compilation.

        kg_fn(nonce_u64, bz) == keygen(nonce); enc_fn(nonce_u64, pk, m,
        bz) == encrypt(pk, m, nonce); dec_fn(sk, ct, bz) ==
        decrypt(sk, ct) for a full (r, n) or dropped (r-1, n) sk;
        *_batch_fn mirror encrypt_batch/decrypt_batch.  No argument
        validation — callers hold the validated arrays."""
        p = self.params
        us = self.uniform_spec
        bundles = dict(
            msf=self.ms_full, msd=self.ms_drop, msl=self.ms_last,
            tf=self.tables_full, td=self.tables_drop,
            dr=self.dr_consts, mg=self.msg_consts, dc=self.dec_consts)

        def kg_fn(nonce, bz):
            return _keygen_jit(nonce, bz["msf"], bz["tf"], p.n, p.r, us)

        def enc_fn(nonce, pk, m_poly, bz):
            return _encrypt_jit(nonce, pk, m_poly, bz["msf"], bz["msd"],
                                bz["msl"], bz["tf"], bz["dr"], bz["mg"],
                                p.n, p.r)

        def dec_fn(sk, ct, bz):
            return _decrypt_jit(sk[: p.r - 1], ct, bz["msd"], bz["td"],
                                bz["dc"])

        def enc_batch_fn(nonces, pk, m_batch, bz):
            return _encrypt_batch_jit(nonces, pk, m_batch, bz["msf"],
                                      bz["msd"], bz["msl"], bz["tf"],
                                      bz["dr"], bz["mg"], p.n, p.r)

        return kg_fn, enc_fn, dec_fn, enc_batch_fn, dec_fn, bundles

    def mult_program(self):
        """(mul_fn, square_fn, bundles) for embedding EvalMult inside an
        OUTER jit without baking the table bundles in as module constants
        (the q-base AND Bsk twiddle tables: the largest literals of any
        op).  mul_fn(a, b, rlk, bundles) == mul(a, b, rlk=rlk)
        bit-for-bit, square_fn(a, rlk, bundles) == square(a, rlk=rlk)."""
        st = self._mult_setup()
        bundles = dict(
            mc=st.mc, tq=self.tables_drop, tb=st.tables_bsk,
            msd=self.ms_drop, msf=self.ms_full, msl=self.ms_last,
            tf=self.tables_full, dr=self.dr_consts)

        def finish(ct3, rlk, bz):
            if rlk is None:
                return ct3
            return _relinearize_jit(ct3, rlk, bz["msf"], bz["msd"],
                                    bz["msl"], bz["tf"], bz["dr"])

        def mul_fn(a, b, rlk, bz):
            ct3 = _mult_jit(a, b, bz["mc"], bz["tq"], bz["tb"], bz["msd"])
            return finish(ct3, rlk, bz)

        def square_fn(a, rlk, bz):
            ct3 = _square_jit(a, bz["mc"], bz["tq"], bz["tb"], bz["msd"])
            return finish(ct3, rlk, bz)

        return mul_fn, square_fn, bundles

    def relin_keygen(self, sk, nonce=0):
        """Generate relinearization keys for mul(): (2, r-1, r, n),
        NTT-domain.

        Special-modulus key switching: the dropped last RNS modulus
        q_last (already the scheme's encryption special modulus,
        bfv_encryption.cuh:111-178) doubles as the key-switching
        modulus P.  Key j encrypts P * q-tilde_j * s^2 over the full
        base q, so switching divides the digit noise by P
        (divide_and_round_q_last — the exact same kernel as
        encryption's modulus drop).

        Draws run under a dedicated Salsa20 key byte
        (sampling.RELIN_KEY_BYTE), independent of every keygen/encrypt
        stream at any nonce.  Nonces must be < 2**63."""
        sampling.check_user_nonce(nonce)
        p = self.params
        sk = check_residues("sk", sk, (p.r, p.n),
                            "keygen returns the NTT-domain (r, n) sk")
        return _relin_keygen_jit(jnp.asarray(nonce, U64), sk, self.ms_full,
                                 self.tables_full, self._p_mont_bank(),
                                 p.n, p.r)

    def relinearize(self, ct3, rlk):
        """(3, r-1, n) EvalMult output + relin keys -> (2, r-1, n).

        RNS-decomposes c2 into its residue digits, key-switches through
        rlk over the extended base (q, q_last), and divides by q_last
        (divide_and_round_q_last), folding c2*s^2 into (c0, c1) with
        only additive noise ~ k*n*B/1 (digit noise / P)."""
        p = self.params
        ct3 = _as_array("ct3", ct3)
        base = (3, p.r - 1, p.n)
        if ct3.shape[-3:] != base or ct3.ndim not in (3, 4):
            raise ValueError(f"ct3: expected (3, r-1, n) or (J, 3, r-1, n),"
                             f" got {ct3.shape}")
        ct3 = check_residues("ct3", ct3, ct3.shape)
        rlk = check_residues("rlk", rlk, (2, p.r - 1, p.r, p.n),
                             "relin_keygen returns (2, r-1, r, n)")
        return _relinearize_jit(ct3, rlk, self.ms_full, self.ms_drop,
                                self.ms_last, self.tables_full,
                                self.dr_consts)

    def galois_keygen(self, sk, elts, nonce=0):
        """Switching keys for the Galois automorphisms x -> x^g:
        {g: (2, r-1, r, n)} for each g in `elts` (odd, 0 < g < 2n).

        Beyond the reference (SEAL's galois_keys): enables homomorphic
        coefficient permutations via apply_galois().  Draws run under
        their own Salsa20 key byte (sampling.GALOIS_KEY_BYTE), with the
        stream region indexed by the ELEMENT VALUE — independent of
        keygen/encrypt/relin streams at any nonce, and safe to call
        repeatedly at one nonce with different element sets (a shared
        element reproduces its key; distinct elements never share
        randomness)."""
        sampling.check_user_nonce(nonce)
        p = self.params
        sk = check_residues("sk", sk, (p.r, p.n),
                            "keygen returns the NTT-domain (r, n) sk")
        elts = sorted({int(g) for g in elts})
        maps = [poly.galois_maps(p.n, g) for g in elts]  # validates each g
        perms = jnp.asarray(np.stack([m[0] for m in maps]))
        negs = jnp.asarray(np.stack([m[1] for m in maps]))
        keys = _galois_keygen_jit(jnp.asarray(nonce, U64), sk, perms, negs,
                                  self.ms_full, self.tables_full,
                                  self._p_mont_bank(), tuple(elts), p.n,
                                  p.r)
        return {g: keys[t] for t, g in enumerate(elts)}

    def apply_galois(self, ct, g, gk):
        """Homomorphic automorphism: decrypts to tau_g(m), i.e.
        out[j] = ±m[(j * g^-1 mod 2n) mod n] with the negacyclic sign,
        reduced mod t.  `gk` is galois_keygen(...)[g].  Accepts
        (2, r-1, n) ciphertexts or (J, 2, r-1, n) batches."""
        p = self.params
        ct = _as_array("ct", ct)
        base = (2, p.r - 1, p.n)
        if ct.shape[-3:] != base or ct.ndim not in (3, 4):
            raise ValueError(f"ct: expected (2, r-1, n) or (J, 2, r-1, n)"
                             f" = (..., {base}), got {ct.shape}")
        ct = check_residues("ct", ct, ct.shape)
        gk = check_residues("gk", gk, (2, p.r - 1, p.r, p.n),
                            "pass one key from galois_keygen()")
        perm, neg = poly.galois_maps(p.n, int(g))
        return _apply_galois_jit(ct, jnp.asarray(perm), jnp.asarray(neg),
                                 gk, self.ms_full, self.ms_drop,
                                 self.ms_last, self.tables_full,
                                 self.dr_consts)

    def next_context(self) -> "BFVContext":
        """The context one level down the modulus chain: same scheme over
        q[:-1], with q[r-2] taking the dropped-special role.  Cached.
        Decryption there uses the same sk (its first r-2 residue rows)."""
        nxt = self._mult_cache.get("next_ctx")
        if nxt is None:
            p = self.params
            if p.r < 3:
                raise ValueError("modulus chain exhausted: r must be >= 3 "
                                 "to drop another modulus")
            np_ = params_mod.BFVParams(
                name=f"{p.name}@L{p.r - 1}", n=p.n, q=p.q[:-1],
                psi=p.psi[:-1], t=p.t, gamma=p.gamma)
            nxt = BFVContext.build(np_, uniform_spec=self.uniform_spec)
            nxt = nxt.with_ntt(self.ntt_kernel)
            self._mult_cache["next_ctx"] = nxt
        return nxt

    def mod_switch_to_next(self, ct):
        """Switch a ciphertext one level down the modulus chain
        (SEAL's mod_switch_to_next): (L, r-1, n) -> (L, r-2, n), each
        component divided-and-rounded by the last kept modulus — the
        exact same kernel as encryption's modulus drop
        (bfv_encryption.cuh:111-178).  The invariant noise is nearly
        preserved while ciphertexts shrink by one residue row; decrypt
        and further eval ops run under next_context()."""
        p = self.params
        ct = _as_array("ct", ct)
        if ct.ndim != 3 or ct.shape[0] < 2:
            raise ValueError(f"ct: expected shape (L>=2, r-1, n), got "
                             f"{ct.shape}")
        L = ct.shape[0]
        ct = check_residues("ct", ct, (L, p.r - 1, p.n))
        nxt = self.next_context()
        return _mod_switch_jit(ct, nxt.dr_consts, nxt.ms_drop, nxt.ms_last)

    def noise_budget(self, sk, ct) -> int:
        """Invariant noise budget in bits (SEAL's
        invariant_noise_budget): floor(log2(q / (2*|w|))) where
        w = [t*(c0 + c1 s + ...)]_q centered — the number of further
        noise-doubling operations the ciphertext survives; 0 means
        decryption is no longer guaranteed.

        The residue computation runs on device (the decrypt pipeline's
        front without the rounding tail); the exact centered CRT
        reconstruction and the max-norm run host-side in Python ints —
        this is a diagnostic, not a hot-path op."""
        p = self.params
        sk = self._sk_drop(sk)
        ct = _as_array("ct", ct)
        if ct.ndim != 3 or ct.shape[0] < 2:
            raise ValueError(f"ct: expected shape (L>=2, r-1, n), got "
                             f"{ct.shape}")
        L = ct.shape[0]
        ct = check_residues("ct", ct, (L, p.r - 1, p.n))
        t_mont = self._mult_cache.get("t_mont_drop")
        if t_mont is None:
            t_mont = jnp.asarray([[hm.to_mont(p.t % qj, qj)]
                                  for qj in p.q[:-1]], dtype=U64)
            self._mult_cache["t_mont_drop"] = t_mont
        w = np.asarray(_noise_poly_jit(sk, ct, t_mont, self.ms_drop,
                                       self.tables_drop))
        qs = [int(q) for q in p.q[: p.r - 1]]
        q_prod = 1
        for q in qs:
            q_prod *= q
        lifts = [(q_prod // q) * pow((q_prod // q) % q, -1, q)
                 for q in qs]
        # plain CPython big-int loop: measured 0.26 s at n=32768, r=15 —
        # FASTER than a vectorized numpy u32-limb CRT (1.3 s; big-int
        # multiply-by-constant is already optimal here).  Hoist the one
        # per-iteration big division.
        q_half = q_prod // 2
        max_w = 0
        for i in range(p.n):
            x = 0
            for j in range(len(qs)):
                x += int(w[j, i]) * lifts[j]
            x %= q_prod
            if x > q_half:
                x = q_prod - x
            if x > max_w:
                max_w = x
        if max_w == 0:
            return q_prod.bit_length() - 1
        budget = q_prod // (2 * max_w)
        return max(0, budget.bit_length() - 1)

    def rotate_rows(self, ct, steps, gks):
        """Cyclic slot rotation of both batching rows by `steps`
        (SEAL rotate_rows) — meaningful with a prime batching t and the
        BatchEncoder (models/encoder.py).  `gks` is the dict from
        galois_keygen and must contain encoder.rotation_element(n,
        steps)."""
        from . import encoder as encoder_mod
        g = encoder_mod.rotation_element(self.params.n, steps)
        if g not in gks:
            raise KeyError(
                f"gks lacks the rotation element {g} for steps={steps}; "
                f"generate with galois_keygen(sk, "
                f"[rotation_element(n, {steps})])")
        return self.apply_galois(ct, g, gks[g])

    def rotate_columns(self, ct, gks):
        """Swap the two batching rows (SEAL rotate_columns; Galois
        element 2n-1)."""
        from . import encoder as encoder_mod
        g = encoder_mod.column_element(self.params.n)
        if g not in gks:
            raise KeyError(f"gks lacks the column element {g}; generate "
                           f"with galois_keygen(sk, [2*n - 1])")
        return self.apply_galois(ct, g, gks[g])

    def _p_mont_bank(self):
        """(r, 1) bank of P * R mod q_i (P = q_last); the last row is 0
        (P === 0 mod q_last) and is never selected by the key-switch
        diagonal mask — padded so it broadcasts against (r, n) rows."""
        pm = self._mult_cache.get("p_mont")
        if pm is None:
            p = self.params
            pm = jnp.asarray([[hm.to_mont(p.q[-1] % qj, qj)]
                              for qj in p.q[:-1]] + [[0]], dtype=U64)
            self._mult_cache["p_mont"] = pm
        return pm

    def _mult_setup(self) -> "_MultSetup":
        st = self._mult_cache.get("setup")
        if st is None:
            p = self.params
            aux = behz.AuxBase.build(p)
            st = _MultSetup(
                mc=behz.MultConsts.build(p, aux),
                tables_bsk=ntt.NTTTables.build(aux.bsk, aux.bsk_psi, p.n,
                                               kernel=self.ntt_kernel),
            )
            self._mult_cache["setup"] = st
        return st

    def _ct_pair(self, op, ct_a, ct_b):
        p = self.params
        ct_a, ct_b = jnp.asarray(ct_a), jnp.asarray(ct_b)
        if ct_a.shape != ct_b.shape:
            raise ValueError(f"{op}: ciphertext shapes differ "
                             f"({ct_a.shape} vs {ct_b.shape})")
        base = (2, p.r - 1, p.n)
        if ct_a.shape[-3:] != base or ct_a.ndim not in (3, 4):
            raise ValueError(f"{op}: expected (2, r-1, n) or (J, 2, r-1, n) "
                             f"= (..., {base}), got {ct_a.shape}")
        ct_a = check_residues(f"{op} lhs", ct_a, ct_a.shape)
        ct_b = check_residues(f"{op} rhs", ct_b, ct_b.shape)
        return ct_a, ct_b

    def _sk_drop(self, sk):
        p = self.params
        sk = jnp.asarray(sk)
        if sk.ndim == 2 and sk.shape[0] >= p.r:
            # extra rows are the same s under higher-level moduli — a
            # full-chain sk decrypts at every level (mod_switch_to_next)
            sk = sk[: p.r - 1]
        return check_residues("sk", sk, (p.r - 1, p.n),
                              "keygen returns the NTT-domain (r, n) sk")

    def roundtrip_check(self, m_poly):
        """demo.cu-style end-to-end: decrypt(encrypt(m)) (demo.cu:274-311)."""
        sk, pk = self.keygen()
        ct = self.encrypt(pk, m_poly)
        return self.decrypt(sk, ct)


# ---------------------------------------------------------------------------
# Jitted pipelines (static over (n, r); retraced per parameter set).
# ---------------------------------------------------------------------------

@jax.jit
def _ct_add_jit(a, b, ms):
    # Exact mod-q add (not the reference's lazy strict-`>` quirk): sums
    # that land exactly on q must reduce to 0 so outputs stay canonical
    # [0, q) ciphertexts accepted by decrypt()/add() again.
    s = a + b
    return s - ms.q * (s >= ms.q).astype(U64)


@jax.jit
def _ct_sub_jit(a, b, ms):
    return poly.poly_sub(a, b, ms)


@jax.jit
def _add_plain_jit(ct, m_poly, mc):
    return ct.at[0].set(poly.add_message(ct[0], m_poly, mc))


@jax.jit
def _ct_negate_jit(ct, ms):
    return modmath.negate_mod(ct, ms.q)


@jax.jit
def _sub_plain_jit(ct, m_poly, mc):
    return ct.at[..., 0, :, :].set(
        poly.sub_message(ct[..., 0, :, :], m_poly, mc))


@jax.jit
def _mul_plain_jit(ct, m_poly, ms, tables):
    # m's coefficients are < t < every q_i, so its residue rows are m
    # itself broadcast over the kept moduli.
    m_res = jnp.broadcast_to(m_poly[None, :], ct.shape[1:])
    fm = ntt.ntt_forward(m_res, tables, ms)
    return _inv_mul(ntt.ntt_forward(ct, tables, ms), fm, tables, ms)


@functools.partial(jax.jit, static_argnames=("n", "r", "uniform_spec"))
def _keygen_jit(nonce, ms, tables, n: int, r: int, uniform_spec: str = "int"):
    """keygen_rns (bfv_keygen.cuh:95-151)."""
    s, a, e = sampling.keygen_draws(n, r, ms, nonce=nonce,
                                    uniform_spec=uniform_spec)
    sk = ntt.ntt_forward(s, tables, ms)              # s kept in NTT domain
    pk0 = _inv_mul(a, sk, tables, ms)                # INTT(a (.) s-hat)
    pk0 = ntt.ntt_forward(poly.poly_add_negate(pk0, e, ms), tables, ms)
    return sk, jnp.stack([pk0, a])                   # NTT(-(a*s + e))


@functools.partial(jax.jit, static_argnames=("n", "r"))
def _encrypt_jit(nonce, pk, m_poly, ms_full, ms_drop, ms_last, tables,
                 dr_consts, msg_consts, n: int, r: int):
    """encryption_rns (bfv_encryption.cuh:223-290)."""
    u, e0, e1 = sampling.encrypt_draws(n, r, ms_full, nonce=nonce)
    return _encrypt_drawn(u, jnp.stack([e0, e1]), pk, m_poly, ms_full,
                          ms_drop, ms_last, tables, dr_consts, msg_consts)


@functools.partial(jax.jit, static_argnames=("n", "r"))
def _encrypt_batch_jit(nonces, pk, m_batch, ms_full, ms_drop, ms_last,
                       tables, dr_consts, msg_consts, n: int, r: int):
    """J-message encryption: the J per-nonce keystreams and the whole
    post-draw body run batched, so every transform batch covers all J
    messages."""
    u, e = sampling.encrypt_draws_batch(n, r, ms_full, nonces)
    return _encrypt_drawn(u, e, pk, m_batch, ms_full, ms_drop, ms_last,
                          tables, dr_consts, msg_consts)


def _encrypt_drawn(u, e, pk, m_poly, ms_full, ms_drop, ms_last, tables,
                   dr_consts, msg_consts):
    """The post-draw encryption body over leading batch dims: u (..., r,
    n), e (..., 2, r, n), m (..., n) -> (..., 2, r-1, n).

    The reference transforms both ciphertext halves (2r forwards,
    bfv_encryption.cuh:268) but they hold the SAME polynomial u — its
    in-place buffers force the duplicate.  Here NTT(u) is computed once
    (r forwards) and broadcast into the dyadic against both pk halves:
    identical values, 25% fewer transforms per encryption."""
    u_ntt = ntt.ntt_forward(u, tables, ms_full)
    c = _inv_mul(u_ntt[..., None, :, :], pk, tables, ms_full)
    c = poly.poly_add(c, e, ms_full)
    c = poly.divide_and_round_q_last(c, dr_consts, ms_drop, ms_last)
    c0 = poly.add_message(c[..., 0, :, :], m_poly[..., None, :], msg_consts)
    return jnp.stack([c0, c[..., 1, :, :]], axis=-3)


@dataclasses.dataclass(frozen=True)
class _MultSetup:
    """Lazily-built EvalMult state for one context (BFVContext._mult_setup):
    BEHZ constants and NTT tables over the auxiliary base."""
    mc: behz.MultConsts
    tables_bsk: ntt.NTTTables


@jax.jit
def _mult_jit(a, b, mc, tables_q, tables_bsk, ms_q):
    """BEHZ EvalMult core: (…, 2, k, n) x2 -> (…, 3, k, n).

    Tensor product over the combined base q ∪ Bsk in NTT form, then
    round(t/q * .) back into base q (behz.scale_and_round).  The base-q
    half multiplies the ORIGINAL residues (they are congruent mod q to
    the centered lifts Bsk sees — standard BEHZ)."""
    ab = behz.rns_to_bsk(a, mc)                      # (…, 2, k+1, n)
    bb = behz.rns_to_bsk(b, mc)
    # both operands' forwards in one transform batch per base
    fq = ntt.ntt_forward(jnp.stack([a, b], axis=-4), tables_q, ms_q)
    fb_ = ntt.ntt_forward(jnp.stack([ab, bb], axis=-4), tables_bsk,
                          mc.ms_bsk)

    def tensor(f, tables, ms):
        fa, fb = f[..., 0, :, :, :], f[..., 1, :, :, :]
        a0, a1 = fa[..., 0, :, :], fa[..., 1, :, :]
        b0, b1 = fb[..., 0, :, :], fb[..., 1, :, :]
        # c0 = INTT(a0 b0), c1 = INTT(a0 b1 + a1 b0), c2 = INTT(a1 b1):
        # one inverse batch
        mid = modmath.add_mod(ntt.dyadic_mul(a0, b1, ms),
                              ntt.dyadic_mul(a1, b0, ms), ms.q)
        prods = jnp.stack([ntt.dyadic_mul(a0, b0, ms), mid,
                           ntt.dyadic_mul(a1, b1, ms)], axis=-3)
        return ntt.ntt_inverse(prods, tables, ms)

    pq = tensor(fq, tables_q, ms_q)
    pb = tensor(fb_, tables_bsk, mc.ms_bsk)
    return behz.scale_and_round(pq, pb, mc)


@jax.jit
def _square_jit(a, mc, tables_q, tables_bsk, ms_q):
    """EvalSquare: _mult_jit with one operand — half the forwards, and
    the cross term computed once and doubled (bit-identical to
    _mult_jit(a, a, ...) since the dyadic product is exact and
    commutative)."""
    ab = behz.rns_to_bsk(a, mc)
    fa_q = ntt.ntt_forward(a, tables_q, ms_q)
    fa_b = ntt.ntt_forward(ab, tables_bsk, mc.ms_bsk)

    def tensor(fa, tables, ms):
        a0, a1 = fa[..., 0, :, :], fa[..., 1, :, :]
        t = ntt.dyadic_mul(a0, a1, ms)
        prods = jnp.stack([ntt.dyadic_mul(a0, a0, ms),
                           modmath.add_mod(t, t, ms.q),
                           ntt.dyadic_mul(a1, a1, ms)], axis=-3)
        return ntt.ntt_inverse(prods, tables, ms)

    pq = tensor(fa_q, tables_q, ms_q)
    pb = tensor(fa_b, tables_bsk, mc.ms_bsk)
    return behz.scale_and_round(pq, pb, mc)


def _kskeygen_body(a, e, sk, target_hat, ms, tables, p_mont):
    """k switching keys encrypting `target_hat` (an NTT-domain secret
    polynomial — s^2 for relin, tau_g(s) for Galois) under sk:
    ksk0_j = NTT(-(a_j s + e_j)) + P*target at modulus row j
    (P = q_last; [P*q-tilde_j]_{q_i} = P*delta_ij, [.]_{q_last} = 0).
    Each key is exactly keygen's pk0 pipeline (bfv_keygen.cuh:120-145)
    plus one scalar multiply-add; all k keys' transforms run as two
    k-batched transform calls."""
    k, r = a.shape[0], a.shape[1]
    x = _inv_mul(a, sk, tables, ms)                  # (k, r, n)
    x = ntt.ntt_forward(poly.poly_add_negate(x, e, ms), tables, ms)
    term = modmath.mont_mul(target_hat, p_mont, ms.q, ms.qinv_neg)
    eye = (jnp.arange(k)[:, None] == jnp.arange(r)[None, :])[..., None]
    x = jnp.where(eye, modmath.add_mod(x, term, ms.q), x)
    return jnp.stack([x, a])                         # (2, k, r, n)


@functools.partial(jax.jit, static_argnames=("n", "r"))
def _relin_keygen_jit(nonce, sk, ms, tables, p_mont, n: int, r: int):
    """Relinearization keys: the switching-key body with target s^2."""
    a, e = sampling.relin_draws(n, r, r - 1, ms, nonce=nonce)
    hs2 = ntt.dyadic_mul(sk, sk, ms)                 # NTT-domain s^2
    return _kskeygen_body(a, e, sk, hs2, ms, tables, p_mont)


@functools.partial(jax.jit, static_argnames=("elts", "n", "r"))
def _galois_keygen_jit(nonce, sk, perms, negs, ms, tables, p_mont,
                       elts: tuple, n: int, r: int):
    """Galois switching keys for E elements: target tau_g(s), computed by
    INTT(sk) -> coefficient-domain automorphism -> forward NTT (one INTT
    shared by all elements)."""
    a, e = sampling.galois_draws(n, r, r - 1, elts, ms, nonce=nonce)
    s_coef = ntt.ntt_inverse(sk, tables, ms)
    out = []
    for t in range(perms.shape[0]):
        ts = poly.galois_apply(s_coef, perms[t], negs[t], ms)
        ts_hat = ntt.ntt_forward(ts, tables, ms)
        out.append(_kskeygen_body(a[t], e[t], sk, ts_hat, ms, tables,
                                  p_mont))
    return jnp.stack(out)                            # (E, 2, k, r, n)


@jax.jit
def _apply_galois_jit(ct, perm, neg, gk, ms_full, ms_drop, ms_last, tables,
                      dr_consts):
    """tau_g on both ciphertext components (one gather + conditional
    negate), then key-switch the permuted c1 from tau_g(s) back to s."""
    tc = poly.galois_apply(ct, perm, neg, ms_drop)
    cc = _keyswitch(tc[..., 1, :, :], gk, ms_full, ms_drop, ms_last, tables,
                    dr_consts)
    c0 = modmath.add_mod(tc[..., 0, :, :], cc[..., 0, :, :], ms_drop.q)
    return jnp.stack([c0, cc[..., 1, :, :]], axis=-3)


def _keyswitch(c2, rlk, ms_full, ms_drop, ms_last, tables, dr_consts):
    """c2 (…, k, n) -> (…, 2, k, n) via the rlk digits.

    The RNS digits d_j = [c2]_{q_j} are lifted to the full base by plain
    u64 reduction (modmath.mod_u64 — each digit is one 60-bit residue),
    transformed, multiplied into both key rows, and the accumulated
    (…, 2, r, n) pair divided by q_last with encryption's own
    divide_and_round_q_last."""
    k = c2.shape[-2]
    d = modmath.mod_u64(c2[..., :, None, :], ms_full.q, ms_full.nu)
    dhat = ntt.ntt_forward(d, tables, ms_full)       # (…, k, r, n)
    acc0 = acc1 = None
    for j in range(k):
        dj = dhat[..., j, :, :]
        t0 = ntt.dyadic_mul(dj, rlk[0, j], ms_full)
        t1 = ntt.dyadic_mul(dj, rlk[1, j], ms_full)
        acc0 = t0 if acc0 is None else modmath.add_mod(acc0, t0, ms_full.q)
        acc1 = t1 if acc1 is None else modmath.add_mod(acc1, t1, ms_full.q)
    cc = ntt.ntt_inverse(jnp.stack([acc0, acc1], axis=-3), tables, ms_full)
    return poly.divide_and_round_q_last(cc, dr_consts, ms_drop, ms_last)


@jax.jit
def _relinearize_jit(ct3, rlk, ms_full, ms_drop, ms_last, tables, dr_consts):
    cc = _keyswitch(ct3[..., 2, :, :], rlk, ms_full, ms_drop, ms_last,
                    tables, dr_consts)
    return _ct_add_jit(ct3[..., :2, :, :], cc, ms_drop)


def _spower_front(sk_drop, ct, ms, tables):
    """x = INTT(sum_{i>=1} NTT(c_i) * s^i) — the decrypt front shared by
    decryption and the noise inspector.  The s-powers and the
    accumulation happen in the NTT domain, so one INTT serves all
    components.  Leading batch dims before the component axis are
    allowed."""
    L = ct.shape[-3]
    f = ntt.ntt_forward(ct[..., 1:, :, :], tables, ms)
    acc = None
    pw = sk_drop
    for i in range(1, L):
        t = ntt.dyadic_mul(f[..., i - 1, :, :], pw, ms)
        acc = t if acc is None else modmath.add_mod(acc, t, ms.q)
        if i + 1 < L:
            pw = ntt.dyadic_mul(pw, sk_drop, ms)
    return ntt.ntt_inverse(acc, tables, ms)


@jax.jit
def _decrypt_jit(sk_drop, ct, ms, tables, dec_consts):
    """decryption_rns (bfv_decryption.cuh:76-138), for (…, L, r-1, n)
    ciphertexts: c0 + sum_{i>=1} c_i * s^i, then the BEHZ rounding tail.
    L = 2 is the reference's pipeline; L >= 3 decrypts un-relinearized
    EvalMult outputs (the standard extended-ciphertext form)."""
    x = _spower_front(sk_drop, ct, ms, tables)
    x = poly.poly_add(x, ct[..., 0, :, :], ms)       # poly_add_xq_d `>` quirk
    x = poly.poly_mul_scalar_mont(x, dec_consts.prod_t_gamma_mont, ms)
    x = poly.poly_mul_scalar_mont(x, dec_consts.inv_punctured_mont, ms)
    return poly.fast_convert_and_round(x, dec_consts)


@jax.jit
def _mod_switch_jit(ct, dr_consts, ms_drop, ms_last):
    return poly.divide_and_round_q_last(ct, dr_consts, ms_drop, ms_last)


@jax.jit
def _noise_poly_jit(sk_drop, ct, t_mont, ms, tables):
    """w = [t * (c0 + sum_i c_i s^i)]_q residues — the decrypt front
    without the BEHZ rounding tail (noise_budget's device half)."""
    x = _spower_front(sk_drop, ct, ms, tables)
    x = poly.poly_add(x, ct[0], ms)
    return modmath.mont_mul(x, t_mont, ms.q, ms.qinv_neg)
