"""CLI driver + serialization tests (the reference's per-driver binaries,
SURVEY.md §4, as subcommands)."""

import numpy as np
import pytest

from ntt_bfv import cli, get_bfv_params
from ntt_bfv.utils import serialize


def test_ntt_test_driver(capsys):
    assert cli.main(["ntt-test", "--n", "2048"]) == 0
    assert "PASS" in capsys.readouterr().out


def test_decryption_test_driver(capsys):
    assert cli.main(["decryption-test"]) == 0
    assert "PASS" in capsys.readouterr().out


def test_keygen_test_driver(capsys):
    assert cli.main(["keygen-test", "--samples", str(1 << 18)]) == 0
    assert "PASS" in capsys.readouterr().out


def test_demo_driver(capsys):
    assert cli.main(["demo"]) == 0
    assert "PASS" in capsys.readouterr().out


def test_keys_encrypt_decrypt_flow(tmp_path, capsys):
    keys = str(tmp_path / "keys.npz")
    ct = str(tmp_path / "ct.npz")
    assert cli.main(["keys", "--out", keys]) == 0
    assert cli.main(["encrypt", "--keys", keys, "--out", ct]) == 0
    assert cli.main(["decrypt", "--keys", keys, "--ct", ct]) == 0
    out = capsys.readouterr().out
    # ramp message: plaintext head is 0..15
    assert "[decrypt] plaintext head: " + str(list(range(16))) in out


def test_serialize_rejects_mismatched_params(tmp_path):
    p3 = get_bfv_params("4k_3q")
    p4 = get_bfv_params("8k_4q")
    path = tmp_path / "keys.npz"
    sk = np.zeros((p3.r, p3.n), dtype=np.uint64)
    pk = np.zeros((2, p3.r, p3.n), dtype=np.uint64)
    serialize.save_keypair(path, p3, sk, pk)
    with pytest.raises(ValueError, match="parameter mismatch"):
        serialize.load_keypair(path, p4)
    with pytest.raises(ValueError, match="not a ciphertext"):
        serialize.load_ciphertext(path, p3)


def test_ntt_test_30bit_family():
    from ntt_bfv import cli
    assert cli.main(["ntt-test", "--n", "2048", "--family", "30bit"]) == 0


def test_serialize_eval_keys_roundtrip(tmp_path):
    p = get_bfv_params("4k_3q")
    want = (2, p.r - 1, p.r, p.n)
    rng = np.random.default_rng(1)
    rlk = rng.integers(0, 1 << 40, want, dtype=np.uint64)
    path = tmp_path / "rlk.npz"
    serialize.save_relin_keys(path, p, rlk)
    np.testing.assert_array_equal(serialize.load_relin_keys(path, p), rlk)

    gks = {3: rng.integers(0, 1 << 40, want, dtype=np.uint64),
           2 * p.n - 1: rng.integers(0, 1 << 40, want, dtype=np.uint64)}
    gpath = tmp_path / "gks.npz"
    serialize.save_galois_keys(gpath, p, gks)
    got = serialize.load_galois_keys(gpath, p)
    assert sorted(got) == sorted(gks)
    for g in gks:
        np.testing.assert_array_equal(got[g], gks[g])
    with pytest.raises(ValueError, match="not a relin-keys"):
        serialize.load_relin_keys(gpath, p)
    with pytest.raises(ValueError, match="parameter mismatch"):
        serialize.load_galois_keys(gpath, get_bfv_params("8k_4q"))
