"""chip_smoke.py's helpers and its refusal to run without a GPU."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from ntt_bfv import cuda
from ntt_bfv.models import bfv
from ntt_bfv.params import get_bfv_params

SCRIPT = Path(__file__).resolve().parent.parent / "chip_smoke.py"


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_exits_nonzero_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    res = subprocess.run([sys.executable, str(SCRIPT)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode != 0
    assert "no GPU found" in res.stderr
    assert '"ok"' not in res.stdout


def test_cache_dir_from_environment(smoke):
    assert smoke.cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/cache"}) == (
        "/x/cache", False)


def test_cache_dir_default_is_fixed_in_checkout(smoke):
    d, set_here = smoke.cache_dir({})
    assert set_here and d == str(SCRIPT.parent / ".jax_cache")
    assert smoke.cache_dir({}) == (d, True)          # no pid, no time
    assert ".jax_cache/" in (SCRIPT.parent / ".gitignore").read_text()


def test_platform_selects_ntt_on_cpu():
    ctx = bfv.BFVContext.build(get_bfv_params("4k_3q"))
    assert ctx.ntt_kernel is False
    assert cuda.selected(ctx.params.n, "gpu")


def test_last_line(smoke):
    line = smoke.last_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_parse_recorded_smi_line(smoke):
    assert smoke.parse_smi("NVIDIA H100 80GB HBM3, 700.00 W\n") == (
        "NVIDIA H100 80GB HBM3", "700.00 W")
    with pytest.raises(ValueError):
        smoke.parse_smi("garbage")
