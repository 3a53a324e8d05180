"""chip_smoke.py's contract, rehearsed on the CPU: it refuses any device
but a GPU, its phases run end to end at tiny sizes through an injected
device check, ``--four`` runs on four virtual devices, and its last line
is exactly the ``{"ok": ..., "device": ...}`` object. Also the H100 peak
table and the compile-cache helper it relies on."""

import contextlib
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

from giddy_tpu.roofline import HBM_BW, chip_bw
from giddy_tpu.util import GROUP, enable_compile_cache

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

TINY = {"config0": GROUP + 5, "config123": GROUP + 7, "selftest": GROUP + 999,
        "tpch": 1 << 14, "four": 4 * GROUP}


def _run(argv) -> list[str]:
    out = io.StringIO()
    cache = jax.config.jax_compilation_cache_dir
    try:
        with contextlib.redirect_stdout(out):
            rc = chip_smoke.main(argv, device_check=lambda devices, count: None,
                                 card=lambda: "Test Card, 1.00 W", sizes=TINY)
    finally:  # main turns the compile cache on; keep this process as it was
        jax.config.update("jax_compilation_cache_dir", cache)
    assert rc == 0
    return out.getvalue().splitlines()


def _assert_last_line(lines, count):
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": count,
    }}
    assert any(line == "card: Test Card, 1.00 W" for line in lines[:-1])


def test_refuses_a_cpu_device():
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu(jax.devices("cpu"), 1)


def test_exits_nonzero_without_a_gpu_or_the_repo(tmp_path):
    """Run as a program on the CPU, and alone in a directory: both fail
    and print no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        p = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode != 0, (script, p.stdout, p.stderr)
        assert '"ok": true' not in p.stdout


def test_phases_run_at_tiny_sizes():
    lines = _run([])
    assert any("[baseline] config0 memory_analysis" in line for line in lines)
    assert any(line.startswith("[selftest] n=") for line in lines)
    assert any(line.startswith("[tpch]") for line in lines)
    _assert_last_line(lines, len(jax.devices()))


def test_four_on_virtual_devices():
    assert len(jax.devices()) >= 4
    lines = _run(["--four"])
    assert sum(line.startswith("[four] ") for line in lines) == 9
    assert not any("[baseline]" in line for line in lines)
    _assert_last_line(lines, len(jax.devices()))


def test_peak_table_has_the_h100():
    assert chip_bw("NVIDIA H100 80GB HBM3") == 3.35e12
    assert set(HBM_BW) == {"NVIDIA H100 80GB HBM3"}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe"])
def test_peak_table_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no published HBM bandwidth"):
        chip_bw(kind)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads the env itself


def test_compile_cache_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert enable_compile_cache() == path  # the same path every time
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
