"""Sharded decode on a virtual 8-device CPU mesh — the multi-host code
path without a cluster (SURVEY.md §5.2.3, call stack CS-5).

Runs in a subprocess because the parent pytest process may already hold a
single-device GPU backend; the checks need JAX_PLATFORMS=cpu with
--xla_force_host_platform_device_count=8 set before jax import.
"""

import pathlib
import subprocess
import sys


def test_dist_checks_on_virtual_mesh():
    script = pathlib.Path(__file__).parent / "dist_checks.py"
    proc = subprocess.run(
        [sys.executable, str(script)],
        capture_output=True,
        text=True,
        timeout=1200,
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr[-4000:]}"
    assert "ALL DIST CHECKS PASSED" in proc.stdout


def test_two_process_distributed_mesh():
    """Actual multi-controller runtime (2 x jax.distributed processes of 4
    virtual devices each): process-spanning 2D mesh, per-process
    addressable shards, cross-process replicated-stream broadcast — the
    DCN-analog pieces the single-process virtual mesh never touches
    (VERDICT r3 next #6; SURVEY.md CS-5)."""
    script = pathlib.Path(__file__).parent / "dist2proc_check.py"
    proc = subprocess.run(
        [sys.executable, str(script)],
        capture_output=True,
        text=True,
        timeout=1200,
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr[-4000:]}"
    assert "ALL 2-PROCESS DIST CHECKS PASSED" in proc.stdout
