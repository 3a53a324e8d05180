"""ctypes bridge to the native host codec (native/lmp.cpp).

Builds the shared library on first use with g++ -O3 (cached next to the
source; rebuilt when the source changes). Falls back to the NumPy
reference silently if no toolchain is available — the NumPy path in
``ref/lmp.py`` is normative either way (tests enforce bit parity).
Set GIDDY_TPU_NO_NATIVE=1 to force the NumPy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent.parent / "native" / "lmp.cpp"
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _build() -> ctypes.CDLL | None:
    if not _SRC.exists():
        return None
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _SRC.parent / f"_lmp_{tag}.so"
    if not out.exists():
        # build under a per-process name, then rename into place: parallel
        # test workers must never load another process's half-written file
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
            str(_SRC), "-o", str(tmp),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except Exception:
            try:  # retry without openmp/march (portability)
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
                    check=True, capture_output=True, timeout=120,
                )
            except Exception:
                tmp.unlink(missing_ok=True)
                return None
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.lmp_pack_u32.argtypes = [u32p, u32p, ctypes.c_int64, ctypes.c_int]
    lib.lmp_unpack_u32.argtypes = [u32p, u32p, ctypes.c_int64, ctypes.c_int]
    lib.zigzag_i32.argtypes = [i32p, u32p, ctypes.c_int64]
    lib.unzigzag_u32.argtypes = [u32p, i32p, ctypes.c_int64]
    lib.dzbv_widths.argtypes = [u32p, ctypes.c_int64, u32p, i64p]
    lib.dzbv_fill.argtypes = [u32p, u32p, ctypes.c_int64, u32p, u32p, u32p, u32p]
    return lib


def get_lib() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        if os.environ.get("GIDDY_TPU_NO_NATIVE") != "1":
            _LIB = _build()
    return _LIB


def lmp_pack(values_u32: np.ndarray, bits: int, ng: int) -> np.ndarray | None:
    """values (ng*GROUP,) uint32 contiguous -> (ng, bits*1024) uint32, or
    None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    words = np.zeros((ng, bits * 1024), dtype=np.uint32)
    lib.lmp_pack_u32(np.ascontiguousarray(values_u32), words, ng, bits)
    return words


def dzbv_split(u: np.ndarray) -> tuple[np.ndarray, list[np.ndarray]] | None:
    """Byte-plane split of a uint32 column (dzbv encode hot path): returns
    (widths-1 as uint32, [plane0..plane3] as uint32 byte values), or None
    if the native library is unavailable. Plane k>0 holds byte k of the
    elements with width > k, in element order; plane0 holds byte 0 of all."""
    lib = get_lib()
    if lib is None:
        return None
    u = np.ascontiguousarray(u, dtype=np.uint32)
    n = u.shape[0]
    wm1 = np.empty(n, np.uint32)
    counts = np.empty(3, np.int64)
    lib.dzbv_widths(u, n, wm1, counts)
    planes = [np.empty(n, np.uint32)] + [np.empty(int(c), np.uint32) for c in counts]
    lib.dzbv_fill(u, wm1, n, planes[0], planes[1], planes[2], planes[3])
    return wm1, planes


def zigzag(d: np.ndarray) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    d = np.ascontiguousarray(d, dtype=np.int32)
    z = np.empty(d.shape[0], np.uint32)
    lib.zigzag_i32(d, z, d.shape[0])
    return z


def unzigzag(z: np.ndarray) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    z = np.ascontiguousarray(z, dtype=np.uint32)
    d = np.empty(z.shape[0], np.int32)
    lib.unzigzag_u32(z, d, z.shape[0])
    return d


def lmp_unpack(words: np.ndarray, bits: int, ng: int) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    v = np.empty(ng * 32768, dtype=np.uint32)
    lib.lmp_unpack_u32(np.ascontiguousarray(words, dtype=np.uint32).reshape(-1), v, ng, bits)
    return v
