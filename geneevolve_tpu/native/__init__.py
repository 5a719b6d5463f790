"""Native (C++) host-side codecs, built on demand with the system toolchain.

The reference's I/O layer is C++ (libStatGen + `src/format_*.cpp`); this
package is its counterpart here. `load()` compiles
`codecs.cpp` into a shared library the first time (cached next to the
source, keyed by source mtime) and exposes it through ctypes. Set
`GE_NO_NATIVE=1` to force the pure-Python fallbacks in `io/`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "codecs.cpp"
_LIB = _HERE / "_codecs.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _build() -> bool:
    try:
        subprocess.run(
            [
                "g++",
                "-O3",
                "-shared",
                "-fPIC",
                "-pthread",
                "-std=c++17",
                str(_SRC),
                "-o",
                str(_LIB),
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception:
        return False


def load() -> Optional[ctypes.CDLL]:
    """The codec library, or None if unavailable/disabled."""
    global _lib, _failed
    if os.environ.get("GE_NO_NATIVE") == "1":
        return None
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        fresh = _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime
        if not fresh and not _build():
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            _failed = True
            return None
        i64 = ctypes.c_int64
        p8 = ctypes.POINTER(ctypes.c_uint8)
        pc = ctypes.c_char_p
        pi64 = ctypes.POINTER(ctypes.c_int64)
        lib.hap_parse.restype = i64
        lib.hap_parse.argtypes = [pc, i64, i64, i64, p8]
        lib.hap_format.restype = i64
        lib.hap_format.argtypes = [p8, i64, i64, ctypes.c_void_p]
        lib.vcf_count.restype = i64
        lib.vcf_count.argtypes = [pc, i64, pi64, pi64]
        lib.vcf_parse_gt.restype = i64
        lib.vcf_parse_gt.argtypes = [pc, i64, i64, i64, p8, pi64, pi64]
        lib.gt_format.restype = i64
        lib.gt_format.argtypes = [p8, p8, i64, i64, ctypes.c_void_p]
        lib.ped_format.restype = i64
        lib.ped_format.argtypes = [pc, i64, ctypes.c_void_p]
        lib.info_format.restype = i64
        lib.info_format.argtypes = [
            pi64, i64, i64, ctypes.POINTER(ctypes.c_double), i64,
            ctypes.c_void_p, i64,
        ]
        lib.info_format_mt.restype = i64
        lib.info_format_mt.argtypes = lib.info_format.argtypes + [i64]
        _lib = lib
        return _lib


def format_info(ids, vals) -> Optional[bytes]:
    """Render the info-file body from (n, k_int) int64 ids and (n, k_val)
    float64 vals via the C formatter; None when the codec is unavailable
    (callers fall back to the Python row loop)."""
    lib = load()
    if lib is None:
        return None
    import numpy as np

    ids = np.ascontiguousarray(ids, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    n, k_int = ids.shape
    k_val = vals.shape[1]
    # %lld <= 20 chars + sep; %g <= 13 chars + sep; margin for safety
    cap = n * (k_int * 22 + k_val * 16 + 2) + 64
    buf = ctypes.create_string_buffer(cap)
    written = lib.info_format_mt(
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        k_int,
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        k_val,
        buf,
        cap,
        min(os.cpu_count() or 1, 16),
    )
    if written < 0:
        return None
    return buf.raw[:written]
