"""Loader for the native (C++) host-side preprocessing library.

Compiles native/tilize.cpp lazily with g++ into a shared object next to the
source, binds it via ctypes, and falls back to a numpy implementation when no
compiler is available. Both paths produce identical output (unit-tested).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_SRC = os.path.join(_NATIVE_DIR, "tilize.cpp")
_SO = os.path.join(_NATIVE_DIR, "libtilize.so")

_lib = None
_lib_tried = False


def _load():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", _SO, _SRC],
                check=True, capture_output=True,
            )
        lib = ctypes.CDLL(_SO)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.tilize_count.restype = ctypes.c_int64
        lib.tilize_count.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i32p, i32p]
        lib.tilize_fill.restype = None
        lib.tilize_fill.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, i32p, f32p, f32p, i32p, i32p, i32p,
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def have_native() -> bool:
    return _load() is not None


def _ptr(a, typ):
    return a.ctypes.data_as(typ)


def tilize_csr(a, T: int = 128, force_numpy: bool = False, dtype=np.float32):
    """CSR -> sparse-tile arrays: (tiles (nt,T,T), rt, ct, first int32).

    Tiles sorted by (row_tile, col_tile-first-seen); every row tile emits at
    least one tile. Requires n % T == 0 (callers pad).
    The native C++ path is f32; other dtypes go through the numpy path.
    """
    dtype = np.dtype(dtype)
    if dtype != np.float32:
        force_numpy = True
    a = a.tocsr()
    n = a.shape[0]
    indptr = np.ascontiguousarray(a.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(a.indices, dtype=np.int32)
    data = np.ascontiguousarray(a.data, dtype=np.float32)
    nrt = -(-n // T)

    lib = None if force_numpy else _load()
    if lib is not None:
        counts = np.zeros(nrt, dtype=np.int32)
        total = lib.tilize_count(
            n, T,
            _ptr(indptr, ctypes.POINTER(ctypes.c_int64)),
            _ptr(indices, ctypes.POINTER(ctypes.c_int32)),
            _ptr(counts, ctypes.POINTER(ctypes.c_int32)),
        )
        tiles = np.zeros((total, T, T), dtype=np.float32)
        rt = np.empty(total, dtype=np.int32)
        ct = np.empty(total, dtype=np.int32)
        first = np.empty(total, dtype=np.int32)
        lib.tilize_fill(
            n, T,
            _ptr(indptr, ctypes.POINTER(ctypes.c_int64)),
            _ptr(indices, ctypes.POINTER(ctypes.c_int32)),
            _ptr(data, ctypes.POINTER(ctypes.c_float)),
            _ptr(tiles.reshape(-1), ctypes.POINTER(ctypes.c_float)),
            _ptr(rt, ctypes.POINTER(ctypes.c_int32)),
            _ptr(ct, ctypes.POINTER(ctypes.c_int32)),
            _ptr(first, ctypes.POINTER(ctypes.c_int32)),
        )
        return tiles, rt, ct, first

    # numpy fallback — same ordering semantics as the C++ path
    tiles_list, rts, cts, firsts = [], [], [], []
    for rti in range(nrt):
        r0, r1 = rti * T, min((rti + 1) * T, n)
        sub = a[r0:r1]
        if sub.nnz == 0:
            tiles_list.append(np.zeros((T, T), dtype))
            rts.append(rti), cts.append(rti), firsts.append(1)
            continue
        coo = sub.tocoo()
        order_of = {}
        for c in coo.col:  # first-seen order, matching the C++ scan
            cti = int(c) // T
            if cti not in order_of:
                order_of[cti] = len(order_of)
        local = {cti: np.zeros((T, T), dtype) for cti in order_of}
        for r, c, v in zip(coo.row, coo.col, coo.data):
            local[int(c) // T][int(r), int(c) - (int(c) // T) * T] += dtype.type(v)
        for j, cti in enumerate(sorted(order_of, key=order_of.get)):
            tiles_list.append(local[cti])
            rts.append(rti), cts.append(cti), firsts.append(1 if j == 0 else 0)
    return (
        np.stack(tiles_list),
        np.asarray(rts, np.int32),
        np.asarray(cts, np.int32),
        np.asarray(firsts, np.int32),
    )
