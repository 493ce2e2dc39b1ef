"""Operator serialization — build once, solve many times.

Reference equivalent: none (the reference rebuilds its Eigen matrices per
run); this is production plumbing because operator
CONSTRUCTION is host-side preprocessing that can dwarf a warm solve:
tilize + RCM on a multi-million-row mesh takes seconds-to-minutes, while
the solve itself is milliseconds. ``save_operator`` writes any registered
operator dataclass to a single .npz (array leaves + JSON'd static fields;
bfloat16 stored as a uint16 view); ``load_operator`` reconstructs it.

    op = from_scipy_auto(a)              # expensive, once
    save_operator("op.npz", op)
    ...
    op = load_operator("op.npz")         # cheap, every run
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import jax.numpy as jnp

import blockcg.operators as _ops


def _to_tuple(v):
    return tuple(_to_tuple(x) for x in v) if isinstance(v, list) else v


def save_operator(path, op) -> None:
    cls = type(op).__name__
    if not hasattr(_ops, cls):
        raise ValueError(f"{cls} is not a blockcg.operators container")
    arrays, dtypes, meta = {}, {}, {}
    for f in dataclasses.fields(op):
        v = getattr(op, f.name)
        if v is None:
            continue
        if hasattr(v, "dtype"):
            a = np.asarray(v)
            dtypes[f.name] = str(a.dtype)
            if a.dtype == jnp.bfloat16:  # numpy can't savez ml_dtypes
                a = a.view(np.uint16)
            arrays[f.name] = a
        else:
            meta[f.name] = v
    hdr = {"class": cls, "meta": meta, "dtypes": dtypes}
    # The logical-nnz cache on DIA/BlockDIA/ELL lives in a side-band attr
    # (not a dataclass field); without persisting it a reloaded operator's
    # ``nnz`` falls back to the padded upper bound and silently inflates
    # Gnnz/s lines computed from reloaded operators.
    nnz_cache = getattr(op, "_nnz", None)
    if nnz_cache is not None:
        hdr["nnz_cache"] = int(nnz_cache)
    np.savez_compressed(
        path,
        __header__=np.frombuffer(
            json.dumps(hdr).encode(), dtype=np.uint8,
        ),
        **arrays,
    )


def load_operator(path):
    import jax

    with np.load(path) as z:
        hdr = json.loads(bytes(z["__header__"]).decode())
        cls = getattr(_ops, hdr["class"])
        kw = {}
        # Honor the RECORDED dtypes: without the x64 scope, jnp.asarray
        # silently truncates f64 leaves to f32 in a default (x64-off)
        # process, and a saved f64 refinement operator would quietly stop
        # being f64.
        with jax.enable_x64(True):
            for name, dt in hdr["dtypes"].items():
                a = z[name]
                if dt == "bfloat16":
                    a = a.view(jnp.bfloat16)
                arr = jnp.asarray(a)
                assert str(arr.dtype) == dt, (name, str(arr.dtype), dt)
                kw[name] = arr
        for name, v in hdr["meta"].items():
            kw[name] = _to_tuple(v)
        op = cls(**kw)
        if "nnz_cache" in hdr:
            object.__setattr__(op, "_nnz", int(hdr["nnz_cache"]))
        return op
