"""NaN-tripwire tests (utils/debug.py)."""

import numpy as np
import jax.numpy as jnp

import blockcg as bc
from blockcg.operators import DenseOperator
from blockcg.problems import random_spd
from blockcg.utils.debug import checked_operator, run_checked


def test_checked_clean_solve_passes():
    n = 64
    op = checked_operator(DenseOperator(A=jnp.asarray(random_spd(n))))
    B = jnp.asarray(np.random.default_rng(0).standard_normal((n, 3)))
    err, (X, info) = run_checked(
        lambda: bc.solve_sbcgrq(op, B, tol=1e-8, max_iter=200)
    )
    err.throw()  # no tripwire
    assert bool(info.converged.all())


def test_checked_trips_on_nan():
    n = 64
    A = random_spd(n)
    A[3, 5] = np.nan
    A[5, 3] = np.nan
    op = checked_operator(DenseOperator(A=jnp.asarray(A)))
    B = jnp.asarray(np.random.default_rng(1).standard_normal((n, 3)))
    err, _ = run_checked(lambda: bc.solve_sbcgrq(op, B, tol=1e-8, max_iter=50))
    try:
        err.throw()
        assert False, "expected the tripwire to fire"
    except Exception as e:
        assert "non-finite" in str(e)


def test_metrics_timed_solve_and_jsonl(tmp_path):
    """utils.metrics: timed_solve produces a JSON-serializable record and
    log_jsonl appends one line per record."""
    import json

    import blockcg as bc
    from blockcg.problems import laplacian_dia
    from blockcg.utils.metrics import log_jsonl, timed_solve

    op = laplacian_dia((32, 32), dtype=jnp.float32)
    rng = np.random.default_rng(60)
    B = jnp.asarray(rng.standard_normal((op.n, 4)), dtype=jnp.float32)
    X, info, rec = timed_solve("sbcgrq", bc.solve_sbcgrq, op, B, tol=1e-5,
                               warm=False)
    assert rec.converged and rec.n == op.n and rec.k == 4
    d = json.loads(rec.to_json())
    assert d["solver"] == "sbcgrq" and d["nnz_per_s"] > 0
    path = tmp_path / "rec.jsonl"
    log_jsonl(str(path), rec)
    log_jsonl(str(path), rec)
    lines = path.read_text().strip().splitlines()
    assert len(lines) == 2 and json.loads(lines[0])["solver"] == "sbcgrq"


def test_checkpoint_roundtrip(tmp_path):
    from blockcg.utils.checkpoint import load_checkpoint, save_checkpoint

    rng = np.random.default_rng(61)
    X = rng.standard_normal((64, 3)).astype(np.float32)
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, X, iteration=7, meta={"tol": 1e-6})
    got = load_checkpoint(p)
    assert got is not None
    X2, it = got[0], got[1]
    np.testing.assert_array_equal(np.asarray(X2), X)
    assert it == 7
    assert load_checkpoint(str(tmp_path / "missing.npz")) is None


def test_convergence_history_trim():
    import blockcg as bc
    from blockcg.problems import laplacian_dia
    from blockcg.utils.metrics import convergence_history

    op = laplacian_dia((32, 32), dtype=jnp.float32)
    rng = np.random.default_rng(62)
    B = jnp.asarray(rng.standard_normal((op.n, 2)), dtype=jnp.float32)
    X, info = bc.solve_sbcgrq(op, B, tol=1e-5, max_iter=500,
                              record_history=True)
    h = convergence_history(info)
    assert len(h) == int(info.iterations)
    assert h[-1] <= 1e-5 * 1.5
