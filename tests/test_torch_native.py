"""The port's C++ row gather (``runtime/native.py`` ``take_rows``) against
the JAX package's (``runtime/native.py``) and numpy, bit for bit.

Both bridges load a library built from the same ``native/src/dbs_native.cpp``:
the JAX package's at ``native/libdbs_native.so``, the port's under
``build/native/``. Held equal exactly:

- the shapes and dtypes of the JAX package's ``tests/test_native.py`` and a
  few more, index arrays of any rank (empty too), its multithreaded size
  (over 4 MiB) at several ``DBS_NATIVE_THREADS``, its bounds errors, and
  ``out=`` (the result written into the given array);
- with ``DBS_NATIVE=0`` (a fresh process) the port answers from numpy, with
  the same rows.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dynamic_load_balance_distributeddnn_tpu.runtime import native as jax_native
from dynamic_load_balance_distributeddnn_tpu_torch.runtime import native

REPO = Path(__file__).resolve().parents[1]

TAKE_CASES = [((100, 32, 32, 3), np.uint8), ((100,), np.int32), ((57, 7), np.float32),
              ((100,), np.int64), ((64, 5, 3), np.float64), ((31, 2), np.int16),
              ((40, 3), np.float16), ((50, 4), np.bool_)]


def test_the_library_builds_under_build_native_and_loads():
    assert native.native_available() and native.native_impl() == "native"
    lib = REPO / "build" / "native" / "libdbs_native.so"
    assert lib.exists() and lib.stat().st_mtime >= native.SOURCE.stat().st_mtime
    assert native.SOURCE == REPO / "native" / "src" / "dbs_native.cpp"


@pytest.mark.parametrize("shape,dtype", TAKE_CASES)
def test_take_rows_equals_jax_and_numpy(shape, dtype):
    rng = np.random.RandomState(0)
    data = (rng.rand(*shape) * 100).astype(dtype)
    idx = rng.randint(0, shape[0], size=(13, 24))
    got = native.take_rows(data, idx)
    np.testing.assert_array_equal(got, jax_native.take_rows(data, idx))
    np.testing.assert_array_equal(got, np.take(data, idx, axis=0))
    assert got.dtype == data.dtype and got.shape == idx.shape + shape[1:]


@pytest.mark.parametrize("idx_shape", [(0,), (5,), (2, 3, 4)])
def test_take_rows_any_index_rank(idx_shape):
    rng = np.random.RandomState(4)
    data = rng.rand(20, 6).astype(np.float32)
    idx = rng.randint(0, 20, size=idx_shape)
    got = native.take_rows(data, idx)
    np.testing.assert_array_equal(got, jax_native.take_rows(data, idx))
    np.testing.assert_array_equal(got, np.take(data, idx, axis=0))
    assert got.shape == idx_shape + (6,)


@pytest.mark.parametrize("threads", ["0", "1", "3", "16"])
def test_take_rows_large_multithreaded_path(threads, monkeypatch):
    monkeypatch.setenv("DBS_NATIVE_THREADS", threads)
    rng = np.random.RandomState(1)
    data = rng.randint(0, 255, size=(4096, 32, 32, 3)).astype(np.uint8)
    idx = rng.randint(0, 4096, size=(8, 512))  # 12 MiB: the threaded branch
    got = native.take_rows(data, idx)
    np.testing.assert_array_equal(got, jax_native.take_rows(data, idx))
    np.testing.assert_array_equal(got, np.take(data, idx, axis=0))


@pytest.mark.parametrize("bad", [[0, 4], [-1], [7]])
def test_take_rows_bounds_errors(bad):
    data = np.zeros((4, 3), np.float32)
    for take in (native.take_rows, jax_native.take_rows):
        with pytest.raises(ValueError):
            take(data, np.array(bad))


def test_take_rows_into_out():
    rng = np.random.RandomState(2)
    data = rng.randint(0, 255, size=(300, 8, 8, 3)).astype(np.uint8)
    idx = rng.randint(0, 300, size=77)
    out = np.full((77, 8, 8, 3), 7, np.uint8)
    got = native.take_rows(data, idx, out=out)
    assert got is out
    np.testing.assert_array_equal(out, np.take(data, idx, axis=0))
    # a non-contiguous source packs the same rows
    src = np.asfortranarray(data[:, :, :, 0])
    np.testing.assert_array_equal(native.take_rows(src, idx), np.take(src, idx, axis=0))


@pytest.mark.parametrize("out", [np.zeros((5, 3), np.float64), np.zeros((4, 3), np.float32),
                                 np.zeros((5, 6), np.float32)[:, ::2]])
def test_take_rows_refuses_a_wrong_out(out):
    with pytest.raises(ValueError):
        native.take_rows(np.zeros((9, 3), np.float32), np.arange(5), out=out)


def test_dbs_native_0_answers_from_numpy_with_the_same_results():
    code = (
        "import json, numpy as np\n"
        "from dynamic_load_balance_distributeddnn_tpu_torch.runtime import native\n"
        "rng = np.random.RandomState(3)\n"
        "data = rng.randint(0, 255, size=(64, 4, 4, 3)).astype(np.uint8)\n"
        "idx = rng.randint(0, 64, size=(5, 9))\n"
        "print(json.dumps({'impl': native.native_impl(),"
        " 'rows': native.take_rows(data, idx).tolist()}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), DBS_NATIVE="0")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       cwd=str(REPO), timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["impl"] == "numpy"
    rng = np.random.RandomState(3)
    data = rng.randint(0, 255, size=(64, 4, 4, 3)).astype(np.uint8)
    idx = rng.randint(0, 64, size=(5, 9))
    assert got["rows"] == native.take_rows(data, idx).tolist()


def test_the_numpy_fallback_takes_out_too(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", True)
    assert native.native_impl() == "numpy"
    data = np.arange(40, dtype=np.float32).reshape(10, 4)
    out = np.empty((3, 4), np.float32)
    assert native.take_rows(data, np.array([9, 0, 4]), out=out) is out
    np.testing.assert_array_equal(out, data[[9, 0, 4]])
    with pytest.raises(ValueError):
        native.take_rows(data, np.array([10]))
