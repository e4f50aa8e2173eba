"""The port's VectorDBSession against the JAX package's, on the CPU.

Both sessions get the same add_vectors / search calls (plain, batched,
filtered, after deletes); the flat regime is exact, so they must return the
same ids, with scores within 1e-5. Also the guards: the port imports no JAX,
and its entry points need a card unless told to use the CPU.
"""
import os
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from fabstir_vectordb_tpu.api.session import VectorDBSession as SessionJ  # noqa: E402
from fabstir_vectordb_tpu.core.object_store import MemoryObjectStore  # noqa: E402
from fabstir_vectordb_tpu_torch.api.session import (  # noqa: E402
    VectorDBError, VectorDBSession)

D = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(x, lo, hi):
    return [{"id": f"doc-{i}", "vector": x[i].tolist(),
             "metadata": {"cat": ["a", "b", "c"][i % 3], "n": i}}
            for i in range(lo, hi)]


@pytest.fixture(scope="module")
def sessions():
    """1,500 rows in batches of 500: the first batch trains IVF on its
    first 10 rows and bootstraps HNSW on the host; later ones run the
    pipelined device-candidate batches."""
    x = np.random.default_rng(0).standard_normal((1500, D)).astype(np.float32)
    cfg = {"sessionId": "s", "storageMode": "mock"}
    sj = SessionJ.create(cfg, store=MemoryObjectStore())
    st = VectorDBSession.create(cfg, device="cpu")
    for lo in range(0, 1500, 500):
        sj.add_vectors(_records(x, lo, lo + 500))
        st.add_vectors(_records(x, lo, lo + 500))
    return sj, st, x


def _near(x, i):
    """A query close to row i but not on it: at distance 0 the norm-expansion
    form leaves ~1e-6 of f32 cancellation, which the square root blows up
    to ~1e-3 in the score, differently in each package."""
    noise = np.random.default_rng(100 + i).standard_normal(D)
    return (x[i] + 0.2 * noise).astype(np.float32)


def _assert_same(got, want):
    assert [r["id"] for r in got] == [r["id"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got],
                               [r["score"] for r in want], rtol=1e-5,
                               atol=1e-5)
    assert [r["metadata"] for r in got] == [r["metadata"] for r in want]


def test_session_search_matches_reference(sessions):
    sj, st, x = sessions
    q = np.random.default_rng(1).standard_normal((6, D)).astype(np.float32)
    for i in range(6):
        _assert_same(st.search(q[i], 10), sj.search(q[i], 10))
    _assert_same(st.search(_near(x, 7), 3, {"includeVectors": True}),
                 sj.search(_near(x, 7), 3, {"includeVectors": True}))
    assert st.search(x[7], 1)[0]["id"] == "doc-7"


def test_session_batched_and_filtered_match_reference(sessions):
    sj, st, x = sessions
    q = np.random.default_rng(2).standard_normal((5, D)).astype(np.float32)
    for a, b in zip(st.search_batch(q, 7), sj.search_batch(q, 7)):
        _assert_same(a, b)
    flt = {"cat": "b"}
    for a, b in zip(st.search_batch(q, 4, flt), sj.search_batch(q, 4, flt)):
        _assert_same(a, b)
        assert all(r["metadata"]["cat"] == "b" for r in a)
    for i in range(3):
        _assert_same(st.search(q[i], 6, {"filter": {"n": {"$lt": 700}}}),
                     sj.search(q[i], 6, {"filter": {"n": {"$lt": 700}}}))


def test_session_deletes_and_stats_match_reference(sessions):
    sj, st, x = sessions
    for s in (sj, st):
        s.delete_vector("doc-7")
        res = s.delete_by_metadata({"n": {"$in": [10, 11, 12]}})
        assert sorted(res.deleted_ids) == ["doc-10", "doc-11", "doc-12"]
        s.update_metadata("doc-20", {"cat": "z"})
    for i in (7, 10, 20, 30):
        _assert_same(st.search(_near(x, i), 5), sj.search(_near(x, i), 5))
    assert all(r["id"] != "doc-7" for r in st.search(x[7], 20))
    _assert_same(st.search(_near(x, 3), 5, {"filter": {"cat": "z"}}),
                 sj.search(_near(x, 3), 5, {"filter": {"cat": "z"}}))
    got, want = st.get_stats().to_json(), sj.get_stats().to_json()
    got.pop("memoryUsageMb"), want.pop("memoryUsageMb")  # IVF tiles differ
    assert got == want
    assert st.vacuum().to_json() == sj.vacuum().to_json()
    _assert_same(st.search(_near(x, 30), 8), sj.search(_near(x, 30), 8))


def test_session_errors_match_reference():
    cfg = {"sessionId": "e", "storageMode": "mock"}
    sj = SessionJ.create(cfg, store=MemoryObjectStore())
    st = VectorDBSession.create(cfg, device="cpu")
    bad = [
        lambda s: s.add_vectors([{"id": "a", "vector": [1.0, float("nan")]}]),
        lambda s: s.add_vectors([{"id": "a", "vector": [1.0]},
                                 {"id": "a", "vector": [2.0]}]),
        lambda s: s.search([1.0, 2.0], 0),
        lambda s: s.search([1.0, 2.0], 3, {"filter": {"$bogus": 1}}),
        lambda s: s.delete_vector("missing"),
    ]
    for call in bad:
        with pytest.raises(Exception) as ej:
            call(sj)
        with pytest.raises(VectorDBError) as et:
            call(st)
        assert et.value.code == ej.value.code
    for s in (sj, st):
        s.add_vectors([{"id": "a", "vector": [1.0, 2.0]}])
    with pytest.raises(VectorDBError) as et:
        st.add_vectors([{"id": "b", "vector": [1.0, 2.0, 3.0]}])
    assert et.value.code == "INVALID_INPUT"
    with pytest.raises(VectorDBError):
        VectorDBSession.create({"sessionId": ""}, device="cpu")
    st.destroy()
    with pytest.raises(VectorDBError):
        st.search([1.0, 2.0], 1)


def test_create_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VectorDBSession.create({"sessionId": "x"})


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import fabstir_vectordb_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'fabstir_vectordb_tpu'\n"
        "       or n.startswith('fabstir_vectordb_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('fabstir_vectordb_tpu_torch.')]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module was imported
