"""K11's and K6's host-side plans and the beam search's result list, on the
CPU.

``index.hnsw.beam_plan`` (warps a query of K11) and ``ops.kmeans.
lloyd_route`` (K6's tensor-core route or its FMA tile) are chosen by
shape on the host; they are checked here at the shapes the main path
gives them. The filtered beam search is held to the JAX package's on a
graph built so that an eligible id leaves a full pool and comes back as a
candidate: the reference merges it into the result list again, where the
repeat takes the slot of a farther eligible row until the final dedup,
and the port's plain version (the one its kernel is held to on the card)
must do the same.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from fabstir_vectordb_tpu.index import hnsw as hnsw_j  # noqa: E402
from fabstir_vectordb_tpu_torch.index import hnsw as hnsw_t  # noqa: E402
from fabstir_vectordb_tpu_torch.ops import kmeans as km_t  # noqa: E402
from .test_torch_kernels import _reentry_graph  # noqa: E402


@pytest.mark.parametrize("b,expand,width,warps", [
    (1, 4, 32, 8),      # serve, one query: 128 candidates a step
    (128, 4, 32, 8),    # serve, a batch
    (1_024, 1, 32, 2),  # the layer-0 link
    (1_024, 1, 16, 1),  # an upper layer of the per-layer plan
    (64, 1, 16, 1),
    (300, 4, 32, 4),    # 8 warps a query would pass the resident warps
    (4_096, 4, 32, 1),  # halved down to one
    (1, 8, 32, 8),      # never past 8
    (2, 1, 1, 1)])      # never below 1
def test_beam_plan_by_shape(b, expand, width, warps):
    got = hnsw_t.beam_plan(b, expand, width)
    assert got == warps
    assert 1 <= got <= 8
    assert got == 1 or b * got <= hnsw_t.BEAM_RESIDENT_WARPS


@pytest.mark.parametrize("n,c,d,aligned,route", [
    (1_048_576, 256, 384, True, "tf32x3"),  # the 10M tier's blocks
    (65_536, 256, 48, True, "tf32x3"),      # PQ's subspaces
    (1_000, 300, 8, True, "tf32x3"),
    (100_000, 3, 384, True, "fma"),         # the flat tier's 3 lists
    (1_000, 63, 384, True, "fma"),
    (1_000, 64, 384, True, "tf32x3"),
    (1_000, 256, 130, True, "fma"),         # 16-byte rows only
    (1_000, 256, 384, False, "fma")])
def test_lloyd_route_by_shape(n, c, d, aligned, route):
    assert km_t.lloyd_route(n, c, d, aligned) == route


def test_filtered_beam_merges_a_reentering_id_as_the_reference_does():
    args, res = _reentry_graph()
    active = np.ones(1, bool)
    dj, rj = hnsw_j.beam_search_kernel(
        *(jnp.asarray(a) for a in args), jnp.asarray(active), layer=0, ef=2,
        max_iters=10, result_mask=jnp.asarray(res), has_result_mask=True)
    st = {}
    dt, rt = hnsw_t.beam_search(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(active),
        layer=0, ef=2, max_iters=10, result_mask=torch.from_numpy(res))
    dp, rp = hnsw_t.beam_search_plain(
        *(torch.from_numpy(a) for a in args), torch.from_numpy(active), 0, 2,
        10, torch.from_numpy(res), stats=st)
    # A's repeat took E's slot: E is gone, the slot is padding
    np.testing.assert_array_equal(np.asarray(rj), [[1, -1]])
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(rp.numpy(), np.asarray(rj))
    np.testing.assert_allclose(dt.numpy()[:, :1], np.asarray(dj)[:, :1])
    assert np.isinf(dt.numpy()[0, 1])
    # the walk: S, A, B, C expanded; A scored twice (a visited set would
    # have kept E)
    assert st["steps"] == 4 and st["steps_max"] == 4
    assert st["rows"] == 5


def test_beam_stats_count_the_longest_chain():
    args, _ = _reentry_graph()
    t = [torch.from_numpy(a) for a in args]
    t[6] = torch.zeros((3, 4))
    t[7] = torch.tensor([[0], [2], [3]], dtype=torch.int32)  # S, E, B
    st = {}
    hnsw_t.beam_search_plain(*t, None, 0, 2, 10, stats=st)
    # S: S, A, B, C; E: E (a dead end); B: B, A, C
    assert st["steps_max"] == 4
    assert st["steps"] == 4 + 1 + 3
