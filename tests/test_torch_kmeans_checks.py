"""Checks of K6 and K7 on the card, shared by ``test_torch_kernels.py``,
``test_torch_kmeans_pp.py``, ``chip_smoke.py`` and
``scripts/time_tile_routes.py``: where two k-means++ runs part and by what
key gap, the card's Philox uniforms, and a K6 Lloyd run held step by step
to the plain arithmetic from its own inputs. The tests at the end hold
the Lloyd check itself on the CPU, where both runs are the plain version.
It imports neither JAX nor pytest.
"""
import numpy as np
import torch

from fabstir_vectordb_tpu_torch.ops import kmeans as km
from fabstir_vectordb_tpu_torch.utils import native

# The tensor cores' distance error (three TF32 products), relative to the
# expansion's terms |x|^2 + |c|^2 (csrc/lloyd_tile.cuh): a row whose two
# nearest centroids lie closer than this may go to either.
TIE = 2e-6


def pp_uniforms_card(seed: int, sub: int, step: int, n: int, device):
    """The uniforms of (sub, step) at rows 0..n-1 by the card's Philox
    routine and counter layout, the ones fvdb_kmeans_pp draws through:
    [n] f32. This checks the shared generator against
    :func:`km.pp_uniforms`, not the fused kernel's own draws, which the
    pick-for-pick comparison covers."""
    out = torch.empty(n, dtype=torch.float32, device=device)
    P, I, U = native.P, native.I, native.U
    native.call("kmeans_seed", "fvdb_pp_uniforms", [U, U, I, I, I, P, P],
                seed & km._M32, (seed >> 32) & km._M32, sub, step, n,
                out.data_ptr(), native.stream_of(out))
    return out


def pp_key_gaps(seed: int, x, mask, rows_a, rows_b, n_sub: int = 1):
    """Where two k-means++ runs under ``seed`` (rows [n_sub, C]) part: for
    each subspace that differs, (subspace, its first pick that differs,
    the relative gap between the two rows' keys there), the keys E / d2
    (E where the step drew unweighted) under the table rows_b's earlier
    picks give and the step's draw; an ineligible row's gap is +inf. A gap
    of rounding's size is a key tie broken the other way."""
    n, d = x.shape
    ds = d // n_sub
    out = []
    for m in range(n_sub):
        diff = torch.nonzero(rows_a[m] != rows_b[m])
        if diff.numel() == 0:
            continue
        i = int(diff[0, 0])
        xm = x[:, m * ds:(m + 1) * ds]
        d2 = torch.full((n,), float("inf"), device=x.device)
        if i > 0:
            d2 = km.seed_min_update_plain(xm, mask, d2, rows_b[m, :i])
        u = km.pp_uniforms(seed, [m], i, n, x.device)[0]
        key = km._seed_key(d2, mask, u, i > 0)
        if not bool(torch.isfinite(key).any()):
            key = km._seed_key(d2, mask, u, False)
        ka, kb = (float(key[int(r[m, i])]) for r in (rows_a, rows_b))
        gap = (abs(ka - kb) / max(ka, kb)
               if np.isfinite(ka) and np.isfinite(kb) else float("inf"))
        out.append((m, i, gap))
    return out


def recording(block, log: list):
    """``block`` (km.lloyd_block or its plain version) that appends each
    call's (input centroids, stacked outputs) to ``log``: handed to
    km._lloyd_until, it keeps that run's own steps."""
    def run(x, mask, cents, steps):
        all_c, errs = block(x, mask, cents, steps)
        log.append((cents, all_c))
        return all_c, errs
    return run


def _steps(init, log, iterations):
    outs = [c for _, all_c in log for c in all_c][:iterations]
    return [init] + outs[:-1], outs


def _gap(x, cents, a, b):
    """Rows whose assignments a and b [N] differ: (their count, the largest
    float64 gap between their distances to the two centroids of cents over
    |x|^2 + |c|^2)."""
    rows = torch.nonzero(a != b)[:, 0]
    if rows.numel() == 0:
        return 0, 0.0
    xr = x[rows].double()
    ca, cb = (cents[v[rows].long()].double() for v in (a, b))
    da, db = ((xr - ca) ** 2).sum(1), ((xr - cb) ** 2).sum(1)
    scale = (xr * xr).sum(1) + torch.maximum((ca * ca).sum(1),
                                             (cb * cb).sum(1))
    return rows.numel(), float(((da - db).abs() / scale).max())


def lloyd_check(x, mask, init, kern_log, plain_log, iterations: int):
    """A K6 Lloyd run (kern_log, recorded by :func:`recording` from
    km.lloyd_block) against the plain run from the same init (plain_log),
    both as km._lloyd_until ran them, over their first ``iterations``
    steps (CUDA tensors). Returns a dict:

    * ``step_err``: every step of the K6 run against the plain step from
      the same input centroids, with the rows sent where K6's assignment
      sent them: the largest difference of the centroids;
    * ``rows_off`` / ``off_gap``: the rows that K6's assignment sends
      elsewhere than the plain assignment from the same centroids, over
      all steps, and the largest float64 gap of such a row (a tie when
      within :data:`TIE`);
    * ``parted_at`` / ``parting_gap``: the first step at which the two
      runs assign a row differently (None if none), and the largest gap of
      those rows under K6's centroids there;
    * ``apart``: the largest difference of the two runs' centroids before
      they part (at every step if they never do).
    """
    k_in, k_out = _steps(init, kern_log, iterations)
    p_in, p_out = _steps(init, plain_log, iterations)
    out = dict(step_err=0.0, rows_off=0, off_gap=0.0, parted_at=None,
               parting_gap=0.0, apart=0.0)
    for t in range(iterations):
        ak = km.assign_clusters(x, k_in[t], mask)[0]
        ap = km.assign_clusters_plain(x, k_in[t], mask)[0]
        n_off, gap = _gap(x, k_in[t], ak, ap)
        out["rows_off"] += n_off
        out["off_gap"] = max(out["off_gap"], gap)
        ok = ak >= 0
        a = ak[ok].long()
        counts = torch.bincount(a, minlength=init.shape[0]).float()
        sums = torch.zeros_like(init).index_add_(0, a, x[ok])
        want = torch.where(counts[:, None] > 0,
                           sums / counts.clamp_min(1.0)[:, None], k_in[t])
        out["step_err"] = max(out["step_err"],
                              float((k_out[t] - want).abs().max()))
        if out["parted_at"] is None:
            a_run = km.assign_clusters_plain(x, p_in[t], mask)[0]
            n_off, gap = _gap(x, k_in[t], ak, a_run)
            if n_off:
                out["parted_at"], out["parting_gap"] = t, gap
            else:
                out["apart"] = max(out["apart"],
                                   float((k_out[t] - p_out[t]).abs().max()))
    return out


def lloyd_holds(res: dict, tol: float) -> bool:
    """The K6 run of :func:`lloyd_check` is right: each step within ``tol``
    of the plain step from its own inputs, every row sent apart at a tie,
    and the two runs' centroids within ``tol`` until they part."""
    return (res["step_err"] <= tol and res["apart"] <= tol
            and res["off_gap"] <= TIE and res["parting_gap"] <= TIE)


def _lloyd_runs(block, n=3000, d=16, c=40):
    g = torch.Generator().manual_seed(17)
    x = torch.randn(n, d, generator=g)
    mask = torch.arange(n) < n - 5
    init = x[:c].clone()
    logs = [], []
    a = km._lloyd_until(x, mask, init, 25, 1e-4, recording(block, logs[0]))
    b = km._lloyd_until(x, mask, init, 25, 1e-4,
                        recording(km.lloyd_block_plain, logs[1]))
    tol = 1e-5 * float(x.abs().max())
    return x, mask, init, logs, a, b, tol


def test_lloyd_check_holds_the_plain_run_to_itself():
    x, mask, init, logs, a, b, tol = _lloyd_runs(km.lloyd_block_plain)
    assert a.iterations == b.iterations > 5  # past one recorded block
    assert sum(all_c.shape[0] for _, all_c in logs[0]) >= a.iterations
    res = lloyd_check(x, mask, init, *logs, a.iterations)
    assert res == dict(step_err=0.0, rows_off=0, off_gap=0.0,
                       parted_at=None, parting_gap=0.0, apart=0.0)
    assert lloyd_holds(res, tol)


def test_lloyd_check_catches_a_step_off_the_plain_step():
    """A run whose centroids move 1e-3 off the plain step at the third
    step of each block fails."""
    def off(x, mask, cents, steps):
        all_c, errs = km.lloyd_block_plain(x, mask, cents, steps)
        if steps > 2:
            all_c = all_c.clone()
            all_c[2, 3, 0] += 1e-3
        return all_c, errs

    x, mask, init, logs, a, _, tol = _lloyd_runs(off)
    res = lloyd_check(x, mask, init, *logs, a.iterations)
    assert abs(res["step_err"] - 1e-3) < 1e-5
    assert not lloyd_holds(res, tol)


def test_gap_of_a_row_at_a_tie_and_off_one():
    """A row midway between two centroids is a tie (gap ~0); one nearer
    the first is not."""
    cents = torch.tensor([[1.0, 0.0], [-1.0, 0.0]])
    x = torch.tensor([[0.0, 2.0], [0.5, 2.0]])
    a, b = torch.tensor([0, 0]), torch.tensor([1, 1])
    assert _gap(x[:1], cents, a[:1], b[:1]) == (1, 0.0)
    n, gap = _gap(x, cents, a, b)
    assert n == 2 and gap == 2.0 / (4.25 + 1.0)
    assert _gap(x, cents, a, a) == (0, 0.0)
