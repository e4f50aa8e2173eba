"""Shard-count-independent persistence for multi-shard state (the JAX
package's ``parallel/persistence.py``, in its format).

Save writes ONE CBOR blob per shard (``<prefix>/shards/shard-%04d.cbor``)
and a JSON manifest of the geometry (``<prefix>/sharded_manifest.json``);
on a :class:`~.mesh.DistMesh` each rank writes its own shards and rank 0
the manifest after a barrier. Load reassembles and re-shards onto ANY mesh
size: padding is append-only (masked rows at the flat tail, invalid
clusters at the IVF tail), so global row and cluster identity is the same
at every shard count. The keys, blobs and manifest are the JAX package's,
byte for byte, so a save made by either package loads in the other.

The IVF blob holds the padded lists (``[C_local, L_pad, D]`` vectors, row
ids and validity), built on the host from a shard's packed lists at save
time and packed again at load: the device never holds the padding.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..cbor import codec
from ..core.object_store import ObjectStore
from ..utils.padding import round_up
from ..utils.transfer import to_device
from .sharded import ShardedIVFState, _ivf_state, _pack_shard

MANIFEST_VERSION = 1


class ShardedPersistenceError(RuntimeError):
    pass


def _load_manifest(store: ObjectStore, prefix: str, kind: str) -> dict:
    man = json.loads(store.get(f"{prefix}/sharded_manifest.json"))
    if man.get("version", 0) > MANIFEST_VERSION:
        raise ShardedPersistenceError(
            f"manifest version {man['version']} is newer than supported "
            f"{MANIFEST_VERSION}"
        )
    if man.get("kind") != kind:
        raise ShardedPersistenceError(
            f"expected kind={kind!r}, found {man.get('kind')!r}"
        )
    return man


def _key(prefix: str, i: int) -> str:
    return f"{prefix}/shards/shard-{i:04d}.cbor"


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# --------------------------------------------------------------- flat corpus
def save_sharded_flat(store: ObjectStore, prefix: str, x, x_sq, mask, mesh,
                      axis: str = "data") -> None:
    """Persist a row-sharded flat corpus (as ``sharded_flat_search`` takes
    it): one blob for each of the mesh's shards of ``axis`` ({"x" f32,
    "x_sq" f32, "mask" u8} of its rows) + the manifest. x may be f32 or
    bf16 (stored as f32, its dtype in the manifest). PyTorch tensors carry
    no sharding, so the mesh is an argument here."""
    n, d = int(x.shape[0]), int(x.shape[1])
    sl = mesh.shard_slices(n, axis)
    for i in mesh.shards(axis):
        store.put(_key(prefix, i), codec.dumps({
            "x": _host(x[sl[i]].float() if isinstance(x, torch.Tensor)
                       else x[sl[i]]).astype(np.float32),
            "x_sq": _host(x_sq[sl[i]]).astype(np.float32),
            "mask": _host(mask[sl[i]]).astype(np.uint8),
        }))
    mesh.barrier()
    if mesh.rank != 0:
        return
    dtype = "bfloat16" if getattr(x, "dtype", None) == torch.bfloat16 \
        else "float32"
    shards = [{"key": _key(prefix, i), "lo": int(s.start), "hi": int(s.stop)}
              for i, s in enumerate(sl)]
    store.put(f"{prefix}/sharded_manifest.json", json.dumps({
        "version": MANIFEST_VERSION, "kind": "flat",
        "dim": d, "n_rows": n, "dtype": dtype, "shards": shards,
    }).encode())


def load_sharded_flat(store: ObjectStore, prefix: str, mesh,
                      axis: str = "data"):
    """Load a flat corpus saved with ANY shard count onto ``mesh``.

    Returns (x, x_sq, mask) tensors on the mesh's device, N padded up to a
    multiple of the axis size with mask=False rows; x is bf16 where the
    save was. Rows keep their global indices."""
    man = _load_manifest(store, prefix, "flat")
    n, d = man["n_rows"], man["dim"]
    n_pad = round_up(n, mesh.shape[axis])
    x = np.zeros((n_pad, d), np.float32)
    x_sq = np.zeros(n_pad, np.float32)
    mask = np.zeros(n_pad, bool)
    for sh in man["shards"]:
        obj = codec.loads(store.get(sh["key"]))
        lo, hi = sh["lo"], sh["hi"]
        x[lo:hi] = obj["x"]
        x_sq[lo:hi] = obj["x_sq"]
        mask[lo:hi] = obj["mask"].astype(bool)
    xd = to_device(x, mesh.device)
    if man["dtype"] == "bfloat16":
        xd = xd.to(torch.bfloat16)
    return xd, to_device(x_sq, mesh.device), to_device(mask, mesh.device)


# ----------------------------------------------------------------- IVF tiles
def _padded_shard(state: ShardedIVFState, s: int) -> dict:
    """Shard s's blob: its lists padded to the state's L_pad, as the
    reference keeps them (a padding slot holds ``pad_row`` in a real
    cluster and zeros in a padding cluster, row -1, invalid)."""
    sh = state.shards[s]
    d = state.pad_row.shape[0]
    real = max(0, min(sh.c_local, state.n_clusters - sh.c_lo))
    vecs = np.zeros((sh.c_local, state.l_pad, d), np.float32)
    vecs[:real] = state.pad_row
    rows = np.full((sh.c_local, state.l_pad), -1, np.int32)
    valid = np.zeros((sh.c_local, state.l_pad), np.uint8)
    lens = _host(sh.lists.list_len).astype(np.int64)
    cl = np.repeat(np.arange(sh.c_local), lens)
    vecs[cl, sh.slots] = _host(sh.x)
    rows[cl, sh.slots] = _host(sh.rows)
    valid[cl, sh.slots] = _host(sh.valid)
    return {"list_vecs": vecs, "list_rows": rows, "list_valid": valid}


def save_sharded_ivf(store: ObjectStore, prefix: str,
                     state: ShardedIVFState) -> None:
    """Persist cluster-sharded IVF state: per-shard self-contained blobs
    (list vectors + global row ids + validity) so a loader never needs the
    original corpus, plus the real (unpadded) centroids."""
    mesh, axis = state.mesh, state.axis
    c_pad = state.c_pad
    c_local = c_pad // mesh.shape[axis]
    for s in sorted(state.shards):
        store.put(_key(prefix, s), codec.dumps(_padded_shard(state, s)))
    mesh.barrier()
    if mesh.rank != 0:
        return
    cents = _host(state.centroids)[: state.n_clusters]
    store.put(f"{prefix}/centroids.cbor",
              codec.dumps({"centroids": cents.astype(np.float32)}))
    shards = [{"key": _key(prefix, i), "lo": i * c_local,
               "hi": (i + 1) * c_local} for i in range(mesh.shape[axis])]
    store.put(f"{prefix}/sharded_manifest.json", json.dumps({
        "version": MANIFEST_VERSION, "kind": "ivf",
        "dim": int(state.pad_row.shape[0]), "l_pad": int(state.l_pad),
        "c_pad": int(c_pad), "n_clusters": int(state.n_clusters),
        "shards": shards,
    }).encode())


def load_sharded_ivf(store: ObjectStore, prefix: str, mesh,
                     axis: str = "data") -> ShardedIVFState:
    """Load IVF state saved with ANY shard count onto ``mesh``: each shard
    this process holds reads the blobs of its clusters and packs them.
    Clusters keep their global ids; padding clusters are derived again for
    the new shard count."""
    man = _load_manifest(store, prefix, "ivf")
    c_real, l_pad, d = man["n_clusters"], man["l_pad"], man["dim"]
    cents_real = codec.loads(store.get(f"{prefix}/centroids.cbor"))["centroids"]
    if cents_real.shape[0] != c_real:
        raise ShardedPersistenceError(
            f"centroid count {cents_real.shape[0]} != n_clusters {c_real}"
        )
    c_local = round_up(c_real, mesh.shape[axis]) // mesh.shape[axis]
    pad_row = None
    blobs = {}
    shards = {}
    for s in mesh.shards(axis):
        lo, hi = s * c_local, min((s + 1) * c_local, c_real)
        parts = []  # (local list, slot, row, vec, valid) of each old shard
        for sh in man["shards"]:
            a, b = sh["lo"], min(sh["hi"], c_real)  # drop old padding
            if b <= max(a, lo) or a >= hi:
                continue
            if sh["key"] not in blobs:
                blobs[sh["key"]] = codec.loads(store.get(sh["key"]))
            obj = blobs[sh["key"]]
            take = slice(max(a, lo) - a, min(b, hi) - a)
            rows = obj["list_rows"][take]
            cl, slot = np.nonzero(rows >= 0)
            if pad_row is None:
                free = np.nonzero(rows < 0)
                if free[0].size:
                    pad_row = obj["list_vecs"][take][free[0][0], free[1][0]]
            parts.append((cl + max(a, lo) - lo, slot, rows[cl, slot],
                          obj["list_vecs"][take][cl, slot],
                          obj["list_valid"][take][cl, slot].astype(bool)))
        if parts:
            cl, slot, rows, vecs, valid = (np.concatenate(z)
                                           for z in zip(*parts))
            order = np.argsort(cl, kind="stable")
            cl, slot, rows, vecs, valid = (a[order] for a in (
                cl, slot, rows, vecs, valid))
        else:
            cl = slot = rows = np.zeros(0, np.int64)
            vecs = np.zeros((0, d), np.float32)
            valid = np.zeros(0, bool)
        shards[s] = _pack_shard(mesh.device, lo, c_local, cl, slot, rows,
                                vecs, valid)
    if pad_row is None:
        pad_row = np.zeros(d, np.float32)
    return _ivf_state(mesh, axis, np.asarray(cents_real, np.float32), c_real,
                      l_pad, pad_row, shards)
