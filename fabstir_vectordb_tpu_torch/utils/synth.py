"""Procedural corpus source: K17, a clustered-Gaussian corpus that any device
regenerates from its seed.

The JAX package's ``utils/synth.py`` draws its rows with ``jax.random``'s
threefry2x32 (partitionable bits); this module reproduces those streams in
integer PyTorch ops, so row r of block b holds the values the JAX package
gives for the same seed: the same key derivation (``key(seed)``, ``fold_in``,
``split``), the same 32-bit counters (element (r, j) of a block is drawn at
its flat index r * D + j, row r's center at r), the same uniform -> normal
map (sqrt(2) * erfinv, the single-precision Giles polynomial XLA uses) and
``randint``'s two-draw modular form. Assignments are exact; values agree to
a few f32 ulps (log1p and the polynomial's roundings differ between
libraries).

Block b: ``x = scale * N(0, I) + centers[randint(n_centers)]`` from
``fold_in(key(seed), b)`` split into (kz, ka); centers ``N(0, I)``
[n_centers, D] from ``key(seed ^ 0x5EED)``.

Because the draws are counter-based, any subset of a block's rows can be
made without the rest: :func:`synth_rows` takes row offsets or a row range.
On CUDA tensors it launches csrc/synth.cu (K17), on CPU tensors it takes its
plain version, :func:`synth_rows_plain`. A CUDA source makes its device
blocks and the bf16 serving mirror with the kernel, and its host blocks are
the kernel's f32 blocks copied to the host once; the JAX package computed
host blocks on its CPU backend instead, to spare a slow host link, which a
PCIe host does not have. A CPU source takes the plain version everywhere.

``VectorStore.attach_device_source`` registers a source; the reduced-rank
mirror build then generates its rows on the device instead of uploading
the host copy. ``spot_check`` guards that contract before attaching.
"""
from __future__ import annotations

import numpy as np
import torch

from . import native
from .device import resolve_device

# Fixed generation-block height: draws are tied to block boundaries, so it
# is part of the corpus identity (see ``tag``).
BLOCK_ROWS = 1 << 20

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's single-precision erfinv (M. Giles): w < 5 and w >= 5 branches
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = float(np.float32(np.sqrt(2.0)))
_UNIFORM_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


# ------------------------------------------------------------ threefry2x32
def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under
    ``key`` = (k0, k1) Python ints. x0, x1: int64 tensors holding uint32
    values; returns the two output words the same way."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _hash_words(key, hi: int, lo: int) -> tuple:
    y0, y1 = threefry2x32(key, torch.tensor([hi], dtype=torch.int64),
                          torch.tensor([lo], dtype=torch.int64))
    return int(y0[0]), int(y1[0])


def prng_key(seed: int) -> tuple:
    """``jax.random.key(seed)`` for a 32-bit seed: the words (0, seed)."""
    seed = int(seed)
    if not 0 <= seed < 1 << 31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    return (0, seed)


def fold_in(key, data: int) -> tuple:
    """``jax.random.fold_in``: threefry of the counter (0, data)."""
    return _hash_words(key, 0, int(data) & _M32)


def split(key, num: int = 2) -> list:
    """``jax.random.split`` (partitionable): key i is threefry of (0, i)."""
    return [_hash_words(key, 0, i) for i in range(num)]


def random_bits(key, counters: torch.Tensor) -> torch.Tensor:
    """32-bit partitionable bits at the flat indices ``counters`` (int64):
    the xor of threefry's two words of (counter >> 32, counter & 0xFFFFFFFF),
    as int64."""
    y0, y1 = threefry2x32(key, counters >> 32, counters & _M32)
    return y0 ^ y1


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to f32, as a fused multiply-add: the f32
    product is exact in f64, so only the sum rounds there first (a second
    rounding to f32 can differ from a true FMA only where the f64 sum lands
    on an f32 midpoint)."""
    return (a.double() * b.double() + c.double()).float()


def erfinv_giles(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erfinv, op for op: the polynomial's steps are fused
    multiply-adds, as XLA's CPU compiler contracts them."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    f32 = torch.float32

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=f32),
                           torch.tensor(_ERFINV_GE5[i], dtype=f32)).to(x.device)

    p = coef(0)
    for i in range(1, 9):
        p = fma(p, w, coef(i))
    out = p * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal``'s uniform in (-1, 1) (f32) from the top 23 of
    32 random bits."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(_UNIFORM_LO, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, f * 2.0 + lo)


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal``'s N(0, 1) draw in f32: sqrt(2) * erfinv(u)."""
    return torch.tensor(_SQRT2, dtype=torch.float32, device=bits.device) \
        * erfinv_giles(uniform_from_bits(bits))


def randint_from_bits(higher: torch.Tensor, lower: torch.Tensor,
                      span: int) -> torch.Tensor:
    """``jax.random.randint(.., 0, span)``'s modular form over two 32-bit
    draws, in uint32 arithmetic: ((hi % s) * m + lo % s) % s with
    m = (2**16 % s)**2 % s, each product
    wrapping at 2**32."""
    span = max(int(span), 1)
    mult = (((1 << 16) % span) ** 2 & _M32) % span
    off = (((higher % span) * mult) & _M32) + (lower % span)
    return ((off & _M32) % span).to(torch.int32)


# -------------------------------------------------------- K17 and its plain
def synth_rows_plain(kz, ka, rows, dim: int, centers=None, scale: float = 1.0,
                     dtype=torch.float32):
    """Plain version of K17: the rows at block offsets ``rows`` (int64
    tensor; its device is the output's) of a block drawn from (kz, ka).
    ``centers`` None: the normal draws themselves (how the centers are
    made). Else ``scale * z + centers[assign]``, with assign drawn from ka's
    two subkeys. Returns (values [n, dim] of ``dtype``, assign [n] int32 or
    None)."""
    rows = rows.to(torch.int64)
    cols = torch.arange(dim, dtype=torch.int64, device=rows.device)
    bits = random_bits(kz, rows[:, None] * dim + cols[None, :])
    if centers is None:
        return normal_from_bits(bits).to(dtype), None
    k_hi, k_lo = ka
    assign = randint_from_bits(random_bits(k_hi, rows),
                               random_bits(k_lo, rows), centers.shape[0])
    # XLA folds sqrt(2) * scale into one f32 constant and fuses the
    # product with the center's add: fma(erfinv(u), that constant, center)
    k = torch.tensor(_scaled_sqrt2(scale), dtype=torch.float32,
                     device=rows.device)
    e = erfinv_giles(uniform_from_bits(bits))
    return fma(e, k, centers[assign.long()]).to(dtype), assign


def _scaled_sqrt2(scale: float) -> float:
    return float(np.float32(np.float32(_SQRT2) * np.float32(scale)))


def synth_rows(kz, ka, rows, dim: int, centers=None, scale: float = 1.0,
               dtype=torch.float32, device=None, out=None):
    """K17 (the reference's ``_gen_fn`` block program and ``_centers``):
    ``rows`` is a ``range`` of block offsets or an int tensor of them;
    ``device`` is where they are made (a tensor's own by default). ``out``
    (optional) is a contiguous [n, dim] tensor of ``dtype`` to write, such
    as a slice of a mirror. ``ka`` is the pair of randint subkeys. Returns
    (values, assign) as :func:`synth_rows_plain` does. The plain version
    on the CPU, csrc/synth.cu on the card."""
    if device is None:
        device = rows.device if isinstance(rows, torch.Tensor) else \
            centers.device
    device = torch.device(device)
    if device.type == "cpu":
        idx = torch.arange(rows.start, rows.stop, dtype=torch.int64) \
            if isinstance(rows, range) else rows.cpu()
        vals, assign = synth_rows_plain(kz, ka, idx, dim, centers, scale,
                                        dtype)
        if out is not None:
            out.copy_(vals)
            vals = out
        return vals, assign
    if device.index is None:  # "cuda" names the current card
        device = torch.device("cuda", torch.cuda.current_device())
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K17 writes f32 or bf16, got {dtype}")
    if isinstance(rows, range):
        if rows.step != 1 or rows.start < 0:
            raise ValueError("a row range must be contiguous and >= 0")
        n, row_lo, rows_ptr = len(rows), rows.start, 0
    else:
        native.check(rows, "rows", torch.int32, 1, device)
        n, row_lo, rows_ptr = rows.shape[0], 0, rows.data_ptr()
    if out is None:
        out = torch.empty((n, dim), dtype=dtype, device=device)
    native.check(out, "out", dtype, 2, device)
    if out.shape != (n, dim):
        raise ValueError(f"out must be [{n}, {dim}], got {tuple(out.shape)}")
    assign = None
    if centers is not None:
        native.check(centers, "centers", torch.float32, 2, device)
        if centers.shape[1] != dim:
            raise ValueError("centers do not fit dim")
        assign = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return out, assign
    P, I, L, U, F = native.P, native.I, native.L, native.U, native.F
    k_hi, k_lo = ka if centers is not None else ((0, 0), (0, 0))
    native.call(
        "synth", "fvdb_synth_rows",
        [U, U, U, U, U, U, P, L, I, I, I, F, P, P, P, I, P],
        kz[0], kz[1], k_hi[0], k_hi[1], k_lo[0], k_lo[1], rows_ptr, row_lo,
        n, dim, 0 if centers is None else centers.shape[0],
        _scaled_sqrt2(scale), 0 if centers is None else centers.data_ptr(),
        0 if assign is None else assign.data_ptr(), out.data_ptr(),
        int(dtype == torch.bfloat16), native.stream_of(out))
    native.launches["synth_rows"] += 1
    return out, assign


# ----------------------------------------------------------------- source
class SyntheticCorpusSource:
    """Clustered-Gaussian corpus, regenerable on any device from its seed
    (the JAX package's class, with ``device``: None means the card)."""

    def __init__(self, seed: int, dim: int, n_centers: int = 4096,
                 scale: float = 0.35, block_rows: int = BLOCK_ROWS,
                 device=None):
        self.seed = int(seed)
        self.dim = int(dim)
        self.n_centers = int(n_centers)
        self.scale = float(scale)
        self.block_rows = int(block_rows)
        self.device = resolve_device(device)
        prng_key(self.seed)  # validates the seed
        self._centers_dev = None

    @property
    def tag(self) -> str:
        """Corpus identity string (the JAX package's, character for
        character)."""
        return (f"synthv1-s{self.seed}-d{self.dim}-c{self.n_centers}"
                f"-sc{self.scale:g}-b{self.block_rows}")

    def block_keys(self, blk_idx: int):
        """(kz, (k_hi, k_lo)): the normal draws' key and randint's two
        subkeys of block ``blk_idx``."""
        kz, ka = split(fold_in(prng_key(self.seed), int(blk_idx)))
        k_hi, k_lo = split(ka)
        return kz, (k_hi, k_lo)

    def centers(self) -> torch.Tensor:
        """[n_centers, dim] f32 on the source's device, made once."""
        if self._centers_dev is None:
            key = prng_key(self.seed ^ 0x5EED)
            self._centers_dev = synth_rows(
                key, None, range(0, self.n_centers), self.dim,
                device=self.device)[0]
        return self._centers_dev

    def rows(self, blk_idx: int, offsets, dtype=torch.float32,
             out=None):
        """(values, assign) of block ``blk_idx`` at ``offsets`` (a range or
        an array of block offsets), made on the source's device."""
        if not isinstance(offsets, range):
            offsets = torch.as_tensor(np.asarray(offsets), dtype=torch.int32) \
                .to(self.device)
        kz, ka = self.block_keys(blk_idx)
        return synth_rows(kz, ka, offsets, self.dim, self.centers(),
                          self.scale, dtype, device=self.device, out=out)

    def device_block(self, blk_idx: int, dtype=None) -> torch.Tensor:
        """One [block_rows, dim] block on the source's device (f32, or
        ``dtype``)."""
        return self.rows(blk_idx, range(0, self.block_rows),
                         dtype or torch.float32)[0]

    def host_block(self, blk_idx: int) -> np.ndarray:
        """The same block as float32 numpy: the f32 device block copied to
        the host once."""
        return self.device_block(blk_idx).cpu().numpy()

    def mirror_bf16(self, n_rows: int) -> torch.Tensor:
        """The [n_rows, dim] bf16 serving mirror, each block written by K17
        straight into its rows of one preallocated tensor. Rows past the
        caller's corpus count are more synthetic rows; callers mask them
        out as they do padding."""
        n_rows = int(n_rows)
        mirror = torch.empty((n_rows, self.dim), dtype=torch.bfloat16,
                             device=self.device)
        for lo in range(0, n_rows, self.block_rows):
            hi = min(lo + self.block_rows, n_rows)
            self.rows(lo // self.block_rows, range(0, hi - lo),
                      torch.bfloat16, out=mirror[lo:hi])
        return mirror

    def spot_check(self, data: np.ndarray, rows: np.ndarray,
                   ulp_frac: float = 0.02) -> bool:
        """True iff ``data[rows]`` is this source's rows to within bf16
        storage rounding: at most ``ulp_frac`` of elements one bf16 ulp
        apart, none further. Makes only the probed rows; gate
        ``attach_device_source`` on it."""
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return True
        by_block: dict[int, list] = {}
        for r in rows:
            by_block.setdefault(int(r) // self.block_rows, []).append(int(r))
        bad = total = 0
        for blk_idx, rs in by_block.items():
            offs = np.asarray(rs) - blk_idx * self.block_rows
            got = _bf16_bits(self.rows(blk_idx, offs)[0].cpu())
            want = _bf16_bits(torch.from_numpy(
                np.ascontiguousarray(data[np.asarray(rs)], np.float32)))
            diff = got != want
            bad += int(diff.sum())
            total += int(diff.size)
            # a differing element must be exactly one bf16 ulp away: map the
            # patterns to a total order (negatives reflected below 0x8000,
            # +0 and -0 both at 0x8000) and require adjacency there
            if diff.any() and (np.abs(_bf16_order(got[diff])
                                      - _bf16_order(want[diff])) > 1).any():
                return False
        return bad <= ulp_frac * max(total, 1)


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    """uint16 bit patterns of f32 (or bf16) values rounded to bf16."""
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _bf16_order(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.int32)
    return np.where(u & 0x8000, 0x8000 - (u & 0x7FFF), 0x8000 + u)
