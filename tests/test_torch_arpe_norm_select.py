"""What the rewritten ARPE and row-norm kernels rest on, on the CPU.

``arpe_tokens`` (csrc/arpe_tokens.cu) no longer counts a row 30 times: it
finds v_k, the row's k-th smallest distance, by one exact radix
selection, and replays the 30 bisection steps with ``v_k <= mid`` in
place of ``count(d2 <= mid) >= k``. The two agree for any real values:
the count reaches k exactly when v_k <= mid. The tests here hold that
identity against ``arpe_tokens_ref``'s thresholds (held against JAX's
Pallas ``arpe_tokens`` in tests/test_torch_pct_kernels.py), on clouds
with points tied past the k-th distance, near-duplicates (negative
distances from rounding) and piles of more than 32 equal distances, at
N = 1, 33, 200 and 1024 and k = 1, 64 and N: v_k from ``torch.kthvalue``
replayed in fp32 gives the plain version's threshold bit for bit on every
row. A numpy copy of the kernel's selection (the 16-bit linear key, then
the fp32 value's order-preserving bits, 8 bits a pass, compaction once a
digit holds at most 32 values) finds the same v_k, and the cases reach
each of its exits.

The row norms (csrc/norm_rows.cu) keep their plain versions: with a row
mask, ``norm_rows_ref`` (one-pass statistics) and ``ln_rows_ref``
(two passes) are held against JAX's ``_ln_f32_rows`` and two-pass LN at
the widths the kernel's chunk count changes over (128, 200, 384, 768,
1024), fp32 out within 1e-5 (both take fp32 sums, in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peekvit_tpu.ops.pallas import fused_attention as jfa
from peekvit_tpu.ops.pallas import fused_attention_vjp as jvjp
from peekvit_torch.ops.cuda import fused_attention as tfa
from peekvit_torch.ops.cuda import pct_embed as tpe

BATCH = 2
SLOTS = 1024          # the kernel's slots a row: 32 lanes x 32, +inf past N
MAX_CANDIDATES = 32   # the kernel compacts a digit of at most this many values
CASES = [(n, k) for n in (1, 33, 200, 1024) for k in sorted({1, 64, n}) if k <= n]
KINDS = ("normal", "tied", "near", "piled")


def _cloud(kind: str, n: int) -> np.ndarray:
    """(BATCH, n, 3) fp32 points. tied: each point three times (rows tie
    past k); near: each point beside two copies moved by ~1e-7 (negative
    distances from rounding); piled: each point 40 times (more than 32
    equal distances)."""
    rng = np.random.default_rng(1009 * n + KINDS.index(kind))
    pts = rng.normal(size=(BATCH, n, 3)).astype(np.float32)
    if kind == "tied":
        pts = np.repeat(pts[:, :(n + 2) // 3], 3, axis=1)[:, :n]
    elif kind == "near":
        pts = np.repeat(pts[:, :(n + 2) // 3], 3, axis=1)[:, :n]
        pts = pts * (1.0 + rng.normal(size=pts.shape) * 1e-7).astype(np.float32)
    elif kind == "piled":
        pts = np.repeat(pts[:, :(n + 39) // 40], 40, axis=1)[:, :n]
    return np.ascontiguousarray(pts, dtype=np.float32)


def _pack(d: int = 16):
    rng = np.random.default_rng(7)
    return tuple(torch.from_numpy((rng.normal(size=s) * 0.3).astype(np.float32))
                 for s in ((3, 6), (3, 6), (6,), (6, d), (d,)))


def _d2(points: torch.Tensor) -> torch.Tensor:
    """The (B, N, N) distances as arpe_tokens_ref forms them."""
    p = points.float()
    x, y, z = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    sq = x * x + y * y + z * z
    xt, yt, zt = (c.transpose(1, 2) for c in (x, y, z))
    return (sq + sq.transpose(1, 2)) - 2.0 * (x * xt + y * yt + z * zt)


def _replay(vk: torch.Tensor, rowmax: torch.Tensor) -> torch.Tensor:
    """The 30 bisection steps in fp32, each decided by v_k <= mid."""
    lo, hi = torch.zeros_like(rowmax), rowmax.clone()
    for _ in range(tpe.BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ge = vk <= mid
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    return hi


# ----------------------------------------------- the kernel's selection, in numpy


def _key16(v: np.ndarray, inv: np.float32) -> np.ndarray:
    """round(sat(v * inv) * 65535) as the kernel forms it: an fp32 product,
    saturated, then one fused multiply-add with 2^23 (exact in float64,
    rounded once), whose low mantissa bits are the key."""
    t = np.clip(v * inv, np.float32(0), np.float32(1))
    fused = (t.astype(np.float64) * 65535.0 + 8388608.0).astype(np.float32)
    return fused.view(np.int32) - 0x4B000000


def _fkey(v: np.ndarray) -> np.ndarray:
    b = v.view(np.uint32)
    return np.where(b >> 31, ~b, b | np.uint32(0x80000000)).astype(np.uint32)


def _pick(digits: np.ndarray, rank: int):
    """The digit holding the rank-th smallest member, the members below
    it, and its count (the kernel's histogram and warp scan)."""
    hist = np.bincount(digits, minlength=256)
    cum = np.cumsum(hist)
    if cum[-1] < rank:
        return None
    d = int(np.searchsorted(cum, rank))
    return d, int(cum[d] - hist[d]), int(hist[d])


def _kernel_select(slots: np.ndarray, rowmax: np.float32, k: int):
    """v_k of one row's 1024 slots as the kernel selects it, and the exit
    taken: "linear0" / "linear1" (compacted after the linear key's first
    or second digit), "bits<shift>" (after a digit of the value's bits),
    "one value" (every member shares all bits), "short" (fewer than k)."""
    member = ~np.isnan(slots)
    rank = k
    linear = bool(rowmax > 0) and bool(np.isfinite(rowmax))
    if linear:
        inv = np.float32(1.0) / rowmax
        key = _key16(slots, inv)
        picked = _pick(key[member] >> 8, rank)
        if picked is None:
            return np.float32(np.nan), "short"
        top, below, count = picked
        rank -= below
        member &= (key >> 8) == top
        if count <= MAX_CANDIDATES:
            return np.sort(slots[member])[rank - 1], "linear0"
        low, below, count = _pick(key[member] & 0xFF, rank)
        rank -= below
        member &= (key & 0xFF) == low
        if count <= MAX_CANDIDATES:
            return np.sort(slots[member])[rank - 1], "linear1"
    fk = _fkey(slots)
    prefix = 0
    for shift in (24, 16, 8, 0):
        picked = _pick(((fk[member] >> shift) & 0xFF).astype(np.int64), rank)
        if picked is None:
            return np.float32(np.nan), "short"
        digit, below, count = picked
        rank -= below
        prefix = (prefix << 8) | digit
        member &= (fk >> shift) == prefix
        if count <= MAX_CANDIDATES:
            return np.sort(slots[member])[rank - 1], f"bits{shift}"
    return slots[member][0], "one value"


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,k", CASES)
def test_kth_distance_replays_the_bisection(n, k, kind):
    """v_k (torch.kthvalue of each row's distances) replayed through the
    30 steps is arpe_tokens_ref's threshold on every row, bit for bit, and
    the neighbour count is the count of distances up to it."""
    points = torch.from_numpy(_cloud(kind, n))
    _, thr, cnt = tpe.arpe_tokens_ref(points, *_pack(), k, knn_stats=True)
    d2 = _d2(points)
    vk = torch.kthvalue(d2, k, dim=-1).values
    hi = _replay(vk, d2.amax(-1))
    assert torch.equal(hi, thr)
    assert torch.equal((d2 <= hi[..., None]).sum(-1).to(torch.int32), cnt)
    assert (cnt >= k).all()
    if kind in ("tied", "piled") and n >= 33 and k < n:
        assert (cnt > k).any()  # rows tie past k
    if kind == "near" and n == 1024:
        assert (d2 < 0).any()   # rounding gives negative distances


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,k", CASES)
def test_kernel_selection_finds_the_kth_distance(n, k, kind):
    """The kernel's selection, in numpy over the row's 1024 slots (+inf
    past N), finds torch.kthvalue's v_k on every row; the piled clouds go
    past the linear key to the value's bits, and a cloud of one point to
    the bits at once (its largest distance is 0)."""
    d2 = _d2(torch.from_numpy(_cloud(kind, n)))
    want = torch.kthvalue(d2, k, dim=-1).values.numpy()
    rows = d2.numpy().reshape(-1, n)
    slots = np.full((rows.shape[0], SLOTS), np.inf, np.float32)
    slots[:, :n] = rows
    exits = set()
    for r in range(rows.shape[0]):
        got, exit_ = _kernel_select(slots[r], rows[r].max(), k)
        assert got == want.reshape(-1)[r], (r, exit_)
        exits.add(exit_)
    if n == 1:
        assert exits == {"bits24"}
    elif kind == "piled" and k < n:
        assert exits - {"linear0", "linear1"}, exits
    elif kind == "normal" and n == 1024:
        assert "linear0" in exits


def test_kernel_selection_edges():
    """Rows the clouds above do not reach: every distance 0 (one value
    after all four digits of the bits), NaN slots (never counted) and
    fewer non-NaN values than k (v_k is NaN, so every step keeps hi)."""
    zeros = np.zeros(SLOTS, np.float32)
    assert _kernel_select(zeros, np.float32(0), 64) == (np.float32(0), "one value")
    row = np.random.default_rng(3).random(SLOTS).astype(np.float32)
    row[::2] = np.nan
    want = np.sort(row[~np.isnan(row)])[63]
    assert _kernel_select(row, np.nanmax(row), 64)[0] == want
    vk, exit_ = _kernel_select(row, np.nanmax(row), SLOTS)
    assert np.isnan(vk) and exit_ == "short"
    hi = _replay(torch.tensor([float(vk)]), torch.tensor([float(np.nanmax(row))]))
    assert hi.item() == np.float32(np.nanmax(row))


# ------------------------------------------------------------------ row norms

WIDTHS = (128, 200, 384, 768, 1024)


@functools.lru_cache(maxsize=None)
def _jax_masked_norms(d: int):
    """One jitted function per width: mask * _ln_f32_rows (one pass) and
    mask * the two-pass LN (fused_attention_vjp._ln_f32), in fp32."""

    @jax.jit
    def norms(x, s, b, m):
        one = jfa._ln_f32_rows(x, s[None], b[None], 1e-6) * m[:, None]
        two = jvjp._ln_f32(x, s, b, 1e-6)[0] * m[:, None]
        return one, two

    return norms


@pytest.mark.parametrize("which", ("norm_rows", "ln_rows"))
@pytest.mark.parametrize("d", WIDTHS)
def test_masked_row_norms_against_jax(d, which):
    """norm_rows_ref (one pass) and ln_rows_ref (two passes) with the
    affine and a row mask of zeros and fractions against JAX's, fp32 out;
    on CPU tensors the wrappers are the plain versions, with no launch."""
    rng = np.random.default_rng(d)
    rows = 37
    x = (rng.normal(size=(rows, d)) * 1.5 + 0.3).astype(np.float32)
    s = (1.0 + rng.normal(size=d) * 0.2).astype(np.float32)
    b = (rng.normal(size=d) * 0.1).astype(np.float32)
    m = (rng.random(rows) * (rng.random(rows) > 0.3)).astype(np.float32)
    one, two = _jax_masked_norms(d)(*(jnp.asarray(a) for a in (x, s, b, m)))
    t = [torch.from_numpy(a) for a in (x, s, b, m)]
    tfa.reset_launch_counts()
    if which == "norm_rows":
        got, want = tfa.norm_rows(t[0], 1e-6, torch.float32, *t[1:]), one
        assert torch.equal(got, tfa.norm_rows_ref(t[0], 1e-6, torch.float32, *t[1:]))
    else:
        got, want = tfa.ln_rows(*t[:3], 1e-6, mask=t[3]), two
        assert torch.equal(got, tfa.ln_rows_ref(*t[:3], 1e-6, mask=t[3]))
    assert tfa.LAUNCHES == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert (got.numpy()[m == 0] == 0).all()
