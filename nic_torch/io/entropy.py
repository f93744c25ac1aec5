"""Entropy-coding layer: quantized CDF tables and rANS bitstreams (a copy
of ``nic.io.entropy``, which imports only numpy).

Turns the hyperprior's learned priors (``nic_torch.models.hyperprior``)
into host-side bitstreams, and codes the grids of an entropy-coded NTC
artifact. The coder the program runs is the C++ rANS of
``nic_torch/native/rans.cpp`` (``nic_torch.native``); the pure-Python
coders here run the same state machines and are its plain versions: the
tests hold the native coder's bytes to them, and the program never calls
them.

Pipeline (scale-hyperprior): ŷ symbols → Gaussian CDFs from a log-spaced
σ bin table (CompressAI-style scale table); ẑ symbols → per-channel
logistic CDFs. Alphabets are sized from the observed symbol range and
stored in the header, so coding is lossless w.r.t. the quantized latents.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "quantize_pmf",
    "gaussian_cdf_table",
    "logistic_cdf_table",
    "scale_bin_indices",
    "rans_encode_py",
    "rans_decode_py",
    "rans_encode_ilv_py",
    "rans_decode_ilv_py",
    "rans_encode_ilv3_py",
    "rans_decode_ilv3_py",
    "SCALE_MIN",
    "SCALE_MAX",
    "NUM_SCALE_BINS",
]

PROB_BITS = 16
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 23

SCALE_MIN = 0.11
SCALE_MAX = 64.0
NUM_SCALE_BINS = 64


def scale_table() -> np.ndarray:
    """Log-spaced σ bins (the standard scale-hyperprior table)."""
    return np.exp(
        np.linspace(math.log(SCALE_MIN), math.log(SCALE_MAX), NUM_SCALE_BINS)
    )


def scale_bin_indices(scales: np.ndarray) -> np.ndarray:
    """Each σ → index of the smallest table entry ≥ σ (conservative bin).

    The table is log-spaced, so the search is closed-form arithmetic
    (np.searchsorted measured ~10× slower at hyperprior latent sizes)."""
    ln_min = math.log(SCALE_MIN)
    step = (math.log(SCALE_MAX) - ln_min) / (NUM_SCALE_BINS - 1)
    with np.errstate(divide="ignore"):  # σ≤0 → bin 0 via the clip
        idx = np.ceil((np.log(np.asarray(scales, np.float64)) - ln_min) / step)
    return idx.clip(0, NUM_SCALE_BINS - 1).astype(np.int32)


def quantize_pmf(pmf: np.ndarray) -> np.ndarray:
    """float pmf row → int32 CDF row summing to exactly 2^16, every symbol
    frequency ≥ 1 (so any symbol stays decodable).

    The drift fix walks symbols cyclically in descending-frequency order,
    ±1 per visit where the result stays ≥ 1. Implemented as vectorized
    whole-cycle updates — BIT-IDENTICAL to the original per-step loop
    (same np.argsort tie order), which persisted entropy-coded artifacts
    rebuild their CDFs with (the artifact loader, ``nic_torch.io.artifacts``)."""
    pmf = np.maximum(np.asarray(pmf, np.float64), 1e-12)
    pmf = pmf / pmf.sum()
    freqs = np.maximum(np.round(pmf * PROB_SCALE).astype(np.int64), 1)
    drift = PROB_SCALE - freqs.sum()
    order = np.argsort(-freqs)
    if drift > 0:
        # every symbol is eligible for +1: whole cycles, then a prefix
        q, r = divmod(drift, len(freqs))
        freqs[order] += q
        freqs[order[:r]] += 1
    else:
        deficit = -drift
        while deficit > 0:
            elig = order[freqs[order] > 1]
            take = elig[:deficit]
            freqs[take] -= 1
            deficit -= len(take)
    cdf = np.zeros(len(freqs) + 1, np.int32)
    cdf[1:] = np.cumsum(freqs)
    return cdf


def _std_normal_cdf(x):
    v = np.asarray(x, np.float64)
    try:  # vectorized erf is ~100× np.vectorize
        from scipy.special import ndtr

        return ndtr(v)
    except ImportError:  # pragma: no cover - scipy is in the base image
        from math import erf, sqrt

        return 0.5 * (1.0 + np.vectorize(lambda t: erf(t / sqrt(2.0)))(v))


def _interval_pmf_rows(upper: np.ndarray, lower: np.ndarray) -> np.ndarray:
    """[rows, S] CDF-difference pmfs with the open tails folded into the
    edge symbols (shared by the gaussian and logistic table builders)."""
    pmf = upper - lower
    pmf[:, 0] += lower[:, 0]
    pmf[:, -1] += 1.0 - upper[:, -1]
    return np.stack([quantize_pmf(row) for row in pmf])


_GAUSSIAN_TABLE_CACHE: dict[int, np.ndarray] = {}


def gaussian_cdf_table(max_abs: int) -> np.ndarray:
    """int32 [NUM_SCALE_BINS, 2*max_abs+2] CDF table for symbols
    v ∈ [-max_abs, max_abs] under N(0, σ_bin²); edge symbols absorb tails.

    Cached per ``max_abs`` — the table depends on nothing else, and its
    build cost (erf over bins × alphabet) would otherwise dominate the
    host decode path."""
    max_abs = int(max_abs)
    hit = _GAUSSIAN_TABLE_CACHE.get(max_abs)
    if hit is not None:
        return hit
    vs = np.arange(-max_abs, max_abs + 1, dtype=np.float64)
    sig = scale_table()[:, None]
    table = _interval_pmf_rows(
        _std_normal_cdf((vs[None, :] + 0.5) / sig),
        _std_normal_cdf((vs[None, :] - 0.5) / sig),
    )
    if len(_GAUSSIAN_TABLE_CACHE) > 8:
        _GAUSSIAN_TABLE_CACHE.clear()
    _GAUSSIAN_TABLE_CACHE[max_abs] = table
    return table


def logistic_cdf_table(mu: np.ndarray, log_s: np.ndarray, max_abs: int) -> np.ndarray:
    """int32 [channels, 2*max_abs+2] CDF table for the factorized z prior
    (per-channel logistic(μ_c, s_c), matching the model's ``logistic_bits``)."""
    vs = np.arange(-max_abs, max_abs + 1, dtype=np.float64)[None, :]
    s = np.exp(np.asarray(log_s, np.float64))[:, None]
    mu = np.asarray(mu, np.float64)[:, None]
    with np.errstate(over="ignore"):  # saturating tails are folded anyway
        upper = 1.0 / (1.0 + np.exp(-((vs + 0.5 - mu) / s)))
        lower = 1.0 / (1.0 + np.exp(-((vs - 0.5 - mu) / s)))
    return _interval_pmf_rows(upper, lower)


# ---------------------------------------------------------------------------
# pure-python rANS (plain versions of the C++ coder; same state machines)
# ---------------------------------------------------------------------------


def rans_encode_py(symbols: np.ndarray, bins: np.ndarray, cdf: np.ndarray) -> bytes:
    out = bytearray()
    x = RANS_L
    for i in range(len(symbols) - 1, -1, -1):
        row = cdf[bins[i]]
        s = int(symbols[i])
        start = int(row[s])
        freq = int(row[s + 1]) - start
        x_max = ((RANS_L >> PROB_BITS) << 8) * freq
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        x = ((x // freq) << PROB_BITS) + (x % freq) + start
    for _ in range(4):
        out.append(x & 0xFF)
        x >>= 8
    out.reverse()
    return bytes(out)


def rans_encode_ilv_py(
    symbols: np.ndarray, bins: np.ndarray, cdf: np.ndarray, lanes: int = 8
) -> tuple[bytes, list[int]]:
    """Pure-python interleaved word-renormalized rANS (stream format 2;
    plain version of nic_torch/native/rans.cpp:nic_rans_encode_ilv — same state
    machine). Lane l owns symbols i ≡ l (mod lanes); each lane is an
    independent 32-bit state renormalizing 16 bits at a time. Returns the
    concatenated lane payloads and their byte lengths (the Python-side
    header is assembled in nic_torch.native)."""
    out = bytearray()
    lens = []
    n = len(symbols)
    for lane in range(lanes):
        words = []
        x = 1 << 16
        for i in range(n - 1 - (n - 1 - lane) % lanes, -1, -lanes):
            row = cdf[bins[i]]
            s = int(symbols[i])
            start = int(row[s])
            freq = int(row[s + 1]) - start
            if x >= (freq << 16):
                words.append(x & 0xFFFF)
                x >>= 16
            x = ((x // freq) << 16) + (x % freq) + start
        chunk = bytearray()
        chunk += bytes(((x >> 16) & 0xFF, (x >> 24) & 0xFF, x & 0xFF, (x >> 8) & 0xFF))
        for w in reversed(words):
            chunk += bytes((w & 0xFF, w >> 8))
        lens.append(len(chunk))
        out += chunk
    return bytes(out), lens


def rans_decode_ilv_py(
    data: bytes, lane_lens: list[int], bins: np.ndarray, cdf: np.ndarray
) -> np.ndarray:
    """Decode the format-2 stream (see rans_encode_ilv_py)."""
    lanes = len(lane_lens)
    off = np.concatenate([[0], np.cumsum(lane_lens)]).astype(np.int64)
    x = np.empty(lanes, np.uint64)
    pos = [0] * lanes
    end = [int(lane_lens[l]) for l in range(lanes)]
    views = [data[off[l]: off[l + 1]] for l in range(lanes)]
    for l in range(lanes):
        v = views[l]
        x[l] = ((v[0] | (v[1] << 8)) << 16) | (v[2] | (v[3] << 8))
        pos[l] = 4
    out = np.empty(len(bins), np.int32)
    for i in range(len(bins)):
        l = i % lanes
        row = cdf[bins[i]]
        xv = int(x[l])
        cum = xv & 0xFFFF
        s = int(np.searchsorted(row, cum, side="right")) - 1
        start = int(row[s])
        freq = int(row[s + 1]) - start
        out[i] = s
        xv = freq * (xv >> 16) + cum - start
        if xv < (1 << 16):
            w = 0
            v = views[l]
            if pos[l] + 1 < end[l]:
                w = v[pos[l]] | (v[pos[l] + 1] << 8)
                pos[l] += 2
            xv = (xv << 16) | w
        x[l] = xv
    return out


def rans_decode_py(data: bytes, bins: np.ndarray, cdf: np.ndarray) -> np.ndarray:
    pos = 0

    def rd():
        nonlocal pos
        b = data[pos] if pos < len(data) else 0
        pos += 1
        return b

    x = 0
    for _ in range(4):
        x = (x << 8) | rd()
    mask = PROB_SCALE - 1
    out = np.empty(len(bins), np.int32)
    for i in range(len(bins)):
        row = cdf[bins[i]]
        cum = x & mask
        s = int(np.searchsorted(row, cum, side="right")) - 1
        start = int(row[s])
        freq = int(row[s + 1]) - start
        out[i] = s
        x = freq * (x >> PROB_BITS) + cum - start
        while x < RANS_L:
            x = (x << 8) | rd()
    return out


def rans_encode_ilv3_py(
    symbols: np.ndarray, bins: np.ndarray, cdf: np.ndarray
) -> bytes:
    """Pure-python stream-format-3 encoder (plain
    version of rans.cpp:nic_rans_encode_ilv3 — same state machine, bit-identical
    output): 64 lanes sharing ONE u16 word stream, payload =
    u32le state[64] | words | 32*4 zero pad. Lane of symbol i is i % 64
    in the batched body and (i - body) in the n % 64 tail."""
    lanes = 64
    n = len(symbols)
    body = n - (n % lanes)
    x = [1 << 16] * lanes
    words: list[int] = []
    for i in range(n - 1, -1, -1):
        lane = (i - body) if i >= body else (i % lanes)
        row = cdf[bins[i]]
        s = int(symbols[i])
        start = int(row[s])
        freq = int(row[s + 1]) - start
        xl = x[lane]
        if xl >= (freq << 16):
            words.append(xl & 0xFFFF)
            xl >>= 16
        x[lane] = ((xl // freq) << 16) + (xl % freq) + start
    out = bytearray()
    for xl in x:
        out += bytes((xl & 0xFF, (xl >> 8) & 0xFF,
                      (xl >> 16) & 0xFF, (xl >> 24) & 0xFF))
    for w in reversed(words):
        out += bytes((w & 0xFF, w >> 8))
    out += bytes(128)
    return bytes(out)


def rans_decode_ilv3_py(
    payload: bytes, bins: np.ndarray, cdf: np.ndarray
) -> np.ndarray:
    """Decode the format-3 payload (see rans_encode_ilv3_py)."""
    lanes = 64
    x = []
    for l in range(lanes):
        b0 = payload[4 * l: 4 * l + 4]
        x.append(b0[0] | (b0[1] << 8) | (b0[2] << 16) | (b0[3] << 24))
    pos = 4 * lanes
    end = len(payload) - 128
    n = len(bins)
    body = n - (n % lanes)
    out = np.empty(n, np.int32)
    for i in range(n):
        lane = (i - body) if i >= body else (i % lanes)
        row = cdf[bins[i]]
        cum = x[lane] & 0xFFFF
        s = int(np.searchsorted(row, cum, side="right")) - 1
        start = int(row[s])
        freq = int(row[s + 1]) - start
        out[i] = s
        xv = freq * (x[lane] >> 16) + cum - start
        if xv < (1 << 16):
            w = 0
            if pos + 1 < end:
                w = payload[pos] | (payload[pos + 1] << 8)
            pos += 2
            xv = (xv << 16) | w
        x[lane] = xv
    return out
