"""Deterministic Falcon-512 with Poseidon2 hash-to-point.

Mirrors dsa/falcon512_poseidon2/: NTRU lattice signatures over
Z_q[x]/(x^512+1), q = 12289, with

- **hash-to-point** via the Poseidon2 sponge (no rejection sampling — 64
  squeezes of the rate reduced mod q, hash_to_point.rs:20),
- **deterministic signing** per falcon-det: the trapdoor sampler's CPRNG is
  seeded with Blake3(log_n || sk || message) (secret_key.rs generate_seed),
  and the nonce is the fixed versioned domain separator,
- the spec **samplerZ** (RCDT base sampler + FACCT approx_exp BerExp,
  math/samplerz.rs — published Falcon/FACCT constants),
- keygen by **NTRUSolve** (field norms + Babai reduction in chunked-f64
  FFT, math/mod.rs:134,219) and signing by **ffSampling** over the
  normalized LDL tree (math/ffsampling.rs).

Verification is exact: s1 = c − s2·h over the NTT, accept iff
‖s1‖² + ‖s2‖² < 34034726 (signature.rs:364).

All polynomial FFTs here use the negacyclic convention with roots
x_k = exp(iπ(2k+1)/n); splits/merges are self-consistent with it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..hash import blake3_host, poseidon2_host as hp

Q = 12289
N = 512
LOG_N = 9
SIG_L2_BOUND = 34034726
SIGMA = 165.7366171829776
SIGMIN = 1.2778336969128337
SIGMA_MAX = 1.8205
SIGMA_STAR = 1.43300980528773  # keygen Gaussian for f, g (math/mod.rs:172)
MAX_SMALL_COEFF = (1 << 5) - 1  # 6-bit encodable f/g coefficients
MAX_BIG_COEFF = (1 << 7) - 1  # 8-bit encodable F/G coefficients

SIG_NONCE_LEN = 40
NONCE_VERSION_BYTE = 1
PREVERSIONED_NONCE = bytes(
    [9] + list(b"FALCON-POSEIDON2-DET") + [0] * 18
)
PK_LEN = 897
SIG_POLY_BYTE_LEN = 625


class FalconError(ValueError):
    pass


# ---------------------------------------------------------------------------
# exact arithmetic mod q: negacyclic NTT over Z_12289
# ---------------------------------------------------------------------------


def _find_generator() -> int:
    for g in range(2, 100):
        seen_half = pow(g, (Q - 1) // 2, Q) != 1
        seen_third = pow(g, (Q - 1) // 3, Q) != 1
        if seen_half and seen_third:
            return g
    raise AssertionError


_G = _find_generator()
_PSI = pow(_G, (Q - 1) // (2 * N), Q)  # primitive 1024th root
_PSI_POWS = [pow(_PSI, i, Q) for i in range(2 * N)]
_PSI_INV_POWS = [pow(_PSI, -i % (2 * N), Q) for i in range(2 * N)]
_N_INV = pow(N, Q - 2, Q)
_OMEGA = _PSI_POWS[2]  # primitive 512th root for the cyclic core


def _ntt(a: list[int]) -> list[int]:
    """Negacyclic NTT: evaluations at ψ^(2k+1), k = 0..N-1."""
    # twist by ψ^j then cyclic NTT at ω^k
    b = [(a[j] * _PSI_POWS[j]) % Q for j in range(N)]
    return _cyclic_ntt(b, _OMEGA)


def _intt(ah: list[int]) -> list[int]:
    b = _cyclic_ntt(ah, pow(_OMEGA, Q - 2, Q))
    return [(b[j] * _N_INV % Q) * _PSI_INV_POWS[j] % Q for j in range(N)]


def _cyclic_ntt(a: list[int], omega: int) -> list[int]:
    n = len(a)
    if n == 1:
        return list(a)
    omega_sq = omega * omega % Q
    even = _cyclic_ntt(a[0::2], omega_sq)
    odd = _cyclic_ntt(a[1::2], omega_sq)
    out = [0] * n
    w = 1
    for k in range(n // 2):
        t = w * odd[k] % Q
        out[k] = (even[k] + t) % Q
        out[k + n // 2] = (even[k] - t) % Q
        w = w * omega % Q
    return out


def poly_mul_mod(a: list[int], b: list[int]) -> list[int]:
    """a·b mod (x^N + 1, q)."""
    ah, bh = _ntt(a), _ntt(b)
    return _intt([x * y % Q for x, y in zip(ah, bh)])


def _balanced(v: int) -> int:
    v %= Q
    return v - Q if v > Q // 2 else v


# ---------------------------------------------------------------------------
# complex FFT over x^n + 1 (roots exp(iπ(2k+1)/n)) + split/merge
# ---------------------------------------------------------------------------


def fft(a: np.ndarray) -> np.ndarray:
    n = len(a)
    w = np.exp(1j * np.pi * np.arange(n) / n)
    return np.fft.ifft(np.asarray(a, dtype=np.complex128) * w) * n


def ifft(F: np.ndarray) -> np.ndarray:
    n = len(F)
    w = np.exp(1j * np.pi * np.arange(n) / n)
    return np.fft.fft(np.asarray(F, dtype=np.complex128)) / n / w


def split_fft(F: np.ndarray):
    n = len(F)
    half = n // 2
    x = np.exp(1j * np.pi * (2 * np.arange(half) + 1) / n)
    f0 = (F[:half] + F[half:]) / 2
    f1 = (F[:half] - F[half:]) / (2 * x)
    return f0, f1


def merge_fft(f0: np.ndarray, f1: np.ndarray) -> np.ndarray:
    half = len(f0)
    n = 2 * half
    x = np.exp(1j * np.pi * (2 * np.arange(half) + 1) / n)
    return np.concatenate([f0 + x * f1, f0 - x * f1])


# ---------------------------------------------------------------------------
# ChaCha20-based CPRNG (deterministic signing) + samplerZ
# ---------------------------------------------------------------------------


class ChaChaRng:
    """Deterministic byte stream from a 32-byte seed (ChaCha20 keystream)."""

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        from ..crypto.aead import _chacha20_block

        self._block = _chacha20_block
        self.seed = seed
        self.counter = 0
        self.buffer = b""

    def fill_bytes(self, n: int) -> bytes:
        while len(self.buffer) < n:
            self.buffer += self._block(self.seed, self.counter, b"\x00" * 12)
            self.counter += 1
        out, self.buffer = self.buffer[:n], self.buffer[n:]
        return out


_RCDT = [
    3024686241123004913666, 1564742784480091954050, 636254429462080897535,
    199560484645026482916, 47667343854657281903, 8595902006365044063,
    1163297957344668388, 117656387352093658, 8867391802663976,
    496969357462633, 20680885154299, 638331848991, 14602316184,
    247426747, 3104126, 28824, 198, 1,
]

_FACCT_C = [
    0x00000004741183A3, 0x00000036548CFC06, 0x0000024FDCBF140A,
    0x0000171D939DE045, 0x0000D00CF58F6F84, 0x000680681CF796E3,
    0x002D82D8305B0FEA, 0x011111110E066FD0, 0x0555555555070F00,
    0x155555555581FF00, 0x400000000002B400, 0x7FFFFFFFFFFF4800,
    0x8000000000000000,
]


def _base_sampler(bytes9: bytes) -> int:
    u = int.from_bytes(bytes9, "little")
    return sum(1 for r in _RCDT if u < r)


def _approx_exp(x: float, ccs: float) -> int:
    y = _FACCT_C[0]
    z = int(math.floor(x * (1 << 63))) & 0xFFFFFFFFFFFFFFFF
    for c in _FACCT_C[1:]:
        y = (c - ((z * y) >> 63)) & 0xFFFFFFFFFFFFFFFF
    z = int(math.floor((1 << 63) * ccs)) & 0xFFFFFFFFFFFFFFFF
    return (z * y) >> 63


def _ber_exp(x: float, ccs: float, rng) -> bool:
    ln2 = math.log(2)
    s = math.floor(x / ln2)
    r = x - s * ln2
    s = min(int(s), 63)
    z = (((_approx_exp(r, ccs) << 1) - 1) >> s) & 0xFFFFFFFFFFFFFFFF
    for i in range(56, -1, -8):
        p = rng.fill_bytes(1)[0]
        w = p - ((z >> i) & 0xFF)
        if w != 0:
            break
    return w < 0


def sampler_z(mu: float, sigma: float, sigma_min: float, rng) -> int:
    """Discrete Gaussian on Z with center mu, stddev sigma (samplerz.rs)."""
    isigma = 1.0 / sigma
    dss = 0.5 * isigma * isigma
    s = math.floor(mu)
    r = mu - s
    ccs = sigma_min * isigma
    inv_2smax_sq = 1.0 / (2.0 * SIGMA_MAX * SIGMA_MAX)
    while True:
        z0 = _base_sampler(rng.fill_bytes(9))
        b = rng.fill_bytes(1)[0] & 1
        z = b + (2 * b - 1) * z0
        zf_min_r = float(z) - r
        x = zf_min_r * zf_min_r * dss - float(z0 * z0) * inv_2smax_sq
        if _ber_exp(x, ccs, rng):
            return z + int(s)


# ---------------------------------------------------------------------------
# keygen: NTRUGen (ntru_solve + Babai reduction)
# ---------------------------------------------------------------------------


def _xgcd(a: int, b: int):
    old_r, r = a, b
    old_s, s = 1, 0
    old_t, t = 0, 1
    while r:
        qt = old_r // r
        old_r, r = r, old_r - qt * r
        old_s, s = s, old_s - qt * s
        old_t, t = t, old_t - qt * t
    return old_r, old_s, old_t


def _field_norm(f: list[int]) -> list[int]:
    """N(f)(x²) = f(x)f(−x): even² − x·odd² over Z[x]/(x^(n/2)+1)."""
    n = len(f)
    fe, fo = f[0::2], f[1::2]
    e2 = _int_negacyclic_mul(fe, fe)
    o2 = _int_negacyclic_mul(fo, fo)
    # x·o2 in x^(n/2)+1: shift with wraparound negation
    xo2 = [-o2[-1]] + o2[:-1]
    return [a - b for a, b in zip(e2, xo2)]


def _int_negacyclic_mul(a: list[int], b: list[int]) -> list[int]:
    """Exact big-int multiplication mod x^n + 1 (schoolbook via Karatsuba
    on Python ints packed per-coefficient)."""
    n = len(a)
    out = [0] * n
    for i, ai in enumerate(a):
        if ai == 0:
            continue
        for j, bj in enumerate(b):
            k = i + j
            if k < n:
                out[k] += ai * bj
            else:
                out[k - n] -= ai * bj
    return out


def _lift(f: list[int]) -> list[int]:
    out = [0] * (2 * len(f))
    out[0::2] = f
    return out


def _galois_adjoint(f: list[int]) -> list[int]:
    return [c if i % 2 == 0 else -c for i, c in enumerate(f)]


def _babai_reduce(f, g, F, G):
    """Reduce (F, G) against (f, g) with 53-bit windows (math/mod.rs:219)."""
    n = len(f)

    def bitsize(x):
        return (max(int(abs(v)).bit_length() for v in x) + 7) & ~7

    size = max(bitsize(f), bitsize(g), 53)
    shift = size - 53
    f_adj = fft(np.array([float(v >> shift) for v in f]))
    g_adj = fft(np.array([float(v >> shift) for v in g]))
    denom = f_adj * np.conj(f_adj) + g_adj * np.conj(g_adj)

    for _ in range(1000):
        cap_size = max(bitsize(F), bitsize(G), 53)
        if cap_size < size:
            return F, G
        cap_shift = cap_size - 53
        F_adj = fft(np.array([float(v >> cap_shift) for v in F]))
        G_adj = fft(np.array([float(v >> cap_shift) for v in G]))
        num = F_adj * np.conj(f_adj) + G_adj * np.conj(g_adj)
        k = np.round(np.real(ifft(num / denom))).astype(object)
        k = [int(v) for v in k]
        if all(v == 0 for v in k):
            return F, G
        kf = _int_negacyclic_mul(k, f)
        kg = _int_negacyclic_mul(k, g)
        scale = cap_size - size
        F = [a - (b << scale) for a, b in zip(F, kf)]
        G = [a - (b << scale) for a, b in zip(G, kg)]
    raise FalconError("Babai reduction did not converge")


def _ntru_solve(f: list[int], g: list[int]):
    n = len(f)
    if n == 1:
        d, u, v = _xgcd(f[0], g[0])
        if d != 1:
            raise FalconError("gcd != 1")
        return [-v * Q], [u * Q]
    fp = _field_norm(f)
    gp = _field_norm(g)
    Fp, Gp = _ntru_solve(fp, gp)
    F = _int_negacyclic_mul(_lift(Fp), _galois_adjoint(g))
    G = _int_negacyclic_mul(_lift(Gp), _galois_adjoint(f))
    return _babai_reduce(f, g, F, G)


def _gen_poly(rng) -> list[int]:
    samples = [sampler_z(0.0, SIGMA_STAR, SIGMA_STAR - 0.001, rng) for _ in range(4096)]
    k = 4096 // N
    return [sum(samples[i * k : (i + 1) * k]) for i in range(N)]


def _gs_norm_squared(f: list[int], g: list[int]) -> float:
    gamma1 = sum(v * v for v in f) + sum(v * v for v in g)
    f_fft = fft(np.array(f, dtype=float))
    g_fft = fft(np.array(g, dtype=float))
    ffgg = f_fft * np.conj(f_fft) + g_fft * np.conj(g_fft)
    qf = Q * np.conj(f_fft) / ffgg
    qg = Q * np.conj(g_fft) / ffgg
    gamma2 = (np.sum(np.abs(qf) ** 2) + np.sum(np.abs(qg) ** 2)) / N
    return max(float(gamma1), float(gamma2))


def ntru_gen(rng) -> list[list[int]]:
    """Returns the short basis [g, -f, G, -F] with fG − gF = q."""
    while True:
        f = _gen_poly(rng)
        g = _gen_poly(rng)
        if max(abs(v) for v in f) > MAX_SMALL_COEFF or max(abs(v) for v in g) > MAX_SMALL_COEFF:
            continue
        if any(v == 0 for v in _ntt([v % Q for v in f])):
            continue
        if _gs_norm_squared(f, g) > 1.3689 * Q:
            continue
        try:
            F, G = _ntru_solve(f, g)
        except FalconError:
            continue
        if max(abs(v) for v in F) > MAX_BIG_COEFF or max(abs(v) for v in G) > MAX_BIG_COEFF:
            continue
        return [g, [-v for v in f], G, [-v for v in F]]


# ---------------------------------------------------------------------------
# LDL tree + ffSampling
# ---------------------------------------------------------------------------


def _ffldl(g00, g01, g10, g11):
    """LDL tree of a 2x2 Hermitian Gram matrix in FFT form.

    Nodes are ("branch", ell, left, right); leaves ("leaf", [sigma, 0])
    after normalization (ffsampling.rs ffldl/normalize_tree)."""
    l10 = g10 / g00
    d00 = g00
    d11 = g11 - l10 * np.conj(l10) * g00
    n = len(g00)
    if n > 2:
        d00_l, d00_r = split_fft(d00)
        d11_l, d11_r = split_fft(d11)
        left = _ffldl(d00_l, d00_r, np.conj(d00_r), d00_l)
        right = _ffldl(d11_l, d11_r, np.conj(d11_r), d11_l)
        return ["branch", l10, left, right]
    return ["branch", l10, ["leaf", list(d00)], ["leaf", list(d11)]]


def _normalize_tree(tree, sigma: float):
    if tree[0] == "leaf":
        tree[1][0] = complex(sigma / math.sqrt(tree[1][0].real))
        tree[1][1] = 0j
        return
    _normalize_tree(tree[2], sigma)
    _normalize_tree(tree[3], sigma)


def _ffsampling_rec(t0, t1, tree, rng):
    _, ell, left, right = tree
    if left[0] == "leaf":
        # n == 2 level: split to scalars and sample at the leaf sigmas
        b1_0, b1_1 = split_fft(t1)
        s_r = float(right[1][0].real)
        z1_0 = sampler_z(float(b1_0[0].real), s_r, SIGMIN, rng)
        z1_1 = sampler_z(float(b1_1[0].real), s_r, SIGMIN, rng)
        z1 = merge_fft(np.array([complex(z1_0)]), np.array([complex(z1_1)]))
        t0p = t0 + (t1 - z1) * ell
        b0_0, b0_1 = split_fft(t0p)
        s_l = float(left[1][0].real)
        z0_0 = sampler_z(float(b0_0[0].real), s_l, SIGMIN, rng)
        z0_1 = sampler_z(float(b0_1[0].real), s_l, SIGMIN, rng)
        z0 = merge_fft(np.array([complex(z0_0)]), np.array([complex(z0_1)]))
        return z0, z1
    t1_0, t1_1 = split_fft(t1)
    z1_0, z1_1 = _ffsampling_rec(t1_0, t1_1, right, rng)
    z1 = merge_fft(z1_0, z1_1)
    t0p = t0 + (t1 - z1) * ell
    t0_0, t0_1 = split_fft(t0p)
    z0_0, z0_1 = _ffsampling_rec(t0_0, t0_1, left, rng)
    z0 = merge_fft(z0_0, z0_1)
    return z0, z1


# ---------------------------------------------------------------------------
# hash-to-point (Poseidon2, hash_to_point.rs:20)
# ---------------------------------------------------------------------------


def nonce_to_elements(nonce: bytes) -> list[int]:
    assert len(nonce) == SIG_NONCE_LEN
    return [
        int.from_bytes(nonce[5 * i : 5 * i + 5], "little") for i in range(8)
    ]


def hash_to_point(message_word, nonce: bytes) -> list[int]:
    state = [0] * 12
    state[0:8] = nonce_to_elements(nonce)
    state = hp.permute(state)
    for i, m in enumerate(message_word):
        state[i] = m % hp.P
    coeffs = []
    for _ in range(64):
        state = hp.permute(state)
        coeffs.extend(v % Q for v in state[0:8])
    return coeffs


def deterministic_nonce() -> bytes:
    return bytes([NONCE_VERSION_BYTE]) + PREVERSIONED_NONCE


# ---------------------------------------------------------------------------
# keys and signatures
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Signature:
    nonce: bytes
    s2: list[int]  # balanced coefficients
    h: list[int]  # public key polynomial mod q

    def to_bytes(self) -> bytes:
        return (
            bytes([0b1011_1001]) + self.nonce
            + encode_sig_poly(self.s2) + encode_public_key(self.h)
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        if len(data) < 1 + SIG_NONCE_LEN + SIG_POLY_BYTE_LEN + PK_LEN:
            raise FalconError("signature too short")
        if data[0] != 0b1011_1001:
            raise FalconError("bad signature header")
        off = 1
        nonce = data[off : off + SIG_NONCE_LEN]
        off += SIG_NONCE_LEN
        s2 = decode_sig_poly(data[off : off + SIG_POLY_BYTE_LEN])
        off += SIG_POLY_BYTE_LEN
        h = decode_public_key(data[off : off + PK_LEN])
        return cls(nonce, s2, h)


@dataclass(frozen=True)
class PublicKey:
    h: list[int]  # N coefficients mod q

    def to_elements(self) -> list[int]:
        return [v % Q for v in self.h]

    def to_commitment(self) -> list[int]:
        return hp.hash_elements(self.to_elements())

    def to_bytes(self) -> bytes:
        return encode_public_key(self.h)

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        return cls(decode_public_key(data))

    def verify(self, message_word, sig: Signature) -> bool:
        if [v % Q for v in sig.h] != [v % Q for v in self.h]:
            return False
        c = hash_to_point(message_word, sig.nonce)
        s2 = [v % Q for v in sig.s2]
        s2h = poly_mul_mod(s2, [v % Q for v in self.h])
        s1 = [(a - b) % Q for a, b in zip(c, s2h)]
        norm = sum(_balanced(v) ** 2 for v in s1) + sum(
            _balanced(v) ** 2 for v in s2
        )
        return norm < SIG_L2_BOUND


class SecretKey:
    """Short basis [g, -f, G, -F] + normalized LDL (Falcon) tree."""

    def __init__(self, basis: list[list[int]]):
        self.basis = [list(map(int, p)) for p in basis]
        g, neg_f, G, neg_F = self.basis
        b_fft = [fft(np.array(p, dtype=float)) for p in self.basis]
        g00 = b_fft[0] * np.conj(b_fft[0]) + b_fft[1] * np.conj(b_fft[1])
        g01 = b_fft[0] * np.conj(b_fft[2]) + b_fft[1] * np.conj(b_fft[3])
        g10 = b_fft[2] * np.conj(b_fft[0]) + b_fft[3] * np.conj(b_fft[1])
        g11 = b_fft[2] * np.conj(b_fft[2]) + b_fft[3] * np.conj(b_fft[3])
        tree = _ffldl(g00, g01, g10, g11)
        _normalize_tree(tree, SIGMA)
        self.tree = tree
        self._b_fft = b_fft

    @classmethod
    def generate(cls, seed: bytes | None = None) -> "SecretKey":
        import secrets as _secrets

        rng = ChaChaRng(seed if seed is not None else _secrets.token_bytes(32))
        return cls(ntru_gen(rng))

    def public_key(self) -> PublicKey:
        g, neg_f = self.basis[0], self.basis[1]
        f = [(-v) % Q for v in neg_f]
        g_ntt = _ntt([v % Q for v in g])
        f_ntt = _ntt(f)
        h_ntt = [a * pow(b, Q - 2, Q) % Q for a, b in zip(g_ntt, f_ntt)]
        return PublicKey(_intt(h_ntt))

    def to_bytes(self) -> bytes:
        """header || f (6-bit) || g (6-bit) || F (8-bit), 1281 bytes."""
        out = bytearray([0x50 | LOG_N])
        g, neg_f, G, neg_F = self.basis
        f = [-v for v in neg_f]
        F = [-v for v in neg_F]
        out += _encode_signed(f, 6)
        out += _encode_signed(g, 6)
        out += _encode_signed(F, 8)
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "SecretKey":
        if data[0] != (0x50 | LOG_N):
            raise FalconError("bad secret key header")
        off = 1
        f, off = _decode_signed(data, off, 6)
        g, off = _decode_signed(data, off, 6)
        F, off = _decode_signed(data, off, 8)
        # recompute G from fG - gF = q: G = (q + gF)/f over the integers —
        # do it mod q via NTT then round by exact division check
        G = _recompute_G(f, g, F)
        return cls([g, [-v for v in f], G, [-v for v in F]])

    def _generate_seed(self, message_word) -> bytes:
        buf = bytes([LOG_N]) + self.to_bytes() + b"".join(
            int(v).to_bytes(8, "little") for v in message_word
        )
        return blake3_host.blake3(buf)

    def sign(self, message_word) -> Signature:
        rng = ChaChaRng(self._generate_seed(message_word))
        return self.sign_with_rng(message_word, rng)

    def sign_with_rng(self, message_word, rng) -> Signature:
        nonce = deterministic_nonce()
        c = hash_to_point(message_word, nonce)
        s2 = self._sign_helper(c, rng)
        return Signature(nonce, s2, self.public_key().h)

    def _sign_helper(self, c: list[int], rng) -> list[int]:
        g_fft, neg_f_fft, G_fft, neg_F_fft = self._b_fft
        c_over_q = fft(np.array([v / Q for v in c], dtype=float))
        t0 = c_over_q * neg_F_fft
        t1 = -c_over_q * neg_f_fft
        while True:
            z0, z1 = _ffsampling_rec(t0, t1, self.tree, rng)
            d0 = t0 - z0
            d1 = t1 - z1
            s0 = d0 * g_fft + d1 * G_fft
            s1 = d0 * neg_f_fft + d1 * neg_F_fft
            norm = (
                float(np.sum(np.abs(s0) ** 2) + np.sum(np.abs(s1) ** 2)) / N
            )
            if norm > SIG_L2_BOUND:
                continue
            s2 = np.round(np.real(ifft(s1))).astype(np.int64)
            if np.max(np.abs(s2)) <= 2047:
                return [int(v) for v in s2]


def _recompute_G(f: list[int], g: list[int], F: list[int]) -> list[int]:
    """G = (q + g·F)/f over Z[x]/(x^N+1), known exact by the NTRU equation."""
    gf = _int_negacyclic_mul(g, F)
    gf[0] += Q
    # divide exactly in the rationals via FFT and round
    quot = ifft(fft(np.array(gf, dtype=float)) / fft(np.array(f, dtype=float)))
    G = [int(round(float(v))) for v in np.real(quot)]
    # exact check: f·G == q + g·F
    if _int_negacyclic_mul(f, G) != gf:
        raise FalconError("secret key decode failed (G recompute)")
    return G


# ---------------------------------------------------------------------------
# encodings (public_key.rs, signature.rs, secret_key.rs)
# ---------------------------------------------------------------------------


def encode_public_key(h: list[int]) -> bytes:
    out = bytearray([LOG_N])
    acc = acc_len = 0
    for c in h:
        acc = (acc << 14) | (c % Q)
        acc_len += 14
        while acc_len >= 8:
            acc_len -= 8
            out.append((acc >> acc_len) & 0xFF)
    assert len(out) == PK_LEN
    return bytes(out)


def decode_public_key(data: bytes) -> list[int]:
    if len(data) != PK_LEN or data[0] != LOG_N:
        raise FalconError("bad public key encoding")
    acc = acc_len = 0
    out = []
    for b in data[1:]:
        acc = (acc << 8) | b
        acc_len += 8
        if acc_len >= 14:
            acc_len -= 14
            v = (acc >> acc_len) & 0x3FFF
            if v >= Q:
                raise FalconError("public key coefficient out of range")
            out.append(v)
    if len(out) != N:
        raise FalconError("bad public key length")
    return out


def encode_sig_poly(s2_balanced: list[int]) -> bytes:
    """Falcon compressed encoding: sign bit, 7 low bits, unary high bits."""
    out = bytearray(SIG_POLY_BYTE_LEN)
    acc = acc_len = 0
    v = 0
    for c in s2_balanced:
        acc <<= 1
        t = c
        if t < 0:
            t = -t
            acc |= 1
        w = t
        acc <<= 7
        acc |= w & 0x7F
        w >>= 7
        acc_len += 8
        acc <<= w + 1
        acc |= 1
        acc_len += w + 1
        while acc_len >= 8:
            acc_len -= 8
            if v >= SIG_POLY_BYTE_LEN:
                raise FalconError("signature does not fit")
            out[v] = (acc >> acc_len) & 0xFF
            v += 1
    if acc_len > 0:
        if v >= SIG_POLY_BYTE_LEN:
            raise FalconError("signature does not fit")
        out[v] = (acc << (8 - acc_len)) & 0xFF
    return bytes(out)


def decode_sig_poly(data: bytes) -> list[int]:
    if len(data) != SIG_POLY_BYTE_LEN:
        raise FalconError("bad signature poly length")
    out = []
    idx = 0
    acc = acc_len = 0
    for _ in range(N):
        if idx >= len(data):
            raise FalconError("signature poly truncated")
        acc = (acc << 8) | data[idx]
        idx += 1
        b = (acc >> acc_len) & 0xFF
        sign = (b >> 7) & 1
        m = b & 0x7F
        while True:
            if acc_len == 0:
                if idx >= len(data):
                    raise FalconError("signature poly truncated")
                acc = (acc << 8) | data[idx]
                idx += 1
                acc_len = 8
            acc_len -= 1
            if (acc >> acc_len) & 1:
                break
            m += 128
            if m > 2047:
                raise FalconError("high bits exceed 2047")
        if sign and m == 0:
            raise FalconError("invalid negative zero encoding")
        out.append(-m if sign else m)
    if (acc & ((1 << acc_len) - 1)) != 0:
        raise FalconError("non-zero unused bits in the last byte")
    if any(data[idx:]):
        raise FalconError("non-zero trailing bytes")
    return out


def _encode_signed(vals: list[int], width: int) -> bytes:
    lim = 1 << (width - 1)
    acc = acc_len = 0
    out = bytearray()
    for v in vals:
        if not (-lim < v < lim):
            raise FalconError("coefficient out of encodable range")
        acc = (acc << width) | (v & ((1 << width) - 1))
        acc_len += width
        while acc_len >= 8:
            acc_len -= 8
            out.append((acc >> acc_len) & 0xFF)
    if acc_len:
        out.append((acc << (8 - acc_len)) & 0xFF)
    return bytes(out)


def _decode_signed(data: bytes, off: int, width: int):
    out = []
    acc = acc_len = 0
    pos = off
    while len(out) < N:
        acc = (acc << 8) | data[pos]
        pos += 1
        acc_len += 8
        while acc_len >= width and len(out) < N:
            acc_len -= width
            v = (acc >> acc_len) & ((1 << width) - 1)
            if v >= 1 << (width - 1):
                v -= 1 << width
            out.append(v)
    return out, pos
