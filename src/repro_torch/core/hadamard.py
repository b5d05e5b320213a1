"""Hadamard matrix constructions.

Model dims are rarely powers of two (2304, 5120, 14336, ...), so we build
H_n = H_{2^a} ⊗ H_m via Sylvester doubling plus Paley constructions for
the odd-part factor m (12, 20, 28, 36, 44, 60 cover every assigned
architecture's hidden/ff dims). Entries are ±1; `normalized` divides by
sqrt(n) to make the matrix orthonormal.

The TPU-native application is the Kronecker two-matmul form
   y = reshape(H_a @ X @ H_bᵀ)   for x reshaped to X (a, b),
which maps straight onto the MXU (see repro/kernels/hadamard.py).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in range(2, int(n**0.5) + 1):
        if n % p == 0:
            return False
    return True


def _quadratic_residues(q: int) -> np.ndarray:
    """χ(a) for a in 0..q-1: 0 if a=0, +1 if QR, -1 otherwise."""
    chi = -np.ones(q, dtype=np.int64)
    chi[0] = 0
    chi[np.unique((np.arange(1, q) ** 2) % q)] = 1
    return chi


def _jacobsthal(q: int) -> np.ndarray:
    chi = _quadratic_residues(q)
    idx = (np.arange(q)[:, None] - np.arange(q)[None, :]) % q
    return chi[idx]


def _paley_I(q: int) -> np.ndarray:
    """Order q+1, q prime ≡ 3 (mod 4)."""
    assert _is_prime(q) and q % 4 == 3
    Q = _jacobsthal(q)
    n = q + 1
    S = np.zeros((n, n), dtype=np.int64)
    S[0, 1:] = 1
    S[1:, 0] = -1
    S[1:, 1:] = Q
    H = S + np.eye(n, dtype=np.int64)
    return H


def _paley_II(q: int) -> np.ndarray:
    """Order 2(q+1), q prime ≡ 1 (mod 4)."""
    assert _is_prime(q) and q % 4 == 1
    Q = _jacobsthal(q)
    n = q + 1
    S = np.zeros((n, n), dtype=np.int64)
    S[0, 1:] = 1
    S[1:, 0] = 1
    S[1:, 1:] = Q
    # Substitute 2x2 blocks: 0 -> [[1,-1],[-1,-1]]; ±1 -> ±[[1,1],[1,-1]]
    Z = np.array([[1, -1], [-1, -1]], dtype=np.int64)
    P = np.array([[1, 1], [1, -1]], dtype=np.int64)
    H = np.zeros((2 * n, 2 * n), dtype=np.int64)
    for i in range(n):
        for j in range(n):
            H[2 * i : 2 * i + 2, 2 * j : 2 * j + 2] = Z if S[i, j] == 0 else S[i, j] * P
    return H


@lru_cache(maxsize=None)
def _base_hadamard(m: int) -> np.ndarray:
    """Hadamard matrix of order m for m in {1, 2} ∪ Paley-constructible."""
    if m == 1:
        return np.array([[1]], dtype=np.int64)
    if m == 2:
        return np.array([[1, 1], [1, -1]], dtype=np.int64)
    if m % 4 == 0 and _is_prime(m - 1) and (m - 1) % 4 == 3:
        return _paley_I(m - 1)
    if m % 4 == 0 and m % 2 == 0 and _is_prime(m // 2 - 1) and (m // 2 - 1) % 4 == 1:
        return _paley_II(m // 2 - 1)
    raise ValueError(f"no Hadamard construction for order {m}")


def _odd_part(n: int) -> tuple[int, int]:
    a = 0
    while n % 2 == 0:
        n //= 2
        a += 1
    return a, n


@lru_cache(maxsize=None)
def hadamard_matrix(n: int, normalized: bool = True) -> np.ndarray:
    """Hadamard matrix of order n (float64). n must be 1, 2, or have its
    odd part coverable by a Paley construction of order 4*odd or 8*odd."""
    a, m = _odd_part(n)
    if m == 1:
        H = _base_hadamard(2) if n >= 2 else _base_hadamard(1)
        while H.shape[0] < n:
            H = np.kron(_base_hadamard(2), H)
    else:
        base = None
        for mult in (4, 8, 16):  # order mult*m must divide n
            order = mult * m
            if n % order == 0:
                try:
                    base = _base_hadamard(order)
                    break
                except ValueError:
                    continue
        if base is None:
            raise ValueError(f"cannot build Hadamard of order {n} (odd part {m})")
        H = base
        while H.shape[0] < n:
            H = np.kron(_base_hadamard(2), H)
    assert H.shape[0] == n, (H.shape, n)
    H = H.astype(np.float64)
    return H / np.sqrt(n) if normalized else H


def hadamard_factors(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(H_a, H_b) with H_n = H_a ⊗ H_b, both factors near sqrt(n) and
    individually constructible. Used by the Kronecker two-matmul fast path."""
    a2, m = _odd_part(n)
    # Put the (Paley) odd-order factor into H_b, pad with 2s to balance.
    if m == 1:
        fb = 1 << (a2 // 2)
    else:
        base_order = next(mult * m for mult in (4, 8, 16) if n % (mult * m) == 0)
        fb = base_order
        while fb * 2 <= n // fb and n % (fb * 2) == 0:
            fb *= 2
    fa = n // fb
    return hadamard_matrix(fa), hadamard_matrix(fb)


def is_hadamard_constructible(n: int) -> bool:
    try:
        hadamard_matrix(n)
        return True
    except ValueError:
        return False
