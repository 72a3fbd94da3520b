"""Sequence alphabet utilities.

The whole framework works in the 6-letter "nt6" alphabet used by FMD indexes:

    0 = $ (sentinel) 1 = A   2 = C   3 = G   4 = T   5 = N

(cf. reference seq_nt6_table, ping_pong.hpp:46-52). Complementation maps
A<->T, C<->G, and leaves $/N fixed (fm6_comp, ping_pong.hpp:38).
"""

from __future__ import annotations

import numpy as np

# ASCII -> nt6 (A/a=1 C/c=2 G/g=3 T/t=4, everything else printable = 5, NUL = 0).
# Mirrors seq_nt6_table (reference ping_pong.hpp:46-52).
NT6_TABLE = np.full(256, 5, dtype=np.uint8)
NT6_TABLE[0] = 0
for _c, _v in (("A", 1), ("C", 2), ("G", 3), ("T", 4)):
    NT6_TABLE[ord(_c)] = _v
    NT6_TABLE[ord(_c.lower())] = _v

# BAM 4-bit nibble -> ASCII base (htslib seq_nt16_str).
NT16_STR = "=ACMGRSVTWYHKDBN"

# ASCII -> BAM nibble (htslib seq_nt16_table, used by encode_bam_seq, bam.cpp:46).
NT16_TABLE = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(NT16_STR):
    NT16_TABLE[ord(_c)] = _i
    NT16_TABLE[ord(_c.lower())] = _i

# nt6 -> nt6 complement: $->$, A<->T, C<->G, N->N (fm6_comp, ping_pong.hpp:38).
COMP6 = np.array([0, 4, 3, 2, 1, 5], dtype=np.uint8)

# nt6 -> ASCII char (reference int2char, ping_pong.hpp:56).
NT6_TO_CHAR = np.frombuffer(b"$ACGTN", dtype=np.uint8)

_RC_TRANS = bytes.maketrans(b"ACGTacgtNn", b"TGCAtgcaNn")


def comp6(c: int) -> int:
    """Complement of a single nt6 symbol."""
    return int(COMP6[c])


def encode_nt6(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> nt6 uint8 array."""
    if isinstance(seq, str):
        seq = seq.encode()
    return NT6_TABLE[np.frombuffer(seq, dtype=np.uint8)]


def decode_nt6(arr: np.ndarray) -> str:
    """nt6 array -> ASCII string ($ACGTN)."""
    return NT6_TO_CHAR[np.asarray(arr, dtype=np.uint8)].tobytes().decode()


def revcomp_str(seq: str) -> str:
    """Reverse complement of an ASCII DNA string (non-ACGT -> N preserved)."""
    return seq.encode().translate(_RC_TRANS)[::-1].decode()


def revcomp_nt6(arr: np.ndarray) -> np.ndarray:
    """Reverse complement of an nt6 array."""
    return COMP6[np.asarray(arr, dtype=np.uint8)][::-1]


def percentile(xs, q: float) -> float:
    """Linear-interpolated percentile of an (already sorted) sequence.

    Identical to reference smoother.cpp:246-255 (which matches
    numpy's default 'linear' interpolation on sorted data).
    """
    xs = list(xs)
    assert 0.0 <= q <= 1.0 and xs
    idx = (len(xs) - 1) * q
    lo = int(np.floor(idx))
    hi = int(np.ceil(idx))
    h = idx - lo
    return (1.0 - h) * xs[lo] + h * xs[hi]


def kmer_keys(seqs: np.ndarray, k: int) -> np.ndarray:
    """Per-position k-mer keys for nt6-encoded reads.

    keys[q, p] = sum_j (seqs[q, p-j] - 1) * 4**j over j in [0, k) — i.e.
    the key of the window *ending* at p, last symbol at 4^0 — or -1 when
    the window crosses the read start or contains a non-ACGT symbol.
    Matches the key order of ops.fmd_jax.build_jump_table.
    """
    s = seqs.astype(np.int64)
    Q, L = s.shape
    keys = np.zeros((Q, L), dtype=np.int64)
    ok = np.ones((Q, L), dtype=bool)
    for j in range(k):
        sh = np.zeros_like(s)
        sh[:, j:] = s[:, :L - j] if j else s
        keys += (sh - 1) * (4 ** j)
        ok &= (sh >= 1) & (sh <= 4)
    ok[:, :k - 1] = False
    return np.where(ok, keys, -1).astype(np.int32)
