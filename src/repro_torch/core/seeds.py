"""Integer seed derivation shared by the estimator core and the models."""
from __future__ import annotations

_MASK63 = (1 << 63) - 1


def fold_seed(seed: int, data: int) -> int:
    """Derive a child seed from (seed, data): a splitmix64-style mix in
    plain integers, so seeds for different layers / tags / steps are
    decorrelated and the derivation costs no device work.  Takes the
    place of the reference's ``fold_in``; the streams it yields are not
    the reference's."""
    x = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & (2 ** 64 - 1)
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & (2 ** 64 - 1)
    x ^= x >> 31
    return x & _MASK63
