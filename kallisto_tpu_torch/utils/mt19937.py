"""Bit-exact clone of C++ std::mt19937 (32-bit Mersenne Twister).

The reference sanitizes non-ACGT transcript characters by drawing from
std::mt19937 gen(42) (reference: src/KmerIndex.cpp:267,331).  numpy's
MT19937 uses a different seeding routine (init_by_array), so we implement
the standard init_genrand seeding here for exact parity.
"""

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER_MASK = 0x80000000
_LOWER_MASK = 0x7FFFFFFF


class MT19937:
    """std::mt19937-compatible generator (single-value seed constructor)."""

    def __init__(self, seed: int = 5489):
        mt = [0] * _N
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, _N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) & 0xFFFFFFFF
        self._mt = mt
        self._idx = _N

    def _generate(self):
        mt = self._mt
        for i in range(_N):
            y = (mt[i] & _UPPER_MASK) | (mt[(i + 1) % _N] & _LOWER_MASK)
            mt[i] = mt[(i + _M) % _N] ^ (y >> 1) ^ (_MATRIX_A if (y & 1) else 0)
        self._idx = 0

    def __call__(self) -> int:
        if self._idx >= _N:
            self._generate()
        y = self._mt[self._idx]
        self._idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF


class MT19937_64:
    """std::mt19937_64-compatible generator (for bootstrap seed streams).

    reference: src/main.cpp:2746-2752 seeds std::mt19937_64 with opt.seed
    and draws one 64-bit seed per bootstrap.
    """

    _N = 312
    _M = 156
    _MATRIX_A = 0xB5026F5AA96619E9
    _UM = 0xFFFFFFFF80000000
    _LM = 0x7FFFFFFF

    def __init__(self, seed: int = 5489):
        mt = [0] * self._N
        mt[0] = seed & 0xFFFFFFFFFFFFFFFF
        for i in range(1, self._N):
            mt[i] = (6364136223846793005 * (mt[i - 1] ^ (mt[i - 1] >> 62)) + i) & 0xFFFFFFFFFFFFFFFF
        self._mt = mt
        self._idx = self._N

    def _generate(self):
        mt = self._mt
        for i in range(self._N):
            x = (mt[i] & self._UM) | (mt[(i + 1) % self._N] & self._LM)
            xa = x >> 1
            if x & 1:
                xa ^= self._MATRIX_A
            mt[i] = mt[(i + self._M) % self._N] ^ xa
        self._idx = 0

    def __call__(self) -> int:
        if self._idx >= self._N:
            self._generate()
        x = self._mt[self._idx]
        self._idx += 1
        x ^= (x >> 29) & 0x5555555555555555
        x ^= (x << 17) & 0x71D67FFFEDA60000
        x ^= (x << 37) & 0xFFF7EEE000000000
        x ^= x >> 43
        return x & 0xFFFFFFFFFFFFFFFF
