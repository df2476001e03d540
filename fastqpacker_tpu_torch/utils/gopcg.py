"""Go ``math/rand/v2`` PCG stream + ``Shuffle``, bit-exact.

The reference's fqscramble seeds ``rand.New(rand.NewPCG(seed, seed))``
and permutes each read with ``rng.Shuffle``
(cmd/fqscramble/main.go:72,152-158). Reproducing its output byte-for-byte
requires Go's exact generator and bounded-int reduction:

- **PCG-DXSM, 128-bit state** (Go ``math/rand/v2/pcg.go``):
  ``NewPCG(hi, lo)`` stores the seeds directly as state; each ``Uint64``
  advances ``state = state*mul + inc`` (128-bit LCG with the standard
  PCG multiplier/increment) and outputs the DXSM mix of the new state.
- **Bounded ints** (``rand.go`` ``uint64n``): power-of-two sizes mask;
  otherwise Lemire's multiply-shift with the ``-n % n`` threshold
  rejection loop.
- **Shuffle** (``rand.go``): Fisher-Yates from the top,
  ``for i := n-1; i > 0; i-- { j := uint64n(i+1); swap(i, j) }``.

The port's copy of ``fastqpacker_tpu/utils/gopcg.py`` (pure Python; the
port has no C++ runtime, so ``fqscramble`` runs this module).
"""

from __future__ import annotations

M64 = (1 << 64) - 1

_MUL_HI = 2549297995355413924
_MUL_LO = 4865540595714422341
_INC_HI = 6364136223846793005
_INC_LO = 1442695040888963407
_CHEAP_MUL = 0xDA942042E4DD58B5


class GoPCG:
    """Go math/rand/v2 ``*Rand`` over a ``NewPCG(seed1, seed2)`` source."""

    def __init__(self, seed1: int, seed2: int) -> None:
        self.hi = seed1 & M64
        self.lo = seed2 & M64

    def uint64(self) -> int:
        # state = state * mul + inc (128-bit), then DXSM output mix
        state = ((self.hi << 64) | self.lo)
        mul = (_MUL_HI << 64) | _MUL_LO
        inc = (_INC_HI << 64) | _INC_LO
        state = (state * mul + inc) & ((1 << 128) - 1)
        self.hi = state >> 64
        self.lo = state & M64
        hi, lo = self.hi, self.lo
        hi ^= hi >> 32
        hi = (hi * _CHEAP_MUL) & M64
        hi ^= hi >> 48
        hi = (hi * (lo | 1)) & M64
        return hi

    def uint64n(self, n: int) -> int:
        """Go ``(*Rand).uint64n`` (64-bit platform path)."""
        if n & (n - 1) == 0:  # power of two
            return self.uint64() & (n - 1)
        prod = self.uint64() * n
        hi, lo = prod >> 64, prod & M64
        if lo < n:
            thresh = (M64 + 1 - n) % n  # -n % n in uint64
            while lo < thresh:
                prod = self.uint64() * n
                hi, lo = prod >> 64, prod & M64
        return hi

    def shuffle(self, seq: list) -> None:
        """In-place Fisher-Yates identical to Go ``rand.Shuffle``."""
        for i in range(len(seq) - 1, 0, -1):
            j = self.uint64n(i + 1)
            seq[i], seq[j] = seq[j], seq[i]


def _utf8_runes(line: bytes) -> list[int]:
    """Go ``[]rune(string)``: decode UTF-8, each invalid byte -> U+FFFD."""
    runes: list[int] = []
    i, n = 0, len(line)
    while i < n:
        b0 = line[i]
        if b0 < 0x80:
            runes.append(b0)
            i += 1
            continue
        # multi-byte: length from the leading byte, validate strictly
        if 0xC2 <= b0 <= 0xDF:
            need, lo, hi = 1, 0x80, 0xBF
        elif 0xE0 <= b0 <= 0xEF:
            need = 2
            lo = 0xA0 if b0 == 0xE0 else 0x80
            hi = 0x9F if b0 == 0xED else 0xBF
        elif 0xF0 <= b0 <= 0xF4:
            need = 3
            lo = 0x90 if b0 == 0xF0 else 0x80
            hi = 0x8F if b0 == 0xF4 else 0xBF
        else:
            runes.append(0xFFFD)
            i += 1
            continue
        cont = line[i + 1 : i + 1 + need]
        if len(cont) < need or not (lo <= cont[0] <= hi) or any(
            not (0x80 <= c <= 0xBF) for c in cont[1:]
        ):
            runes.append(0xFFFD)
            i += 1
            continue
        v = b0 & (0x3F >> need)
        for c in cont:
            v = (v << 6) | (c & 0x3F)
        runes.append(v)
        i += 1 + need
    return runes


def _encode_runes(runes: list[int]) -> bytes:
    return "".join(map(chr, runes)).encode("utf-8", "replace")


def shuffle_line(line: bytes, rng: GoPCG) -> bytes:
    """Go ``shuffleString`` (main.go:152-158): shuffle the line's runes.

    ASCII fast path shuffles bytes directly (identical result)."""
    if not line:
        rng.shuffle([])  # n<=1: consumes nothing, but keep symmetry
        return line
    if max(line) < 0x80:
        arr = list(line)
        rng.shuffle(arr)
        return bytes(arr)
    runes = _utf8_runes(line)
    rng.shuffle(runes)
    return _encode_runes(runes)


def scramble_text(data: bytes, seed: int, rng: GoPCG | None = None) -> bytes:
    """The whole Go ``scramble`` loop (main.go:111-149): a 4-line state
    machine over ``bufio.Scanner`` lines (trailing ``\\r`` stripped, no
    validation), shuffling line 1 of each group; incomplete trailing
    groups are dropped; every emitted line gets ``\\n``. Pass ``rng`` to
    carry the PCG stream across chunked calls (cut chunks at 4-line-group
    boundaries)."""
    if rng is None:
        rng = GoPCG(seed, seed)
    out = bytearray()
    group: list[bytes] = []
    n = len(data)
    i = 0
    while i < n:
        j = data.find(b"\n", i)
        if j < 0:
            line = data[i:n]
            i = n
        else:
            line = data[i:j]
            i = j + 1
        if line.endswith(b"\r"):
            line = line[:-1]
        group.append(line)
        if len(group) == 4:
            header, seq, plus, qual = group
            out += header + b"\n"
            out += shuffle_line(seq, rng) + b"\n"
            out += plus + b"\n"
            out += qual + b"\n"
            group = []
    return bytes(out)
