"""FFT-friendly padded grid sizes (counterpart of
``learned_hologram_gan_tpu/utils/fftlen.py``).

The aspect-derived column padding of a high-resolution geometry can land on
a length with a large prime factor (2176 x 3840 at pad 320 gives 3840 + 2 *
564 = 4968 = 2^3 * 3^3 * 23), which FFT libraries handle by Bluestein's
algorithm at several times the work and memory.  These helpers pick the
smallest 2/3/5-smooth padded sizes at or above the reference's padding.
"""

from __future__ import annotations

from typing import Tuple


def is_smooth(n: int, primes=(2, 3, 5)) -> bool:
    """Whether ``n`` has no prime factor outside ``primes``."""
    for p in primes:
        while n % p == 0:
            n //= p
    return n == 1


def next_fast_len(n: int) -> int:
    """Smallest 5-smooth integer >= n."""
    while not is_smooth(n):
        n += 1
    return n


def good_fft_pads(rows: int, cols: int, min_pad_rows: int) -> Tuple[int, int]:
    """(pad_rows, pad_cols) giving 5-smooth padded sizes with at least the
    reference's padding on each axis (``pad_cols >= min_pad_rows * cols /
    rows``), split evenly on both sides."""
    min_pad_cols = int(min_pad_rows * (cols / rows))
    padded_r = next_fast_len(rows + 2 * min_pad_rows)
    padded_c = next_fast_len(cols + 2 * min_pad_cols)
    # keep parity so the padding splits evenly
    if (padded_r - rows) % 2:
        padded_r = next_fast_len(padded_r + 1)
    if (padded_c - cols) % 2:
        padded_c = next_fast_len(padded_c + 1)
    return (padded_r - rows) // 2, (padded_c - cols) // 2
