"""The least time of K2, the streaming Hamming matcher (``match_reduce``),
for the work its inputs need: every input read once (descriptors, valid
flags, the features' positions and the map's projections) and its four
int32 outputs written once (per row the best, the second best and its
column; per column the best row), against the card's memory rate; or
2 x N x M x 256 int8 operations (the +-1 products of two 256-bit
descriptors) against int8's peak, whichever is longer.  The count is
``chip_smoke.py`` phase 7's."""


def work(n: int, m: int, batch: int = 1, guided: bool = True) -> tuple[float, float]:
    """(bytes, int8 operations) of one launch over ``batch`` sequences of
    ``n`` features against ``m`` map points."""
    inputs = n * (32 + 1) + m * (32 + 1) + (8 * (n + m) if guided else 0)
    outputs = 4 * (3 * n + m)
    return batch * (inputs + outputs), batch * 2.0 * n * m * 256


def least_s(n: int, m: int, peaks: dict, batch: int = 1, guided: bool = True) -> float:
    nbytes, ops = work(n, m, batch, guided)
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["int8_ops_per_s"])
