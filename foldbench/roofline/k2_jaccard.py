"""K2, the cached bitmap-Jaccard kernel (`bitmap_tile<0>` in
`kernels/csrc/bitmap_jaccard.cu`): (Q, W) and (N, W) packed bitmaps with
their popcounts in, the (Q, N) float32 similarity matrix out.

Bytes: both bitmap operands and both popcount vectors read once, the
matrix written once. Operations: per pair and word an xor, a popcount and
an add; per pair the sums, the two differences, the conversion and the
division's share (6)."""

TRACE_NAME = "bitmap_tile<0>"


def work(Q: int, N: int, W: int) -> tuple[int, int]:
    """(bytes, operations) of one launch."""
    return (Q * W * 4 + N * W * 4 + Q * 4 + N * 4 + Q * N * 4,
            3 * Q * N * W + 6 * Q * N)
