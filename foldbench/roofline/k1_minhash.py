"""K1, the MinHash kernel (`minhash_kernel` in `kernels/csrc/minhash.cu`):
(B, L) shingle hashes and (H,) seeds in, (B, H) lanes out.

Bytes: every input read once and every output written once. Operations:
12 native 32-bit integer operations per valid shingle and lane (the lane
hash's xor, multiply and add; fmix32's three shift-xor pairs and two
multiplies; the running minimum), counted over the valid shingles that
these inputs hold, not the padded ones."""

TRACE_NAME = "minhash_kernel"


def work(B: int, L: int, H: int, valid_shingles: int) -> tuple[int, int]:
    """(bytes, operations) of one launch."""
    return B * L * 4 + H * 4 + B * H * 4, 12 * valid_shingles * H
