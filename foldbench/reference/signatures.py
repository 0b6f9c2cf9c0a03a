"""Step ① from the inputs, in plain PyTorch: shingle hashes, MinHash
lanes and the one-hot bitmap, worked out again from the token ids.

These are frozen copies of the plain formulas of FOLD's signatures (an
FNV-style polynomial over n-token windows finished by Murmur3's fmix32,
one fmix32 hash per lane seeded from the golden ratio, bit `lane mod T`
set), kept here so that the yardstick does not move with the program.
Every uint32 lives as an int64 in [0, 2**32), where `>>` is logical and
products are taken mod 2**32 through 16-bit halves, so the CPU and the card
give the same bits.

What the comparison needs is each document's set of bitmap positions: as a
(B, T) 0/1 float32 matrix, so that intersections are one exact matrix
product (integer counts far below 2**24), and its popcount.
"""
from __future__ import annotations

import torch

from foldbench.traffic.generate import pad

__all__ = ["M32", "hash_seeds", "shingle_hashes", "minhash", "bitmap_bits",
           "signatures", "batch_signatures"]

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_POLY = 0x01000193
_BLOCK = 1 << 22          # int64 elements per temporary block


def _mul32(a: torch.Tensor, c) -> torch.Tensor:
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 13)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def hash_seeds(num: int, base_seed: int, device) -> torch.Tensor:
    """(num,) lane seeds."""
    idx = torch.arange(num, dtype=torch.int64, device=device)
    return _fmix32((_mul32(idx, _GOLDEN) + (base_seed & M32)) & M32)


def shingle_hashes(tokens: torch.Tensor, lengths: torch.Tensor,
                   n: int) -> torch.Tensor:
    """(B, L) token ids (zero-padded) -> (B, L) hashes of the n-token
    windows; positions past max(len - n + 1, min(len, 1)) hold M32."""
    t = tokens.to(torch.int64) & M32
    B, L = t.shape
    h = torch.zeros((B, L), dtype=torch.int64, device=t.device)
    for k in range(n):
        h = (_mul32(h, _POLY) + torch.roll(t, -k, dims=1) + 1) & M32
    h = _fmix32(h)
    lengths = lengths.to(torch.int64).to(t.device)
    count = torch.where(lengths >= n, lengths - n + 1,
                        torch.clamp(lengths, max=1))
    pos = torch.arange(L, device=t.device)[None, :]
    return torch.where(pos < count[:, None], h, torch.full_like(h, M32))


def minhash(sh: torch.Tensor, seeds: torch.Tensor,
            lane_bits: int = 32) -> torch.Tensor:
    """(B, L) shingle hashes x (H,) seeds -> (B, H) lanes: the least hash of
    each lane over the valid shingles (all ones where there are none).
    `lane_bits` < 32 keeps only the low bits of each hash (the control)."""
    B, L = sh.shape
    H = seeds.shape[0]
    valid = sh != M32
    mask = (1 << lane_bits) - 1
    out = torch.empty((B, H), dtype=torch.int64, device=sh.device)
    step = max(1, _BLOCK // max(B * L, 1))
    for h0 in range(0, H, step):
        s = seeds[h0:h0 + step].reshape(-1, 1, 1)
        x = _fmix32((_mul32(sh[None] ^ s, _GOLDEN) + s) & M32) & mask
        x = torch.where(valid[None], x, torch.full_like(x, mask))
        out[:, h0:h0 + step] = x.amin(-1).T
    return out


def bitmap_bits(lanes: torch.Tensor, T: int) -> torch.Tensor:
    """(B, H) lanes -> (B, T) float32 0/1: position `lane mod T` set."""
    bits = torch.zeros((lanes.shape[0], T), dtype=torch.float32,
                       device=lanes.device)
    return bits.scatter_(1, lanes % T, 1.0)


def signatures(tokens, lengths, *, num_hashes: int, shingle_n: int, T: int,
               seed: int, device, lane_bits: int = 32
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Padded token ids and lengths (numpy) -> (bits (B, T) float32 0/1,
    popcounts (B,) int64) on `device`."""
    tok = torch.from_numpy(tokens.astype("int64")).to(device)
    ln = torch.from_numpy(lengths.astype("int64")).to(device)
    lanes = minhash(shingle_hashes(tok, ln, shingle_n),
                    hash_seeds(num_hashes, seed, device), lane_bits)
    bits = bitmap_bits(lanes, T)
    return bits, bits.sum(1).to(torch.int64)


def batch_signatures(docs: list, fold: dict, device,
                     lane_bits: int = 32) -> list:
    """(bits, popcounts) per batch of `docs` (a list of documents per
    batch), worked out in blocks of 512 documents under `fold`'s widths."""
    flat = [d for batch in docs for d in batch]
    bits, pcs = [], []
    for s in range(0, len(flat), 512):
        b, p = signatures(*pad(flat[s:s + 512]),
                          num_hashes=fold["num_hashes"],
                          shingle_n=fold["shingle_n"], T=fold["T"],
                          seed=fold["seed"], device=device,
                          lane_bits=lane_bits)
        bits.append(b)
        pcs.append(p)
    bits, pcs = torch.cat(bits), torch.cat(pcs)
    out, at = [], 0
    for batch in docs:
        out.append((bits[at:at + len(batch)], pcs[at:at + len(batch)]))
        at += len(batch)
    return out
