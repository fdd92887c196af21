"""Dense 64-bit solution fingerprints, two 32-bit lanes
(port of ``constraint_solver_tpu/ops/fingerprint.py``).

    fp(x) = XOR_i h(i, x_i)    per lane, h = murmur3 fmix32 of the salted position
                               mixed with the value bits

so a move changes the fingerprint in O(1): ``fp' = fp ^ h(i, old) ^ h(i, new)``.

Divergence in representation only: a fingerprint is an ``int64`` tensor holding
the uint32 value in [0, 2^32), because PyTorch implements no ``>>`` for uint32 on
the CPU.  ``_mix32`` works in int64 and masks to 32 bits after every multiply
(the product wraps, and its low 32 bits stay right), so every value equals the
JAX package's uint32 bit for bit.  PyTorch has no XOR reduction either, so
``_xor_reduce`` halves the axis pairwise.
"""

from __future__ import annotations

import torch

# Two lane salts, the JAX package's arbitrary odd constants.
_SALTS = (0x9E3779B9, 0x85EBCA77)
_M32 = 0xFFFFFFFF


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 finalizer on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def position_hash_planes(idx: torch.Tensor, value_bits: torch.Tensor) -> tuple:
    """h(i, v) as two int64 planes of uint32 values (the bit patterns of
    ``idx`` and ``value_bits`` taken modulo 2^32, as the JAX package's casts
    to uint32 do)."""
    idx = idx.long() & _M32
    value_bits = value_bits.long() & _M32
    return tuple(_mix32(value_bits ^ _mix32(idx ^ salt)) for salt in _SALTS)


def position_hash(idx: torch.Tensor, value_bits: torch.Tensor) -> torch.Tensor:
    """h(i, v) for both lanes: [..., 2]."""
    return torch.stack(position_hash_planes(idx, value_bits), dim=-1)


def _xor_reduce(lane_hashes: torch.Tensor) -> torch.Tensor:
    """XOR-reduce [..., n, 2] over axis -2 → [..., 2], by pairwise halving."""
    x = lane_hashes
    while x.shape[-2] > 1:
        if x.shape[-2] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1, :])], dim=-2)
        half = x.shape[-2] // 2
        x = x[..., :half, :] ^ x[..., half:, :]
    return x[..., 0, :]


def fingerprint_i32(values: torch.Tensor) -> torch.Tensor:
    """Fingerprint of an integer [..., n] solution vector → int64[..., 2]."""
    idx = torch.arange(values.shape[-1], device=values.device).expand(values.shape)
    return _xor_reduce(position_hash(idx, values))


def fingerprint_f32(values: torch.Tensor) -> torch.Tensor:
    """Fingerprint of a float32 [..., n] vector by its bit patterns (the int32
    view, masked to uint32 in int64 by ``position_hash_planes``)."""
    return fingerprint_i32(values.contiguous().view(torch.int32))


def fp_update(
    fp: torch.Tensor, idx: torch.Tensor, old_bits: torch.Tensor, new_bits: torch.Tensor
) -> torch.Tensor:
    """O(1) update of ``fp`` [..., 2] for position ``idx`` changed old → new
    (``idx``/``old_bits``/``new_bits`` broadcastable [...])."""
    return fp ^ position_hash(idx, old_bits) ^ position_hash(idx, new_bits)
