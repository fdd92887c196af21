"""Deterministic string seeding (port of ``constraint_solver_tpu/utils/seeding.py``).

The same scheme as the JAX package: any string, hashed with blake2b-256, and the
first 8 bytes of the digest (little-endian, top bit cleared) as a 63-bit integer
seed.  Divergence: that integer seeds a ``torch.Generator`` on the solver's device
instead of a JAX key, so the numbers drawn from one seed differ between the two
packages (``utils/draws.py`` says how the tests still compare trajectories).
"""

from __future__ import annotations

import hashlib

import torch


def hash_str(seed: str) -> bytes:
    """blake2b-256 digest of the seed string (32 bytes)."""
    return hashlib.blake2b(seed.encode("utf-8"), digest_size=32).digest()


def seed_string_to_int(seed: str) -> int:
    """The 63-bit integer the JAX package hands to ``jax.random.key``."""
    return int.from_bytes(hash_str(seed)[:8], "little") & 0x7FFF_FFFF_FFFF_FFFF


def seed_string_to_generator(seed: str, device: torch.device | str) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the string."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed_string_to_int(seed))
    return gen
