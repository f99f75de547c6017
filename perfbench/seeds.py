"""Seeds of the generator streams a run draws from its ``--seed``."""

from __future__ import annotations

import hashlib


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for the stream ``stream`` of the run seeded ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
