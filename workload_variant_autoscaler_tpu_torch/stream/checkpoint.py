"""Crash-safe warm-restart checkpoint: versioned, CRC-guarded, atomic.

Counterpart of the reference package's `stream/checkpoint.py`. A
restarted controller reloads its cross-cycle state from this file
instead of paying a cold full pass. The hierarchical solve engine
(solver/hierarchy.py) saves its warm cold-start snapshot here under its
own magic; the streaming core's payload uses the stream magic.

File format, designed for torn writes and version drift:

    line 1   JSON header: {"magic": "wva-stream-ckpt", "version": 1,
             "crc": <crc32 of the body bytes>}
    line 2+  JSON body (one object, the caller's checkpoint payload)

- **Atomic**: the file is written to `<path>.tmp`, fsynced and
  `os.replace`d into place, so a crash mid-save leaves the previous
  checkpoint intact, never a half-written one.
- **Torn-write tolerant**: a truncated or bit-flipped file fails the
  CRC (or the JSON parse) and is discarded; the caller falls back to a
  cold full pass. A checkpoint can only be wrong by being absent, never
  by being silently corrupt.
- **Versioned**: an unknown `version` is discarded the same way. No
  migration logic: a cold start costs one full pass.

Staleness is the caller's policy (it compares the payload's wall-clock
`taken_at` against its own maximum age): this module only guarantees
that what loads is exactly what was saved.
"""

from __future__ import annotations

import json
import os
import zlib

CHECKPOINT_MAGIC = "wva-stream-ckpt"
CHECKPOINT_VERSION = 1

# The hierarchical solve engine's warm cold-start snapshot (arena slabs,
# per-variant solve signatures, the warm-greedy seed) rides the same file
# format under its own magic/version, so a stream checkpoint can never be
# mistaken for an arena checkpoint or the other way round: a mismatch is
# a clean discard, not a mis-restore.
ARENA_CHECKPOINT_MAGIC = "wva-arena-ckpt"
ARENA_CHECKPOINT_VERSION = 1


class CheckpointError(ValueError):
    """Unusable checkpoint file (missing, torn, corrupt, or from an
    incompatible version): the caller discards it and cold-starts."""


def save_checkpoint(path: str, payload: dict, *,
                    magic: str = CHECKPOINT_MAGIC,
                    version: int = CHECKPOINT_VERSION) -> None:
    """Serialize `payload` to `path` atomically. Raises OSError on an
    unwritable destination, TypeError/ValueError on a payload JSON cannot
    hold; never leaves a partial file behind."""
    body = json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    header = json.dumps({
        "magic": magic,
        "version": version,
        "crc": zlib.crc32(body) & 0xFFFFFFFF,
    }, sort_keys=True, separators=(",", ":")).encode("utf-8")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(header + b"\n" + body)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_checkpoint(path: str, *,
                    magic: str = CHECKPOINT_MAGIC,
                    version: int = CHECKPOINT_VERSION) -> dict:
    """Read and verify a checkpoint. Raises CheckpointError on any defect
    (an absent file included): callers treat every failure mode alike,
    discard and cold-start."""
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        raise CheckpointError(f"unreadable checkpoint: {e}") from e
    head, sep, body = raw.partition(b"\n")
    if not sep:
        raise CheckpointError("torn checkpoint: missing body")
    try:
        header = json.loads(head)
    except ValueError as e:
        raise CheckpointError(f"corrupt checkpoint header: {e}") from e
    if not isinstance(header, dict) or header.get("magic") != magic:
        raise CheckpointError(f"not a {magic} checkpoint")
    if header.get("version") != version:
        raise CheckpointError(
            f"unsupported checkpoint version {header.get('version')!r}")
    if header.get("crc") != zlib.crc32(body) & 0xFFFFFFFF:
        raise CheckpointError("checkpoint CRC mismatch (torn write?)")
    try:
        payload = json.loads(body)
    except ValueError as e:
        raise CheckpointError(f"corrupt checkpoint body: {e}") from e
    if not isinstance(payload, dict):
        raise CheckpointError("checkpoint body is not an object")
    return payload
