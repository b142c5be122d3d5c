"""Typing helpers (reference: src/hydrusvideodeduplicator/typing_utils.py)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ValueRange:
    lo: int
    hi: int
