"""Shared plugin helpers (reference: framework/plugins/helper)."""

from __future__ import annotations

from ..framework.interface import MAX_NODE_SCORE


def default_normalize_score(max_priority: int, reverse: bool, scores: list[int]) -> list[int]:
    """Reference: plugins/helper/normalize_score.go DefaultNormalizeScore."""
    max_count = max(scores) if scores else 0
    if max_count == 0:
        if reverse:
            return [max_priority] * len(scores)
        return scores
    out = []
    for s in scores:
        s = max_priority * s // max_count
        if reverse:
            s = max_priority - s
        out.append(s)
    return out


def default_normalize(scores: list[int], reverse: bool = False) -> list[int]:
    return default_normalize_score(MAX_NODE_SCORE, reverse, scores)
