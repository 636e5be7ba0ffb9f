"""Draft-model pairings for speculative decoding (``serve/speculative.py``).

For each target architecture, the small config worth drafting with.  The
determinism contract makes a pairing a throughput knob only: a poor draft
commits fewer tokens a step, never other tokens.  A draft whose vocabulary
is wider than the target's may propose ids the target does not have; the
target's ``verify`` clamps them to its last id (the reference's gather
semantics) and rejects them.

    from repro_torch.configs.spec_pairs import draft_arch_for
    draft_arch_for("llama-7b")   # -> "smollm-360m"
"""
from __future__ import annotations

from typing import Optional

# target arch id -> draft arch id (both resolvable by core.config.get_config)
PAIRS = {
    "llama-7b": "smollm-360m",
    "llama-33h": "smollm-360m",
    "llama-16h": "smollm-360m",
    "llama-gqa": "smollm-360m",
    "qwen3-8b": "smollm-360m",
    "qwen2.5-14b": "smollm-360m",
    "qwen1.5-32b": "smollm-360m",
}


def draft_arch_for(target_arch: str) -> Optional[str]:
    """The paired draft config id for ``target_arch``, or ``None`` (fall
    back to self-speculation)."""
    return PAIRS.get(target_arch)
