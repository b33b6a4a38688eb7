"""Input kind ``frame``: ``traffic["pool"]`` single host uint16 frames, the
frames of one spiral stack of as many frames (``speckle.speckle_stack``);
``truth`` is empty."""
from __future__ import annotations

from perfbench.gen import speckle


def make_pool(seed: int, config: dict, traffic: dict, device) -> list[dict]:
    return speckle.make_pool(seed, config, dict(traffic, input="frame"), device)
