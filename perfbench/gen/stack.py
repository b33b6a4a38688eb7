"""Input kind ``stack``: ``traffic["pool"]`` stacks of ``traffic["frames"]``
host uint16 frames, each one speckle pattern moved along the configuration's
spiral (``speckle.speckle_stack``); ``truth`` holds the spiral's ``dy``, ``dx``."""
from __future__ import annotations

from perfbench.gen import speckle


def make_pool(seed: int, config: dict, traffic: dict, device) -> list[dict]:
    return speckle.make_pool(seed, config, dict(traffic, input="stack"), device)
