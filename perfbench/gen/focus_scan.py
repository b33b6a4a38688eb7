"""Input kind ``focus_scan``: ``traffic["pool"]`` scans of ``traffic["frames"]``
host uint16 frames, one speckle pattern blurred more the farther a frame is
from the middle one (``speckle.focus_scan``); ``truth`` holds ``best_frame``."""
from __future__ import annotations

from perfbench.gen import speckle


def make_pool(seed: int, config: dict, traffic: dict, device) -> list[dict]:
    return speckle.make_pool(seed, config, dict(traffic, input="focus_scan"), device)
