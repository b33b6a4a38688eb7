"""Input kind ``stack_resident``: ``traffic["pool"]`` float32 stacks of
``traffic["frames"]`` frames held on the card, as a flat-field correction
with ``as_numpy=False`` leaves them for the analysis that follows.

Each stack is the ``stack`` kind's spiral speckle counts
(``speckle.speckle_stack``), cast to float32 on the card, plus a uniform
offset drawn a pixel from ``traffic["offset"]`` = [lo, hi): calibrated frames
are not whole counts, and some fall below zero. An item carries the
contiguous CUDA tensor (``stack``), the host copy of the same float32 values
(``data``, which the reference reads) and the spiral (``truth``: ``dy``,
``dx``). Every draw comes from one generator seeded with ``--seed``."""
from __future__ import annotations

import numpy as np
import torch

from perfbench.gen import speckle


def make_pool(seed: int, config: dict, traffic: dict, device) -> list[dict]:
    det, content = config["detector"], config["content"]
    H, W = int(det["height"]), int(det["width"])
    T = int(traffic["frames"])
    lo, hi = (float(v) for v in traffic["offset"])
    dys, dxs = speckle.spiral(T, content["spiral_amplitude"], content["spiral_omega"])
    gen = speckle.generator(seed, device)
    pool = []
    with torch.no_grad():
        for _ in range(int(traffic["pool"])):
            counts = speckle.speckle_stack(gen, T, H, W, grain_px=content["grain_px"],
                                           mean_counts=content["mean_counts"], dys=dys, dxs=dxs, device=device)
            stack = torch.empty((T, H, W), dtype=torch.float32, device=device)
            for t in range(T):
                raw = torch.from_numpy(counts[t].view(np.int16)).to(device).to(torch.int32) & 0xFFFF
                offset = torch.rand((H, W), generator=gen, device=device, dtype=torch.float32) * (hi - lo) + lo
                stack[t] = raw.to(torch.float32) + offset
            pool.append({"stack": stack, "data": stack.cpu().numpy(), "truth": {"dy": dys, "dx": dxs}})
    return pool
