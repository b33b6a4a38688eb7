# SPDX-License-Identifier: CECILL-2.1
"""End-to-end pipelines of the PyTorch port."""
from .pipeline import SpeckleStackPipeline, WavefrontScanPipeline, full_step_fn

__all__ = ["SpeckleStackPipeline", "WavefrontScanPipeline", "full_step_fn"]
