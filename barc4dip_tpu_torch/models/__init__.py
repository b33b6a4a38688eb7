# SPDX-License-Identifier: CECILL-2.1
"""End-to-end pipelines of the PyTorch port."""
from .pipeline import SpeckleStackPipeline, WavefrontScanPipeline

__all__ = ["SpeckleStackPipeline", "WavefrontScanPipeline"]
