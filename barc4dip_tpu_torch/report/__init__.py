# SPDX-License-Identifier: CECILL-2.1
"""Reporting of the PyTorch port: Markdown logbook summaries."""
from .markdown import logbook_report, register_formatter

__all__ = ["logbook_report", "register_formatter"]
