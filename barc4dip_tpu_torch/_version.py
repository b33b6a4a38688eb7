# SPDX-License-Identifier: CECILL-2.1
"""Package version (the port's own copy of ``barc4dip_tpu/_version.py``):
the installed distribution's, else the checkout's ``pyproject.toml``."""
from __future__ import annotations

__all__ = ["__version__"]


def _resolve_version() -> str:
    try:
        from importlib.metadata import version

        return version("barc4dip-tpu")
    except Exception:
        pass
    try:
        import pathlib
        import tomllib

        pyproject = pathlib.Path(__file__).resolve().parent.parent / "pyproject.toml"
        with open(pyproject, "rb") as f:
            return tomllib.load(f)["project"]["version"]
    except Exception:
        return "0+unknown"


__version__ = _resolve_version()
