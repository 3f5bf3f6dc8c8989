"""The flags every example takes."""
from __future__ import annotations

import argparse


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def require(cond: bool, what: str):
    """Raise unless ``cond``: an example's claim did not hold."""
    if not cond:
        raise RuntimeError(f"example check failed: {what}")
