"""Structured logging.

Replaces the reference's unconditional stdout progress prints littering the
hot path (reference: context_decoder.cpp:68-181, self_attention.cpp:72-140)
with a standard leveled logger that is silent by default in the hot path
and cheap when disabled.
"""

from __future__ import annotations

import logging
import os
import sys

__all__ = ["get_logger"]

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    level = os.environ.get("LLM_ENGINE_LOG_LEVEL", "WARNING").upper()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    root = logging.getLogger("llm_inference_engine")
    root.addHandler(handler)
    root.setLevel(getattr(logging, level, logging.WARNING))
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    return logging.getLogger(f"llm_inference_engine.{name}")
