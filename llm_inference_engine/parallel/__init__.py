from llm_inference_engine.parallel.mesh import make_mesh
from llm_inference_engine.parallel.multihost import (
    initialize_multihost, make_multihost_mesh)
from llm_inference_engine.parallel import pipeline  # noqa: F401
from llm_inference_engine.parallel import sharding  # noqa: F401

__all__ = ["make_mesh", "make_multihost_mesh", "initialize_multihost",
           "pipeline", "sharding"]
