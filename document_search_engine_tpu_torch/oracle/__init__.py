from . import spec
from .oracle import OracleEngine
from .vector import VectorOracleEngine

__all__ = ["spec", "OracleEngine", "VectorOracleEngine"]
