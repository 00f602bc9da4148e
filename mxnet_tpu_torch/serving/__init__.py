"""Serving plane of the port: the paged generation engine and its
registry."""
from .decode_engine import GenerationEngine, GenerationResult, TokenStream
from .program_store import GenerativeProgramStore
from .registry import ModelRegistry
from .scheduler import ServeClosed, ServeOverloaded, ServeTimeout

__all__ = ["ModelRegistry", "GenerationEngine", "GenerationResult",
           "TokenStream", "GenerativeProgramStore", "ServeClosed",
           "ServeOverloaded", "ServeTimeout"]
