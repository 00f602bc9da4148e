"""Serving plane of the port: the forward plane (bucketed programs, the
continuous batcher), the paged generation engine, the registry both
serve from, and the open-loop load generator."""
from .decode_engine import GenerationEngine, GenerationResult, TokenStream
from .loadgen import OpenLoopSchedule, latency_protocol, run_loadgen
from .program_store import (GenerativeProgramStore, ProgramStore,
                            bucket_edges, bucket_for)
from .registry import ModelRegistry
from .scheduler import (TIERS, ServeClosed, ServeOverloaded, ServeRequest,
                        ServeTimeout, ServingEngine)

__all__ = ["ModelRegistry", "ProgramStore", "ServingEngine", "ServeRequest",
           "TIERS", "GenerationEngine", "GenerationResult", "TokenStream",
           "GenerativeProgramStore", "ServeClosed", "ServeOverloaded",
           "ServeTimeout", "OpenLoopSchedule", "run_loadgen",
           "latency_protocol", "bucket_edges", "bucket_for"]
