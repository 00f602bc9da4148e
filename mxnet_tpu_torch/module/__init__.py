"""Modules of the port."""
from .base_module import BaseModule, BatchEndParam
from .module import Module, load_checkpoint

__all__ = ["BaseModule", "BatchEndParam", "Module", "load_checkpoint"]
