"""Modules of the port."""
from ..model import load_checkpoint, save_checkpoint
from .base_module import BaseModule, BatchEndParam
from .module import Module

__all__ = ["BaseModule", "BatchEndParam", "Module", "load_checkpoint",
           "save_checkpoint"]
