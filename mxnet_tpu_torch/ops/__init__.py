"""Functional operator doors of the port."""
