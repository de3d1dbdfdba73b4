"""Serving sessions of the port."""
