"""Inference runtime."""
