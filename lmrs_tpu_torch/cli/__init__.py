"""Command-line front ends."""
