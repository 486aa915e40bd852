"""Interop with the reference codec's on-disk formats (host code)."""
