"""Serving loop over the live runtime."""
