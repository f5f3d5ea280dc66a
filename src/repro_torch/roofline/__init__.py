"""Per-device cost models of a step: products and collectives."""
