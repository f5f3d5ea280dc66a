"""Sharding rules and activation constraints over a mesh's axes."""
