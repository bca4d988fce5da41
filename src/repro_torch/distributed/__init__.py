"""Collectives of the sharded serving engine, over per-shard tensors
(`collectives`)."""
