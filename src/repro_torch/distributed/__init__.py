"""Collectives over per-shard tensors (`collectives`) and the GPipe
schedule over a mesh's "pod" axis (`pipeline`)."""
