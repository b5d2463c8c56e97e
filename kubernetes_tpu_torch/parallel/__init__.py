"""The node-sharded mesh (parallel/sharding.py)."""
