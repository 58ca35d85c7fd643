"""The benchmark's plain reference of GenConViT: float32 PyTorch functions
over state dicts with the reference checkpoints' keys, and the seeded init
that makes those state dicts. Nothing here imports the port or JAX."""
