"""String seeding, the draw interface, state trees, checkpoints and state conversion from the JAX package."""
