"""Problem interface, tabu ring and elite archive, local-search descent, ILS rounds and the single-lane driver, batched over lanes."""
