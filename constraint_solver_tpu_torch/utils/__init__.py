"""String seeding, the draw interface, state trees and state conversion from the JAX package."""
