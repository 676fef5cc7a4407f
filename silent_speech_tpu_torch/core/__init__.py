"""The port's own copies of the jax-free modules of the JAX package's core
(the clip format, the landmark constants, the reference state_dict export,
the trainer config): the port imports nothing of the JAX package."""
