"""The live runtime: the native frame ring, the threaded pipeline, the
capture shims and their headless fakes (port of the JAX runtime/)."""
