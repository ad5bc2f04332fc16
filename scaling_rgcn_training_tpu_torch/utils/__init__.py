"""Host utilities copied from the JAX package (jax-free): timing banners,
config checks, results reports."""
