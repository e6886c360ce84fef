"""Helpers that carry weights between the JAX package and this one."""
