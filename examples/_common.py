"""Shared bootstrap for the example scripts: make the in-repo package
importable and compute in float64 so printed numbers match the
double-precision reference examples (the examples run on whatever device
JAX finds; the H100 has native float64)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_enable_x64", True)
