"""Solvers of the port: the grid max-flow main path and its masked loop."""
