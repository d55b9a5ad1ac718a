"""Frozen arithmetic of the benchmark: what a change to the program cannot move."""
