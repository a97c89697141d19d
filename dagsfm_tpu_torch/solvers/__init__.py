"""Convex solvers: ADMM L1 regression, constrained L1, box QP, and the
block-coordinate SDP of Lagrange-dual rotation averaging."""
