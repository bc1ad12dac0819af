"""Device solvers; ``scan`` holds the fused converge session."""
