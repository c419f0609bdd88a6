"""Device LP solvers of the port."""
