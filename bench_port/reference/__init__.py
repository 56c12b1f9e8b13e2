"""The plain references the benchmark's output checks compare with."""
