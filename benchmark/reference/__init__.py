"""The plain f32 reference the benchmark holds the port against; it
imports nothing of the port."""
