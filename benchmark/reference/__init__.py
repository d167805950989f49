"""The plain reference the benchmark judges the port against (numpy and
plain torch; imports nothing of the port and nothing of JAX)."""
