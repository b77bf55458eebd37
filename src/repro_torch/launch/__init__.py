"""Train-step construction of the port."""
